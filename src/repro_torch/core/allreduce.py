"""Union Sparse Allreduce: nested heterogeneous butterfly over a stacked mesh (reference: ``repro.core.allreduce``).

The reference maps the paper's socket schedule onto mesh collectives
inside ``shard_map``; the port runs the same schedule on stacked ``[M,
...]`` tensors, every op batched over the node axis (no Python loop over
nodes), with the group exchanges done by
:class:`repro_torch.core.transport.StackedTransport`:

* one butterfly layer of degree k == a group all_to_all (down /
  scatter-reduce) and a tiled group all_gather in reverse order (up);
* the hash-permuted sorted-range partition is a static-shape
  ``bucket_partition``;
* the tree-merge sum is a stable re-sort + segment compaction
  (``merge="sort"``) or the rank-merge pipelines of
  ``repro_torch.kernels.ops.merge_sorted_runs`` (``merge="fused"`` or
  ``"banded"``);
* ``wire=`` picks the payload of every exchange
  (``repro_torch.kernels.wirecodec``): bit-packed index offsets and f32,
  bf16 or per-row int8 values, decoded against the stage subrange base
  the receiver knows.

Static capacities make overflow a counted, returned quantity, as in the
reference.  r-way replication (paper §V) is a plain layer: the physical
plan prepends a degree-r replica-merge stage (``make_device_plan(
replication=r)``), and each physical node's values are multiplied by its
``contribution_weights`` entry before it, so every logical shard is
summed from its first alive replica.  The dense baselines run on
stacked ``[M, n]`` tensors too: the ring is the transport's ``psum``, the
hierarchical and binary butterflies a tiled reduce-scatter per layer down
and a tiled all-gather per layer up, and the bucketed hierarchical
butterfly the same over a list of buckets, stage-major.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs

from .sparse_vec import (SENTINEL, SparseChunk, _drop_last_row, _mask_val,
                         _put_rows, bucket_partition, compact_overflow,
                         concat_sorted_groups, segment_compact)
from .topology import ButterflyPlan, check_wire
from .transport import StackedTransport


@dataclasses.dataclass(frozen=True)
class Stage:
    """One butterfly layer bound to a mesh axis."""
    axis_name: str
    degree: int
    axis_index_groups: Tuple[Tuple[int, ...], ...]
    bucket_capacity: int
    merged_capacity: int


@dataclasses.dataclass(frozen=True)
class DevicePlan:
    """Butterfly plan bound to mesh axes, with static capacities.

    ``axes``: ordered [(axis_name, axis_size)], most-significant first;
    ``degrees_per_axis`` factorizes each axis and the concatenated degree
    sequence is the logical ButterflyPlan over prod(sizes) nodes.  On the
    stacked mesh node ids are the row-major flattening of the axis
    coordinates, so stage l's groups are the logical plan's layer-l groups.
    ``replication`` > 1 marks an r-way replicated plan: replica j of
    logical shard i is physical node ``i + j * num_logical``, and stage 0
    is the replica-merge layer, whose groups are :meth:`replica_groups`.
    """

    axes: Tuple[Tuple[str, int], ...]
    stages: Tuple[Stage, ...]
    logical: ButterflyPlan
    in_capacity: int
    out_capacity: int
    replication: int = 1

    @property
    def num_nodes(self) -> int:
        """Physical node count (= prod of the bound mesh-axis sizes)."""
        return self.logical.num_nodes

    @property
    def num_logical(self) -> int:
        """Logical shard count (== num_nodes unless replicated)."""
        return self.logical.num_nodes // self.replication

    def replica_groups(self) -> List[List[int]]:
        """[[physical ids] per logical shard] (``core.replication``)."""
        from .replication import replica_groups
        return replica_groups(self.num_nodes, self.replication)

    def edges_arrays(self) -> List[np.ndarray]:
        """Per-stage [M, k_l + 1] int64 range edges, clipped to uint32 max
        as the reference's uint32 edges are."""
        return [np.minimum(self.logical.all_edges(l), (1 << 32) - 1)
                for l in range(len(self.stages))]

    def edges_tensors(self, device) -> List[torch.Tensor]:
        """:meth:`edges_arrays` as int64 tensors on ``device``: one
        host-to-device copy a stage, counted in ``union.htod_copies``."""
        edges = self.edges_arrays()
        obs.count_htod("union.htod_copies", device, len(edges))
        return [torch.as_tensor(e, dtype=torch.int64, device=device)
                for e in edges]


def make_device_plan(axes: Sequence[Tuple[str, int]],
                     degrees_per_axis: dict,
                     in_capacity: int,
                     out_capacity: int,
                     slack: float = 2.0,
                     replication: int = 1) -> DevicePlan:
    """Bind a heterogeneous butterfly to mesh axes with static capacities
    (the reference's arithmetic exactly).

    Stage l buckets hold ``ceil(m_{l-1}/k * slack)`` entries; merged
    chunks hold ``min(k*c_l, ceil(out_capacity * slack / prod(k_1..k_l)))``
    -- lossless when the hash permutation balances ranges and
    ``out_capacity`` covers the global union.  ``replication=r`` prepends
    the degree-r replica-merge stage to the first axis.
    """
    if replication < 1:
        raise ValueError(f"replication must be >= 1, got {replication}")
    if replication > 1:
        name0, size0 = axes[0]
        if size0 % replication:
            raise ValueError(
                f"first axis {name0}={size0} not divisible by "
                f"r={replication}")
        base = tuple(degrees_per_axis.get(
            name0, (size0 // replication,) if size0 > replication else ()))
        degrees_per_axis = dict(degrees_per_axis)
        degrees_per_axis[name0] = (replication,) + base
    degrees: List[int] = []
    for name, size in axes:
        d = tuple(degrees_per_axis.get(name, (size,)))
        if math.prod(d) != size:
            raise ValueError(f"axis {name}: prod{d} != {size}")
        degrees.extend(d)
    m = math.prod(s for _, s in axes)
    logical = ButterflyPlan(m, tuple(degrees))

    stages: List[Stage] = []
    m_prev = in_capacity
    prod_k = 1
    for name, size in axes:
        sub = ButterflyPlan(size, tuple(degrees_per_axis.get(name, (size,))))
        for sl in range(sub.depth):
            k = sub.degrees[sl]
            groups = tuple(tuple(g) for g in sub.axis_index_groups(sl))
            cap = _round8(int(math.ceil(m_prev / k * slack)))
            prod_k *= k
            merged = min(k * cap,
                         _round8(int(math.ceil(out_capacity * slack / prod_k))))
            merged = max(merged, 8)
            stages.append(Stage(axis_name=name, degree=k,
                                axis_index_groups=groups,
                                bucket_capacity=cap, merged_capacity=merged))
            m_prev = merged
    return DevicePlan(axes=tuple(axes), stages=tuple(stages), logical=logical,
                      in_capacity=in_capacity, out_capacity=out_capacity,
                      replication=replication)


def _round8(x: int) -> int:
    return max(8, ((x + 7) // 8) * 8)


def shape_bucket(n: int, floor: int = 8) -> int:
    """Round a capacity up to the next power of two (at least ``floor``)."""
    if n < 0:
        raise ValueError(f"shape_bucket: capacity must be >= 0, got {n}")
    if floor < 1:
        raise ValueError(f"shape_bucket: floor must be >= 1, got {floor}")
    b = int(floor)
    while b < n:
        b <<= 1
    return b


# Per-layer merge strategies of the union path.
MERGE_MODES = ("sort", "fused", "banded")


def check_merge(merge: str) -> str:
    """Validate a merge-mode name; returns it for chaining."""
    if merge not in MERGE_MODES:
        raise ValueError(f"merge must be one of {MERGE_MODES}, got {merge!r}")
    return merge


def sparse_allreduce_union(chunk: SparseChunk, plan: DevicePlan,
                           edges: Sequence[torch.Tensor],
                           transport: StackedTransport,
                           merge: str = "sort", wire: str = "raw",
                           weight: Optional[torch.Tensor] = None
                           ) -> Tuple[SparseChunk, torch.Tensor]:
    """Nested butterfly sparse allreduce; every node gets the full union sum.

    ``chunk``: the stacked nodes' sorted chunks, idx [M, C] (hashed int64),
    val [M, C] or [M, C, W].  ``edges``: per-stage [M, k_l + 1] range
    edges (:meth:`DevicePlan.edges_tensors`).  ``merge`` picks the
    per-layer merge of the k sorted runs arriving at each layer: ``"sort"``
    concatenates, stably re-sorts and segment-compacts; ``"fused"`` and
    ``"banded"`` rank-merge the runs and scatter-add in one pass through
    the CUDA kernels (``repro_torch.kernels.ops.merge_sorted_runs``).  All
    give the same indices and overflow, and the same values on dyadic
    inputs.  ``wire`` picks the exchanged payload: ``"raw"`` ships int64
    indices and the values; the ``"delta"`` family ships indices as
    bit-packed int32 words of offsets from the stage subrange base --
    down: bucket d from ``e[d]``, decoded against the receiver's own
    ``e[j]``; up: from the sender's ``e[j]``, gathered row t decoded
    against ``e[t]`` -- and values as f32 (``delta``, bit-identical to
    raw), bf16 (``delta+bf16``) or per-row int8 with an f32 scale
    (``delta+int8ef``).  The kernel merges take the narrow values and the
    scale as they are; the sort merge dequantizes first.  One layer costs
    one transport exchange down and one up, whatever the wire.
    ``weight`` (r-way replicated plans): ``[M]`` per-node
    ``contribution_weights``, 1 on each logical shard's first alive
    replica and 0 elsewhere, multiplied into the values before the first
    layer; indices still flow from every replica and the zeros merge away
    exactly, so the union equals the unreplicated one.
    Returns (union chunk of capacity ``out_capacity`` per node, overflow
    [M] -- entries dropped to capacity anywhere in the network).  Spans
    (:mod:`repro_torch.obs`): ``union.partition``, ``union.exchange`` and
    ``union.merge`` each layer down, ``union.gather`` each layer up,
    ``union.trim`` the final compaction.
    """
    check_merge(merge)
    check_wire(wire)
    if weight is not None:
        w = weight.to(chunk.val.dtype).reshape(
            (-1,) + (1,) * (chunk.val.ndim - 1))
        chunk = SparseChunk(idx=chunk.idx, val=chunk.val * w)
    overflow = torch.zeros(chunk.idx.shape[0], dtype=torch.int64,
                           device=chunk.idx.device)
    compute_dtype = chunk.val.dtype
    if wire != "raw":
        from repro_torch.kernels import wirecodec as _wc
        widths = _wc.stage_index_bits(plan)

    # ---- down: scatter-reduce through the layers --------------------------
    for l, st in enumerate(plan.stages):
        k, e = st.degree, edges[l]
        with obs.span("union.partition"):
            buckets, ovf = bucket_partition(chunk, e, k, st.bucket_capacity)
            overflow = overflow + ovf
        with obs.span("union.exchange"):
            if wire == "raw":
                r_idx, r_val = transport.all_to_all(l, buckets.idx,
                                                    buckets.val)
                r_scale = None
            else:
                # bucket d covers [e[d], e[d+1]): ship offsets from e[d]
                send_words = _wc.pack_indices(buckets.idx, e[:, :k],
                                              widths[l])
                send_val, scale = buckets.val, None
                if wire == "delta+bf16":
                    send_val = send_val.to(torch.bfloat16)
                elif wire == "delta+int8ef":
                    m = send_val.shape[0]
                    q, scale = _wc.quant8_rows(send_val.reshape(
                        (m * k,) + send_val.shape[2:]))
                    send_val, scale = (q.reshape(send_val.shape),
                                       scale.reshape(m, k))
                sent = (send_words, send_val) + (() if scale is None
                                                 else (scale,))
                got = transport.all_to_all(l, *sent)
                r_scale = got[2] if scale is not None else None
                # every received row is a bucket of this node's own
                # subrange, whose base is e[j], j = its position in the
                # stage group
                base = torch.gather(e, 1, transport.position(l).unsqueeze(1))
                r_idx = _wc.unpack_indices(got[0], base.expand(-1, k),
                                           st.bucket_capacity, widths[l])
                r_val = got[1]
        with obs.span("union.merge"):
            if merge in ("fused", "banded"):
                from repro_torch.kernels import ops as _kops
                chunk, movf = _kops.merge_sorted_runs(
                    r_idx, r_val, st.merged_capacity, mode=merge,
                    row_scale=r_scale,
                    out_dtype=compute_dtype if wire != "raw" else None)
                overflow = overflow + movf
            else:
                if r_scale is not None:
                    r_val = _wc.dequant8_rows(r_val, r_scale)
                cat = concat_sorted_groups(r_idx, r_val.to(compute_dtype))
                overflow = overflow + compact_overflow(cat,
                                                       st.merged_capacity)
                chunk = segment_compact(cat, st.merged_capacity, max_depth=k)

    # ---- up: allgather back through the same nodes (nested) ---------------
    for li in range(len(plan.stages) - 1, -1, -1):
        with obs.span("union.gather"):
            if wire == "raw":
                idx, val = transport.all_gather(li, chunk.idx, chunk.val)
                chunk = SparseChunk(idx=idx, val=val)
                continue
            # the sender's chunk covers its own subrange [e[j], e[j+1]);
            # after the gather, row t covers subrange t of the group-shared
            # edges
            k, e = plan.stages[li].degree, edges[li]
            m, cap = chunk.idx.shape[0], chunk.capacity
            base = torch.gather(e, 1,
                                transport.position(li).unsqueeze(1))[:, 0]
            send_words = _wc.pack_indices(chunk.idx, base, widths[li])
            if wire == "delta+int8ef":
                q, scale = _wc.quant8_rows(chunk.val)
                words, gq, gs = transport.all_gather(li, send_words, q,
                                                     scale.unsqueeze(1))
                val = _wc.dequant8_rows(
                    gq.reshape((m, k, cap) + gq.shape[2:]),
                    gs).reshape(gq.shape)
            else:
                send_val = chunk.val
                if wire == "delta+bf16":
                    send_val = send_val.to(torch.bfloat16)
                words, val = transport.all_gather(li, send_words, send_val)
            idx = _wc.unpack_indices(words.reshape(m, k, -1), e[:, :k], cap,
                                     widths[li]).reshape(m, k * cap)
            chunk = SparseChunk(idx=idx, val=val.to(compute_dtype))

    if chunk.capacity != plan.out_capacity:
        chunk = _trim_sorted(chunk, plan.out_capacity)
    return chunk, overflow


@obs.span("union.trim")
def _trim_sorted(chunk: SparseChunk, cap: int) -> SparseChunk:
    """Keep the first ``cap`` *valid* rows of concat-of-sorted-ranges
    chunks (valid rows compacted to the front, sentinel padding after)."""
    valid = chunk.valid_mask()
    pos = torch.cumsum(valid, -1) - 1
    dest = torch.where(valid & (pos < cap), pos, cap)
    lead = chunk.idx.shape[:-1]
    out_idx = torch.full(lead + (cap + 1,), SENTINEL, dtype=torch.int64,
                         device=chunk.idx.device).scatter_(-1, dest, chunk.idx)
    wshape = chunk.val.shape[chunk.idx.ndim:]
    out_val = torch.zeros(lead + (cap + 1,) + wshape, dtype=chunk.val.dtype,
                          device=chunk.val.device)
    _put_rows(out_val, dest, _mask_val(valid, chunk.val), add=False)
    return SparseChunk(idx=out_idx[..., :-1],
                       val=_drop_last_row(out_val, len(wshape) + 1))


def run_union_allreduce(plan: DevicePlan, idx: torch.Tensor, val: torch.Tensor,
                        merge: str = "sort", wire: str = "raw",
                        transport: Optional[StackedTransport] = None,
                        dead=None):
    """Run the union allreduce on stacked tensors on their device.

    idx: int64 [M, C] hashed *sorted* indices per physical node (SENTINEL
    padded); val: [M, C] or [M, C, W].  ``merge`` / ``wire``: see
    :func:`sparse_allreduce_union`.  ``transport`` defaults to a fresh
    :class:`StackedTransport` over ``plan.logical`` on ``idx``'s device.
    ``dead``: dead *physical* node ids of an r-way replicated plan
    (``make_device_plan(replication=r)``); their ``contribution_weights``
    are applied before the first layer, so each logical shard is summed
    from its first alive replica.  Raises ``DeadLogicalNode`` when a whole
    replica group is dead -- with ``replication=1``, for any dead node.
    Returns (idx [M, out_cap], val [M, out_cap(,W)], overflow [M]).
    """
    weight = None
    if plan.replication > 1 or dead:
        from .replication import contribution_weights
        obs.count_htod("union.htod_copies", idx.device)
        weight = torch.as_tensor(contribution_weights(
            plan.num_nodes, plan.replication, dead), device=idx.device)
    if idx.shape[0] != plan.num_nodes:
        raise ValueError(f"expected {plan.num_nodes} stacked chunks, got "
                         f"{idx.shape[0]}")
    if transport is None:
        transport = StackedTransport(plan.logical, idx.device)
    chunk, ovf = sparse_allreduce_union(
        SparseChunk(idx=idx, val=val), plan, plan.edges_tensors(idx.device),
        transport, merge=merge, wire=wire, weight=weight)
    return chunk.idx, chunk.val, ovf


# ---------------------------------------------------------------------------
# Dense baselines (paper §II) on stacked [M, n] tensors
# ---------------------------------------------------------------------------

def dense_allreduce_ring(x: torch.Tensor,
                         transport: StackedTransport) -> torch.Tensor:
    """The reference's stock ``lax.psum`` over the data axis: the
    transport's whole-mesh sum of the stacked ``[M, ...]`` tensor, every
    node receiving the total."""
    return transport.psum(x)


def dense_allreduce_hierarchical(x: torch.Tensor, plan: DevicePlan,
                                 transport: StackedTransport) -> torch.Tensor:
    """Heterogeneous-degree hierarchical dense allreduce of a stacked
    ``[M, n]`` tensor: a tiled reduce-scatter down the butterfly layers,
    then a tiled all-gather back up: the one bucket of
    :func:`dense_allreduce_hierarchical_bucketed`.  ``n`` must divide by
    the butterfly size; ``transport`` is bound to ``plan.logical``.  Costs
    ``2 * depth`` exchanges; every node's row holds the full sum."""
    return dense_allreduce_hierarchical_bucketed([x], plan, transport)[0]


def dense_allreduce_hierarchical_bucketed(
        xs: Sequence[torch.Tensor], plan: DevicePlan,
        transport: StackedTransport) -> List[torch.Tensor]:
    """The hierarchical dense allreduce of a list of stacked buckets
    ``[M, n_b]`` (each ``n_b`` divisible by the butterfly size), in
    stage-major issue order: every bucket's reduce-scatter at stage l
    comes before any bucket's at stage l + 1, then the all-gathers in
    reverse stage order, bucket by bucket.  Both collectives sum each
    element over its group members in member order, whichever bucket
    holds it, so every bucket's result is bit for bit that of reducing it
    alone.  ``2 * depth * len(xs)`` exchanges."""
    xs = list(xs)
    bad = [x.shape[1] for x in xs if x.shape[1] % plan.num_nodes]
    if bad:
        raise ValueError(f"length {bad[0]} is not divisible by the "
                         f"butterfly size {plan.num_nodes}")
    for l in range(len(plan.stages)):
        xs = [transport.reduce_scatter(l, x) for x in xs]
    for l in range(len(plan.stages) - 1, -1, -1):
        xs = [transport.all_gather(l, x)[0] for x in xs]
    return xs


def dense_allreduce_binary(x: torch.Tensor, axis_size: int,
                           transport: Optional[StackedTransport] = None
                           ) -> torch.Tensor:
    """Degree-2 butterfly (hypercube) allreduce of a stacked ``[M, n]``
    tensor: log2(M) reduce-scatter layers, then the all-gathers.
    ``transport`` (default: a fresh one on ``x``'s device) must be bound
    to ``ButterflyPlan(axis_size, (2,) * log2(axis_size))``."""
    depth = int(math.log2(axis_size))
    plan = ButterflyPlan(axis_size, (2,) * depth)
    if transport is None:
        transport = StackedTransport(plan, x.device)
    for l in range(depth):
        x = transport.reduce_scatter(l, x)
    for l in range(depth - 1, -1, -1):
        (x,) = transport.all_gather(l, x)
    return x
