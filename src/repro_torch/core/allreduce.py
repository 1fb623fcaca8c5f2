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
  (``merge="sort"``) or the fused rank-merge pipeline of
  ``repro_torch.kernels.ops.merge_sorted_runs`` (``merge="fused"``).

Static capacities make overflow a counted, returned quantity, as in the
reference.  Replication, the banded merge, wire codecs and the dense
baselines are later slices.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .sparse_vec import (SENTINEL, SparseChunk, _drop_last_row, _mask_val,
                         _put_rows, bucket_partition, compact_overflow,
                         concat_sorted_groups, segment_compact)
from .topology import ButterflyPlan
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

    def edges_arrays(self) -> List[np.ndarray]:
        """Per-stage [M, k_l + 1] int64 range edges, clipped to uint32 max
        as the reference's uint32 edges are."""
        return [np.minimum(self.logical.all_edges(l), (1 << 32) - 1)
                for l in range(len(self.stages))]

    def edges_tensors(self, device) -> List[torch.Tensor]:
        """:meth:`edges_arrays` as int64 tensors on ``device``."""
        return [torch.as_tensor(e, dtype=torch.int64, device=device)
                for e in self.edges_arrays()]


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


# Per-layer merge strategies of the reference; "banded" is not ported yet.
MERGE_MODES = ("sort", "fused", "banded")


def check_merge(merge: str) -> str:
    """Validate a merge-mode name for the port; returns it for chaining."""
    if merge not in MERGE_MODES:
        raise ValueError(f"merge must be one of {MERGE_MODES}, got {merge!r}")
    if merge == "banded":
        raise NotImplementedError(
            "merge='banded' is not ported yet (ROADMAP Queue 1 item 7)")
    return merge


def sparse_allreduce_union(chunk: SparseChunk, plan: DevicePlan,
                           edges: Sequence[torch.Tensor],
                           transport: StackedTransport,
                           merge: str = "sort"
                           ) -> Tuple[SparseChunk, torch.Tensor]:
    """Nested butterfly sparse allreduce; every node gets the full union sum.

    ``chunk``: the stacked nodes' sorted chunks, idx [M, C] (hashed int64),
    val [M, C] or [M, C, W].  ``edges``: per-stage [M, k_l + 1] range
    edges (:meth:`DevicePlan.edges_tensors`).  ``merge`` picks the
    per-layer merge of the k sorted runs arriving at each layer: ``"sort"``
    concatenates, stably re-sorts and segment-compacts; ``"fused"``
    rank-merges the runs and scatter-adds in one pass through the CUDA
    kernels (``repro_torch.kernels.ops.merge_sorted_runs``).  Both give
    the same indices and overflow, and the same values on dyadic inputs.
    One layer costs one transport exchange down and one up.
    Returns (union chunk of capacity ``out_capacity`` per node, overflow
    [M] -- entries dropped to capacity anywhere in the network).
    """
    check_merge(merge)
    overflow = torch.zeros(chunk.idx.shape[0], dtype=torch.int64,
                           device=chunk.idx.device)

    # ---- down: scatter-reduce through the layers --------------------------
    for l, st in enumerate(plan.stages):
        buckets, ovf = bucket_partition(chunk, edges[l], st.degree,
                                        st.bucket_capacity)
        overflow = overflow + ovf
        r_idx, r_val = transport.all_to_all(l, buckets.idx, buckets.val)
        if merge == "fused":
            from repro_torch.kernels import ops as _kops
            chunk, movf = _kops.merge_sorted_runs(r_idx, r_val,
                                                  st.merged_capacity)
            overflow = overflow + movf
        else:
            cat = concat_sorted_groups(r_idx, r_val)
            overflow = overflow + compact_overflow(cat, st.merged_capacity)
            chunk = segment_compact(cat, st.merged_capacity)

    # ---- up: allgather back through the same nodes (nested) ---------------
    for li in range(len(plan.stages) - 1, -1, -1):
        idx, val = transport.all_gather(li, chunk.idx, chunk.val)
        chunk = SparseChunk(idx=idx, val=val)  # concat of sorted disjoint ranges

    if chunk.capacity != plan.out_capacity:
        chunk = _trim_sorted(chunk, plan.out_capacity)
    return chunk, overflow


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
                        merge: str = "sort",
                        transport: Optional[StackedTransport] = None):
    """Run the union allreduce on stacked tensors on their device.

    idx: int64 [M, C] hashed *sorted* indices per node (SENTINEL padded);
    val: [M, C] or [M, C, W].  ``transport`` defaults to a fresh
    :class:`StackedTransport` over ``plan.logical`` on ``idx``'s device.
    Returns (idx [M, out_cap], val [M, out_cap(,W)], overflow [M]).
    """
    if plan.replication != 1:
        raise NotImplementedError(
            "replicated union plans are not ported yet (ROADMAP Queue 1 "
            "item 8)")
    if idx.shape[0] != plan.num_nodes:
        raise ValueError(f"expected {plan.num_nodes} stacked chunks, got "
                         f"{idx.shape[0]}")
    if transport is None:
        transport = StackedTransport(plan.logical, idx.device)
    chunk, ovf = sparse_allreduce_union(
        SparseChunk(idx=idx, val=val), plan, plan.edges_tensors(idx.device),
        transport, merge=merge)
    return chunk.idx, chunk.val, ovf
