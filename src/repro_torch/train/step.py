"""Train step and gradient sync over the stacked data mesh (reference: ``repro.train.step``).

The reference runs one program per device under ``shard_map``: each data
shard differentiates its rows' loss, then the gradients are synced over
the data axes in one of three modes --

* ``ring``   -- the whole-mesh sum (``lax.psum``);
* ``hier``   -- the paper's heterogeneous-degree nested butterfly, dense:
  a tiled reduce-scatter down the degree sequence, the all-gather back up
  (``core.allreduce.dense_allreduce_hierarchical``);
* ``sparse`` -- the paper's Sparse Allreduce for the input-embedding
  gradient, whose rows are those the batch touched (§I-A.1), and
  ``hier`` for every other leaf.  Tied embeddings make that gradient
  dense in the vocabulary, so the sparse leaf exists only untied; a tied
  model syncs it with ``hier``.

The port keeps M data positions stacked on one device
(:class:`MeshCtx`): parameters and AdamW state are held once, the batch
is split into M row blocks as the reference shards rows, and each
block's loss is differentiated with ``torch.autograd.grad`` into stacked
``[M, ...]`` gradients -- in one batched program: every position runs on
its own broadcast view of the parameters (``expand``, no copy), so the
gradient of the summed block losses with respect to those views is each
block's own gradient.  The sync runs over the stacked transport
(``core.transport.StackedTransport``) through the port's union Sparse
Allreduce and its CUDA merge kernels.  Every synced gradient's M rows
are equal by construction; AdamW applies once, to row 0.

A model axis (``mesh_ctx(data, model=tp)``, tp > 1): the parameters
are the global leaves at that tp, and each data row's forward runs its
tp model positions as ``models.transformer`` describes -- replicated
work once, sharded products over the positions -- so each data row's
loss is counted once and every held leaf gets the true gradient of its
rows, ``[M, *global]``, the shape the tp = 1 sync takes.  ``ring`` and
``hier`` sum those elementwise over the data axis, which gives the bits
of a per-shard sync.  The sparse sync runs one union Sparse Allreduce
per vocab shard of V / tp rows (the reference's ``v_start``), all tp of
them as one stacked reduce over the dp * tp positions with column-wise
groups (``StackedTransport(columns=tp)``), so each merge kernel
launches once a layer for every column.

FSDP (``cfg.fsdp``): the FSDP block leaves are differentiated with
respect to the held-once leaf through each period's gather
(``models.sharding.FsdpGather``), whose backward reduce-scatters the M
positions' gradients of that period over the data axis while the
backward runs, as the reference's all_gather transpose does; the sync
then only divides such a leaf by dp, and the M stacked copies of a
period's block gradients never outlive its backward.  The other leaves
keep the stacked path.  Batches of a VLM (``img_embeds``) and of an
encoder-decoder (``enc_frames``) are split over the positions and the
microbatches as the tokens are.

A ``pod`` axis (``mesh_ctx(data, model, pod=p)``): a second data axis
outside ``data``, the data positions being the p * data of both, in
row-major order (the device order of ``jax.make_mesh((pod, data,
model), ("pod", "data", "model"))``).  The butterfly plans bind the pod
stage first, as the reference's do (the slowest link gets the outermost
layer), with each axis's degrees concatenated into one logical plan, so
the hier and sparse syncs on a pod mesh are those of the flat mesh with
the degrees concatenated; the ring sums over ``pod`` and then over
``data``, as the reference's ``psum`` per axis.

``sync_overlap="bucketed"`` (the reference's overlapped sync schedule):
the dense butterfly's leaves are concatenated into byte-bounded buckets
(:func:`plan_grad_buckets`) whose exchanges are issued stage-major
(``core.allreduce.dense_allreduce_hierarchical_bucketed``).  Each
element is summed over the same members in the same order as by its
leaf's own butterfly, so the synced gradients are those of ``"off"`` bit
for bit, on any floats.  The sync runs after the backward on one stream,
so here the schedule only reorders the exchanges and groups small
leaves.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.core.allreduce import (
    MERGE_MODES, DevicePlan, dense_allreduce_hierarchical_bucketed,
    make_device_plan, sparse_allreduce_union)
from repro_torch.core.sparse_vec import SENTINEL, HashPerm, SparseChunk
from repro_torch.core.topology import ButterflyPlan, check_wire
from repro_torch.core.transport import (ModelAxis, StackedTransport,
                                        resolve_device)
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig
from repro_torch.models.sharding import (check_ported, fsdp_block_paths,
                                         full_model_spec_tuples, is_fsdp_leaf)
from repro_torch.optim.adamw import AdamW

SYNC_PERM = HashPerm.make(1234)

SYNC_OVERLAP_MODES = ("off", "bucketed")
SYNC_MODES = ("ring", "hier", "sparse")


# ---------------------------------------------------------------------------
# Mesh bookkeeping
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshCtx:
    """A ``data`` axis of ``data`` stacked positions, an optional ``pod``
    axis of ``pod`` outside it, and a ``model`` axis of ``model``
    positions within each data row, on ``device``; mesh position (p *
    data + d) * model + m is pod p's data row d's model position m, and
    data row p * data + d of the M = pod * data rows.  ``model_axis`` is
    the model axis's transport (its counts read what the forwards
    exchanged)."""
    data: int
    device: torch.device
    tp_axis: str = "model"
    model: int = 1
    model_axis: Optional[ModelAxis] = dataclasses.field(default=None,
                                                        compare=False)
    pod: int = 1

    @property
    def tp(self) -> int:
        """Tensor-parallel size."""
        return self.model

    @property
    def dp(self) -> int:
        """Data-parallel size M: pod * data."""
        return self.pod * self.data

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        """The data axes, the outermost first: ``("pod", "data")`` on a
        pod mesh, else ``("data",)``."""
        return ("pod", "data") if self.pod > 1 else ("data",)

    @property
    def dp_sizes(self) -> List[Tuple[str, int]]:
        """``[(axis, size)]`` of the data axes, the outermost (``pod``)
        first."""
        return [(a, self.pod if a == "pod" else self.data)
                for a in self.dp_axes]

    @property
    def shape(self) -> Dict[str, int]:
        """Axis sizes, as a mesh's ``shape`` (``pod`` only on a pod
        mesh)."""
        return dict(self.dp_sizes, model=self.model)

    def axis_ctx(self, cfg: ModelConfig) -> T.AxisCtx:
        """The models' axis context: tp and the model axis; with
        ``cfg.fsdp``, the FSDP axes and the gather's transport, one stage
        of degree M over the data positions."""
        ax = T.AxisCtx(tp_axis=self.tp_axis, tp=self.tp,
                       dp_axes=self.dp_axes, model=self.model_axis)
        if not cfg.fsdp:
            return ax
        return dataclasses.replace(
            ax, fsdp_axes=self.dp_axes, fsdp_transport=StackedTransport(
                ButterflyPlan(self.dp, (self.dp,)), self.device))


def mesh_ctx(data: int, model: int = 1, pod: int = 1,
             device=None) -> MeshCtx:
    """The port's mesh: ``pod`` x ``data`` stacked data positions, each
    with ``model`` model positions, on ``device`` (default: the current
    CUDA device).  ``pod`` > 1 adds the ``pod`` data axis outside
    ``data`` (``dp_axes = ("pod", "data")``)."""
    if data < 1 or model < 1 or pod < 1:
        raise ValueError(f"pod, data and model axes must be >= 1, got "
                         f"{pod}, {data}, {model}")
    return MeshCtx(data=int(data), device=resolve_device(device),
                   model=int(model), pod=int(pod),
                   model_axis=ModelAxis(model) if model > 1 else None)


def tuned_dp_degrees(mc: MeshCtx, in_capacity: int, out_capacity: int,
                     retune: bool = False) -> Dict[str, Tuple[int, ...]]:
    """``dp_degrees="auto"``: each data axis's degrees from the port's
    cached autotuner (``core.autotune.resolve_degrees``, ``mesh_sig`` the
    axis and its size), under the stored calibration of this backend and
    the mesh's M positions.  With none stored, the stacked transport is
    calibrated once (``calibrate_fabric(store=True)``).  The reference
    falls back to nominal TPU rates per axis (``TPU_DCN`` for ``pod``,
    ``TPU_ICI`` for the others); those are a TPU's links and say nothing
    about this device, whose every axis is the same stacked transport."""
    from repro_torch.core import autotune
    if mc.dp == 1:
        return {a: () for a in mc.dp_axes}
    backend = autotune.backend_name(mc.device)
    fabric = autotune.calibrated_fabric(backend=backend, num_devices=mc.dp)
    if fabric is None:
        fabric = autotune.calibrate_fabric(mc.dp, device=mc.device,
                                           store=True)
    degrees = {}
    for a, size in mc.dp_sizes:
        degs, _src = autotune.resolve_degrees(
            size, n0=max(in_capacity, 1),
            total_range=max(out_capacity, 2) * 4, fabric=fabric,
            serial_nic=False, mesh_sig=((a, size),), retune=retune)
        degrees[a] = tuple(degs)
    return degrees


def _dp_plan(mc: MeshCtx, degrees, in_capacity: int,
             out_capacity: int) -> DevicePlan:
    """``make_device_plan`` over the data axes, the pod stage first;
    ``degrees`` a dict with at most one entry per data axis, or ``None``
    (one round-robin stage per axis)."""
    axes = mc.dp_sizes
    if degrees is None:
        degrees = {a: (size,) for a, size in axes}
    unknown = sorted(set(degrees) - set(mc.dp_axes))
    if unknown:
        raise ValueError(f"dp_degrees names {unknown}, not data axes of "
                         f"this mesh {list(mc.dp_axes)}")
    return make_device_plan(axes, degrees, in_capacity=in_capacity,
                            out_capacity=out_capacity)


def default_dp_plan(mc: MeshCtx, in_capacity: int, out_capacity: int,
                    degrees=None, retune: bool = False) -> DevicePlan:
    """Butterfly plan over the data axes, the pod stage first (the
    slowest link gets the outermost layer): ``degrees`` a dict of each
    axis's degrees, ``"auto"`` (:func:`tuned_dp_degrees`) or ``None`` (one
    round-robin stage per axis)."""
    if degrees == "auto":
        degrees = tuned_dp_degrees(mc, in_capacity, out_capacity,
                                   retune=retune)
    return _dp_plan(mc, degrees, in_capacity, out_capacity)


# ---------------------------------------------------------------------------
# Gradient sync on stacked [M, ...] gradients
# ---------------------------------------------------------------------------

# float32 elements of one block of a leaf's dense sync (all M rows)
HIER_BLOCK = 1 << 27


def _hier_allreduce_leaf(g: torch.Tensor, plan: DevicePlan,
                         transport: StackedTransport,
                         capture: Optional[dict] = None,
                         row: Optional[int] = None) -> torch.Tensor:
    """One stacked leaf [M, ...] through the dense butterfly: the leaf
    alone in :func:`_bucketed_hier_leaves` (one bucket, in column blocks
    of at most ``HIER_BLOCK`` float32 elements when it is larger), so a
    multi-GB leaf needs no float32 copy of itself.  ``capture`` receives
    its float32 row 0 under ``"f32"``; with ``row`` only that row of the
    result is kept."""
    return _bucketed_hier_leaves([g], plan, transport, DEFAULT_BUCKET_BYTES,
                                 captures=[capture], row=row)[0]


# The bucket budget of the bucketed sync schedule (the reference's): 4 MB
# sits just above the paper's 2-4 MB packet floor
DEFAULT_BUCKET_BYTES = 4 << 20


def plan_grad_buckets(sizes: Sequence[int], bucket_bytes: int,
                      bytes_per_elem: int = 4) -> List[List[int]]:
    """Greedy contiguous partition of leaf indices into byte-bounded
    buckets (the reference's, unchanged).

    ``sizes``: element count per gradient leaf, in sync order.  The
    buckets' concatenation is exactly ``range(len(sizes))``, every leaf in
    one bucket, and each bucket holds at most ``bucket_bytes`` unless it
    is a single leaf larger than the budget (which gets a bucket of its
    own rather than being split)."""
    if bucket_bytes <= 0:
        raise ValueError(f"bucket_bytes must be positive, got {bucket_bytes}")
    if bytes_per_elem <= 0:
        raise ValueError(
            f"bytes_per_elem must be positive, got {bytes_per_elem}")
    buckets: List[List[int]] = []
    cur: List[int] = []
    cur_bytes = 0
    for i, n in enumerate(sizes):
        if n < 0:
            raise ValueError(f"leaf size must be >= 0, got sizes[{i}]={n}")
        nb = int(n) * bytes_per_elem
        if cur and cur_bytes + nb > bucket_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nb
    if cur:
        buckets.append(cur)
    return buckets


def _bucketed_hier_leaves(gs: List[torch.Tensor], plan: DevicePlan,
                          transport: StackedTransport, bucket_bytes: int,
                          captures: Optional[List[Optional[dict]]] = None,
                          row: Optional[int] = None) -> List[torch.Tensor]:
    """The dense butterfly of stacked leaves ``gs`` ([M, ...] each) in the
    bucketed stage-major schedule; returns each leaf's reduced stacked
    value in its dtype, in order.

    Each leaf is cast to float32 and padded to a multiple of M;
    :func:`plan_grad_buckets` groups the padded flats (one position's
    float32 bytes, as the reference counts one device's), and a bucket is
    their concatenation ``[M, sum n_i]``.  Buckets go through
    ``core.allreduce.dense_allreduce_hierarchical_bucketed`` in windows of
    at most ``HIER_BLOCK`` float32 elements: the buckets of a window are
    built, reduced stage-major together and written back before the next
    window's are built, and a bucket above ``HIER_BLOCK`` (one oversized
    leaf) is cut into column blocks of at most ``HIER_BLOCK`` elements,
    each a window of its own.  Every element is summed over the same
    members in the same order whatever bucket, window or block holds it,
    so the result is that of each leaf alone (``"off"``,
    :func:`_hier_allreduce_leaf`) bit for bit.  The leaves of ``gs`` are
    dropped from the list as their windows are built, and each result is
    allocated at its leaf's first write-back.  With ``row`` only that row
    of each result is kept and returned (the rows are equal).
    ``captures[i]``, when a dict, receives leaf i's float32 row 0 under
    ``"f32"``."""
    m = plan.num_nodes
    shapes = [g.shape for g in gs]
    n = [int(np.prod(sh[1:], dtype=np.int64)) for sh in shapes]
    padded = [x + (-x) % m for x in n]
    buckets = plan_grad_buckets(padded, bucket_bytes)
    captured = {i for i, c in enumerate(captures or ()) if c is not None}
    # units, each [(leaf, lo, hi)] column slices of padded flats: one per
    # bucket, or one per column block of an oversized leaf (lo < n always:
    # blocks start at multiples of M)
    cols = max(m, HIER_BLOCK // m // m * m)
    units = []
    for b in buckets:
        width = sum(padded[i] for i in b)
        if m * width <= HIER_BLOCK or len(b) > 1:
            units.append([(i, 0, padded[i]) for i in b])
        else:
            (i,) = b
            units.extend([(i, lo, min(lo + cols, padded[i]))]
                         for lo in range(0, padded[i], cols))
    keep = slice(None) if row is None else slice(row, row + 1)
    # each result (and captured row) is allocated at its leaf's first
    # write-back, as the leaves before it are freed
    dtypes, device = [g.dtype for g in gs], gs[0].device
    results: List[Optional[torch.Tensor]] = [None] * len(gs)
    rows0: Dict[int, torch.Tensor] = {}
    u = 0
    while u < len(units):
        window, elems = [], 0
        while u < len(units):
            w = sum(hi - lo for _, lo, hi in units[u])
            if window and elems + m * w > HIER_BLOCK:
                break
            window.append(units[u])
            elems += m * w
            u += 1
        def bucket(unit):
            parts = []
            for i, lo, hi in unit:
                x = gs[i].reshape(m, -1)[:, lo:min(hi, n[i])].to(
                    torch.float32)
                if hi > n[i]:
                    x = F.pad(x, (0, hi - n[i]))
                parts.append(x)
                if hi == padded[i]:   # a leaf is dropped once fully read
                    gs[i] = None
            return parts[0] if len(parts) == 1 else torch.cat(parts, 1)
        # the window's buffers are held by the reduce alone, which drops
        # them after the first stage
        reduced = dense_allreduce_hierarchical_bucketed(
            [bucket(unit) for unit in window], plan, transport)
        for unit, r in zip(window, reduced):
            off = 0
            for i, lo, hi in unit:
                real = min(hi, n[i]) - lo
                if results[i] is None:
                    results[i] = torch.empty(
                        (m if row is None else 1, n[i]), dtype=dtypes[i],
                        device=device)
                    if i in captured:
                        rows0[i] = torch.empty(n[i], dtype=torch.float32,
                                               device=device)
                results[i][:, lo:lo + real] = r[keep, off:off + real]
                if i in rows0:
                    rows0[i][lo:lo + real] = r[0, off:off + real]
                off += hi - lo
        del reduced
    for i, r0 in rows0.items():
        captures[i]["f32"] = r0.reshape(shapes[i][1:])
    return [r.reshape(sh if row is None else sh[1:])
            for r, sh in zip(results, shapes)]


def _as_int32(x: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 read as int32 (the reference's
    ``astype(jnp.int32)``)."""
    return torch.where(x >= 2**31, x - 2**32, x)


def sparse_sync_rows(grad: torch.Tensor, ids: torch.Tensor, mc: MeshCtx,
                     dplan: DevicePlan, edges: Sequence[torch.Tensor],
                     transport: StackedTransport,
                     merge: str = "sort", wire: str = "raw",
                     ef: Optional[torch.Tensor] = None,
                     capture: Optional[dict] = None,
                     row: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor,
                                Optional[torch.Tensor]]:
    """Sparse Allreduce of a row-sparse gradient table over the data axis,
    one union reduce per vocab shard.

    grad: [M, V, d] each data position's gradient; ids: [M, N] the token
    ids of each data position's rows.  The table splits into tp =
    ``mc.tp`` vocab shards of V / tp rows, mesh position n = i * tp + j
    holding data row i's shard j (at tp = 1, the whole table).  Each
    position hashes the ids of its shard (``SYNC_PERM`` of the global id,
    ``v_start = j * V / tp``), sorts them into ``in_capacity`` slots,
    gathers those rows and runs the union butterfly over the data axis
    within its column (``transport`` stacks the dp * tp positions,
    ``edges`` [dp * tp, k + 1] per stage); the union's rows are written
    back into a ``[V / tp + 1, d]`` buffer whose last row takes the
    padding.  Returns (synced [M, V, d] in grad's dtype, overflow [M *
    tp] per mesh position, new carry); with ``row`` only that data row's
    shards are written back (the union is the same at every data row),
    synced [V, d].

    ``ef`` [M, V, d] float32: the ``wire="delta+int8ef"`` error-feedback
    carry, added to the rows sent; the residual of one per-row int8
    quantization of the sent rows is stored back into the carry (the
    reference's bounded proxy for the per-stage re-quantization).
    ``capture``, when given, receives the float32 synced data row 0 under
    ``"f32"`` and the union's hashed indices [M * tp, out] under
    ``"idx"`` (test hooks).
    """
    from repro_torch.kernels.wirecodec import dequant8_rows, quant8_rows
    dp, vp, d = grad.shape
    tp = mc.tp
    v_l = vp // tp
    m = dp * tp
    grad = grad.reshape(m, v_l, d)
    dev = grad.device
    ids = ids.reshape(dp, -1).to(torch.int64).repeat_interleave(tp, 0)
    v_start = (torch.arange(m, device=dev) % tp)[:, None] * v_l
    loc = ids - v_start
    mine = (loc >= 0) & (loc < v_l)
    hashed = torch.where(mine, SYNC_PERM.fwd(ids),
                         torch.full_like(ids, SENTINEL))
    hsorted = torch.sort(hashed, dim=-1).values
    cap_in = dplan.in_capacity
    valid = hsorted != SENTINEL
    is_head = torch.cat([torch.ones((m, 1), dtype=torch.bool, device=dev),
                         hsorted[:, 1:] != hsorted[:, :-1]], 1) & valid
    pos = torch.cumsum(is_head.to(torch.int64), -1) - 1
    slot = torch.where(is_head & (pos < cap_in), pos, cap_in)
    uniq = torch.full((m, cap_in + 1), SENTINEL, dtype=torch.int64,
                      device=dev).scatter_(1, slot, hsorted)[:, :cap_in]
    okr = uniq != SENTINEL
    safe_rows = torch.clamp(_as_int32(SYNC_PERM.inv(uniq)) - v_start, 0,
                            v_l - 1)
    node = torch.arange(m, device=dev)[:, None]
    keep = okr[..., None].to(torch.float32)
    vals = grad[node, safe_rows].to(torch.float32) * keep
    new_ef = None
    if ef is not None:
        ef = ef.reshape(m, v_l, d)
        vals = vals + ef[node, safe_rows].to(torch.float32) * keep
        q, s = quant8_rows(vals.reshape(m * cap_in, d))
        resid = (vals - dequant8_rows(q, s).reshape(m, cap_in, d)) * keep
        ef_dest = torch.where(okr, safe_rows, v_l)
        new_ef = torch.cat([ef.to(torch.float32),
                            torch.zeros((m, 1, d), dtype=torch.float32,
                                        device=dev)], 1)
        new_ef[node, ef_dest] = resid
        new_ef = new_ef[:, :v_l].reshape(dp, vp, d)
    chunk, ovf = sparse_allreduce_union(
        SparseChunk(idx=uniq, val=vals), dplan, edges, transport,
        merge=merge, wire=wire)
    if capture is not None:
        capture["idx"] = chunk.idx.clone()
    pick = slice(None) if row is None else slice(row * tp, (row + 1) * tp)
    idx, val = chunk.idx[pick], chunk.val[pick]
    del chunk
    ok = idx != SENTINEL
    dest = torch.where(ok, _as_int32(SYNC_PERM.inv(idx)) - v_start[pick], v_l)
    vals = val * ok[..., None].to(val.dtype)
    rows_n = idx.shape[0]
    synced = torch.zeros((rows_n, v_l + 1, d), dtype=torch.float32,
                         device=dev)
    synced[torch.arange(rows_n, device=dev)[:, None], dest] = vals
    synced = synced[:, :v_l].reshape(-1, vp, d)
    if row is not None:
        synced = synced[0]
    if capture is not None:
        capture["f32"] = (synced if row is not None else synced[0]).clone()
    return synced.to(grad.dtype), ovf, new_ef


@dataclasses.dataclass
class SyncPlans:
    """The sync's plans, the sparse plan's edges, and one stacked
    transport per plan (the whole-mesh sum runs on ``psum``'s)."""
    hier_plan: Optional[DevicePlan]
    sparse_plan: Optional[DevicePlan]
    sparse_edges: Optional[List[torch.Tensor]]
    hier: Optional[StackedTransport]
    sparse: Optional[StackedTransport]
    psum: StackedTransport


def sync_grads(grads, cfg: ModelConfig, mc: MeshCtx, mode: str,
               plans: SyncPlans, token_ids: Optional[torch.Tensor],
               merge: str = "sort", wire: str = "raw",
               ef: Optional[torch.Tensor] = None,
               repl_weight: Optional[torch.Tensor] = None,
               dp_logical: Optional[int] = None,
               rows: Optional[int] = None, consume: bool = False,
               capture: Optional[dict] = None, overlap: str = "off",
               bucket_bytes: int = DEFAULT_BUCKET_BYTES):
    """Combine stacked per-position gradients [M, ...] into the gradient
    of the global mean loss: ``(synced, overflow [M * tp], new carry)``
    (at tp > 1 each leaf is the data row's global-shape gradient).

    Leaves go in sorted-path order.  ``repl_weight`` [M] (r-way replicated
    data parallelism, paper §V): each position's ``contribution_weights``
    entry multiplies its gradients before the sum, so each logical shard
    counts once, from its first alive replica, and the mean divides by
    ``dp_logical`` (= M / r).  ``rows=0`` keeps only row 0 of each synced
    leaf (the rows are equal); ``consume=True`` drops each input leaf from
    ``grads`` once synced, so the stacked gradients are freed leaf by
    leaf.  ``capture`` receives the float32 sync of the embedding leaf
    (``capture["emb"]``, a test hook).  An FSDP leaf arrives held once,
    already summed over the positions by its gather's backward, and its
    synced gradient is ``g / dp`` with no exchange (the replication
    weights never apply: FSDP with replication > 1 raises).  The ring
    sums over each data axis in turn (``pod`` first).
    ``overlap="bucketed"`` defers the dense butterfly's leaves to one
    bucketed pass (:func:`_bucketed_hier_leaves`, ``bucket_bytes`` a
    bucket) after the others; the sparse, FSDP and ring leaves are not
    bucketed, and every result is that of ``"off"`` bit for bit.  The
    embedding's :func:`sparse_sync_rows` is the span ``train.sync.sparse``
    (:mod:`repro_torch.obs`)."""
    if overlap not in SYNC_OVERLAP_MODES:
        raise ValueError(
            f"overlap must be one of {SYNC_OVERLAP_MODES}, got {overlap!r}")
    spec = dict(T.tree_leaves(full_model_spec_tuples(cfg, mc.tp)))
    dp = float(dp_logical if dp_logical is not None else mc.dp)
    overflow = torch.zeros(mc.dp * mc.tp, dtype=torch.int64,
                           device=mc.device)
    new_ef = ef
    out = []
    deferred = []          # (weighted grad, capture) of the bucketed leaves
    ring_axes = tuple(size for _, size in mc.dp_sizes)
    for path in [p for p, _ in T.tree_leaves(grads)]:
        parent = grads
        for k in path[:-1]:
            parent = parent[k]
        g = parent[path[-1]]
        if consume:
            del parent[path[-1]]
        if cfg.fsdp and is_fsdp_leaf(spec[path]):
            out.append((path, g / dp))
            del g
            continue
        if repl_weight is not None:
            g = g * repl_weight.to(g.dtype).reshape((-1,) + (1,) * (g.ndim - 1))
        cap = {} if capture is not None and path == ("emb",) else None
        picked = False                  # r is row ``rows`` already
        if mode == "sparse" and path == ("emb",) and not cfg.tie_embeddings:
            with obs.span("train.sync.sparse"):
                r, ovf, nef = sparse_sync_rows(
                    g, token_ids, mc, plans.sparse_plan, plans.sparse_edges,
                    plans.sparse, merge=merge, wire=wire, ef=ef, capture=cap,
                    row=rows)
            overflow = overflow + ovf
            if nef is not None:
                new_ef = nef
            picked = rows is not None
        elif mode in ("hier", "sparse") and plans.hier_plan is not None \
                and g[0].numel() >= mc.dp:
            if overlap == "bucketed":
                deferred.append((g, cap))
                out.append((path, None))
                del g
                continue
            r = _hier_allreduce_leaf(g, plans.hier_plan, plans.hier,
                                     capture=cap, row=rows)
            picked = rows is not None
        else:
            r = plans.psum.psum(g, axes=ring_axes)
        del g
        if rows is not None and not picked:
            r = r[rows]
        r = r / dp
        if cap is not None:
            capture["emb"] = cap
        out.append((path, r))
        del r
    if deferred:
        gs = [g for g, _ in deferred]
        caps = [cap for _, cap in deferred]
        del deferred[:]
        reduced = _bucketed_hier_leaves(gs, plans.hier_plan, plans.hier,
                                        bucket_bytes, captures=caps,
                                        row=rows)
        reduced.reverse()                # each row dropped once divided
        for j, cap in zip([j for j, (_, v) in enumerate(out) if v is None],
                          caps):
            out[j] = (out[j][0], reduced.pop() / dp)
            if cap is not None:
                capture["emb"] = cap
        del gs
    return T.tree_from_leaves(
        full_model_spec_tuples(cfg, mc.tp), out), overflow, new_ef


def _sharded_grad_norm(grads) -> torch.Tensor:
    """Global grad norm of one copy of the synced gradients, leaf by leaf
    in sorted-path order.  The leaves are held whole, at any tp, so every
    element is counted once: the reference's ``psum`` of a model-sharded
    leaf's squares over the model axis is implicit."""
    total = None
    for _, g in T.tree_leaves(grads):
        sq = torch.sum(torch.square(g.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _build_sync_plans(cfg: ModelConfig, mc: MeshCtx, sync: str, dp_degrees,
                      sparse_tokens_hint: Optional[int],
                      retune: bool) -> SyncPlans:
    """The plan set of one (cfg, mesh, sync) combination, shared by
    :func:`make_train_step` and :func:`make_sync_fn`: the hier plan
    (capacities unused), and for ``sparse`` a union plan over the data
    axes sized to the batch's sparsity -- in = min(tokens a position, V /
    tp) and out = min(V / tp, in * M), each rounded up to 8 -- whose
    transport and edges repeat it in every model column.  Both plans bind
    the data axes pod first."""
    sparse_plan = sparse_edges = hier_plan = None
    hier_t = sparse_t = None
    if sync in ("hier", "sparse"):
        hier_plan = default_dp_plan(mc, 8, 8, dp_degrees, retune=retune)
        hier_t = StackedTransport(hier_plan.logical, mc.device)
    if sync == "sparse":
        v_l = T.padded_vocab(cfg, mc.tp) // mc.tp
        cin = int(min(v_l, sparse_tokens_hint or (1 << 16)))
        cin = (cin + 7) // 8 * 8
        cout = (min(v_l, cin * mc.dp) + 7) // 8 * 8
        sp_degrees = dp_degrees
        if dp_degrees == "auto":
            sp_degrees = tuned_dp_degrees(mc, cin, cout, retune=retune)
        sparse_plan = _dp_plan(mc, sp_degrees or None, cin, cout)
        sparse_edges = [e.repeat_interleave(mc.tp, 0) for e
                        in sparse_plan.edges_tensors(mc.device)]
        sparse_t = StackedTransport(sparse_plan.logical, mc.device,
                                    columns=mc.tp)
    psum_t = hier_t if hier_t is not None else StackedTransport(
        ButterflyPlan(mc.dp, (mc.dp,) if mc.dp > 1 else ()), mc.device)
    return SyncPlans(hier_plan, sparse_plan, sparse_edges, hier_t, sparse_t,
                     psum_t)


def _check_sync_settings(sync: str, sync_merge: str, sync_wire: str,
                         sync_overlap: str) -> None:
    """Shared validation of make_train_step / make_sync_fn."""
    if sync not in SYNC_MODES:
        raise ValueError(f"sync must be one of {SYNC_MODES}, got {sync!r}")
    if sync_merge not in MERGE_MODES:
        raise ValueError(
            f"sync_merge must be one of {MERGE_MODES}, got {sync_merge!r}")
    check_wire(sync_wire)
    if sync_wire != "raw" and sync != "sparse":
        raise ValueError(
            f"sync_wire={sync_wire!r} only applies to the sparse sync path "
            f"(got sync={sync!r}); ring/hier sync is dense and unencoded")
    if sync_overlap not in SYNC_OVERLAP_MODES:
        raise ValueError(f"sync_overlap must be one of {SYNC_OVERLAP_MODES}, "
                         f"got {sync_overlap!r}")
    if sync_overlap == "bucketed" and sync not in ("hier", "sparse"):
        raise ValueError(
            f"sync_overlap='bucketed' requires sync in ('hier', 'sparse') "
            f"(got sync={sync!r}): ring sync is a single psum per leaf with "
            f"no butterfly stages to interleave")


def _replication(cfg: ModelConfig, mc: MeshCtx, replication: int, dead):
    """``(weights tensor or None, dp_logical)``; raises
    ``DeadLogicalNode`` when a whole replica group is dead, and
    ``ValueError`` for FSDP with replication > 1, as the reference."""
    if replication > 1 or dead:
        from repro_torch.core.replication import contribution_weights
        if cfg.fsdp and replication > 1:
            raise ValueError(
                "replication>1 is unsupported with fsdp: the per-period "
                "all_gather transpose sums FSDP leaf grads over data before "
                "contribution weights could mask replicas")
        if mc.dp % replication:
            raise ValueError(f"dp={mc.dp} not divisible by r={replication}")
        w = contribution_weights(mc.dp, replication, dead)
        return (torch.as_tensor(np.asarray(w, np.float32), device=mc.device),
                mc.dp // replication)
    return None, mc.dp


def _stack_tokens(x, mc: MeshCtx, dtype=torch.int64) -> torch.Tensor:
    """A [B, S, ...] batch as [M, B / M, S, ...] on the mesh's device, in
    ``dtype`` (``None``: its own)."""
    t = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) \
        else x
    t = t.to(device=mc.device, dtype=dtype or t.dtype)
    if t.shape[0] % mc.dp:
        raise ValueError(f"batch of {t.shape[0]} rows does not split over "
                         f"{mc.dp} data positions")
    return t.reshape((mc.dp, t.shape[0] // mc.dp) + tuple(t.shape[1:]))


def make_sync_fn(cfg: ModelConfig, mc: MeshCtx, *, sync: str = "hier",
                 dp_degrees=None, sync_merge: str = "sort",
                 sync_wire: str = "raw", replication: int = 1,
                 dead: Optional[set] = None, sync_overlap: str = "off",
                 sync_bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                 sparse_tokens_hint: Optional[int] = None,
                 retune: bool = False, salt_shards: bool = True):
    """The sync stage of :func:`make_train_step` alone, the bit-exactness
    harness: ``(fn, spec)`` with ``fn(grads, token_ids, capture=None) ->
    (synced, overflow)`` (``capture`` as :func:`sync_grads`'s).  ``grads``
    is one parameter-shaped gradient tree (every data position holds it,
    as the reference's replicated layout does); ``token_ids`` the [B, S]
    batch the sparse leaf's union is built from.
    ``synced`` holds each leaf stacked [M, ...] (all rows equal) and
    ``overflow`` is [M].  With ``salt_shards`` each *logical* shard's
    copy is scaled by 2^-((n mod dp_logical) mod 4) first, so routing
    faults cannot cancel and replicas stay identical.  An FSDP leaf is
    only divided by dp, each position's salted copy on its own, as in the
    reference's harness (there its gather's transpose sums it).  Error
    feedback is not threaded (``delta+int8ef`` syncs with no carry).  At
    tp > 1 ``grads`` is the global tree at that tp; the salt is the data
    position's, and ``overflow`` is [M * tp], per mesh position.
    ``sync_overlap`` / ``sync_bucket_bytes``: as :func:`sync_grads`'s
    ``overlap`` / ``bucket_bytes``."""
    _check_sync_settings(sync, sync_merge, sync_wire, sync_overlap)
    check_ported(cfg, mc.tp)
    repl_w, dp_logical = _replication(cfg, mc, replication, dead)
    plans = _build_sync_plans(cfg, mc, sync, dp_degrees, sparse_tokens_hint,
                              retune)
    node = torch.arange(mc.dp, device=mc.device)
    salt = torch.exp2(-((node % dp_logical) % 4).to(torch.float32))

    def fn(grads, token_ids, capture: Optional[dict] = None):
        def stack(g):
            s = g.to(mc.device).unsqueeze(0).expand((mc.dp,) + tuple(g.shape))
            if salt_shards:
                s = s * salt.to(g.dtype).reshape((-1,) + (1,) * g.ndim)
            return s
        stacked = T.tree_from_leaves(grads, [(p, stack(g)) for p, g
                                             in T.tree_leaves(grads)])
        tokens = _stack_tokens(token_ids, mc).reshape(mc.dp, -1)
        synced, overflow, _ = sync_grads(
            stacked, cfg, mc, sync, plans, tokens, merge=sync_merge,
            wire=sync_wire, repl_weight=repl_w, dp_logical=dp_logical,
            capture=capture, overlap=sync_overlap,
            bucket_bytes=sync_bucket_bytes)
        return synced, overflow

    return fn, full_model_spec_tuples(cfg, mc.tp)


EXTRA_KEYS = ("img_embeds", "enc_frames")


def train_fingerprint(cfg: ModelConfig, **settings) -> str:
    """Digest of the config and run settings a checkpoint must match to
    resume exactly (the soak refuses a mismatch).  Pass the mesh's
    ``shape`` among the settings: a pod mesh's names its ``pod`` axis, so
    its digest differs from the flat mesh's of the same M."""
    payload = {"cfg": dataclasses.asdict(cfg),
               "settings": {k: settings[k] for k in sorted(settings)}}
    return hashlib.sha1(
        json.dumps(payload, sort_keys=True, default=str).encode()
    ).hexdigest()[:16]


def make_train_step(cfg: ModelConfig, mc: MeshCtx, *, sync: str = "ring",
                    opt: Optional[AdamW] = None, dp_degrees=None,
                    aux_weight: float = 0.01, microbatch: int = 1,
                    sparse_tokens_hint: Optional[int] = None,
                    sync_merge: str = "sort", sync_wire: str = "raw",
                    replication: int = 1, dead: Optional[set] = None,
                    retune: bool = False, sync_overlap: str = "off",
                    sync_bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                    donate: bool = True):
    """``(step, specs)``: ``step(params, opt_state, batch) -> (params,
    opt_state, metrics)`` over the stacked data mesh ``mc``.

    batch: ``tokens`` / ``labels`` [B, S] (numpy or tensors), B divisible
    by M, and a VLM's ``img_embeds`` [B, Ti, d] / an encoder-decoder's
    ``enc_frames`` [B, S_enc, d].  Each position differentiates ``loss + aux_weight * aux`` of its
    B / M rows (``microbatch`` > 1 accumulates float32 gradients over that
    many row slices and divides, as the reference's scan does); the
    stacked gradients are synced (``sync``, ``dp_degrees``,
    ``sync_merge``, ``sync_wire``: as the reference's); the global norm
    of the synced gradients feeds AdamW, which updates one copy of the
    parameters.  ``replication=r`` / ``dead``: M / r logical shards
    hosted r-way (the launcher tiles the batch r times), each counted from
    its first alive replica.  ``sync_wire="delta+int8ef"`` carries the
    error feedback in the optimizer state: pass an ``AdamWState`` the
    first time, then the ``{"adamw": ..., "ef": [M, V, d]}`` dict the
    step returned.  Metrics: ``loss`` and ``aux`` (means over the
    positions), ``gnorm``, ``sync_overflow`` (the largest position's).
    At tp > 1 (``mc.tp``) the parameters are ``init_params(cfg, tp)``'s
    global leaves and each data row's loss counts once; each model
    position's aux is on its token slice, the objective weighs their
    mean, ``aux`` reports the mean over every position, and
    ``capture["aux"]`` receives them all, [M, tp].

    ``step(..., mark=fn)`` calls ``fn("fwd_bwd")``, ``fn("sync")`` and
    ``fn("update")`` as each stage is enqueued (timing hooks); a step is
    the span ``train.step`` (:mod:`repro_torch.obs`);
    ``capture={}`` receives the embedding leaf's float32 sync
    (``capture["emb"]``) and row 0 of every synced leaf
    (``capture["synced"]``).  Updates never write in place.  With
    ``donate`` (the default, as the reference's buffer donation) AdamW
    drops the caller's parameters and optimizer state leaf by leaf as it
    replaces them, so a step holds one set of moments: the caller must
    not read the ``params`` and ``opt_state`` it passed.  FSDP leaves
    (``cfg.fsdp``) are differentiated held once, through each period's
    gather; FSDP with ``replication`` > 1 raises ``ValueError``.
    ``sync_overlap="bucketed"`` (``hier`` or ``sparse`` only) syncs the
    dense butterfly's leaves in ``sync_bucket_bytes`` buckets issued
    stage-major, with the bits of ``"off"`` (:func:`sync_grads`).  On a
    pod mesh the batch splits over the pod * data positions in row-major
    order."""
    _check_sync_settings(sync, sync_merge, sync_wire, sync_overlap)
    check_ported(cfg, mc.tp)
    if microbatch < 1:
        raise ValueError(f"microbatch must be >= 1, got {microbatch}")
    opt = opt or AdamW()
    ax = mc.axis_ctx(cfg)
    repl_w, dp_logical = _replication(cfg, mc, replication, dead)
    plans = _build_sync_plans(cfg, mc, sync, dp_degrees, sparse_tokens_hint,
                              retune)
    use_ef = sync == "sparse" and sync_wire == "delta+int8ef"
    ef_shape = (mc.dp, T.padded_vocab(cfg, mc.tp), cfg.d_model)
    fsdp_paths = fsdp_block_paths(cfg)

    def grads_of(ps, tree, tokens, labels, extras):
        """Each position's gradients of its rows' loss, stacked [M, ...]
        (an FSDP leaf's summed over the positions), and the M losses and
        aux."""
        loss, aux = T.forward_loss(
            tree, tokens, labels, cfg, ax,
            extra_embeds=extras.get("img_embeds"),
            enc_frames=extras.get("enc_frames"))
        # at tp > 1 aux is each model position's: the objective weighs
        # their mean
        aux_obj = aux.mean(-1) if mc.tp > 1 else aux
        gs = torch.autograd.grad((loss + aux_weight * aux_obj).sum(), ps)
        return gs, loss.detach(), aux.detach()

    @obs.span("train.step")
    def step(params, opt_state, batch, mark: Optional[Callable] = None,
             capture: Optional[dict] = None):
        mark = mark or (lambda stage: None)
        ef = None
        if use_ef:
            if not (isinstance(opt_state, dict) and "ef" in opt_state):
                opt_state = {"adamw": opt_state, "ef": torch.zeros(
                    ef_shape, dtype=torch.float32, device=mc.device)}
            ef, opt_state = opt_state["ef"], opt_state["adamw"]
        tokens = _stack_tokens(batch["tokens"], mc)
        labels = _stack_tokens(batch["labels"], mc)
        extras = {k: _stack_tokens(batch[k], mc, dtype=None)
                  for k in EXTRA_KEYS if batch.get(k) is not None}
        leaves = T.tree_leaves(params)
        # position i differentiates through its own (broadcast) copy; an
        # FSDP leaf is held once and gathered per period
        ps = [p.detach().requires_grad_(True)
              if path[0] == "blocks" and path[1:] in fsdp_paths else
              p.detach().unsqueeze(0).expand((mc.dp,) + tuple(p.shape))
              .requires_grad_(True) for path, p in leaves]
        tree = T.tree_from_leaves(params, [(path, p) for (path, _), p
                                           in zip(leaves, ps)])
        if microbatch == 1:
            stacked, losses, auxes = grads_of(ps, tree, tokens, labels,
                                              extras)
        else:
            rows = tokens.shape[1]
            if rows % microbatch:
                raise ValueError(f"{rows} rows a position do not split "
                                 f"into {microbatch} microbatches")
            per = rows // microbatch
            stacked = losses = auxes = None
            for j in range(microbatch):
                sl = slice(j * per, (j + 1) * per)
                gs, l, a = grads_of(ps, tree, tokens[:, sl], labels[:, sl],
                                    {k: v[:, sl] for k, v in extras.items()})
                gs = [g.to(torch.float32) for g in gs]
                if stacked is None:
                    stacked, losses, auxes = gs, l, a
                else:
                    stacked = [s + g for s, g in zip(stacked, gs)]
                    losses, auxes = losses + l, auxes + a
                del gs
            stacked = [s / microbatch for s in stacked]
            losses, auxes = losses / microbatch, auxes / microbatch
        del tree, ps, extras
        mark("fwd_bwd")
        grads = T.tree_from_leaves(params, [(path, s) for (path, _), s
                                            in zip(leaves, stacked)])
        del stacked, leaves
        synced, overflow, new_ef = sync_grads(
            grads, cfg, mc, sync, plans,
            tokens.reshape(mc.dp, -1), merge=sync_merge, wire=sync_wire,
            ef=ef, repl_weight=repl_w, dp_logical=dp_logical, rows=0,
            consume=True, capture=capture, overlap=sync_overlap,
            bucket_bytes=sync_bucket_bytes)
        mark("sync")
        if capture is not None:
            capture["synced"] = T.tree_from_leaves(synced,
                                                   T.tree_leaves(synced))
        gnorm = _sharded_grad_norm(synced)
        new_params, new_opt, _ = opt.update(synced, opt_state, params,
                                            gnorm=gnorm, donate=donate)
        if use_ef:
            new_opt = {"adamw": new_opt, "ef": new_ef}
        metrics = {"loss": losses.mean(), "aux": auxes.mean(), "gnorm": gnorm,
                   "sync_overflow": overflow.max()}
        if capture is not None:
            capture["aux"] = auxes
        mark("update")
        return new_params, new_opt, metrics

    specs = {"params": full_model_spec_tuples(cfg, mc.tp)}
    return step, specs


# ---------------------------------------------------------------------------
# Serving steps (prefill, decode, greedy)
# ---------------------------------------------------------------------------

def init_cache_global(cfg: ModelConfig, mc: MeshCtx, b: int, max_seq: int,
                      seq_sharded: bool = False):
    """The decode cache of ``b`` rows at the reference's global shapes
    (``models.transformer.init_cache``), on the mesh's device; row r
    belongs to data position r // (b / M), as the reference's ``P(dp)``
    shards it.  ``seq_sharded``: the split-KV layout, the same global
    tensors with every row replicated and the sequence axis split over
    the ``data`` positions (slots [d * S / data, (d + 1) * S / data) on
    data position d)."""
    return T.init_cache(cfg, b, max_seq, mc.tp, mc.device,
                        seq_shards=mc.data if seq_sharded else 1)


def seq_transport(mc: MeshCtx) -> StackedTransport:
    """The split-KV layout's transport: one stage of degree ``data`` over
    the data positions (a pod's replicas hold the same split)."""
    return StackedTransport(ButterflyPlan(mc.data, (mc.data,)), mc.device)


def serving_tree(params, cfg: ModelConfig, mc: MeshCtx):
    """The held-once parameters as the serving forwards take them on the
    mesh: each leaf a broadcast [M, ...] view, an FSDP block leaf held
    once (gathered per period)."""
    held = fsdp_block_paths(cfg)
    return T.tree_from_leaves(params, [
        (p, t if p[0] == "blocks" and p[1:] in held else
         t.unsqueeze(0).expand((mc.dp,) + tuple(t.shape)))
        for p, t in T.tree_leaves(params)])


def _serving_params(cfg: ModelConfig, mc: MeshCtx, replicated: bool = False):
    """``view(params) -> (tree, head32)``: :func:`serving_tree` of the last
    parameter set passed (rebuilt when another set comes or its head
    tensor is replaced), or the held-once set itself when the batch is
    ``replicated`` (the split-KV layout), and its float32 head,
    ``T.head_f32`` (one cast shared by every step serving that set)."""
    memo = {}

    def view(params):
        head = params["emb"] if cfg.tie_embeddings else params["head"]
        key = (id(params), id(head))
        if memo.get("key") != key:
            memo.clear()
            memo.update(key=key, params=params,
                        tree=params if replicated
                        else serving_tree(params, cfg, mc))
        return memo["tree"], T.head_f32(params, cfg)
    return view


def _greedy_ids(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """Greedy ids of float logits [..., V_pad]: the padded columns
    (``vocab <= j < V_pad``; exactly zero under tied embeddings, which
    can beat all-negative real logits) are set to ``-inf`` before the
    argmax (the first maximum on ties).  int32 [...]."""
    cols = torch.arange(logits.shape[-1], device=logits.device)
    masked = logits.to(torch.float32).masked_fill(cols >= vocab, -math.inf)
    return torch.argmax(masked, dim=-1).to(torch.int32)


def _serve_batch(batch, mc: MeshCtx):
    """A serving batch's tokens and extras as [M, B / M, ...] rows."""
    tokens = _stack_tokens(batch["tokens"], mc)
    extras = {k: _stack_tokens(batch[k], mc, dtype=None)
              for k in EXTRA_KEYS if batch.get(k) is not None}
    return tokens, extras


def make_prefill_step(cfg: ModelConfig, mc: MeshCtx, max_seq: int):
    """``(step, specs)``: ``step(params, batch) -> (logits [B, V_pad]
    float32, cache)``, the prompt forward of ``batch["tokens"]`` [B, T]
    (and a VLM's ``img_embeds`` / an encoder-decoder's ``enc_frames``)
    with B split over the M data positions in contiguous blocks;
    ``params`` are the held-once global leaves, as the train step takes
    them.  The cache is :func:`init_cache_global`'s at ``max_seq``."""
    check_ported(cfg, mc.tp)
    ax = mc.axis_ctx(cfg)
    view = _serving_params(cfg, mc)

    def step(params, batch):
        tree, head32 = view(params)
        tokens, extras = _serve_batch(batch, mc)
        logits, cache = T.forward_prefill(
            tree, tokens, cfg, ax, max_seq,
            enc_frames=extras.get("enc_frames"),
            extra_embeds=extras.get("img_embeds"), head32=head32)
        return logits.reshape(-1, logits.shape[-1]), cache
    return step, {"params": full_model_spec_tuples(cfg, mc.tp)}


def _replicated_tokens(x, mc: MeshCtx) -> torch.Tensor:
    """Replicated ids or positions [B] (the reference's ``P(None)``) as
    an int64 tensor on the mesh's device."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t.to(device=mc.device, dtype=torch.int64)


def make_decode_step(cfg: ModelConfig, mc: MeshCtx, *,
                     seq_sharded: bool = False, serve2d: bool = False):
    """``(step, specs)``: ``step(params, token, pos, cache[, cross_cache])
    -> (logits [B, V_pad] float32, cache)``, one decode step of B rows
    (ids and positions [B], numpy or tensors) split over the M data
    positions in contiguous blocks; the cache is updated in place and
    returned.

    ``seq_sharded``: the split-KV layout (a context one position's cache
    cannot hold): the B rows are replicated, the cache is
    :func:`init_cache_global`'s with ``seq_sharded=True`` and its
    sequence axis is split over the ``data`` positions
    (:func:`seq_transport`).  ``serve2d``: the 2D
    weight-stationary decode of an FSDP config (attention and mamba
    blocks), either cache layout.  ``step.capture`` (a dict, initially
    empty) holds the last step's ``"moe_dropped"``."""
    check_ported(cfg, mc.tp)
    ax = mc.axis_ctx(cfg)
    seq_axis = seq_transport(mc) if seq_sharded else None
    T._check_decode_layout(cfg, seq_axis, serve2d)
    view = _serving_params(cfg, mc, replicated=seq_sharded)
    rows = (lambda x: _replicated_tokens(x, mc)) if seq_sharded \
        else (lambda x: _stack_tokens(x, mc))
    capture: dict = {}

    def step(params, token, pos, cache, *cross):
        tree, head32 = view(params)
        logits, cache = T.forward_decode(
            tree, rows(token), rows(pos), cache, cfg, ax,
            cross_cache=cross[0] if cross else None, head32=head32,
            seq_axis=seq_axis, serve2d=serve2d,
            mesh_sizes=mc.shape, capture=capture)
        return logits.reshape(-1, logits.shape[-1]), cache
    step.capture = capture
    return step, {"params": full_model_spec_tuples(cfg, mc.tp)}


def make_prefill_greedy_step(cfg: ModelConfig, mc: MeshCtx, max_seq: int):
    """:func:`make_prefill_step` with :func:`_greedy_ids` fused: ``step(
    params, batch) -> (ids int32 [B], cache)``, ids on the device (the
    vocab-sized logits never leave it)."""
    prefill, specs = make_prefill_step(cfg, mc, max_seq)

    def step(params, batch):
        logits, cache = prefill(params, batch)
        return _greedy_ids(logits, cfg.vocab), cache
    return step, specs


def make_decode_greedy_step(cfg: ModelConfig, mc: MeshCtx, *,
                            seq_sharded: bool = False, serve2d: bool = False):
    """:func:`make_decode_step` with :func:`_greedy_ids` fused: ``step(
    params, token, pos, cache[, cross_cache]) -> (ids int32 [B], cache)``,
    the continuous-batching scheduler's step; its one output a caller
    reads on the host is the ids."""
    decode, specs = make_decode_step(cfg, mc, seq_sharded=seq_sharded,
                                     serve2d=serve2d)

    def step(params, token, pos, cache, *cross):
        logits, cache = decode(params, token, pos, cache, *cross)
        return _greedy_ids(logits, cfg.vocab), cache
    step.capture = decode.capture
    return step, specs
