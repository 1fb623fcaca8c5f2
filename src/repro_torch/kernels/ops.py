"""Kernel-backed merge and compaction pipelines (reference: ``repro.kernels.ops``).

``segment_compact`` / ``merge_add`` here are the kernel-backed versions of
the plain ones in ``repro_torch.core.sparse_vec`` (which stay the
oracles), and ``merge_sorted_runs`` is the per-layer kernel merge of the
union allreduce: rank-merge the k sorted runs (``rank_merge``), compact
duplicate indices, and scatter-add the values (``onehot_scatter``).  All
of it is batched over the stacked-mesh node axis, so one layer is one
launch of each kernel.

Merge modes: ``"fused"`` scatters straight from the input layout (the
dense rank and scatter kernels); ``"banded"`` uses the sortedness of the
runs -- the windowed rank kernel, and the banded scatter on values
permuted into merge order, where destinations are monotone with at most
``band`` sources per row.  Both give the same indices, overflow and (in
the same summation order) the same value bits.  Values enter the scatter
kernels in their wire type (f32, bf16, or int8 with a per-source scale)
and are widened only in registers.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.sparse_vec import SENTINEL, SparseChunk, head_flags

from .onehot_scatter import banded_onehot_scatter_add, onehot_scatter_add
from .rank_merge import merge_ranks, rank_counts
from .spmv_ell import spmv_ell

MERGE_KERNEL_MODES = ("fused", "banded")


def _check_mode(mode: str) -> None:
    if mode not in MERGE_KERNEL_MODES:
        raise ValueError(
            f"mode must be one of {MERGE_KERNEL_MODES}, got {mode!r}")


def _compact_positions(idx: torch.Tensor, out_capacity: int):
    """Destination row per entry of sorted idx streams [..., C] (+ head
    flags); rows past ``out_capacity`` and padding go to the drop bin
    ``out_capacity``."""
    valid = idx != SENTINEL
    is_head = head_flags(idx)
    pos = torch.cumsum(is_head, -1) - 1
    pos = torch.where(valid & (pos < out_capacity), pos, out_capacity)
    return pos, is_head


def _to_merge_order(x: torch.Tensor, ranks: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` [..., C(, W)] moved to their merge rank (a bijection
    per stream), in ``x``'s own dtype."""
    r = ranks if x.ndim == ranks.ndim else ranks.unsqueeze(-1).expand(x.shape)
    return torch.empty_like(x).scatter_(ranks.ndim - 1, r, x)


def _compact_scatter_add(merged_idx: torch.Tensor,
                         ranks: Optional[torch.Tensor], val: torch.Tensor,
                         out_capacity: int, mode: str = "fused",
                         band: Optional[int] = None,
                         scale: Optional[torch.Tensor] = None,
                         out_dtype: Optional[torch.dtype] = None
                         ) -> Tuple[SparseChunk, torch.Tensor]:
    """Shared tail of every compact pipeline: scatter the head index of
    each duplicate group, then coalesce the values with one scatter-add
    kernel launch.

    ``merged_idx``: sorted [..., C] int64 streams; ``ranks``: position of
    value row e within its stream (None when the rows are already in
    stream order); ``val``: [..., C] or [..., C, W] in its wire type.
    ``mode="fused"`` scatters from the input layout (``final_pos[e] =
    pos[ranks[e]]``); ``mode="banded"`` first permutes the values (and
    ``scale``) into merge order, so that ``pos`` is non-decreasing with
    at most ``band`` sources per row, and runs the banded kernel.
    ``scale`` [..., C] f32: per-source factor applied in the kernel.
    ``out_dtype``: output value dtype (default ``val``'s).  Returns
    ``(chunk, n_unique)``.
    """
    _check_mode(mode)
    out_dtype = val.dtype if out_dtype is None else out_dtype
    pos, is_head = _compact_positions(merged_idx, out_capacity)
    lead = merged_idx.shape[:-1]
    out_idx = torch.full(lead + (out_capacity + 1,), SENTINEL,
                         dtype=torch.int64, device=merged_idx.device)
    out_idx.scatter_(-1, torch.where(is_head, pos, out_capacity), merged_idx)
    scalar = val.ndim == merged_idx.ndim
    v2 = val.unsqueeze(-1) if scalar else val
    if mode == "banded":
        if band is None:
            raise ValueError("banded mode needs a source-multiplicity bound")
        if ranks is not None:
            v2 = _to_merge_order(v2, ranks)
            if scale is not None:
                scale = _to_merge_order(scale, ranks)
        out_val = banded_onehot_scatter_add(
            pos.to(torch.int32), v2.contiguous(), out_capacity, band=band,
            scale=scale)
    else:
        final_pos = pos if ranks is None else torch.gather(pos, -1, ranks)
        out_val = onehot_scatter_add(final_pos.to(torch.int32),
                                     v2.contiguous(), out_capacity,
                                     scale=scale)
    out_val = out_val.to(out_dtype)
    if scalar:
        out_val = out_val[..., 0]
    return (SparseChunk(idx=out_idx[..., :-1], val=out_val),
            is_head.sum(-1))


def segment_compact(chunk: SparseChunk, out_capacity: Optional[int] = None,
                    max_dup: Optional[int] = None) -> SparseChunk:
    """Kernel-backed coalesce of sorted chunks (one scatter-add launch).
    ``max_dup``: bound on how often any index repeats in a chunk; when
    given, the banded kernel runs (a sorted chunk is already in stream
    order, so nothing is permuted)."""
    out_capacity = out_capacity or chunk.capacity
    mode = "banded" if max_dup is not None else "fused"
    out, _ = _compact_scatter_add(chunk.idx, None, chunk.val, out_capacity,
                                  mode=mode, band=max_dup)
    return out


def merge_add(a: SparseChunk, b: SparseChunk,
              out_capacity: Optional[int] = None,
              mode: str = "fused") -> SparseChunk:
    """Kernel-backed merge of two sorted chunks with collision summation:
    merge ranks from two :func:`rank_counts` launches, the merged index
    stream from one scatter, and the values coalesced
    (``final_pos[e] = compact_pos[rank[e]]``).  ``mode="banded"`` assumes
    each chunk's valid indices are unique (at most 2 sources per row) and
    runs the banded kernels."""
    _check_mode(mode)
    banded = mode == "banded"
    ca, cb = a.capacity, b.capacity
    out_capacity = out_capacity or (ca + cb)
    dev = a.idx.device
    rank_a = torch.arange(ca, device=dev) + rank_counts(
        a.idx.contiguous(), b.idx.contiguous(), strict=True, banded=banded)
    rank_b = torch.arange(cb, device=dev) + rank_counts(
        b.idx.contiguous(), a.idx.contiguous(), strict=False, banded=banded)
    ranks = torch.cat([rank_a, rank_b], -1)
    idx = torch.cat([a.idx, b.idx], -1)
    merged_idx = torch.empty_like(idx).scatter_(-1, ranks, idx)
    cat = torch.cat([a.val, b.val], a.idx.ndim - 1)
    out, _ = _compact_scatter_add(merged_idx, ranks, cat, out_capacity,
                                  mode=mode, band=2)
    return out


def merge_sorted_runs(idx: torch.Tensor, val: torch.Tensor, out_capacity: int,
                      mode: str = "fused",
                      row_scale: Optional[torch.Tensor] = None,
                      out_dtype: Optional[torch.dtype] = None
                      ) -> Tuple[SparseChunk, torch.Tensor]:
    """k-way merge of one butterfly layer, batched over leading dims:
    rank-merge the sorted runs, compact duplicate indices, and scatter-add
    the values in one pass (no full re-sort).

    ``idx`` [..., k, cap] int64 (each run sorted, SENTINEL-padded),
    ``val`` [..., k, cap] or [..., k, cap, W] in its wire type.

    1. run r's entry i lands at ``i + sum_{s != r} #{j : runs[s][j] (<= if
       s < r else <) runs[r][i]}`` -- the stable tie-break
       ``strict=(s > r)`` of the reference, so equal indices keep run
       order (:func:`merge_ranks`, one launch);
    2. one scatter builds the merged idx stream; head flags + cumsum give
       each entry its compacted destination row;
    3. the values are coalesced with one scatter-add launch: from the
       input layout (``mode="fused"``), or permuted into merge order for
       the banded kernel with ``band = k`` (``mode="banded"``, which
       assumes each run's valid indices are unique -- the butterfly
       invariant).

    ``row_scale`` [..., k] f32: one dequantization scale per run (the
    int8 wire ships one per exchanged row), repeated per entry and applied
    inside the scatter kernel.  ``out_dtype``: output value dtype (wire
    decodes pass the compute dtype; default keeps ``val``'s).

    Returns ``(chunk, overflow)`` with the contract of
    ``sparse_vec.segment_compact`` + ``compact_overflow`` on the sorted
    concatenation: ``overflow`` [...] counts unique indices beyond
    ``out_capacity`` (dropped).
    """
    _check_mode(mode)
    lead = idx.shape[:-2]
    k, cap = idx.shape[-2], idx.shape[-1]
    total = k * cap
    rank = merge_ranks(idx.contiguous(), banded=mode == "banded").reshape(
        lead + (total,)).to(torch.int64)
    flat_idx = idx.reshape(lead + (total,))
    merged_idx = torch.empty_like(flat_idx).scatter_(-1, rank, flat_idx)
    scale = None
    if row_scale is not None:
        scale = row_scale.to(torch.float32).unsqueeze(-1).expand(
            lead + (k, cap)).reshape(lead + (total,))
    out, n_unique = _compact_scatter_add(
        merged_idx, rank, val.reshape(lead + (total,) + val.shape[idx.ndim:]),
        out_capacity, mode=mode, band=k, scale=scale, out_dtype=out_dtype)
    return out, torch.clamp(n_unique - out_capacity, min=0)


def spmv(cols: torch.Tensor, weights: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """ELL SpMV (PageRank's local product) through the kernel."""
    return spmv_ell(cols, weights, x)
