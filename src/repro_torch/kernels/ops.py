"""Kernel-backed merge and compaction pipelines (reference: ``repro.kernels.ops``).

``segment_compact`` / ``merge_add`` here are the kernel-backed versions of
the plain ones in ``repro_torch.core.sparse_vec`` (which stay the
oracles), and ``merge_sorted_runs`` is the per-layer fused merge of the
union allreduce: rank-merge the k sorted runs (``rank_merge``), compact
duplicate indices, and scatter-add the values straight from the input
layout (``onehot_scatter``).  All of it is batched over the stacked-mesh
node axis, so one layer is one launch of each kernel.  Only
``mode="fused"`` is ported; the banded mode is a later slice.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.sparse_vec import SENTINEL, SparseChunk, head_flags

from .onehot_scatter import onehot_scatter_add
from .rank_merge import merge_ranks, rank_counts
from .spmv_ell import spmv_ell


def _check_mode(mode: str) -> None:
    if mode == "banded":
        raise NotImplementedError(
            "merge mode 'banded' is not ported yet (ROADMAP Queue 1 item 7)")
    if mode != "fused":
        raise ValueError(f"mode must be 'fused', got {mode!r}")


def _compact_positions(idx: torch.Tensor, out_capacity: int):
    """Destination row per entry of sorted idx streams [..., C] (+ head
    flags); rows past ``out_capacity`` and padding go to the drop bin
    ``out_capacity``."""
    valid = idx != SENTINEL
    is_head = head_flags(idx)
    pos = torch.cumsum(is_head, -1) - 1
    pos = torch.where(valid & (pos < out_capacity), pos, out_capacity)
    return pos, is_head


def _compact_scatter_add(merged_idx: torch.Tensor,
                         ranks: Optional[torch.Tensor], val: torch.Tensor,
                         out_capacity: int) -> Tuple[SparseChunk, torch.Tensor]:
    """Shared tail of every compact pipeline: scatter the head index of
    each duplicate group, then coalesce the values with one scatter-add
    kernel launch.

    ``merged_idx``: sorted [..., C] int64 streams; ``ranks``: position of
    value row e within its stream (None when the rows are already in
    stream order); ``val``: [..., C] or [..., C, W].  Returns ``(chunk,
    n_unique)``.
    """
    pos, is_head = _compact_positions(merged_idx, out_capacity)
    lead = merged_idx.shape[:-1]
    out_idx = torch.full(lead + (out_capacity + 1,), SENTINEL,
                         dtype=torch.int64, device=merged_idx.device)
    out_idx.scatter_(-1, torch.where(is_head, pos, out_capacity), merged_idx)
    scalar = val.ndim == merged_idx.ndim
    v2 = val.unsqueeze(-1) if scalar else val
    final_pos = pos if ranks is None else torch.gather(pos, -1, ranks)
    out_val = onehot_scatter_add(final_pos.to(torch.int32),
                                 v2.to(torch.float32).contiguous(),
                                 out_capacity).to(val.dtype)
    if scalar:
        out_val = out_val[..., 0]
    return (SparseChunk(idx=out_idx[..., :-1], val=out_val),
            is_head.sum(-1))


def segment_compact(chunk: SparseChunk, out_capacity: Optional[int] = None,
                    max_dup: Optional[int] = None) -> SparseChunk:
    """Kernel-backed coalesce of sorted chunks (one scatter-add launch).
    ``max_dup`` selects the banded kernel, which is not ported yet."""
    if max_dup is not None:
        _check_mode("banded")
    out_capacity = out_capacity or chunk.capacity
    out, _ = _compact_scatter_add(chunk.idx, None, chunk.val, out_capacity)
    return out


def merge_add(a: SparseChunk, b: SparseChunk,
              out_capacity: Optional[int] = None,
              mode: str = "fused") -> SparseChunk:
    """Kernel-backed merge of two sorted chunks with collision summation:
    merge ranks from two :func:`rank_counts` launches, the merged index
    stream from one scatter, and the values coalesced straight from the
    inputs (``final_pos[e] = compact_pos[rank[e]]``)."""
    _check_mode(mode)
    ca, cb = a.capacity, b.capacity
    out_capacity = out_capacity or (ca + cb)
    dev = a.idx.device
    rank_a = torch.arange(ca, device=dev) + rank_counts(
        a.idx.contiguous(), b.idx.contiguous(), strict=True)
    rank_b = torch.arange(cb, device=dev) + rank_counts(
        b.idx.contiguous(), a.idx.contiguous(), strict=False)
    ranks = torch.cat([rank_a, rank_b], -1)
    idx = torch.cat([a.idx, b.idx], -1)
    merged_idx = torch.empty_like(idx).scatter_(-1, ranks, idx)
    cat = torch.cat([a.val, b.val], a.idx.ndim - 1)
    out, _ = _compact_scatter_add(merged_idx, ranks, cat, out_capacity)
    return out


def merge_sorted_runs(idx: torch.Tensor, val: torch.Tensor, out_capacity: int,
                      mode: str = "fused") -> Tuple[SparseChunk, torch.Tensor]:
    """Fused k-way merge of one butterfly layer, batched over leading dims:
    rank-merge the sorted runs, compact duplicate indices, and scatter-add
    the values in one pass (no full re-sort).

    ``idx`` [..., k, cap] int64 (each run sorted, SENTINEL-padded),
    ``val`` [..., k, cap] or [..., k, cap, W].

    1. run r's entry i lands at ``i + sum_{s != r} #{j : runs[s][j] (<= if
       s < r else <) runs[r][i]}`` -- the stable tie-break
       ``strict=(s > r)`` of the reference, so equal indices keep run
       order (:func:`merge_ranks`, one launch);
    2. one scatter builds the merged idx stream; head flags + cumsum give
       each entry its compacted destination row;
    3. the values go from the input layout into the compacted output with
       one :func:`onehot_scatter_add` launch, ``final_pos[e] = pos[rank[e]]``.

    Returns ``(chunk, overflow)`` with the contract of
    ``sparse_vec.segment_compact`` + ``compact_overflow`` on the sorted
    concatenation: ``overflow`` [...] counts unique indices beyond
    ``out_capacity`` (dropped).
    """
    _check_mode(mode)
    lead = idx.shape[:-2]
    total = idx.shape[-2] * idx.shape[-1]
    rank = merge_ranks(idx.contiguous()).reshape(lead + (total,)).to(torch.int64)
    flat_idx = idx.reshape(lead + (total,))
    merged_idx = torch.empty_like(flat_idx).scatter_(-1, rank, flat_idx)
    out, n_unique = _compact_scatter_add(
        merged_idx, rank, val.reshape(lead + (total,) + val.shape[idx.ndim:]),
        out_capacity)
    return out, torch.clamp(n_unique - out_capacity, min=0)


def spmv(cols: torch.Tensor, weights: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """ELL SpMV (PageRank's local product) through the kernel."""
    return spmv_ell(cols, weights, x)
