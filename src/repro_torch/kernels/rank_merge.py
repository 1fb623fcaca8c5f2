"""Merge-rank kernels: positions of sorted streams in their merge (reference: ``repro.kernels.rank_merge``).

The paper merges sorted sparse vectors pairwise; the merge *permutation*
is computed directly instead of with a data-dependent two-pointer loop:

    rank_a[i] = i + #{j : b_j <  a_i}       (stable: a before b on ties)
    rank_b[j] = j + #{i : a_i <= b_j}

:func:`rank_counts` is the counting term.  ``banded=False`` is TPU row 1
(``csrc/rank_merge.cu``: one binary search per query over all of b);
``banded=True`` is TPU row 2 (``csrc/rank_merge_banded.cu``: a tile of
``bm`` queries resolves every b below and above its edges at once and
searches only the window that straddles it, staged ``bn`` entries at a
time).  :func:`merge_ranks` runs either kernel over all k sorted runs of
every stacked node in one launch and returns the merge ranks of a
butterfly layer directly.  :func:`rank_tile_stats` reports the TPU banded
kernel's tile classes for the same streams.  The plain versions are in
``ref``.  Indices are int64 in [0, 2**32) (unsigned 32-bit order).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.sparse_vec import SENTINEL

from . import _build
from .ref import (merge_ranks_ref, rank_counts_banded_ref, rank_counts_ref)

# default tile shape of the reference's compare plane; the banded kernel
# takes bm as its query tile and bn as its staging chunk
BM, BN = 512, 512


def _launch(banded: bool, a: torch.Tensor, b: torch.Tensor, out: torch.Tensor,
            groups: int, q: int, na: int, s: int, nb: int, mode: int,
            bm: int, bn: int) -> None:
    kernel = "rank_counts_banded" if banded else "rank_counts"
    _build.check_cuda(kernel, a, b, out)
    with torch.cuda.device(a.device):
        if banded:
            _build.launch(kernel, "repro_rank_counts_banded", a.data_ptr(),
                          b.data_ptr(), out.data_ptr(), groups, q, na, s, nb,
                          mode, bm, bn, _build.stream_of(a))
        else:
            _build.launch(kernel, "repro_rank_counts", a.data_ptr(),
                          b.data_ptr(), out.data_ptr(), groups, q, na, s, nb,
                          mode, _build.stream_of(a))


def _check_index(name: str, *tensors) -> None:
    for t in tensors:
        if t.dtype != torch.int64:
            raise TypeError(f"{name}: indices must be int64, got {t.dtype}")


def _check_tiles(bm: int, bn: int) -> None:
    if not 1 <= bm <= 1024 or not 1 <= bn <= 12288:
        raise ValueError(f"banded rank tiles need 1 <= bm <= 1024 and "
                         f"1 <= bn <= 12288, got bm={bm}, bn={bn}")


def rank_counts(a: torch.Tensor, b: torch.Tensor, *, strict: bool = True,
                banded: bool = False, bm: int = BM,
                bn: int = BN) -> torch.Tensor:
    """counts[..., i] = #{j : b[..., j] < a[..., i]} (strict) or <= (not
    strict), int32; a [..., Ca] and b [..., Cb] sorted int64 with equal
    leading (batch) dims.  ``banded`` picks the windowed kernel (query tile
    ``bm``, staging chunk ``bn``); both give the same counts.  CUDA tensors
    launch the kernel, CPU tensors run the plain version."""
    _check_index("rank_counts", a, b)
    if a.shape[:-1] != b.shape[:-1]:
        raise ValueError(f"rank_counts: batch dims {tuple(a.shape[:-1])} "
                         f"!= {tuple(b.shape[:-1])}")
    side = "left" if strict else "right"
    if banded:
        _check_tiles(bm, bn)
    if a.device.type == "cpu":
        return (rank_counts_banded_ref(a, b, side, bm) if banded
                else rank_counts_ref(a, b, side))
    out = torch.empty(a.shape, dtype=torch.int32, device=a.device)
    _launch(banded, a, b, out, math.prod(a.shape[:-1]), 1, a.shape[-1], 1,
            b.shape[-1], 1 if strict else 0, bm, bn)
    return out


def merge_ranks(runs: torch.Tensor, *, banded: bool = False, bm: int = BM,
                bn: int = BN) -> torch.Tensor:
    """Stable merge ranks of the k sorted runs of each group: runs
    [..., k, cap] int64 -> int32 [..., k, cap], a bijection onto
    [0, k*cap) per group.  Run r's entry i goes to ``i + sum_{s != r}``
    of its :func:`rank_counts` against run s, strict for ``s > r`` and
    non-strict for ``s < r`` (earlier runs win ties), one launch for all
    groups and run pairs (``banded`` picks the windowed kernel)."""
    _check_index("merge_ranks", runs)
    if banded:
        _check_tiles(bm, bn)
    if runs.device.type == "cpu":
        return merge_ranks_ref(runs, bm if banded else None)
    k, cap = runs.shape[-2], runs.shape[-1]
    out = torch.empty(runs.shape, dtype=torch.int32, device=runs.device)
    _launch(banded, runs, runs, out, math.prod(runs.shape[:-2]), k, cap, k,
            cap, 2, bm, bn)
    return out


# ---------------------------------------------------------------------------
# The TPU banded kernel's tile classification (host-side report)
# ---------------------------------------------------------------------------

def _pad_sorted(x: torch.Tensor, block: int) -> torch.Tensor:
    """Pad a sorted 1-D stream with SENTINEL to a block multiple."""
    n = x.shape[0]
    out = torch.full((-(-n // block) * block,), SENTINEL, dtype=torch.int64,
                     device=x.device)
    out[:n] = x
    return out


def _block_edges(x_padded: torch.Tensor, block: int) -> torch.Tensor:
    """[2, nblocks] int64 (min, max) per block of a sorted padded stream
    (int64 order on [0, 2**32) is the reference's biased-int32 order)."""
    b = x_padded.reshape(-1, block)
    return torch.stack([b[:, 0], b[:, -1]])


def _tile_classes(a_edges: torch.Tensor, b_edges: torch.Tensor, strict: bool):
    """(full, skip) boolean [I, J] tables: b-block entirely below every row
    of the a-block (adds bn per row), or entirely above (adds nothing);
    everything else is a frontier tile."""
    a_lo, a_hi = a_edges[0][:, None], a_edges[1][:, None]
    b_lo, b_hi = b_edges[0][None, :], b_edges[1][None, :]
    if strict:
        full = b_hi < a_lo
        skip = b_lo >= a_hi
    else:
        full = b_hi <= a_lo
        skip = b_lo > a_hi
    return full, skip & ~full


def rank_tile_stats(a, b, *, strict: bool = True, bm: int = BM,
                    bn: int = BN) -> dict:
    """Tile-work counter of the TPU banded kernel on concrete 1-D streams
    (uint32 numpy or int64 tensors): how many (a-block, b-block) tiles run
    the full compare (frontier) vs are resolved from block edges alone;
    the dense kernel compares all ``total`` tiles."""
    ta, tb = (x.to(torch.int64) if isinstance(x, torch.Tensor)
              else torch.as_tensor(np.asarray(x).astype(np.int64))
              for x in (a, b))
    full, skip = _tile_classes(_block_edges(_pad_sorted(ta, bm), bm),
                               _block_edges(_pad_sorted(tb, bn), bn), strict)
    n_full, n_skip = int(full.sum()), int(skip.sum())
    total = int(full.shape[0] * full.shape[1])
    return {"total_tiles": total, "full_below_tiles": n_full,
            "skipped_tiles": n_skip,
            "frontier_tiles": total - n_full - n_skip}
