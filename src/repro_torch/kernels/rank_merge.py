"""Merge-rank kernels: positions of sorted streams in their merge (reference: ``repro.kernels.rank_merge``).

The paper merges sorted sparse vectors pairwise; the merge *permutation*
is computed directly instead of with a data-dependent two-pointer loop:

    rank_a[i] = i + #{j : b_j <  a_i}       (stable: a before b on ties)
    rank_b[j] = j + #{i : a_i <= b_j}

:func:`rank_counts` is the counting term.  ``banded=False`` is TPU row 1
(``csrc/rank_merge.cu``: a merge path -- co-rank splitters per output
tile, then each tile merged in shared memory; the k-way form is a merge
tree of ceil(log2 k) such levels, all in one block's shared memory when
a group fits there); ``banded=True`` is TPU row 2
(``csrc/rank_merge_banded.cu``: the TPU's tile triage -- every (a-block,
b-block) tile classified from block edges, only frontier blocks staged
and searched, one query tile per CUDA block against all other runs at
once).  :func:`merge_ranks` runs either kernel over all k sorted runs of
every stacked node in one call and returns the merge ranks of a
butterfly layer directly.  :func:`rank_tile_stats` reports the TPU banded
kernel's tile classes for two streams, :func:`merge_tile_stats` for a
whole layer (counted by the kernel itself on the card).  The plain
versions are in ``ref``.  Indices are int64 in [0, 2**32) (unsigned
32-bit order).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from . import _build
from .ref import (merge_ranks_ref, rank_counts_banded_ref, rank_counts_ref,
                  tile_classes)

# default tile shape of the reference's compare plane; the banded kernel
# takes bm as its query tile and bn as its b-block
BM, BN = 512, 512
# the banded kernel's limits: bm queries per CUDA block (64 threads x 16),
# one bn-entry block of uint32 must fit the card's shared memory
BM_MAX, BN_MAX = 1024, 49152
# frontier bytes the banded kernel stages at a time (at least one b-block):
# 16 KB measured fastest at both union_wire layers (PERF.md)
_STAGE_BYTES = 16 * 1024


def _dense(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor, groups: int,
           q: int, na: int, s: int, nb: int, mode: int) -> None:
    _build.check_cuda("rank_counts", a, b, out)
    k, cap = (q, na) if mode == 2 else (1, na + nb)
    with torch.cuda.device(a.device):  # the scratch size reads the device
        nbytes = _build.library().repro_rank_counts_scratch(groups, k, cap,
                                                            mode)
        scratch = (torch.empty(nbytes, dtype=torch.uint8, device=a.device)
                   if nbytes else None)
        _build.launch("rank_counts", "repro_rank_counts", a.data_ptr(),
                      b.data_ptr(), out.data_ptr(),
                      None if scratch is None else scratch.data_ptr(),
                      groups, q, na, s, nb, mode, _build.stream_of(a))


def _banded(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor, groups: int,
            q: int, na: int, s: int, nb: int, mode: int, bm: int, bn: int,
            stats: Optional[torch.Tensor] = None) -> None:
    _build.check_cuda("rank_counts_banded", a, b, out)
    scratch = torch.empty(
        _build.library().repro_rank_counts_banded_scratch(groups * s, nb, bn),
        dtype=torch.uint8, device=a.device)
    with torch.cuda.device(a.device):
        _build.launch("rank_counts_banded", "repro_rank_counts_banded",
                      a.data_ptr(), b.data_ptr(), out.data_ptr(),
                      scratch.data_ptr(),
                      None if stats is None else stats.data_ptr(), groups, q,
                      na, s, nb, mode, bm, bn, _STAGE_BYTES,
                      _build.stream_of(a))


def _check_index(name: str, *tensors) -> None:
    for t in tensors:
        if t.dtype != torch.int64:
            raise TypeError(f"{name}: indices must be int64, got {t.dtype}")


def _check_tiles(bm: int, bn: int) -> None:
    if not 1 <= bm <= BM_MAX or not 1 <= bn <= BN_MAX:
        raise ValueError(f"banded rank tiles need 1 <= bm <= {BM_MAX} and "
                         f"1 <= bn <= {BN_MAX}, got bm={bm}, bn={bn}")


def _check_length(name: str, n: int) -> None:
    if n >= 2**31:
        raise ValueError(f"{name}: merged length {n} does not fit int32 ranks")


def rank_counts(a: torch.Tensor, b: torch.Tensor, *, strict: bool = True,
                banded: bool = False, bm: int = BM,
                bn: int = BN) -> torch.Tensor:
    """counts[..., i] = #{j : b[..., j] < a[..., i]} (strict) or <= (not
    strict), int32; a [..., Ca] and b [..., Cb] sorted int64 with equal
    leading (batch) dims.  ``banded`` picks the tile-triage kernel (query
    tile ``bm``, b-block ``bn``); both give the same counts.  CUDA tensors
    launch the kernel, CPU tensors run the plain version."""
    _check_index("rank_counts", a, b)
    if a.shape[:-1] != b.shape[:-1]:
        raise ValueError(f"rank_counts: batch dims {tuple(a.shape[:-1])} "
                         f"!= {tuple(b.shape[:-1])}")
    _check_length("rank_counts", a.shape[-1] + b.shape[-1])
    side = "left" if strict else "right"
    if banded:
        _check_tiles(bm, bn)
    if a.device.type == "cpu":
        return (rank_counts_banded_ref(a, b, side, bm, bn) if banded
                else rank_counts_ref(a, b, side))
    out = torch.empty(a.shape, dtype=torch.int32, device=a.device)
    args = (a, b, out, math.prod(a.shape[:-1]), 1, a.shape[-1], 1,
            b.shape[-1], 1 if strict else 0)
    if banded:
        _banded(*args, bm, bn)
    else:
        _dense(*args)
    return out


def merge_ranks(runs: torch.Tensor, *, banded: bool = False, bm: int = BM,
                bn: int = BN) -> torch.Tensor:
    """Stable merge ranks of the k sorted runs of each group: runs
    [..., k, cap] int64 -> int32 [..., k, cap], a bijection onto
    [0, k*cap) per group.  Run r's entry i goes to ``i + sum_{s != r}``
    of its :func:`rank_counts` against run s, strict for ``s > r`` and
    non-strict for ``s < r`` (earlier runs win ties): the merge tree
    (dense) or all run pairs' triage (``banded``), one call for all
    groups."""
    _check_index("merge_ranks", runs)
    k, cap = runs.shape[-2], runs.shape[-1]
    _check_length("merge_ranks", k * cap)
    if banded:
        _check_tiles(bm, bn)
    if runs.device.type == "cpu":
        return merge_ranks_ref(runs, (bm, bn) if banded else None)
    out = torch.empty(runs.shape, dtype=torch.int32, device=runs.device)
    args = (runs, runs, out, math.prod(runs.shape[:-2]), k, cap, k, cap, 2)
    if banded:
        _banded(*args, bm, bn)
    else:
        _dense(*args)
    return out


# ---------------------------------------------------------------------------
# The TPU banded kernel's tile classification (host-side report)
# ---------------------------------------------------------------------------

def rank_tile_stats(a, b, *, strict: bool = True, bm: int = BM,
                    bn: int = BN) -> dict:
    """Tile-work counter of the TPU banded kernel on concrete 1-D streams
    (uint32 numpy or int64 tensors): how many (a-block, b-block) tiles run
    the full compare (frontier) vs are resolved from block edges alone;
    the dense kernel compares all ``total`` tiles."""
    ta, tb = (x.to(torch.int64) if isinstance(x, torch.Tensor)
              else torch.as_tensor(np.asarray(x).astype(np.int64))
              for x in (a, b))
    full, skip = tile_classes(ta, tb, strict, bm, bn)
    n_full, n_skip = int(full.sum()), int(skip.sum())
    total = int(full.shape[0] * full.shape[1])
    return _stats_dict(total, n_full, n_skip)


def _stats_dict(total: int, n_full: int, n_skip: int) -> dict:
    return {"total_tiles": total, "full_below_tiles": n_full,
            "skipped_tiles": n_skip,
            "frontier_tiles": total - n_full - n_skip}


def merge_tile_stats(runs: torch.Tensor, *, bm: int = BM,
                     bn: int = BN) -> dict:
    """The banded merge's tile classes over one butterfly layer: the
    :func:`rank_tile_stats` dict summed over every group and ordered run
    pair (r, s != r) of runs [..., k, cap], strict for ``s > r``.  CUDA
    tensors: counted by the banded kernel while it ranks the layer (one
    ``rank_counts_banded`` launch); CPU tensors: :func:`rank_tile_stats`
    pair by pair (plain version)."""
    _check_index("merge_tile_stats", runs)
    _check_tiles(bm, bn)
    k, cap = runs.shape[-2], runs.shape[-1]
    flat = runs.reshape(-1, k, cap)
    if runs.device.type == "cpu":
        sums = [0, 0, 0]
        for g in range(flat.shape[0]):
            for r in range(k):
                for s in range(k):
                    if s != r:
                        st = rank_tile_stats(flat[g, r], flat[g, s],
                                             strict=s > r, bm=bm, bn=bn)
                        sums[0] += st["total_tiles"]
                        sums[1] += st["full_below_tiles"]
                        sums[2] += st["skipped_tiles"]
        return _stats_dict(*sums)
    stats = torch.zeros(3, dtype=torch.int64, device=runs.device)
    out = torch.empty(runs.shape, dtype=torch.int32, device=runs.device)
    _banded(runs, runs, out, flat.shape[0], k, cap, k, cap, 2, bm, bn, stats)
    n_full, n_skip, n_front = (int(x) for x in stats.tolist())
    return _stats_dict(n_full + n_skip + n_front, n_full, n_skip)
