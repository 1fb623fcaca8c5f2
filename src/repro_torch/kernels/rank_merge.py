"""Merge-rank kernel: positions of sorted streams in their merge (reference: ``repro.kernels.rank_merge``).

The paper merges sorted sparse vectors pairwise; the merge *permutation*
is computed directly instead of with a data-dependent two-pointer loop:

    rank_a[i] = i + #{j : b_j <  a_i}       (stable: a before b on ties)
    rank_b[j] = j + #{i : a_i <= b_j}

:func:`rank_counts` is the counting term (TPU row 1, ``rank_counts(banded=
False)``); :func:`merge_ranks` runs the same CUDA kernel over all k sorted
runs of every stacked node in one launch and returns the merge ranks of a
butterfly layer directly.  The kernel (``csrc/rank_merge.cu``) binary-
searches each query instead of the TPU's dense compare plane; the plain
versions are in ``ref``.  Indices are int64 in [0, 2**32) (unsigned 32-bit
order).  The banded TPU variant is not ported yet.
"""
from __future__ import annotations

import math

import torch

from . import _build
from .ref import merge_ranks_ref, rank_counts_ref

_KERNEL = "rank_counts"


def _launch(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor, groups: int,
            q: int, na: int, s: int, nb: int, mode: int) -> None:
    _build.check_cuda(_KERNEL, a, b, out)
    with torch.cuda.device(a.device):
        _build.launch(_KERNEL, "repro_rank_counts", a.data_ptr(), b.data_ptr(),
                      out.data_ptr(), groups, q, na, s, nb, mode,
                      _build.stream_of(a))


def _check_index(name: str, *tensors) -> None:
    for t in tensors:
        if t.dtype != torch.int64:
            raise TypeError(f"{name}: indices must be int64, got {t.dtype}")


def rank_counts(a: torch.Tensor, b: torch.Tensor, *,
                strict: bool = True) -> torch.Tensor:
    """counts[..., i] = #{j : b[..., j] < a[..., i]} (strict) or <= (not
    strict), int32; a [..., Ca] and b [..., Cb] sorted int64 with equal
    leading (batch) dims.  CUDA tensors launch the kernel, CPU tensors run
    the plain version."""
    _check_index("rank_counts", a, b)
    if a.shape[:-1] != b.shape[:-1]:
        raise ValueError(f"rank_counts: batch dims {tuple(a.shape[:-1])} "
                         f"!= {tuple(b.shape[:-1])}")
    if a.device.type == "cpu":
        return rank_counts_ref(a, b, "left" if strict else "right")
    out = torch.empty(a.shape, dtype=torch.int32, device=a.device)
    _launch(a, b, out, math.prod(a.shape[:-1]), 1, a.shape[-1], 1,
            b.shape[-1], 1 if strict else 0)
    return out


def merge_ranks(runs: torch.Tensor) -> torch.Tensor:
    """Stable merge ranks of the k sorted runs of each group: runs
    [..., k, cap] int64 -> int32 [..., k, cap], a bijection onto
    [0, k*cap) per group.  Run r's entry i goes to ``i + sum_{s != r}``
    of its :func:`rank_counts` against run s, strict for ``s > r`` and
    non-strict for ``s < r`` (earlier runs win ties), one launch for all
    groups and run pairs."""
    _check_index("merge_ranks", runs)
    if runs.device.type == "cpu":
        return merge_ranks_ref(runs)
    k, cap = runs.shape[-2], runs.shape[-1]
    out = torch.empty(runs.shape, dtype=torch.int32, device=runs.device)
    _launch(runs, runs, out, math.prod(runs.shape[:-2]), k, cap, k, cap, 2)
    return out
