"""Plain PyTorch versions of every kernel (reference: ``repro.kernels.ref``).

Each function computes exactly what its CUDA kernel computes, batched over
the same leading dims.  A kernel wrapper runs these only for CPU tensors;
on the card they are what ``chip_smoke.py`` holds each kernel against.
They repeat the kernels' arithmetic and are no yardstick of speed.
"""
from __future__ import annotations

import math

import torch


def onehot_scatter_add_ref(pos: torch.Tensor, val: torch.Tensor,
                           num_rows: int) -> torch.Tensor:
    """out[..., p, :] = sum_{i: pos[..., i] == p} val[..., i, :] in f32;
    pos entries outside [0, num_rows) are dropped.  pos: [..., C], val:
    [..., C, W] -> out [..., num_rows, W].  On the CPU ``index_add_`` sums
    each row's sources in increasing i, the kernel's order."""
    lead, c, w = pos.shape[:-1], pos.shape[-1], val.shape[-1]
    b = math.prod(lead)
    p = pos.reshape(b, c).to(torch.int64)
    p = torch.where((p < 0) | (p >= num_rows), num_rows, p)
    flat = (torch.arange(b, device=pos.device).unsqueeze(1) * (num_rows + 1)
            + p).reshape(-1)
    out = torch.zeros(b * (num_rows + 1), w, dtype=torch.float32,
                      device=val.device)
    out.index_add_(0, flat, val.reshape(b * c, w).to(torch.float32))
    return out.reshape(b, num_rows + 1, w)[:, :num_rows].reshape(
        lead + (num_rows, w))


def rank_counts_ref(a: torch.Tensor, b: torch.Tensor, side: str) -> torch.Tensor:
    """counts[..., i] = #{j : b[..., j] < a[..., i]} (side='left') or <=
    (side='right'), int32; a, b int64 sorted in [0, 2**32)."""
    return torch.searchsorted(b.contiguous(), a.contiguous(),
                              right=(side == "right")).to(torch.int32)


def merge_ranks_ref(runs: torch.Tensor) -> torch.Tensor:
    """Stable merge rank of every entry of k sorted runs [..., k, cap]:
    ``i + sum_{s != r} #{j : runs[s][j] (<= if s < r else <) runs[r][i]}``,
    int32 [..., k, cap] (a bijection onto [0, k*cap) per group)."""
    k, cap = runs.shape[-2], runs.shape[-1]
    ranks = []
    for r in range(k):
        rk = torch.arange(cap, device=runs.device, dtype=torch.int32).expand(
            runs.shape[:-2] + (cap,))
        for s in range(k):
            if s != r:
                rk = rk + rank_counts_ref(runs[..., r, :], runs[..., s, :],
                                          "right" if s < r else "left")
        ranks.append(rk)
    return torch.stack(ranks, -2)


def spmv_ell_ref(cols: torch.Tensor, weights: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """ELL SpMV: y[..., r] = sum_k weights[..., r, k] * x[..., cols[..., r, k]].

    cols: int32 [..., R, K] (negative = padding), weights [..., R, K],
    x [..., N] -> f32 [..., R]."""
    lead, r, k = cols.shape[:-2], cols.shape[-2], cols.shape[-1]
    b = math.prod(lead)
    safe = cols.reshape(b, r * k).clamp(min=0).to(torch.int64)
    g = torch.gather(x.reshape(b, -1).to(torch.float32), 1, safe)
    g = g * (cols.reshape(b, r * k) >= 0)
    y = (weights.reshape(b, r * k).to(torch.float32) * g).reshape(b, r, k)
    return y.sum(-1).reshape(lead + (r,))
