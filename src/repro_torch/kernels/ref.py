"""Plain PyTorch versions of every kernel (reference: ``repro.kernels.ref``).

Each function computes exactly what its CUDA kernel computes, batched over
the same leading dims.  A kernel wrapper runs these only for CPU tensors;
on the card they are what ``chip_smoke.py`` holds each kernel against.
They repeat the kernels' arithmetic and are no yardstick of speed.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def onehot_scatter_add_ref(pos: torch.Tensor, val: torch.Tensor,
                           num_rows: int,
                           scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[..., p, :] = sum_{i: pos[..., i] == p} val[..., i, :] (times
    ``scale[..., i]`` when given) in f32; pos entries outside [0, num_rows)
    are dropped.  pos: [..., C], val: [..., C, W] (f32, bf16 or int8),
    scale: [..., C] f32 -> out [..., num_rows, W].  Each source row is
    widened (and scaled) in f32 first, then summed; on the CPU
    ``index_add_`` sums each row's sources in increasing i, the kernels'
    order."""
    lead, c, w = pos.shape[:-1], pos.shape[-1], val.shape[-1]
    b = math.prod(lead)
    p = pos.reshape(b, c).to(torch.int64)
    p = torch.where((p < 0) | (p >= num_rows), num_rows, p)
    flat = (torch.arange(b, device=pos.device).unsqueeze(1) * (num_rows + 1)
            + p).reshape(-1)
    src = val.reshape(b * c, w).to(torch.float32)
    if scale is not None:
        src = src * scale.reshape(b * c, 1).to(torch.float32)
    out = torch.zeros(b * (num_rows + 1), w, dtype=torch.float32,
                      device=val.device)
    out.index_add_(0, flat, src)
    return out.reshape(b, num_rows + 1, w)[:, :num_rows].reshape(
        lead + (num_rows, w))


def row_order_ref(pos: torch.Tensor, num_rows: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scatter's counting layout: ``perm`` = a stable argsort of the
    destinations (those outside [0, num_rows) sorted last as ``num_rows``)
    and ``offsets`` = the exclusive cumsum of each row's source count,
    int32 [..., C] and [..., num_rows + 1]."""
    lead, c = pos.shape[:-1], pos.shape[-1]
    b = math.prod(lead)
    key = pos.reshape(b, c).to(torch.int64)
    key = torch.where((key < 0) | (key >= num_rows), num_rows, key)
    perm = torch.argsort(key, dim=-1, stable=True)
    flat = (torch.arange(b, device=pos.device).unsqueeze(1) * (num_rows + 1)
            + key).reshape(-1)
    counts = torch.bincount(flat, minlength=b * (num_rows + 1)).reshape(
        b, num_rows + 1)
    offsets = torch.zeros(b, num_rows + 1, dtype=torch.int64,
                          device=pos.device)
    offsets[:, 1:] = torch.cumsum(counts[:, :-1], -1)
    return (perm.to(torch.int32).reshape(lead + (c,)),
            offsets.to(torch.int32).reshape(lead + (num_rows + 1,)))


def banded_onehot_scatter_add_ref(pos: torch.Tensor, val: torch.Tensor,
                                  num_rows: int, band: int,
                                  scale: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """The banded scatter's result: for non-decreasing ``pos`` with at
    most ``band`` sources per row in [0, num_rows) -- the kernel's
    precondition, under which each block's source window holds every
    source of its rows -- it is :func:`onehot_scatter_add_ref`."""
    if band < 1:
        raise ValueError(f"band must be >= 1, got {band}")
    return onehot_scatter_add_ref(pos, val, num_rows, scale)


def rank_counts_ref(a: torch.Tensor, b: torch.Tensor, side: str) -> torch.Tensor:
    """counts[..., i] = #{j : b[..., j] < a[..., i]} (side='left') or <=
    (side='right'), int32; a, b int64 sorted in [0, 2**32)."""
    return torch.searchsorted(b.contiguous(), a.contiguous(),
                              right=(side == "right")).to(torch.int32)


def rank_counts_banded_ref(a: torch.Tensor, b: torch.Tensor, side: str,
                           bm: int) -> torch.Tensor:
    """The banded kernel's counts, through its window arithmetic: query
    tile t of ``bm`` entries of a, with edges ``lo``/``hi`` (its first and
    last entry), counts every b before the window ``[w0, w1) =
    [search(lo), search(hi))`` in full and none after it, and searches
    only inside it.  Equal to :func:`rank_counts_ref` for sorted a, b."""
    a, b = a.contiguous(), b.contiguous()
    ca = a.shape[-1]
    first = torch.arange(0, ca, bm, device=a.device)
    last = (first + bm).clamp(max=ca) - 1
    right = side == "right"
    w0 = torch.searchsorted(b, a[..., first].contiguous(), right=right)
    w1 = torch.searchsorted(b, a[..., last].contiguous(), right=right)
    tile = torch.arange(ca, device=a.device) // bm
    inside = torch.searchsorted(b, a, right=right)
    return torch.minimum(torch.maximum(inside, w0[..., tile]),
                         w1[..., tile]).to(torch.int32)


def merge_ranks_ref(runs: torch.Tensor, banded_bm: Optional[int] = None
                    ) -> torch.Tensor:
    """Stable merge rank of every entry of k sorted runs [..., k, cap]:
    ``i + sum_{s != r} #{j : runs[s][j] (<= if s < r else <) runs[r][i]}``,
    int32 [..., k, cap] (a bijection onto [0, k*cap) per group).
    ``banded_bm`` takes the counts through :func:`rank_counts_banded_ref`
    with that query tile."""
    k, cap = runs.shape[-2], runs.shape[-1]
    ranks = []
    for r in range(k):
        rk = torch.arange(cap, device=runs.device, dtype=torch.int32).expand(
            runs.shape[:-2] + (cap,))
        for s in range(k):
            if s != r:
                side = "right" if s < r else "left"
                a, b = runs[..., r, :], runs[..., s, :]
                rk = rk + (rank_counts_ref(a, b, side) if banded_bm is None
                           else rank_counts_banded_ref(a, b, side, banded_bm))
        ranks.append(rk)
    return torch.stack(ranks, -2)


def spmv_csr_ref(row_ptr: torch.Tensor, cols: torch.Tensor,
                 wts: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Stacked-CSR SpMV: y[r] = sum_{j in [row_ptr[r], row_ptr[r+1])}
    wts[j] * x[node(r), cols[j]] with node(r) = r // n_rows, where x is
    [M, N] and row_ptr [M * n_rows + 1]: a gather and a segment sum
    (``index_add_`` over each nonzero's row) -> f32 [M, n_rows]."""
    m = x.shape[0]
    r = row_ptr.shape[0] - 1
    n_rows = r // m if m else 0
    lens = (row_ptr[1:] - row_ptr[:-1]).to(torch.int64)
    row = torch.repeat_interleave(torch.arange(r, device=x.device), lens)
    xi = (row // max(n_rows, 1)) * x.shape[-1] + cols.to(torch.int64)
    prod = wts.to(torch.float32) * x.reshape(-1).to(torch.float32)[xi]
    y = torch.zeros(r, dtype=torch.float32, device=x.device)
    return y.index_add_(0, row, prod).reshape(m, n_rows)


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
