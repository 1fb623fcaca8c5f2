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

from repro_torch.core.sparse_vec import SENTINEL


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


def banded_windows_ref(pos: torch.Tensor, num_rows: int,
                       bm: int) -> torch.Tensor:
    """The banded kernel's window table: int64 [..., T + 1], T =
    ceil(num_rows / bm), entry t the first i with ``pos[..., i] >=
    min(t * bm, num_rows)`` (C if none) -- the TPU's start table (one
    searchsorted per bm-row output tile) with one boundary more, the end
    of the last tile's window.  For non-decreasing ``pos`` output tile t's
    sources are ``[first[t], first[t + 1])``."""
    keys = torch.clamp(torch.arange(-(-num_rows // bm) + 1,
                                    device=pos.device) * bm, max=num_rows)
    keys = keys.to(pos.dtype).expand(pos.shape[:-1] + keys.shape)
    return torch.searchsorted(pos.contiguous(), keys.contiguous())


def rank_counts_ref(a: torch.Tensor, b: torch.Tensor, side: str) -> torch.Tensor:
    """counts[..., i] = #{j : b[..., j] < a[..., i]} (side='left') or <=
    (side='right'), int32; a, b int64 sorted in [0, 2**32)."""
    return torch.searchsorted(b.contiguous(), a.contiguous(),
                              right=(side == "right")).to(torch.int32)


def tile_classes(a: torch.Tensor, b: torch.Tensor, strict: bool, bm: int,
                 bn: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The TPU banded kernel's tile classes: a [..., Ca] in blocks of
    ``bm`` and b [..., Cb] in blocks of ``bn`` (each padded with SENTINEL
    to a block multiple), and (full, skip) boolean [..., I, J] -- the
    b-block wholly below every query of the a-block (b_hi < a_lo, or <=
    when not strict: it adds its length), or wholly above (b_lo >= a_hi,
    or >: it adds nothing); every other tile is a frontier tile."""
    a_lo, a_hi = (e.unsqueeze(-1) for e in _padded_edges(a, bm))
    b_lo, b_hi = (e.unsqueeze(-2) for e in _padded_edges(b, bn))
    full = b_hi < a_lo if strict else b_hi <= a_lo
    skip = b_lo >= a_hi if strict else b_lo > a_hi
    return full, skip & ~full


def _padded_edges(x: torch.Tensor, block: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(first, last) entry of every ``block``-entry block of sorted streams
    x [..., C], the last block padded with SENTINEL: [..., ceil(C/block)]
    each."""
    c = x.shape[-1]
    last = torch.arange(block - 1, -(-c // block) * block, block,
                        device=x.device)
    hi = x[..., last.clamp(max=c - 1)]
    hi = torch.where(last < c, hi, torch.full_like(hi, SENTINEL))
    return x[..., ::block], hi


def rank_counts_banded_ref(a: torch.Tensor, b: torch.Tensor, side: str,
                           bm: int, bn: int) -> torch.Tensor:
    """The banded kernel's counts, through its tile triage
    (:func:`tile_classes`).  Full blocks are a prefix of b and skipped ones
    a suffix, so a query's count is every entry of its tile's full blocks
    plus a search confined to the frontier window between them.  Equal to
    :func:`rank_counts_ref` for sorted a, b."""
    a, b = a.contiguous(), b.contiguous()
    ca, cb = a.shape[-1], b.shape[-1]
    full, skip = tile_classes(a, b, side == "left", bm, bn)
    nbb = full.shape[-1]
    w0 = (full.sum(-1) * bn).clamp(max=cb)
    w1 = ((nbb - skip.sum(-1)) * bn).clamp(max=cb)
    tile = torch.arange(ca, device=a.device) // bm
    inside = torch.searchsorted(b, a, right=side == "right")
    return torch.minimum(torch.maximum(inside, w0[..., tile]),
                         w1[..., tile]).to(torch.int32)


def merge_ranks_ref(runs: torch.Tensor,
                    banded: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Stable merge rank of every entry of k sorted runs [..., k, cap]:
    ``i + sum_{s != r} #{j : runs[s][j] (<= if s < r else <) runs[r][i]}``,
    int32 [..., k, cap] (a bijection onto [0, k*cap) per group).
    ``banded=(bm, bn)`` takes the counts through
    :func:`rank_counts_banded_ref` with those tiles."""
    k, cap = runs.shape[-2], runs.shape[-1]
    ranks = []
    for r in range(k):
        rk = torch.arange(cap, device=runs.device, dtype=torch.int32).expand(
            runs.shape[:-2] + (cap,))
        for s in range(k):
            if s != r:
                side = "right" if s < r else "left"
                a, b = runs[..., r, :], runs[..., s, :]
                rk = rk + (rank_counts_ref(a, b, side) if banded is None
                           else rank_counts_banded_ref(a, b, side, *banded))
        ranks.append(rk)
    return torch.stack(ranks, -2)


# ---------------------------------------------------------------------------
# Mirrors of the dense kernel's merge path (exercised by the CPU tests)
# ---------------------------------------------------------------------------

def merge_path_coranks(a: torch.Tensor, b: torch.Tensor, diag: torch.Tensor,
                       a_wins_ties: bool) -> torch.Tensor:
    """Co-rank of each diagonal d of ``diag`` (int64 [..., D]) in the merge
    of sorted a [..., Ca] and b [..., Cb]: how many of the merge's first d
    entries come from a, by the kernel's binary search -- the least i in
    [max(0, d - Cb), min(d, Ca)] whose a[i] does not come before
    b[d - 1 - i] (a comes first on ties when ``a_wins_ties``, else b)."""
    ca, cb = a.shape[-1], b.shape[-1]
    lo = (diag - cb).clamp(min=0)
    hi = diag.clamp(max=ca)
    if ca == 0 or cb == 0:
        return lo
    for _ in range(ca.bit_length() + 1):
        mid = (lo + hi) // 2
        x = a.gather(-1, mid.clamp(max=ca - 1))
        y = b.gather(-1, (diag - 1 - mid).clamp(0, cb - 1))
        first = (x <= y) if a_wins_ties else (x < y)
        go = lo < hi
        lo = torch.where(go & first, mid + 1, lo)
        hi = torch.where(go & ~first, mid, hi)
    return lo


def _merge_steps(a: torch.Tensor, b: torch.Tensor, a_wins_ties: bool):
    """Co-ranks at every diagonal 0..Ca+Cb, and which merge step takes a."""
    n = a.shape[-1] + b.shape[-1]
    d = torch.arange(n + 1, device=a.device).expand(a.shape[:-1] + (n + 1,))
    i = merge_path_coranks(a, b, d.contiguous(), a_wins_ties)
    return d, i, i[..., 1:] > i[..., :-1]


def merge_path_counts_ref(a: torch.Tensor, b: torch.Tensor,
                          side: str) -> torch.Tensor:
    """:func:`rank_counts_ref` through the merge path: step d of the merge
    takes a[i] when the co-rank rises from i, and that entry's count is
    d - i (ties: a first for side='left', b first for 'right')."""
    ca = a.shape[-1]
    d, i, take = _merge_steps(a, b, side == "left")
    counts = torch.zeros(a.shape[:-1] + (ca + 1,), dtype=torch.int64,
                         device=a.device)
    counts.scatter_(-1, torch.where(take, i[..., :-1], ca),
                    d[..., :-1] - i[..., :-1])
    return counts[..., :ca].to(torch.int32)


def merge_tree_ranks_ref(runs: torch.Tensor) -> torch.Tensor:
    """:func:`merge_ranks_ref` through the dense kernel's merge tree: each
    entry becomes the key (value << 31) | origin, origin = r * cap + i
    (the kernel packs value << 32 into uint64: the same order), so keys
    are distinct and ordered by (value, run, position); ceil(log2 k)
    levels (at least one) merge adjacent segments of 2^l runs pairwise by
    co-ranks (an odd segment passes through), and the last level gives
    each origin its merged position."""
    lead, k, cap = runs.shape[:-2], runs.shape[-2], runs.shape[-1]
    n = k * cap
    keys = (runs.reshape(lead + (n,)) << 31) | torch.arange(
        n, device=runs.device)
    levels = max(1, (k - 1).bit_length())
    for level in range(levels):
        seg = cap << level
        parts = []
        for a0 in range(0, n, 2 * seg):
            a, b = keys[..., a0:a0 + seg], keys[..., a0 + seg:a0 + 2 * seg]
            if b.shape[-1] == 0:
                parts.append(a)
                continue
            d, i, take = _merge_steps(a, b, True)
            d, i = d[..., :-1], i[..., :-1]
            parts.append(torch.where(
                take, a.gather(-1, i.clamp(max=a.shape[-1] - 1)),
                b.gather(-1, (d - i).clamp(max=b.shape[-1] - 1))))
        keys = torch.cat(parts, -1)
    ranks = torch.empty(lead + (n,), dtype=torch.int32, device=runs.device)
    ranks.scatter_(-1, keys & (2**31 - 1), torch.arange(
        n, dtype=torch.int32, device=runs.device).expand(lead + (n,)))
    return ranks.reshape(runs.shape)


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


def trim_runs_ref(idx: torch.Tensor, val: torch.Tensor, run_length: int,
                  cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first ``cap`` valid rows of ``idx`` int64 [..., C] and ``val``
    [..., C] or [..., C, W...] in order, SENTINEL and zero values after them
    -> (idx [..., cap], val [..., cap(, W...)]): a cumulative sum of the
    valid flags places each kept row, one scatter moves the indices and
    one the values into a drop bin past ``cap``.  It holds for any layout
    of the valid rows; ``run_length`` (the kernel's S = C / run_length
    sorted runs) is taken for the wrapper's signature and not used.  The
    values are copied, never summed."""
    valid = idx != SENTINEL
    pos = torch.cumsum(valid, -1) - 1
    dest = torch.where(valid & (pos < cap), pos, cap)
    lead = idx.shape[:-1]
    out_idx = torch.full(lead + (cap + 1,), SENTINEL, dtype=torch.int64,
                         device=idx.device).scatter_(-1, dest, idx)
    wshape = val.shape[idx.ndim:]
    rows = valid.reshape(valid.shape + (1,) * len(wshape))
    masked = torch.where(rows, val, torch.zeros_like(val))
    out_val = torch.zeros(lead + (cap + 1,) + wshape, dtype=val.dtype,
                          device=val.device)
    d = dest.reshape(dest.shape + (1,) * len(wshape)).expand(masked.shape)
    out_val.scatter_(idx.ndim - 1, d, masked)
    return out_idx[..., :cap], out_val[(..., slice(0, cap))
                                       + (slice(None),) * len(wshape)]
