"""Sorted fixed-capacity sparse vectors + hash permutation (reference: ``repro.core.sparse_vec``).

The paper (§III-A) hash-permutes vertex indices so that contiguous range
partitions are balanced, keeps indices sorted, and sums by coherent merges
of sorted streams.  Two representations live here:

* host (numpy): variable-length sorted ``(idx, val)`` pairs for the
  simulator and the host ``config`` planning;
* device (torch): fixed-capacity :class:`SparseChunk`, batched over any
  leading dims -- ``idx`` int64 ``[..., C]`` sorted ascending with
  ``SENTINEL`` padding at the tail, ``val`` ``[..., C]`` or
  ``[..., C, W]``.

Hashed indices live in ``[0, 2**32)``.  Torch's ``uint32`` lacks ``<``,
``searchsorted`` and ``-``, so the port holds them as ``int64`` with
``SENTINEL = 2**32 - 1``: int64 order on that range *is* unsigned 32-bit
order, which replaces the reference's biased-int32 ``searchsorted`` trick
with plain comparisons.  Convert to ``uint32`` numpy only to compare with
the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

# Sentinel index: sorts after every real index (uint32 max).
SENTINEL = (1 << 32) - 1
_MASK32 = (1 << 32) - 1
# Knuth multiplicative constant (odd => bijection on uint32).
_KNUTH = 2654435761


# ---------------------------------------------------------------------------
# Hash permutation (paper §III-A: "random hash to the vertex indices")
# ---------------------------------------------------------------------------

def _egcd_inv_u32(a: int) -> int:
    """Modular inverse of odd ``a`` modulo 2**32 (Newton iteration)."""
    assert a % 2 == 1
    x = a
    for _ in range(5):
        x = (x * (2 - a * x)) % (1 << 64)
    return x % (1 << 32)


def _mul_u32(x: torch.Tensor, m: int) -> torch.Tensor:
    """``(x * m) mod 2**32`` for int64 ``x`` in [0, 2**32) without int64
    overflow: split ``m`` into 16-bit halves."""
    lo, hi = m & 0xFFFF, m >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK32


@dataclasses.dataclass(frozen=True)
class HashPerm:
    """Bijective affine-xor permutation of the uint32 index space:
    ``fwd(i) = ((i ^ s) * m) mod 2^32`` with odd multiplier ``m``."""

    mult: int
    xor: int

    @staticmethod
    def make(seed: int) -> "HashPerm":
        """Seeded random permutation (odd multiplier mixed with Knuth's);
        draws exactly as the reference does, so equal seeds give equal
        permutations."""
        rng = np.random.RandomState(seed)
        m = int(rng.randint(0, 1 << 31)) * 2 + 1
        m = (m * _KNUTH) % (1 << 32)
        if m % 2 == 0:
            m += 1
        s = int(rng.randint(0, 1 << 31))
        return HashPerm(mult=m, xor=s)

    def fwd_np(self, idx: np.ndarray) -> np.ndarray:
        """Hash uint32 indices into the permuted space (host numpy)."""
        i = idx.astype(np.uint64)
        out = ((i ^ np.uint64(self.xor)) * np.uint64(self.mult)) % (1 << 32)
        return out.astype(np.uint32)

    def inv_np(self, h: np.ndarray) -> np.ndarray:
        """Invert :meth:`fwd_np` (host numpy)."""
        minv = np.uint64(_egcd_inv_u32(self.mult))
        i = (h.astype(np.uint64) * minv) % (1 << 32)
        return (i.astype(np.uint32) ^ np.uint32(self.xor))

    def fwd(self, idx: torch.Tensor) -> torch.Tensor:
        """Hash int64 indices in [0, 2**32) into the permuted space."""
        return _mul_u32(idx.to(torch.int64) ^ self.xor, self.mult)

    def inv(self, h: torch.Tensor) -> torch.Tensor:
        """Invert :meth:`fwd`."""
        return _mul_u32(h.to(torch.int64), _egcd_inv_u32(self.mult)) ^ self.xor


IDENTITY_PERM = HashPerm(mult=1, xor=0)


# ---------------------------------------------------------------------------
# Host-side variable-length sorted sparse vectors (simulator / config)
# ---------------------------------------------------------------------------

def sort_coalesce_np(idx: np.ndarray, val: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Sort by index and sum duplicates.  val: [N] or [N, W]."""
    if idx.size == 0:
        return idx.astype(np.uint32), val
    order = np.argsort(idx, kind="stable")
    idx = idx[order]
    val = val[order]
    uniq, inv = np.unique(idx, return_inverse=True)
    summed = np.zeros((uniq.shape[0],) + val.shape[1:], dtype=val.dtype)
    np.add.at(summed, inv, val)
    return uniq.astype(np.uint32), summed


def merge_add_np(a_idx, a_val, b_idx, b_val):
    """Merge two sorted sparse vectors, summing index collisions."""
    return sort_coalesce_np(np.concatenate([a_idx, b_idx]),
                            np.concatenate([a_val, b_val], axis=0))


def tree_sum_np(parts):
    """Paper §III-A tree summation: pairwise merge up to a root."""
    parts = list(parts)
    if not parts:
        raise ValueError("tree_sum of zero parts")
    while len(parts) > 1:
        nxt = []
        for i in range(0, len(parts) - 1, 2):
            nxt.append(merge_add_np(*parts[i], *parts[i + 1]))
        if len(parts) % 2 == 1:
            nxt.append(parts[-1])
        parts = nxt
    return parts[0]


# ---------------------------------------------------------------------------
# Device-side fixed-capacity chunks (batched over leading dims)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SparseChunk:
    """Fixed-capacity sorted sparse vectors, batched over leading dims.

    idx: int64 [..., C]  sorted ascending, SENTINEL padding at the tail
    val: [..., C] or [..., C, W]  rows beyond the valid prefix are zero
    """

    idx: torch.Tensor
    val: torch.Tensor

    @property
    def capacity(self) -> int:
        """Static slot count C (valid entries + SENTINEL padding)."""
        return self.idx.shape[-1]

    @property
    def width(self) -> int:
        """Trailing value width W (1 for scalar-per-index chunks)."""
        return 1 if self.val.ndim == self.idx.ndim else self.val.shape[-1]

    def valid_mask(self) -> torch.Tensor:
        """bool [..., C]: True on non-padding slots."""
        return self.idx != SENTINEL

    def count(self) -> torch.Tensor:
        """Number of valid entries per chunk, [...] int64."""
        return self.valid_mask().sum(-1)


def _rows_like(mask: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-row [..., C] tensor against ``val`` [..., C(, W)]."""
    return mask if val.ndim == mask.ndim else mask.unsqueeze(-1)


def _mask_val(mask: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    return torch.where(_rows_like(mask, val), val, torch.zeros_like(val))


def _take_rows(val: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``val[..., pos, (W)]`` along the row dim of a [..., C(, W)] tensor."""
    if val.ndim == pos.ndim:
        return torch.gather(val, -1, pos)
    return torch.gather(val, -2, pos.unsqueeze(-1).expand(
        pos.shape + val.shape[-1:]))


def _put_rows(out: torch.Tensor, dest: torch.Tensor, src: torch.Tensor,
              add: bool) -> torch.Tensor:
    """Row scatter (set or add) of ``src`` [..., C(, W)] into ``out``
    [..., R(, W)] at row ``dest`` [..., C], in place."""
    if src.ndim == dest.ndim:
        return out.scatter_add_(-1, dest, src) if add else \
            out.scatter_(-1, dest, src)
    d = dest.unsqueeze(-1).expand(dest.shape + src.shape[-1:])
    return out.scatter_add_(-2, d, src) if add else out.scatter_(-2, d, src)


def _drop_last_row(t: torch.Tensor, rows_dim_from_end: int) -> torch.Tensor:
    return t[..., :-1] if rows_dim_from_end == 1 else t[..., :-1, :]


def head_flags(idx: torch.Tensor) -> torch.Tensor:
    """bool [..., C]: first occurrence of each valid index in a sorted
    stream (the duplicate-group heads the compaction keeps)."""
    first = torch.ones(idx.shape[:-1] + (1,), dtype=torch.bool,
                       device=idx.device)
    return torch.cat([first, idx[..., 1:] != idx[..., :-1]], -1) \
        & (idx != SENTINEL)


def sort_chunk(idx: torch.Tensor, val: torch.Tensor) -> SparseChunk:
    """Stable sort of (idx, val) rows ascending by idx (sentinels sink)."""
    sidx, order = torch.sort(idx, dim=-1, stable=True)
    return SparseChunk(idx=sidx, val=_take_rows(val, order))


def segment_compact(chunk: SparseChunk, out_capacity: Optional[int] = None,
                    use_kernel: bool = False) -> SparseChunk:
    """Coalesce duplicate indices of a *sorted* chunk; pad to out_capacity.

    Plain torch path (the sort path's oracle); ``use_kernel`` switches to
    the kernel-backed ``repro_torch.kernels.ops.segment_compact``.  On
    CUDA the value sum is a float ``scatter_add_`` (atomics), so it may
    differ from run to run in the last ulp; on dyadic values it is exact.
    """
    if use_kernel:
        from repro_torch.kernels import ops as _kops
        return _kops.segment_compact(chunk, out_capacity)
    idx, val = chunk.idx, chunk.val
    out_capacity = out_capacity or idx.shape[-1]
    valid = idx != SENTINEL
    is_head = head_flags(idx)
    pos = torch.cumsum(is_head, -1) - 1
    pos = torch.where(valid & (pos < out_capacity), pos, out_capacity)
    lead = idx.shape[:-1]
    out_idx = torch.full(lead + (out_capacity + 1,), SENTINEL,
                         dtype=torch.int64, device=idx.device)
    out_idx.scatter_(-1, torch.where(is_head, pos, out_capacity), idx)
    out_val = torch.zeros(lead + (out_capacity + 1,) + val.shape[idx.ndim:],
                          dtype=val.dtype, device=val.device)
    _put_rows(out_val, pos, _mask_val(valid, val), add=True)
    return SparseChunk(idx=out_idx[..., :-1],
                       val=_drop_last_row(out_val, val.ndim - idx.ndim + 1))


def compact_overflow(chunk: SparseChunk, out_capacity: int) -> torch.Tensor:
    """Unique indices per chunk that do not fit in out_capacity, [...]."""
    n_unique = head_flags(chunk.idx).sum(-1)
    return torch.clamp(n_unique - out_capacity, min=0)


def merge_add(a: SparseChunk, b: SparseChunk, out_capacity: Optional[int] = None,
              use_kernel: bool = False) -> SparseChunk:
    """Merge-add two sorted chunks (paper's pairwise tree-merge step)."""
    if use_kernel:
        from repro_torch.kernels import ops as _kops
        return _kops.merge_add(a, b, out_capacity)
    row_dim = a.idx.ndim - 1
    idx = torch.cat([a.idx, b.idx], -1)
    val = torch.cat([a.val, b.val], row_dim)
    out_capacity = out_capacity or (a.capacity + b.capacity)
    return segment_compact(sort_chunk(idx, val), out_capacity)


def tree_sum(chunks, out_capacity: Optional[int] = None) -> SparseChunk:
    """Tree-sum a list of sorted chunks (static shapes)."""
    chunks = list(chunks)
    while len(chunks) > 1:
        nxt = []
        for i in range(0, len(chunks) - 1, 2):
            nxt.append(merge_add(chunks[i], chunks[i + 1]))
        if len(chunks) % 2 == 1:
            nxt.append(chunks[-1])
        chunks = nxt
    out = chunks[0]
    if out_capacity is not None and out_capacity != out.capacity:
        out = segment_compact(out, out_capacity)
    return out


def bucket_partition(chunk: SparseChunk, edges: torch.Tensor, k: int,
                     bucket_capacity: int) -> Tuple[SparseChunk, torch.Tensor]:
    """Split sorted chunks into k range-buckets of fixed capacity.

    ``edges``: int64 [..., k+1] monotone range boundaries, one row per
    chunk.  Returns (buckets with idx [..., k, cap] / val [..., k, cap(,
    W)], overflow [...]).  A sorted chunk makes each bucket a contiguous
    slab, so entry j of bucket b sits at offset ``j - start_b``.
    """
    idx, val = chunk.idx, chunk.val
    lead, c = idx.shape[:-1], idx.shape[-1]
    valid = idx != SENTINEL
    start = torch.searchsorted(idx.contiguous(), edges[..., :-1].contiguous())
    bucket = torch.searchsorted(edges[..., 1:].contiguous(), idx.contiguous(),
                                right=True).clamp_(0, k - 1)
    offset = torch.arange(c, device=idx.device) - torch.gather(start, -1, bucket)
    ok = valid & (offset >= 0) & (offset < bucket_capacity)
    overflow = (valid & ~ok).sum(-1)
    dest = torch.where(ok, bucket * bucket_capacity + offset,
                       k * bucket_capacity)
    n = k * bucket_capacity + 1
    out_idx = torch.full(lead + (n,), SENTINEL, dtype=torch.int64,
                         device=idx.device).scatter_(-1, dest, idx)
    wshape = val.shape[idx.ndim:]
    out_val = torch.zeros(lead + (n,) + wshape, dtype=val.dtype,
                          device=val.device)
    _put_rows(out_val, dest, _mask_val(ok, val), add=False)
    out_val = _drop_last_row(out_val, len(wshape) + 1)
    return (SparseChunk(idx=out_idx[..., :-1].reshape(lead + (k, bucket_capacity)),
                        val=out_val.reshape(lead + (k, bucket_capacity) + wshape)),
            overflow)


def concat_sorted_groups(idx: torch.Tensor, val: torch.Tensor) -> SparseChunk:
    """Flatten [..., k, cap(, W)] group buckets into sorted chunks [..., k*cap]."""
    lead = idx.shape[:-2]
    flat_idx = idx.reshape(lead + (-1,))
    flat_val = val.reshape(lead + (-1,) + val.shape[idx.ndim:])
    return sort_chunk(flat_idx, flat_val)


def lookup(chunk: SparseChunk, query_idx: torch.Tensor) -> torch.Tensor:
    """Gather values of ``query_idx`` [..., Q] from sorted chunks (0 if
    missing)."""
    pos = torch.searchsorted(chunk.idx.contiguous(), query_idx.contiguous())
    pos = pos.clamp_(0, chunk.capacity - 1)
    hit = torch.gather(chunk.idx, -1, pos) == query_idx
    return _mask_val(hit, _take_rows(chunk.val, pos))
