"""Plain union sum of every node's sparse vector.

The inputs are what the benchmark drew: ``idx`` [m, C] ids with
SENTINEL padding and ``val`` [m, C].  The union is the sorted distinct
ids over all nodes, each with the float64 sum of its values; every node
is owed the whole union.  ``dtype`` lower than float64 is the control:
the sums accumulated in that type.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

SENTINEL = (1 << 32) - 1


def union_sum(idx: torch.Tensor, val: torch.Tensor,
              dtype: torch.dtype = torch.float64
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(ids int64 [U], sums float64 [U])``."""
    valid = idx != SENTINEL
    ids, inv = torch.unique(idx[valid], sorted=True, return_inverse=True)
    sums = torch.zeros(ids.numel(), dtype=dtype, device=idx.device)
    sums.index_add_(0, inv, val[valid].to(dtype))
    return ids, sums.to(torch.float64)


def compare(oi: torch.Tensor, ov: torch.Tensor, want_i: torch.Tensor,
            want_v: torch.Tensor) -> Dict[str, float]:
    """Every node's returned ``(oi, ov)`` [m, out] against the union:
    ``idx_mismatch`` counts the slots whose id differs (the union's ids
    first, then SENTINEL in every slot after them, a union longer than
    the slots counting its missing ids), ``val_abs_err`` is the largest
    |value - sum| over the union's slots."""
    n = want_i.numel()
    out = oi.shape[1]
    k = min(n, out)
    mismatch = int((oi[:, :k] != want_i[:k]).sum()) + \
        int((oi[:, k:] != SENTINEL).sum()) + oi.shape[0] * (n - k)
    err = float((ov[:, :k].to(torch.float64) - want_v[:k]).abs().max()) \
        if k else 0.0
    return {"idx_mismatch": mismatch, "val_abs_err": err}
