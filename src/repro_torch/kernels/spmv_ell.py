"""ELL SpMV kernel, PageRank's local product (reference: ``repro.kernels.spmv_ell``).

Edge-partitioned PageRank computes ``Q_i = G_i P_i`` on every node; after
the hash permutation the column structure is uniform, so ELL (fixed slots
per row, padded) is a natural layout.  The port's CUDA kernel
(``csrc/spmv_ell.cu``, TPU row 7) runs one warp per row over all stacked
nodes in one launch; the plain version is in ``ref``.
"""
from __future__ import annotations

import math

import torch

from . import _build
from .ref import spmv_ell_ref

_KERNEL = "spmv_ell"


def spmv_ell(cols: torch.Tensor, weights: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """y[..., r] = sum_k weights[..., r, k] * x[..., cols[..., r, k]];
    cols < 0 are padding, every other column must be < N (the kernel
    does not check it; ``graph.engine.stack_ell(n_cols=)`` does, once,
    when the tables are built).  cols int32 [..., R, K], weights f32 [..., R, K],
    x f32 [..., N] with the same leading (batch) dims -> f32 [..., R].
    CUDA tensors launch the kernel, CPU tensors run the plain version."""
    if cols.dtype != torch.int32:
        raise TypeError(f"spmv_ell: cols must be int32, got {cols.dtype}")
    if weights.shape != cols.shape or x.shape[:-1] != cols.shape[:-2]:
        raise ValueError(f"spmv_ell: shapes cols {tuple(cols.shape)}, weights "
                         f"{tuple(weights.shape)}, x {tuple(x.shape)}")
    if cols.device.type == "cpu":
        return spmv_ell_ref(cols, weights, x)
    if weights.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError("spmv_ell: weights and x must be float32")
    lead, r, k = cols.shape[:-2], cols.shape[-2], cols.shape[-1]
    y = torch.empty(lead + (r,), dtype=torch.float32, device=cols.device)
    _build.check_cuda(_KERNEL, cols, weights, x, y)
    with torch.cuda.device(cols.device):
        _build.launch(_KERNEL, "repro_spmv_ell", cols.data_ptr(),
                      weights.data_ptr(), x.data_ptr(), y.data_ptr(),
                      math.prod(lead), r, k, x.shape[-1],
                      _build.stream_of(cols))
    return y
