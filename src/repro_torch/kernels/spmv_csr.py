"""Stacked-CSR SpMV kernel, PageRank's local product on the card (reference: ``repro.kernels.spmv_ell``).

Edge-partitioned PageRank computes ``Q_i = G_i P_i`` on every node.  The
reference multiplies padded ELL tables (fixed slots per row); power-law
hub rows set the slot count, so on one card the padding, not the edges,
would set the memory and the time.  The port's main path multiplies the
block-diagonal CSR of :func:`repro_torch.graph.engine.stack_csr` instead
(``csrc/spmv_csr.cu``, TPU row 7; the ported ELL kernel stays in
``spmv_ell``): no padding, all stacked nodes in one launch, the rows cut
into balanced bins by :func:`csr_bins` once per graph.  The bin limits
live here alone and reach the kernel as launch arguments.  The plain
version is in ``ref``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build
from .ref import spmv_csr_ref

# A row longer than CSR_LONG gets a bin of its own; every other bin holds
# at most CSR_BIN_ROWS rows and CSR_BIN_NNZ nonzeros of one node.  Picked
# by a sweep on the card at the smoke's graph: 4 products a thread beat 8
# and 16; shorter serial sums beat fewer long-row blocks down to 128.
CSR_LONG, CSR_BIN_NNZ, CSR_BIN_ROWS = 128, 1024, 512


def csr_bins(row_ptr: np.ndarray, n_rows: int) -> np.ndarray:
    """Row starts ``[nbins + 1]`` (int32) of the bins one block each of the
    CSR kernel takes: cuts before and after every row longer than
    ``CSR_LONG``, at every node boundary (multiples of ``n_rows``), every
    ``CSR_BIN_ROWS`` rows, and at the first row whose start reaches each
    multiple of ``CSR_BIN_NNZ - CSR_LONG`` nonzeros.  Between two cuts the
    rows' starts differ by less than that step and none is longer than
    ``CSR_LONG``, so a bin of several rows holds at most ``CSR_BIN_NNZ``
    nonzeros.  Host numpy, once per graph."""
    row_ptr = np.asarray(row_ptr, np.int64)
    r = len(row_ptr) - 1
    if r <= 0:
        return np.zeros(1, np.int32)
    if r >= 2**31:
        raise ValueError(f"csr_bins: {r} rows do not fit int32 bin starts")
    starts = row_ptr[:-1]
    long_rows = np.flatnonzero(np.diff(row_ptr) > CSR_LONG)
    step = CSR_BIN_NNZ - CSR_LONG
    cuts = np.concatenate([
        [0, r], long_rows, long_rows + 1,
        np.arange(0, r, max(n_rows, 1)), np.arange(0, r, CSR_BIN_ROWS),
        np.searchsorted(starts, np.arange(0, int(row_ptr[-1]), step))])
    return np.unique(cuts[cuts <= r]).astype(np.int32)


def spmv_csr(row_ptr: torch.Tensor, cols: torch.Tensor, wts: torch.Tensor,
             x: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """y[m, r] = sum_j wts[j] * x[m, cols[j]] over row m * n_rows + r of
    the stacked block-diagonal CSR (``row_ptr`` int32 or int64 [M * n_rows
    + 1], ``cols`` int32 node-local and ``wts`` f32 [nnz]), x f32 [M, N]
    -> f32 [M, n_rows].  ``bins``: :func:`csr_bins` of ``row_ptr`` (int32,
    the kernel's work split).  Every column must be < N (the kernel does
    not check it; ``graph.engine.stack_csr(n_cols=)`` does, once).  CUDA
    tensors launch the kernel, CPU tensors run the plain version."""
    if cols.dtype != torch.int32 or bins.dtype != torch.int32:
        raise TypeError(f"spmv_csr: cols and bins must be int32, got "
                        f"{cols.dtype} and {bins.dtype}")
    if row_ptr.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"spmv_csr: row_ptr must be int32 or int64, got "
                        f"{row_ptr.dtype}")
    m = x.shape[0]
    r = row_ptr.shape[0] - 1
    if (x.ndim != 2 or wts.shape != cols.shape or cols.ndim != 1
            or row_ptr.ndim != 1 or (r % m if m else r) != 0):
        raise ValueError(f"spmv_csr: shapes row_ptr {tuple(row_ptr.shape)}, "
                         f"cols {tuple(cols.shape)}, wts {tuple(wts.shape)},"
                         f" x {tuple(x.shape)}")
    if row_ptr.device.type == "cpu":
        return spmv_csr_ref(row_ptr, cols, wts, x)
    if wts.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError("spmv_csr: wts and x must be float32")
    n_rows = r // m if m else 0
    y = torch.empty(m, n_rows, dtype=torch.float32, device=x.device)
    _build.check_cuda("spmv_csr", row_ptr, cols, wts, x, y, bins)
    with torch.cuda.device(x.device):
        _build.launch("spmv_csr", "repro_spmv_csr", row_ptr.data_ptr(),
                      cols.data_ptr(), wts.data_ptr(), x.data_ptr(),
                      y.data_ptr(), bins.data_ptr(), bins.shape[0] - 1,
                      n_rows, x.shape[-1], int(row_ptr.dtype == torch.int64),
                      CSR_LONG, CSR_BIN_NNZ, CSR_BIN_ROWS, _build.stream_of(x))
    return y
