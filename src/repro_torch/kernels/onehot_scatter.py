"""Deterministic row scatter-add, the merge-sum of the fused pipeline (reference: ``repro.kernels.onehot_scatter``).

Once each source row's destination ``pos`` is known (sorted indices make
it a cumsum), the paper's coherent merge-sum is

    out[p, :] = sum_{i : pos_i = p} val[i, :]

The TPU computes it as a one-hot matmul on the matrix unit (TPU row 3,
``onehot_scatter_add(scale=None)``).  The port's CUDA kernel
(``csrc/onehot_scatter.cu``) sums each output row over its sources in
increasing source order with no float atomics, so two launches on the same
input give the same bits.  The plain version is in ``ref``.  The scaled
(wire-decode) and banded TPU variants are not ported yet.
"""
from __future__ import annotations

import math

import torch

from . import _build
from .ref import onehot_scatter_add_ref

_KERNEL = "onehot_scatter_add"


def onehot_scatter_add(pos: torch.Tensor, val: torch.Tensor,
                       num_rows: int) -> torch.Tensor:
    """out[..., num_rows, W] (f32) = scatter-add of val [..., C, W] at rows
    pos [..., C] (int32), batched over the leading dims.  Any pos outside
    [0, num_rows) is dropped.  CUDA tensors launch the kernel (val must be
    float32), CPU tensors run the plain version."""
    if pos.dtype != torch.int32:
        raise TypeError(f"onehot_scatter_add: pos must be int32, got {pos.dtype}")
    if val.shape[:-1] != pos.shape:
        raise ValueError(f"onehot_scatter_add: val {tuple(val.shape)} does not "
                         f"match pos {tuple(pos.shape)} + (W,)")
    if pos.device.type == "cpu":
        return onehot_scatter_add_ref(pos, val, num_rows)
    if val.dtype != torch.float32:
        raise TypeError(f"onehot_scatter_add: val must be float32, got {val.dtype}")
    lead, c, w = pos.shape[:-1], pos.shape[-1], val.shape[-1]
    out = torch.empty(lead + (num_rows, w), dtype=torch.float32,
                      device=pos.device)
    _build.check_cuda(_KERNEL, pos, val, out)
    with torch.cuda.device(pos.device):
        _build.launch(_KERNEL, "repro_onehot_scatter_add", pos.data_ptr(),
                      val.data_ptr(), out.data_ptr(), math.prod(lead), c,
                      num_rows, w, _build.stream_of(pos))
    return out
