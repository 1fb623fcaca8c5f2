"""Run compaction of the union path's gathered chunk (no TPU kernel behind it).

After the up-gathers of the union butterfly every node holds S equal runs
of the last merged capacity, each sorted with its valid rows first and
SENTINEL padding after; the reduce returns their valid prefixes laid end
to end, cut to the out capacity.  The JAX package computes that trim
with a cumulative sum of the valid flags and a scatter over every slot;
on the card the port launches one hand-written kernel
(``csrc/trim_runs.cu``) that reads each kept row once and writes every
output slot once.  The plain version, ``ref.trim_runs_ref``, is that
scan-and-scatter trim, which assumes nothing of the runs.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from . import _build
from .ref import trim_runs_ref


def trim_runs(idx: torch.Tensor, val: torch.Tensor, run_length: int,
              cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first ``cap`` valid rows of ``idx`` int64 [..., C] and ``val``
    [..., C] or [..., C, W...], where each chunk is S = C / ``run_length``
    runs of ``run_length`` slots, each sorted with its valid rows first and
    SENTINEL after; returns (idx [..., cap], val [..., cap(, W...)]), the
    runs' valid prefixes in order, SENTINEL and zero values after them.
    Values are copied, not summed.  CUDA tensors (contiguous) launch the
    kernel, CPU tensors run the plain version, meta tensors get empty
    outputs of the result's shape."""
    if idx.dtype != torch.int64:
        raise TypeError(f"trim_runs: idx must be int64, got {idx.dtype}")
    if val.dtype == torch.bool or val.dtype.is_complex:
        raise TypeError(f"trim_runs: no kernel for {val.dtype} values")
    if idx.ndim < 1 or val.shape[:idx.ndim] != idx.shape:
        raise ValueError(f"trim_runs: shapes idx {tuple(idx.shape)}, val "
                         f"{tuple(val.shape)}")
    c = idx.shape[-1]
    if run_length < 1 or c % run_length:
        raise ValueError(f"trim_runs: {c} slots are not whole runs of "
                         f"{run_length}")
    if cap < 0:
        raise ValueError(f"trim_runs: capacity {cap} < 0")
    if idx.device.type == "cpu":
        return trim_runs_ref(idx, val, run_length, cap)
    lead, wshape = idx.shape[:-1], val.shape[idx.ndim:]
    out_idx = torch.empty(lead + (cap,), dtype=torch.int64, device=idx.device)
    out_val = torch.empty(lead + (cap,) + wshape, dtype=val.dtype,
                          device=val.device)
    if idx.device.type == "meta":       # a dry run's trace: shapes only
        return out_idx, out_val
    _build.check_cuda("trim_runs", idx, val)
    batch = math.prod(lead)
    if batch == 0 or cap == 0:
        return out_idx, out_val
    off = torch.empty(batch, c // run_length + 1, dtype=torch.int64,
                      device=idx.device)
    with torch.cuda.device(idx.device):
        _build.launch("trim_runs", "repro_trim_runs", idx.data_ptr(),
                      val.data_ptr(), off.data_ptr(), out_idx.data_ptr(),
                      out_val.data_ptr(), batch, c, run_length, cap,
                      math.prod(wshape) * val.element_size(),
                      _build.stream_of(idx))
    return out_idx, out_val
