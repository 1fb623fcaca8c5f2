"""Deterministic row scatter-add, the merge-sum of the kernel merges (reference: ``repro.kernels.onehot_scatter``).

Once each source row's destination ``pos`` is known (sorted indices make
it a cumsum), the paper's coherent merge-sum is

    out[p, :] = sum_{i : pos_i = p} val[i, :] (* scale[i])

The TPU computes it as a one-hot matmul on the matrix unit.  The port's
CUDA kernels sum each output row over its sources in increasing source
order with no float atomics, so two launches on the same input give the
same bits:

* :func:`onehot_scatter_add` (``csrc/onehot_scatter.cu``, TPU rows 3 and
  4): any order of ``pos``; a stable counting layout (radix passes over
  the destination's digits, :func:`row_order`) puts each row's sources
  next to each other in increasing source order, and each row then sums
  its run;
* :func:`banded_onehot_scatter_add` (``csrc/banded_onehot_scatter.cu``,
  TPU rows 5 and 6): non-decreasing ``pos`` with at most ``band`` sources
  per row; one small launch builds the table of each ``BANDED_ROWS``-row
  output tile's source window (:func:`banded_windows`, the TPU's
  start-block table), then each block reads its own window once, and a
  tile with an empty window only writes its zero rows.

``val`` arrives in its wire type -- f32, bf16, or int8 with ``scale`` --
and is widened (and scaled) in registers only; sums are f32.  The plain
versions are in ``ref``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import _build
from .ref import (banded_onehot_scatter_add_ref, banded_windows_ref,
                  onehot_scatter_add_ref, row_order_ref)

# the reference's default tile shapes (out-rows, width, in-rows)
BM, BN, BK = 128, 128, 512
# output rows per block of the banded CUDA kernel (one window per tile)
BANDED_ROWS = 4096

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def band_inner_tiles(band: int, bm: int, bk: int) -> int:
    """Static bound on input tiles any bm-row output tile of the TPU banded
    kernel draws from: its <= band*bm source rows are contiguous, so they
    span at most ceil(band*bm/bk) blocks plus one for misalignment."""
    return -(-band * bm // bk) + 1


def _check(name: str, pos: torch.Tensor, val: torch.Tensor,
           scale: Optional[torch.Tensor]) -> None:
    if pos.dtype != torch.int32:
        raise TypeError(f"{name}: pos must be int32, got {pos.dtype}")
    if val.shape[:-1] != pos.shape:
        raise ValueError(f"{name}: val {tuple(val.shape)} does not match "
                         f"pos {tuple(pos.shape)} + (W,)")
    if val.dtype not in _DTYPES:
        raise TypeError(f"{name}: val must be float32, bfloat16 or int8, "
                        f"got {val.dtype}")
    if scale is None:
        if val.dtype == torch.int8:
            raise TypeError(f"{name}: int8 values need a scale")
    elif scale.shape != pos.shape or scale.dtype != torch.float32:
        raise ValueError(f"{name}: scale must be float32 {tuple(pos.shape)}, "
                         f"got {scale.dtype} {tuple(scale.shape)}")


def _layout_buffers(pos: torch.Tensor, num_rows: int):
    """Scratch and permutation [B, C] (int32) of the counting layout,
    allocated on ``pos``'s device."""
    b, c = math.prod(pos.shape[:-1]), pos.shape[-1]
    if c >= 2**31 - 1 or num_rows >= 2**31 - 1:
        raise ValueError(f"counting layout needs C and num_rows < 2**31 - 1,"
                         f" got {c} and {num_rows}")
    n = _build.library().repro_row_order_scratch(b, c)
    kw = dict(dtype=torch.int32, device=pos.device)
    return torch.empty(n, **kw), torch.empty(b, c, **kw)


def _launch(kernel: str, entry: str, pos: torch.Tensor, val: torch.Tensor,
            scale: Optional[torch.Tensor], num_rows: int,
            *extra: int) -> torch.Tensor:
    """Launch a scatter's C entry; ``extra`` (scratch pointers, tile rows)
    goes after the value dtype."""
    lead, c, w = pos.shape[:-1], pos.shape[-1], val.shape[-1]
    out = torch.empty(lead + (num_rows, w), dtype=torch.float32,
                      device=pos.device)
    tensors = (pos, val, out) if scale is None else (pos, val, scale, out)
    if scale is not None:
        kernel += "_scaled"
    _build.check_cuda(kernel, *tensors)
    with torch.cuda.device(pos.device):
        _build.launch(kernel, entry, pos.data_ptr(), val.data_ptr(),
                      None if scale is None else scale.data_ptr(),
                      out.data_ptr(), math.prod(lead), c, num_rows, w,
                      _DTYPES[val.dtype], *extra, _build.stream_of(pos))
    return out


def row_order(pos: torch.Tensor, num_rows: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stable counting layout of :func:`onehot_scatter_add`, exposed
    on its own: ``(perm, offsets)`` with ``perm`` int32 [..., C] the source
    indices sorted by destination (a stable sort: each row's sources in
    increasing index; sources outside [0, num_rows) last, in index order)
    and ``offsets`` int32 [..., num_rows + 1], row p's sources being
    ``perm[offsets[p]:offsets[p + 1]]`` (``offsets[num_rows]`` = sources
    kept).  CUDA tensors launch the kernel's layout stages (counted as
    ``row_order``) and derive the offsets from the sorted destinations
    with one ``searchsorted``; CPU tensors run the plain version."""
    if pos.dtype != torch.int32:
        raise TypeError(f"row_order: pos must be int32, got {pos.dtype}")
    if pos.device.type == "cpu":
        return row_order_ref(pos, num_rows)
    _build.check_cuda("row_order", pos)
    lead, c = pos.shape[:-1], pos.shape[-1]
    scratch, perm = _layout_buffers(pos, num_rows)
    with torch.cuda.device(pos.device):
        _build.launch("row_order", "repro_row_order", pos.data_ptr(),
                      math.prod(lead), c, num_rows, scratch.data_ptr(),
                      perm.data_ptr(), _build.stream_of(pos))
    flat = pos.reshape(perm.shape)
    keys = torch.where((flat >= 0) & (flat < num_rows), flat,
                       num_rows).gather(1, perm.long())
    rows = torch.arange(num_rows + 1, dtype=torch.int32, device=pos.device)
    rows = rows.expand(perm.shape[0], -1).contiguous()
    off = torch.searchsorted(keys, rows, out_int32=True)
    return perm.reshape(lead + (c,)), off.reshape(lead + (num_rows + 1,))


def onehot_scatter_add(pos: torch.Tensor, val: torch.Tensor, num_rows: int,
                       scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[..., num_rows, W] (f32) = scatter-add of val [..., C, W] (f32,
    bf16, or int8 with ``scale``) at rows pos [..., C] (int32), each source
    row times ``scale[..., i]`` (f32 [..., C]) when given, batched over the
    leading dims.  Any pos outside [0, num_rows) is dropped.  CUDA tensors
    launch the kernel (``onehot_scatter_add``, or
    ``onehot_scatter_add_scaled`` with a scale), CPU tensors run the plain
    version."""
    _check("onehot_scatter_add", pos, val, scale)
    if pos.device.type == "cpu":
        return onehot_scatter_add_ref(pos, val, num_rows, scale)
    scratch, perm = _layout_buffers(pos, num_rows)  # alive until launched
    return _launch("onehot_scatter_add", "repro_onehot_scatter_add", pos, val,
                   scale, num_rows, scratch.data_ptr(), perm.data_ptr())


def banded_onehot_scatter_add(pos: torch.Tensor, val: torch.Tensor,
                              num_rows: int, *, band: int,
                              scale: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Band-limited :func:`onehot_scatter_add`: requires ``pos``
    non-decreasing along C with at most ``band`` sources per row in
    [0, num_rows) (rows parked at >= num_rows -- drop bin, padding -- sit
    at the tail); then the result equals the dense scatter's.  The kernel
    does not check the precondition.  CUDA tensors launch
    ``banded_onehot_scatter_add`` (``_scaled`` with a scale), CPU tensors
    run the plain version.  One call makes two CUDA launches (the window
    table, then the scatter) and counts as one; its C entry refuses C >
    2**31 - 2**16 (32-bit indices within a batch row)."""
    _check("banded_onehot_scatter_add", pos, val, scale)
    if band < 1:
        raise ValueError(f"band must be >= 1, got {band}")
    if pos.device.type == "cpu":
        return banded_onehot_scatter_add_ref(pos, val, num_rows, band, scale)
    table = _window_table(pos, num_rows)
    return _launch("banded_onehot_scatter_add",
                   "repro_banded_onehot_scatter_add", pos, val, scale,
                   num_rows, table.data_ptr(), BANDED_ROWS)


def _window_table(pos: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Scratch for the window table, int64 [..., ceil(num_rows /
    BANDED_ROWS) + 1], allocated on ``pos``'s device."""
    return torch.empty(pos.shape[:-1] + (-(-num_rows // BANDED_ROWS) + 1,),
                       dtype=torch.int64, device=pos.device)


def banded_windows(pos: torch.Tensor, num_rows: int) -> torch.Tensor:
    """The banded scatter's window table, exposed on its own: int64
    [..., T + 1] with T = ceil(num_rows / BANDED_ROWS) and ``first[...,
    t]`` the first source i with ``pos[..., i] >= min(t * BANDED_ROWS,
    num_rows)`` (C if none), for non-decreasing ``pos`` [..., C] int32;
    output tile t's sources are ``[first[t], first[t + 1])``.  CUDA
    tensors launch the table kernel alone (counted as ``banded_windows``),
    CPU tensors run the plain version."""
    if pos.dtype != torch.int32:
        raise TypeError(f"banded_windows: pos must be int32, got {pos.dtype}")
    if pos.device.type == "cpu":
        return banded_windows_ref(pos, num_rows, BANDED_ROWS)
    _build.check_cuda("banded_windows", pos)
    table = _window_table(pos, num_rows)
    with torch.cuda.device(pos.device):
        _build.launch("banded_windows", "repro_banded_windows", pos.data_ptr(),
                      table.data_ptr(), math.prod(pos.shape[:-1]),
                      pos.shape[-1], num_rows, BANDED_ROWS,
                      _build.stream_of(pos))
    return table
