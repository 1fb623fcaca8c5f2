"""Compressed wire codecs of the union-path butterfly stages (reference: ``repro.kernels.wirecodec``).

The ``wire=`` knob of :class:`repro_torch.core.api.SparseAllreduce`
changes what every exchange of the union path carries:

* **Index stream ("delta" family)** -- every stage payload is a sorted run
  confined to one contiguous subrange of the hashed space whose base both
  ends know (receiver j of a down-stage exchange owns bucket subrange j;
  row t of an up-stage gather covers subrange t).  Indices travel as
  offsets from that base, bit-packed at the static per-stage width
  ``ceil(log2(max_span + 1))``; the all-ones offset marks SENTINEL
  padding.  Exactly lossless.
* **Value stream** -- ``delta`` keeps fp32 (bit-identical to ``raw``),
  ``delta+bf16`` ships bfloat16, ``delta+int8ef`` ships per-row-scaled
  int8 plus one f32 scale per row; the merge kernels take both narrow
  types as they are and widen them only in registers
  (``ops.merge_sorted_runs(row_scale=...)``).

Torch's ``uint32`` has no shifts or subtraction on the CPU, so offsets and
shifts are computed in int64 and spills are masked to 32 bits (int64 can
shift by 32, so the reference's double shift is not needed).  Packed words
are held as int32 bit patterns: 4 bytes a word, as on the reference's
wire; ``words.view(np.uint32)`` gives the reference's words.  Widths,
word counts and strides are host ints from the
:class:`~repro_torch.core.allreduce.DevicePlan`.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.sparse_vec import SENTINEL
from repro_torch.core.topology import check_wire

# Wire modes whose value stream loses precision (bounded-error tests;
# refused by the sim backend and the planned reduce path).
LOSSY_WIRE = ("delta+bf16", "delta+int8ef")

_MASK32 = (1 << 32) - 1


def stage_index_bits(plan) -> Tuple[int, ...]:
    """Per-stage offset width in bits: ``ceil(log2(max_span + 1))`` over the
    stage-l subrange spans of every node (the +1 reserves the all-ones
    SENTINEL marker)."""
    bits = []
    for l in range(len(plan.stages)):
        e = plan.logical.all_edges(l)                    # [M, k+1] int64
        span = int(np.max(e[:, 1:] - e[:, :-1]))
        bits.append(max(1, min(32, int(math.ceil(math.log2(span + 1))))))
    return tuple(bits)


def stage_strides(plan) -> Tuple[int, ...]:
    """Per-stage mixed-radix stride within the stage's mesh axis: a node's
    position in its stage-l group is ``(axis_index // stride_l) %
    degree_l`` (digit l of the axis index, most-significant first)."""
    per_axis: dict = {}
    for st in plan.stages:
        per_axis.setdefault(st.axis_name, []).append(st.degree)
    pos = {a: 0 for a in per_axis}
    out = []
    for st in plan.stages:
        ds = per_axis[st.axis_name]
        i = pos[st.axis_name]
        pos[st.axis_name] += 1
        out.append(math.prod(ds[i + 1:]))
    return tuple(out)


def index_words(cap: int, width: int) -> int:
    """32-bit words holding ``cap`` offsets of ``width`` bits each."""
    return max(1, -(-(cap * width) // 32))


def encoded_payload_bytes(wire: str, cap: int, index_bits: int,
                          width: int = 1) -> int:
    """Exact on-wire bytes of one encoded [cap(, width)] stage row (index
    words + value stream + the int8ef per-row scale)."""
    check_wire(wire)
    if wire == "raw":
        return cap * (4 + 4 * width)
    nbytes = 4 * index_words(cap, index_bits)
    nbytes += cap * width * {"delta": 4, "delta+bf16": 2,
                             "delta+int8ef": 1}[wire]
    if wire == "delta+int8ef":
        nbytes += 4                                     # f32 row scale
    return nbytes


def _bit_layout(cap: int, width: int, device):
    bitpos = torch.arange(cap, dtype=torch.int64, device=device) * width
    return bitpos // 32, bitpos % 32


def pack_indices(idx: torch.Tensor, base: torch.Tensor,
                 width: int) -> torch.Tensor:
    """Pack sorted int64 index rows [..., cap] into int32 words
    [..., n_words]: entry i holds ``idx - base`` (SENTINEL -> the all-ones
    marker) in bits [i*width, (i+1)*width), little-endian.  ``base`` [...]
    is each row's subrange start."""
    lead, cap = idx.shape[:-1], idx.shape[-1]
    nw = index_words(cap, width)
    marker = (1 << width) - 1
    offs = torch.where(idx == SENTINEL, marker,
                       (idx - base.unsqueeze(-1)) & _MASK32)   # uint32 wrap
    word, shift = _bit_layout(cap, width, idx.device)
    lo = (offs << shift) & _MASK32
    hi = offs >> (32 - shift)           # bits spilling into the next word
    acc = torch.zeros(lead + (nw + 1,), dtype=torch.int64, device=idx.device)
    # disjoint bit ranges: adding is OR-ing (integer adds are exact)
    acc.scatter_add_(-1, word.expand(lo.shape), lo)
    acc.scatter_add_(-1, (word + 1).expand(hi.shape), hi)
    acc = acc[..., :nw]
    return (acc - ((acc >> 31) << 32)).to(torch.int32)   # same 32 bits


def unpack_indices(words: torch.Tensor, base: torch.Tensor, cap: int,
                   width: int) -> torch.Tensor:
    """Inverse of :func:`pack_indices`: int32 words [..., n_words] +
    ``base`` [...] -> int64 indices [..., cap], marker offsets restored
    to SENTINEL."""
    nw = words.shape[-1]
    marker = (1 << width) - 1
    word, shift = _bit_layout(cap, width, words.device)
    w = words.to(torch.int64) & _MASK32
    lo = torch.index_select(w, -1, word) >> shift
    hi = (torch.index_select(w, -1, (word + 1).clamp(max=nw - 1))
          << (32 - shift)) & _MASK32
    offs = (lo | hi) & marker
    return torch.where(offs == marker, SENTINEL,
                       (base.unsqueeze(-1) + offs) & _MASK32)


def quant8_rows(val: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization of [R, ...] values: ``(q int8
    [R, ...], scale f32 [R])`` with ``scale = max(max|row| / 127, 1e-30)``
    and ``q = clip(round(val / scale), -127, 127)`` (round half to even),
    all in f32 as the reference computes it."""
    v = val.to(torch.float32)
    amax = v.abs().reshape(v.shape[0], -1).amax(-1)
    scale = torch.clamp(amax / 127.0, min=1e-30)
    s = scale.reshape((-1,) + (1,) * (val.ndim - 1))
    q = torch.clamp(torch.round(v / s), -127.0, 127.0).to(torch.int8)
    return q, scale


def dequant8_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quant8_rows` in f32; ``scale`` holds one entry per
    leading row of ``q`` (shape ``q.shape[:scale.ndim]``).  The kernel
    merges fuse this multiply into the scatter instead."""
    s = scale.to(torch.float32).reshape(
        scale.shape + (1,) * (q.ndim - scale.ndim))
    return q.to(torch.float32) * s
