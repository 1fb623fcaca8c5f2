"""Tile-work / FLOP model of the per-layer merges (reference: ``repro.kernels.costmodel``).

Three ways to merge the k sorted runs arriving at a butterfly layer
(``merge="sort" | "fused" | "banded"``), priced in the TPU kernels' tiles
and FLOPs, the terms the autotuner's reports use:

* ``sort``   -- concat + full argsort of all C = k*cap rows: ~C*log2(C)
  compare-swaps, no tiles;
* ``fused``  -- rank-merge (k*(k-1) dense compare planes of
  cap^2/(bm*bn) tiles each) + a one-hot scatter-add whose inner grid
  dimension scans all C/bk input tiles for every output tile;
* ``banded`` -- the same, band-limited: compare tiles off the merge
  frontier are resolved from block edges, and the scatter's inner
  dimension is ``band_inner_tiles(k, bm, bk)``.

The port's banded rank kernel (``csrc/rank_merge_banded.cu``) performs
exactly this tile triage, so ``merge_tile_report``'s frontier counts
(from ``rank_merge.rank_tile_stats``) describe the work it does; the
tile shapes are the kernel modules' own constants.  ``wire_bytes_report``
prices one stage row on the wire under the ``wire=`` codecs
(``kernels.wirecodec``), with the fabric's packet floor applied once, to
the encoded size.
"""
from __future__ import annotations

import math
from typing import Optional

from repro_torch.core.topology import check_wire

from . import onehot_scatter, rank_merge
from .onehot_scatter import band_inner_tiles
from .rank_merge import rank_tile_stats
from .wirecodec import encoded_payload_bytes

SCATTER_BM, SCATTER_BN, SCATTER_BK = (onehot_scatter.BM, onehot_scatter.BN,
                                      onehot_scatter.BK)
RANK_BM, RANK_BN = rank_merge.BM, rank_merge.BN


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def scatter_tile_report(c: int, width: int, out_rows: int, *, mode: str,
                        band: Optional[int] = None,
                        bm: int = SCATTER_BM, bn: int = SCATTER_BN,
                        bk: int = SCATTER_BK) -> dict:
    """Tile/FLOP count of the one-hot scatter-add of C input rows into
    ``out_rows`` destinations of ``width`` columns: each (out-tile,
    width-tile, in-tile) visit is one [bk, bm]^T @ [bk, bn] contraction
    of 2*bk*bm*bn FLOPs; ``fused`` scans all input tiles per output
    tile, ``banded`` the static band bound."""
    n_out = _cdiv(out_rows, bm)
    n_w = _cdiv(max(width, 1), bn)
    if mode == "banded":
        if band is None:
            raise ValueError("banded scatter report needs the band bound")
        inner = band_inner_tiles(band, bm, bk)
    else:
        inner = _cdiv(c, bk)
    tiles = n_out * n_w * inner
    return {"inner_tiles_per_out_tile": inner, "out_tiles": n_out * n_w,
            "tiles": tiles, "mxu_flops": tiles * 2 * bk * bm * bn}


def merge_tile_report(idx, out_capacity: int, *, mode: str, width: int = 1,
                      bm: int = SCATTER_BM, bn: int = SCATTER_BN,
                      bk: int = SCATTER_BK, rank_bm: int = RANK_BM,
                      rank_bn: int = RANK_BN) -> dict:
    """Tile-work count of one butterfly-layer merge on a concrete
    ``[k, cap]`` workload of sorted SENTINEL-padded runs (uint32 numpy or
    an int64 tensor): the rank-merge compare tiles (the banded frontier
    measured on the actual runs), the scatter-add tiles and a FLOP
    total; for ``sort`` the argsort compare estimate."""
    k, cap = int(idx.shape[0]), int(idx.shape[1])
    c = k * cap
    if mode == "sort":
        comparisons = int(c * max(1.0, math.log2(max(c, 2))))
        return {"mode": mode, "k": k, "cap": cap,
                "rank_compare_tiles": 0, "rank_cheap_tiles": 0,
                "scatter_inner_tiles_per_out_tile": 0, "scatter_tiles": 0,
                "flops": comparisons}
    per_pair_tiles = _cdiv(cap, rank_bm) * _cdiv(cap, rank_bn)
    pairs = k * (k - 1)
    if mode == "banded":
        compare = cheap = 0
        for r in range(k):
            for s in range(k):
                if s == r:
                    continue
                st = rank_tile_stats(idx[r], idx[s], strict=(s > r),
                                     bm=rank_bm, bn=rank_bn)
                compare += st["frontier_tiles"]
                cheap += st["full_below_tiles"] + st["skipped_tiles"]
    elif mode == "fused":
        compare, cheap = pairs * per_pair_tiles, 0
    else:
        raise ValueError(f"unknown merge mode {mode!r}")
    sc = scatter_tile_report(c, width, out_capacity, mode=mode, band=k,
                             bm=bm, bn=bn, bk=bk)
    rank_flops = compare * rank_bm * rank_bn      # one compare+add per cell
    return {"mode": mode, "k": k, "cap": cap,
            "rank_compare_tiles": compare, "rank_cheap_tiles": cheap,
            "rank_total_tiles": pairs * per_pair_tiles,
            "scatter_inner_tiles_per_out_tile":
                sc["inner_tiles_per_out_tile"],
            "scatter_tiles": sc["tiles"],
            "flops": rank_flops + sc["mxu_flops"]}


def wire_bytes_report(cap: int, index_bits: int, *, wire: str = "raw",
                      value_width: int = 1, fabric=None,
                      fanout: int = 1) -> dict:
    """Encoded on-wire cost of one stage row of ``cap`` entries at the
    stage's offset width ``index_bits`` (raw ships 32-bit indices): exact
    byte counts, the compression against raw and, with a
    ``core.netmodel.Fabric``, the modeled message times with the packet
    floor applied to the encoded size."""
    check_wire(wire)
    raw = encoded_payload_bytes("raw", cap, 32, value_width)
    enc = encoded_payload_bytes(wire, cap, index_bits, value_width)
    rep = {"wire": wire, "cap": cap,
           "index_bits": 32 if wire == "raw" else index_bits,
           "value_width": value_width,
           "raw_bytes": raw, "encoded_bytes": enc,
           "compression": raw / enc}
    if fabric is not None:
        rep["msg_time_s"] = fabric.msg_time(float(enc), fanout)
        rep["raw_msg_time_s"] = fabric.msg_time(float(raw), fanout)
        rep["floor_bound"] = float(enc) < float(fabric.floor_bytes)
    return rep
