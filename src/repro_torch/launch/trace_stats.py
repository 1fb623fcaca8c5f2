"""Exchange bytes and FLOPs of a traced step (the port's counterpart of ``repro.launch.hlo_stats``).

The reference parses compiled HLO text; the port reads what its
censuses saw while the step ran (``repro_torch.analysis.auditor``):

* bytes per exchange, per device, by the reference's formulas
  (``hlo_stats.py``'s header): all-reduce (``psum``, ``pmax``) 2 * size *
  (k - 1) / k, all-gather and all-to-all size * (k - 1) / k,
  reduce-scatter size * (k - 1), collective-permute size -- size being
  one position's result bytes and k the exchange's group size (at least
  2) -- summed over the exchange census by kind;
* matmul and total FLOPs from ``torch.utils.flop_counter.FlopCounterMode``
  (the total counts only the ops it has formulas for: products,
  convolutions, attention);
* the unfused op bytes, every non-view op's inputs and outputs
  (``OpCensus.op_bytes``): an upper bound on the memory traffic, since a
  fused kernel moves its intermediates through registers.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable



# the census's exchange kinds under the reference's HLO op names
HLO_KIND = {"psum": "all-reduce", "pmax": "all-reduce",
            "all_gather": "all-gather", "reduce_scatter": "reduce-scatter",
            "all_to_all": "all-to-all"}
MATMUL_OPS = ("mm", "bmm", "addmm", "baddbmm", "_scaled_mm")


def moved_bytes(kind: str, size: float, k: int) -> float:
    """Per-device bytes one collective moves (an HLO kind name: result
    bytes ``size``, group size ``k``), the reference's formulas."""
    k = max(int(k), 2)
    if kind == "all-reduce":
        return 2.0 * size * (k - 1) / k
    if kind in ("all-gather", "all-to-all"):
        return size * (k - 1) / k
    if kind == "reduce-scatter":
        return size * (k - 1)
    if kind == "collective-permute":
        return float(size)
    raise ValueError(f"unknown collective kind {kind!r}")


def collective_stats(records: Iterable[dict], axis=None
                     ) -> Dict[str, Dict[str, float]]:
    """``{hlo kind: {"count", "bytes"}}`` per device over an exchange
    census's records (of ``axis`` only, when given)."""
    out: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"count": 0.0, "bytes": 0.0})
    for r in records:
        if axis is not None and r["axis"] != axis:
            continue
        kind = HLO_KIND[r["kind"]]
        out[kind]["count"] += 1
        out[kind]["bytes"] += moved_bytes(kind, r["result_bytes"], r["group"])
    return dict(out)


def total_collective_bytes(stats: Dict[str, Dict[str, float]]) -> float:
    """The bytes of every kind."""
    return sum(v["bytes"] for v in stats.values())


def flops(counter) -> Dict[str, float]:
    """``{"total", "matmul"}`` FLOPs of a ``FlopCounterMode`` run."""
    counts = counter.get_flop_counts().get("Global", {})
    matmul = sum(v for op, v in counts.items()
                 if getattr(op, "__name__", str(op)).split(".")[0]
                 in MATMUL_OPS)
    return {"total": float(counter.get_total_flops()),
            "matmul": float(matmul)}
