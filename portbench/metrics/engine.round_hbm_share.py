"""engine.round_hbm_share: a PageRank round's least bytes (the stacked
CSR and the rank vector in and out, counted from the graph the benchmark
drew) over 3.35 TB/s, as a share of the device's busy time a round in
the traced window (%)."""
from portbench import roofline


def read(ctx):
    tr = ctx.get("trace") or {}
    rounds = ctx["units"] * ctx["work"].get("rounds", 0)
    if not rounds or not tr.get("busy_s"):
        return None
    busy_ms = tr["busy_s"] * 1e3 / rounds
    return 100.0 * roofline.hbm_ms(ctx["facts"]["round_bytes"]) / busy_ms
