"""union.reduce_hbm_share: a union reduce's least bytes (every node's
valid input entries read once, the union written once to every node;
int64 index and float32 value, counted from the drawn batches) over
3.35 TB/s, as a share of the device's busy time a reduce in the traced
window (%)."""
from portbench import roofline


def read(ctx):
    tr = ctx.get("trace") or {}
    n = ctx["units"] * ctx["work"].get("reduces", 0)
    if not n or not tr.get("busy_s"):
        return None
    busy_ms = tr["busy_s"] * 1e3 / n
    return 100.0 * roofline.hbm_ms(ctx["facts"]["reduce_bytes"]) / busy_ms
