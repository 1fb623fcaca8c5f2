"""train.mfu: model FLOPs of a step (6 x the active matmul parameters x
tokens plus attention's two products, forward and backward, counted from
the published configuration, no recompute) times the traced steps, over
the traced window's seconds, as a share of 989 TFLOP/s (bf16, H100 SXM
data sheet) (%)."""
from portbench import roofline


def read(ctx):
    tr = ctx.get("trace") or {}
    if not ctx["units"] or not tr.get("window_s") or not tr.get("device"):
        return None
    flops = ctx["facts"]["flops_per_step"] * ctx["units"]
    return 100.0 * flops / tr["window_s"] / roofline.BF16_FLOPS_PER_S
