"""train.update_ms: the median over the traced steps of the step's update stage,
between CUDA events recorded at the training step's ``mark`` hooks (ms)."""
import statistics


def read(ctx):
    ms = (ctx.get("spans") or {}).get("update_ms")
    return statistics.median(ms) if ms else None
