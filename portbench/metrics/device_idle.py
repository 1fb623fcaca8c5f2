"""device_idle.<cell>: the share of the traced window in which no kernel,
copy or fill ran on the device (%); one reader for every cell's name."""


def read(ctx):
    tr = ctx.get("trace") or {}
    if not tr.get("busy_s") or not tr.get("window_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
