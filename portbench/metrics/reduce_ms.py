"""reduce_ms: the window's wall milliseconds over every union reduce
completed in it (host clock; each reduce ends in a synchronisation)."""


def read(ctx):
    n = ctx["units"] * ctx["work"].get("reduces", 0)
    return ctx["window_s"] * 1e3 / n if n else None
