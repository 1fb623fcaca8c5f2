"""train_tokens_per_s: every token trained in the window over the
window's wall seconds (host clock; each step ends in a
synchronisation)."""


def read(ctx):
    tokens = ctx["units"] * ctx["work"].get("tokens", 0)
    return tokens / ctx["window_s"] if tokens else None
