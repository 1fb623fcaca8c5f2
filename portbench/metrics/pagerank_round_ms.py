"""pagerank_round_ms: the window's wall milliseconds over every PageRank
round completed in it (host clock; each job ends in a synchronisation)."""


def read(ctx):
    rounds = ctx["units"] * ctx["work"].get("rounds", 0)
    return ctx["window_s"] * 1e3 / rounds if rounds else None
