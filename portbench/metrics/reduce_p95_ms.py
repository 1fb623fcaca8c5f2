"""reduce_p95_ms: the 95th percentile (nearest rank) of every reduce in
the window, from the call to the synchronisation that ends it (host
clock)."""
import math


def read(ctx):
    if not ctx["work"].get("reduces"):
        return None
    lat = sorted(ctx["latencies_s"])
    if not lat:
        return None
    return lat[max(0, math.ceil(0.95 * len(lat)) - 1)] * 1e3
