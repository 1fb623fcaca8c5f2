"""engine.config_s: host seconds of the graph engine's ``config`` (the
program's ``engine.config`` span totals, a call: set-up runs before the
profiler, so the timeline does not hold it)."""
from portbench import spans


def read(ctx):
    obs = spans.recorder()
    tot = obs.snapshot()["spans"].get("engine.config") if obs else None
    if not tot or not tot["calls"]:
        return None
    return tot["ns"] / tot["calls"] / 1e9
