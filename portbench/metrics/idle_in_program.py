"""idle_in_program.<cell>: the share of the device's idle time, from the
first to the last device activity of the traced window, that the
program's phases own (%): each idle instant goes to the innermost
``repro_torch.obs`` span open on the host then (its host stamps put on
the trace's clock by ``obs.trace_us``), and a phase is a span under the
unit's outermost one (the union reduce's phases; the training step's
sparse sync and the union phases in it).  The unit's own span and the
host outside every span own the rest.  One reader for every cell's
name."""
from portbench import spans


def read(ctx):
    obs = spans.recorder()
    device = (ctx.get("trace") or {}).get("device")
    if obs is None or not device:
        return None
    tl = [s for s in obs.timeline() if s.end_ns is not None]
    if not tl:
        return None
    owners = spans.idle_owners(device, ((s, obs.trace_us(s.start_ns),
                                         obs.trace_us(s.end_ns)) for s in tl))
    if not owners:
        return None
    phases = sum(us for s, us in owners.items()
                 if s is not None and s.parent is not None)
    return 100.0 * phases / sum(owners.values())
