"""What the readers of the program's spans and counters share.

The program (``repro_torch.obs``) keeps, while a ``torch.profiler``
session records, a timeline of span records: ``id``, ``parent``,
``root`` (the outermost span's id), ``name``, host ``start_ns`` /
``end_ns`` (``time.time_ns()``), ``counts`` (the counter increments made
while the span was open) and ``device_ms()`` (device milliseconds
between its two CUDA events, or None).  The harness's profiler is on
for the traced units alone, so the timeline covers them.  A program
without the recorder (an earlier commit) gives nothing to read, and the
readers then return None: the metric is left out of the line.
"""
from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from portbench.tracing import _intervals_union


def recorder():
    """The program's ``repro_torch.obs``, or None where it has none."""
    try:
        from repro_torch import obs
    except ImportError:
        return None
    return obs


def timeline() -> Optional[list]:
    """The program's timeline, or None."""
    obs = recorder()
    return None if obs is None else obs.timeline()


def per_unit(tl: Sequence, unit: str) -> Dict[int, list]:
    """``{id: [the span and every span under it]}`` of each outermost
    span named ``unit`` (a reduce, a step), in the order the units
    opened, the unit's own span first (the spans of one unit share its
    ``root`` id)."""
    units = {s.id: [] for s in tl if s.name == unit and s.parent is None}
    for s in tl:
        if s.root in units:
            units[s.root].append(s)
    return units


def device_ms_per_unit(tl: Optional[Sequence], unit: str,
                       names: Iterable[str]) -> List[float]:
    """For each ``unit`` span, the device ms summed over its spans
    named one of ``names``; units with no such span holding events are
    left out."""
    names = set(names)
    out = []
    for spans in per_unit(tl or (), unit).values():
        ms = [s.device_ms() for s in spans if s.name in names]
        ms = [x for x in ms if x is not None]
        if ms:
            out.append(sum(ms))
    return out


def count_per_unit(tl: Optional[Sequence], unit: str,
                   counter: str) -> List[int]:
    """For each ``unit`` span, the increments of ``counter`` made
    while it was open."""
    return [spans[0].counts.get(counter, 0)
            for spans in per_unit(tl or (), unit).values()]


def median(xs: Sequence[float]) -> Optional[float]:
    return statistics.median(xs) if xs else None


def idle_owners(device: Sequence[Tuple[str, float, float]],
                spans_us: Iterable[Tuple[object, float, float]]
                ) -> Optional[Dict[object, float]]:
    """``{owner: idle us}``: each instant of the device's idle time, from
    the first to the last device activity, given to the innermost span
    open then, or to None where the host was inside none.  ``device`` is
    the trace's ``(name, start us, duration us)`` activity, ``spans_us``
    the spans as ``(owner, start, end)`` on the trace's clock, nested as
    one thread opens them (the innermost open span is the last opened).
    None without idle time."""
    busy = _intervals_union((ts, ts + dur) for _, ts, dur in device)
    if len(busy) < 2:
        return None
    idle = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    spans_us = list(spans_us)
    owners = [o for o, _, _ in spans_us]
    # the span boundaries in time order: at one instant closes first, then
    # opens, an outer span's (the later end) before an inner one's
    marks = sorted([(a, 1, -b, i) for i, (_, a, b) in enumerate(spans_us)]
                   + [(b, 0, 0.0, i) for i, (_, _, b) in enumerate(spans_us)])
    out: Dict[object, float] = {}
    stack: List[int] = []
    j, t = 0, float("-inf")
    for at, opens, _, i in marks + [(float("inf"), 0, 0.0, None)]:
        owner = owners[stack[-1]] if stack else None
        while j < len(idle) and idle[j][1] <= t:
            j += 1
        k = j
        while k < len(idle) and idle[k][0] < at:
            lo, hi = max(idle[k][0], t), min(idle[k][1], at)
            if hi > lo:
                out[owner] = out.get(owner, 0.0) + hi - lo
            k += 1
        if i is not None:
            if opens:
                stack.append(i)
            else:
                stack.remove(i)
        t = at
    return out
