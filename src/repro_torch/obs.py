"""The port's spans and counters: one recorder at its layer boundaries.

    from repro_torch import obs

    with obs.span("union.merge"):         # or @obs.span("union.trim")
        ...
    obs.count("t.items", 2)
    obs.count_htod("union.htod_copies", device, 2)    # none on the CPU
    obs.snapshot()      # {"spans": {name: {"calls", "ns"}}, "counters": {...}}

It records at two levels.

* Totals, always on: for each span name the number of calls and the
  host nanoseconds spent inside (``time.perf_counter_ns``); for each
  counter its running value.  The memory is fixed, so a long job can read
  :func:`snapshot` as its metrics (the benchmark reads the engine's
  set-up there).  A span costs a flag read, two clock reads and a dict
  update: no CUDA call, no synchronisation, no tensor.  :func:`snapshot`
  also reads ``kernels._build.LAUNCHES`` as its ``launch.<kernel>``
  counters (it keeps no copy; :func:`reset` leaves them to
  ``_build.reset_launches``).
* Timeline, only while a ``torch.profiler`` session records
  (``torch.autograd.profiler._is_profiler_enabled``): each span is also a
  :class:`Span` record -- an id, its parent's id, the id of its outermost
  span (``root``: all spans of one reduce, job or step share it), its
  name, its host start and end from ``time.time_ns()``, and the counter
  increments made while it was open.  Where CUDA is initialised, a pair
  of timing ``torch.cuda.Event`` s is recorded on the current stream at
  open and close, except while that stream captures a CUDA graph (an
  event record would enter the graph); :meth:`Span.device_ms` reads them
  once the device has passed both.  The timeline keeps every span of
  every profiled stretch until :func:`reset`; it nests spans in the order
  they open and close, as one thread opens them.

The clock.  A ``torch.profiler`` Chrome trace stamps an event at ``ts =
(Unix-epoch ns - baseTimeNanoseconds) / 1000`` us, where the base is the
epoch floored to a 7,889,238-second interval (libkineto's
``ChromeTraceBaseTime``; torch's ``profiler._chrome_trace_export.
_trimester_base_ns``).  :func:`trace_us` applies that rule to a
``time.time_ns()`` stamp, so a span's host stamps land on a device
trace's clock.  A trace whose base was fixed before an interval boundary
that a stamp lies after is the one case it misses (once in 91 days).
"""
from __future__ import annotations

import functools
import itertools
import time
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

TRACE_BASE_INTERVAL_S = 7_889_238
HOST_DEVICE_TYPES = ("cpu",)        # count_htod counts no copy onto these


class Span:
    """One timeline record (module docstring)."""

    __slots__ = ("id", "parent", "root", "name", "start_ns", "end_ns",
                 "counts", "events", "_begin")

    def __init__(self, id: int, parent: Optional[int], root: int, name: str,
                 start_ns: int):
        self.id, self.parent, self.root, self.name = id, parent, root, name
        self.start_ns, self.end_ns = start_ns, None
        self.counts: Dict[str, int] = {}
        self.events = None          # (open, close) CUDA events, or None
        self._begin = None

    def device_ms(self) -> Optional[float]:
        """Device milliseconds between the span's two events (None without
        them: on the CPU, or opened or closed inside a graph capture)."""
        if self.events is None:
            return None
        return float(self.events[0].elapsed_time(self.events[1]))


def _cuda_event() -> Optional["torch.cuda.Event"]:
    """A timing event recorded on the current stream, or None (CUDA not
    initialised, or the stream capturing a graph)."""
    if not torch.cuda.is_initialized() or \
            torch.cuda.is_current_stream_capturing():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class Recorder:
    """Totals, counters and the timeline (module docstring); the module's
    functions act on one process-wide instance, :data:`RECORDER`."""

    def __init__(self):
        self.totals: Dict[str, List[int]] = {}      # name -> [calls, ns]
        self.counters: Dict[str, int] = {}
        self._timeline: List[Span] = []
        self._ids = itertools.count(1)
        self._open: List[Span] = []                 # open timeline spans

    def span(self, name: str) -> "_SpanContext":
        """A context manager (also a decorator) timing ``name``."""
        return _SpanContext(self, name)

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to counter ``name`` (and to every open timeline
        span's increments)."""
        self.counters[name] = self.counters.get(name, 0) + n
        for s in self._open:
            s.counts[name] = s.counts.get(name, 0) + n

    def snapshot(self) -> dict:
        """``{"spans": {name: {"calls", "ns"}}, "counters": {name:
        value}}``, the counters with every kernel's ``launch.<kernel>``."""
        from repro_torch.kernels import _build
        counters = dict(self.counters)
        counters.update((f"launch.{k}", v) for k, v in _build.LAUNCHES.items())
        return {"spans": {k: {"calls": c, "ns": ns}
                          for k, (c, ns) in self.totals.items()},
                "counters": counters}

    def timeline(self) -> List[Span]:
        """The timeline's spans in the order they opened."""
        return list(self._timeline)

    def reset(self) -> None:
        """Clear the totals, counters and timeline."""
        self.totals.clear()
        self.counters.clear()
        self._timeline.clear()

    def _begin_span(self, name: str) -> Span:
        sid = next(self._ids)
        parent = self._open[-1] if self._open else None
        s = Span(sid, parent.id if parent else None,
                 parent.root if parent else sid, name, time.time_ns())
        s._begin = _cuda_event()
        self._open.append(s)
        self._timeline.append(s)
        return s

    def _end_span(self, s: Span) -> None:
        if s._begin is not None:
            end = _cuda_event()
            s.events = None if end is None else (s._begin, end)
            s._begin = None
        s.end_ns = time.time_ns()
        self._open.remove(s)


class _SpanContext:
    __slots__ = ("rec", "name", "t0", "rec_span")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self) -> "_SpanContext":
        self.rec_span = self.rec._begin_span(self.name) \
            if _autograd_profiler._is_profiler_enabled else None
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        dt = time.perf_counter_ns() - self.t0
        tot = self.rec.totals.get(self.name)
        if tot is None:
            self.rec.totals[self.name] = [1, dt]
        else:
            tot[0] += 1
            tot[1] += dt
        if self.rec_span is not None:
            self.rec._end_span(self.rec_span)
        return False

    def __call__(self, fn):
        rec, name = self.rec, self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with _SpanContext(rec, name):
                return fn(*args, **kwargs)
        return spanned


def count_htod(name: str, device, n: int = 1) -> None:
    """Count ``n`` host-to-device copies onto ``device`` in counter
    ``name``; none where ``device`` is the host (a tensor made there from
    host memory crosses no bus)."""
    if torch.device(device).type not in HOST_DEVICE_TYPES:
        RECORDER.count(name, n)


def trace_base_ns(ns: int) -> int:
    """The Chrome trace base (``baseTimeNanoseconds``) of a trace taken at
    Unix-epoch ``ns`` (module docstring)."""
    step = TRACE_BASE_INTERVAL_S * 1_000_000_000
    return ns // step * step


def trace_us(ns: int) -> float:
    """A ``time.time_ns()`` stamp on the Chrome trace's clock: ``(ns -
    base) / 1000`` us, the base the Unix epoch floored to a
    7,889,238-second interval (libkineto's ``ChromeTraceBaseTime``)."""
    return (ns - trace_base_ns(ns)) / 1000.0


RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
snapshot = RECORDER.snapshot
timeline = RECORDER.timeline
reset = RECORDER.reset
