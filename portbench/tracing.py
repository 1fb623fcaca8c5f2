"""The traced run: the profiler around part of the window, and the
reduction of its trace to what the metric readers read.

On the card the trace is ``torch.profiler``'s CUDA activity alone
(CUPTI: every kernel, copy and fill, and the host's CUDA runtime calls).
Host operator recording is left off: it costs each operator some
microseconds on the host, which would stretch the traced window past
the untraced one where the host launches many small operations.  On the
CPU (the tests) the host's operators and spans are recorded instead.
The trace is exported as a Chrome trace into ``TMPDIR`` and deleted once
read.  :func:`reduce_trace` gives the device activity inside the traced
window (the harness's ``portbench.traced`` span where the host is
recorded, else the extent of the trace), its union (busy time), the
largest operations by name and the longest idle gaps, each named by the
host call open when the gap began and the next one the host made.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function",
             "cuda_runtime", "cuda_driver")
WINDOW_SPAN = "portbench.traced"

Activity = Tuple[str, float, float]       # name, start us, duration us


class Profiler:
    """``torch.profiler`` over CUDA activity (on the CPU, host activity),
    started and stopped by the harness around the traced units."""

    def __init__(self, device_type: str):
        import torch
        acts = [torch.profiler.ProfilerActivity.CUDA
                if device_type == "cuda" else
                torch.profiler.ProfilerActivity.CPU]
        self._prof = torch.profiler.profile(activities=acts)
        self._span = torch.profiler.record_function(WINDOW_SPAN)

    def start(self) -> None:
        self._prof.__enter__()
        self._span.__enter__()

    def stop(self, sync) -> dict:
        """End the span, wait for the device, stop, and reduce the trace."""
        self._span.__exit__(None, None, None)
        sync()
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(prefix="portbench_trace_", suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self._prof = None
        return reduce_trace(events)


def _intervals_union(spans: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce_trace(events: Sequence[dict], top: int = 10) -> dict:
    """``{"window_s", "busy_s", "device": [(name, start_us, dur_us)],
    "device_ops": [[name, s]], "idle_gaps": [[name, s]]}`` of the events
    inside the ``portbench.traced`` span, or, in a trace without it, of
    all events (the window from the first to the end of the last); a
    trace with no events, or with no device activity, gives ``busy_s`` 0
    and empty lists."""
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("cat") in DEVICE_CATS + HOST_CATS]
    win = [e for e in spans if e.get("name") == WINDOW_SPAN]
    if win:
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
    elif spans:
        w0 = min(float(e["ts"]) for e in spans)
        w1 = max(float(e["ts"]) + float(e.get("dur", 0.0)) for e in spans)
    else:
        return {"window_s": 0.0, "busy_s": 0.0, "device": [],
                "device_ops": [], "idle_gaps": []}
    device: List[Activity] = []
    host: List[Activity] = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            if ts >= w0 and ts + dur <= w1:
                device.append((str(e.get("name")), ts, dur))
        elif cat in HOST_CATS and e.get("name") != WINDOW_SPAN:
            if ts + dur >= w0 and ts <= w1:
                host.append((str(e.get("name")), ts, dur))
    busy_spans = _intervals_union((ts, ts + dur) for _, ts, dur in device)
    busy_us = sum(b - a for a, b in busy_spans)
    by_name: Dict[str, float] = {}
    for name, _, dur in device:
        by_name[name] = by_name.get(name, 0.0) + dur
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    edges = [w0] + [x for span in busy_spans for x in span] + [w1]
    gaps = sorted(((edges[i], edges[i + 1] - edges[i])
                   for i in range(0, len(edges) - 1, 2)
                   if edges[i + 1] > edges[i]), key=lambda g: -g[1])[:top]
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy_us / 1e6,
            "device": device,
            "device_ops": [[n, us / 1e6] for n, us in ops],
            "idle_gaps": [[f"{host_at(host, t)} -> {host_next(host, t)}",
                           us / 1e6] for t, us in gaps]}


def host_at(host: Sequence[Activity], t: float) -> str:
    """The innermost (shortest) host span open at time ``t``, or
    ``"python"`` (the host between recorded calls)."""
    best: Optional[Activity] = None
    for a in host:
        if a[1] <= t <= a[1] + a[2] and (best is None or a[2] < best[2]):
            best = a
    return best[0] if best is not None else "python"


def host_next(host: Sequence[Activity], t: float) -> str:
    """The first host span that begins after time ``t``, or ``"end"``."""
    after = [a for a in host if a[1] > t]
    return min(after, key=lambda a: a[1])[0] if after else "end"


def _pattern(names: Iterable[str]) -> "re.Pattern":
    alt = "|".join(re.escape(n) for n in names)
    return re.compile(rf"(?:^|[\s:])(?:{alt})(?:[<(]|$)")


def device_us(trace: dict, names: Optional[Iterable[str]] = None,
              exclude: bool = False) -> Tuple[float, int]:
    """``(total us, count)`` of the traced device activity whose function
    name is one of ``names`` (or, with ``exclude``, none of them; all of
    it without ``names``)."""
    pat = _pattern(names) if names is not None else None
    total, count = 0.0, 0
    for name, _, dur in trace.get("device", ()):
        if pat is None or bool(pat.search(name)) != exclude:
            total += dur
            count += 1
    return total, count
