#!/usr/bin/env python3
"""Where ``torch.profiler`` loses device events, on one NVIDIA GPU.

    python3 tools/profiler_window.py [--seconds 240]

For ``--seconds``, one process takes profiler traces of one workload --
five calls of the dense merge-rank kernel at [64, 4, 131072], two CUDA
launches (partition, merge) a level -- the way ``chip_smoke.py``'s
``profile_kernels`` does: an unrecorded warm-up call, then the recorded
window, its edges ``margin`` seconds from the calls.  Inside the window,
before the calls, stand probes whose survival locates a loss:

* ``packed``: 32 spin kernels (``torch.cuda._sleep``) back to back;
* ``spaced``: 32 spin kernels 2 ms apart on the host;
* ``start`` / ``end``: a spin kernel inside a host annotation just before
  and just after the calls.

Each probe group sits in a host annotation, so the trace holds the host
range it was launched in.  A loss of the window's first N records takes
the packed pads first; a loss of the window's first T ms takes the
spaced pads up to T and all packed pads at once.  The traces alternate
between the allocator holding about 50 GB cached and its cache released,
and between margins of 20 ms and 50 ms, with 200 calls of the workload
between traces.  Writes one JSON line per trace to
``chiprun_out/profiler_window.jsonl`` (process age, reserved GB, margin,
the kernel's launches kept of 10 + 10, the probes kept, the end marker's
device start less its host annotation's start, and the raw host ranges
and spin kernels' device starts) and prints a summary.  Needs a CUDA GPU
and nvcc.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PADS = 32
GROUPS = ("packed", "spaced", "start", "end")


def trace(torch, fn, margin: float) -> dict:
    """One trace; the kernel's launches and the probes kept in it."""
    from torch.autograd import DeviceType
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)
    out = []
    sync = torch.cuda.synchronize
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: out.append(p.events())) as prof:
        fn()
        sync()
        time.sleep(margin)
        prof.step()
        time.sleep(margin)
        with record_function("packed"):
            for _ in range(PADS):
                torch.cuda._sleep(100)
            sync()
        with record_function("spaced"):
            for _ in range(PADS):
                torch.cuda._sleep(100)
                time.sleep(0.002)
            sync()
        with record_function("start"):
            torch.cuda._sleep(1000)
            sync()
        for _ in range(5):
            fn()
        sync()
        with record_function("end"):
            torch.cuda._sleep(1000)
            sync()
        time.sleep(margin)
        prof.step()
    events = out.pop()
    host = {e.name: (e.time_range.start, e.time_range.end) for e in events
            if e.device_type == DeviceType.CPU and e.name in GROUPS}
    spins = sorted(e.time_range.start for e in events
                   if e.device_type != DeviceType.CPU
                   and "spin_kernel" in e.name)
    kernels = {}
    for e in events:
        if e.device_type != DeviceType.CPU:
            for name in ("partition_kernel", "merge_kernel"):
                if name in e.name:
                    kernels[name] = kernels.get(name, 0) + 1
    # a spin kernel belongs to the last host range that began before its
    # device start less the shift; the shift is read off the end marker
    # (the last spin kernel), so a cut end leaves the probes unassigned
    zero = host["packed"][0]
    rec = {"kernels": kernels, "spin_kernels": len(spins),
           "host_ms": {g: [(t - zero) / 1e3 for t in host[g]]
                       for g in host},
           "spins_ms": [(t - zero) / 1e3 for t in spins]}
    kept = {g: 0 for g in GROUPS}
    shift = None
    if spins and "end" in host and spins[-1] >= host["end"][0]:
        shift = spins[-1] - host["end"][0]
        for t in spins:
            owner = max((g for g in host if host[g][0] <= t - shift),
                        key=lambda g: host[g][0], default=None)
            if owner is not None:
                kept[owner] += 1
    rec["kept"] = kept
    rec["end_shift_ms"] = None if shift is None else shift / 1e3
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=240.0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profiler_window: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import subprocess
    from repro_torch.kernels.rank_merge import merge_ranks
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    t_start = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    runs = torch.randint(0, 1 << 31, (64, 4, 131072), generator=gen,
                         device="cuda").sort(dim=-1).values
    fn = lambda: merge_ranks(runs)
    fn()
    torch.cuda.synchronize()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    path = os.path.join(ROOT, "chiprun_out", "profiler_window.jsonl")
    lines = []
    i = 0
    while time.perf_counter() - t_start < args.seconds:
        cached = i % 2 == 0
        if cached:
            blocks = [torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
                      for _ in range(50)]
            del blocks
        else:
            torch.cuda.empty_cache()
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        margin = 0.02 if i % 4 < 2 else 0.05
        rec = {"trace": i, "age_s": time.perf_counter() - t_start,
               "reserved_gb": torch.cuda.memory_reserved() / 2**30,
               "margin_s": margin, **trace(torch, fn, margin)}
        lines.append(rec)
        i += 1
    with open(path, "w") as f:
        for rec in lines:
            f.write(json.dumps(rec) + "\n")
    whole = [r for r in lines if r["kernels"] == {"partition_kernel": 10,
                                                  "merge_kernel": 10}]
    print(json.dumps({
        "traces": len(lines), "whole": len(whole),
        "cut": [{k: r[k] for k in ("trace", "age_s", "reserved_gb",
                                   "margin_s", "kernels", "kept",
                                   "end_shift_ms", "host_ms", "spins_ms")}
                for r in lines if r not in whole][:8],
        "end_shift_ms": [r["end_shift_ms"] for r in lines]}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
