"""The benchmark's harness: everything between the command line and the
result line, driven by ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  The configuration's ``file`` (``portbench/configs/<name>.json``)
holds its sizes and settings; the traffic mix is the data file
``portbench/traffic/<traffic>.json``, whose ``runner`` key names the
general generator and runner that read it
(``portbench/runners/<runner>.py``).  Every metric, end to end or per
layer, is a small reader of its own, ``portbench/metrics/<name>.py``
(or, for a quantity that each cell reports under a name of its own such
as ``device_idle.train``, the reader of the name's first part,
``device_idle.py``), whose ``read(ctx)`` returns a number or ``None``
(nothing to read: the metric is left out of the line).  So a cell, a configuration, a traffic
mix or a metric is added by adding files and entries.

A run: set-up (the runner builds its inputs on the device from the seed
and the program's objects, and warms every shape the cell uses), then
the window: units of work back to back for ``--seconds``, each ending in
a synchronisation, timed on the host clock; with ``--trace 1`` the first
``trace_units`` units run under the profiler.  Then the peak memory is
read, the program's state freed, and the runner's check compares what
the window produced with the plain reference.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (the part before the first
    dot), compared whole, is JAX's, jaxlib's, flax's or the JAX
    package's."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def merged(base: dict, over: Optional[dict]) -> dict:
    """``base`` with the keys of ``over`` replaced (the CPU tests' small
    sizes)."""
    out = dict(base)
    out.update(over or {})
    return out


def cell_spec(manifest: dict, workload: str, root: str = ROOT):
    """``(workload entry, configuration, traffic)`` of a cell by name."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    wl = cells[workload]
    cfg_entry = {c["name"]: c for c in manifest["configs"]}[wl["config"]]
    config = load_json(os.path.join(root, cfg_entry["file"]))
    traffic = load_json(os.path.join(root, "portbench", "traffic",
                                     f"{wl['traffic']}.json"))
    return wl, config, traffic


def cell_metrics(manifest: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics a run of the cell reports: with ``trace`` the per-layer
    metrics that list the cell (or, without a ``workloads`` key, move an
    end-to-end metric the cell reports), else its end-to-end metrics."""
    e2e = [m for m in manifest["end_to_end"]
           if workload in m.get("workloads", (workload,))]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def reader(name: str, root: str = ROOT) -> Callable[[dict], Optional[float]]:
    """``read`` of ``portbench/metrics/<name>.py``, or, where there is no
    such file, of the reader of the part of ``name`` before its first
    dot."""
    path = os.path.join(root, "portbench", "metrics", f"{name}.py")
    if not os.path.exists(path):
        path = os.path.join(root, "portbench", "metrics",
                            f"{name.split('.', 1)[0]}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def runner(name: str):
    """The runner module ``portbench/runners/<name>.py``."""
    return importlib.import_module(f"portbench.runners.{name}")


def device_sync(device) -> Callable[[], None]:
    import torch
    if torch.device(device).type == "cuda":
        return torch.cuda.synchronize
    return lambda: None


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=False)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def run_window(cell, seconds: float, sync, trace_units: int = 0,
               profiler=None) -> dict:
    """Units back to back until ``seconds`` have passed (each unit ends in
    a synchronisation); the first ``trace_units`` under ``profiler``.
    Returns the window's wall seconds, the units done and each unit's
    seconds, and the reduced trace."""
    import torch
    lat: List[float] = []
    trace = None
    if profiler is not None:
        profiler.start()
    start = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"portbench.{cell.unit}"):
            cell.step(i)
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        i += 1
        if profiler is not None and i == trace_units:
            trace = profiler.stop(sync)
            profiler = None
        if t1 - start >= seconds and profiler is None:
            break
    return {"window_s": t1 - start, "units": i, "latencies_s": lat,
            "trace": trace}


def build_cell(workload: str, seed: int, device: str, root: str = ROOT,
               overrides: Optional[dict] = None, log=sys.stderr):
    """``(manifest, configuration, traffic, cell)``: the cell's runner set
    up and warmed.  ``overrides`` (tests: ``{"config": {...}, "traffic":
    {...}}``) replaces keys of the configuration and traffic files."""
    manifest = load_json(os.path.join(root, "BENCHMARK.json"))
    _, config, traffic = cell_spec(manifest, workload, root)
    overrides = overrides or {}
    config = merged(config, overrides.get("config"))
    traffic = merged(traffic, overrides.get("traffic"))
    cell = runner(traffic["runner"]).Cell(config, traffic, seed, device,
                                          log=log)
    cell.warm()
    device_sync(device)()
    return manifest, config, traffic, cell


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: str = ROOT,
             overrides: Optional[dict] = None, t_start: Optional[float] = None,
             log=sys.stderr) -> dict:
    """One run of ``workload`` on ``device``: the result line's object
    (checks last); ``overrides`` as :func:`build_cell`'s."""
    import torch
    from portbench.tracing import Profiler
    t_start = time.perf_counter() if t_start is None else t_start
    manifest, config, traffic, cell = build_cell(workload, seed, device, root,
                                                 overrides, log)
    sync = device_sync(device)
    setup_s = time.perf_counter() - t_start
    prof = Profiler(torch.device(device).type) if trace else None
    win = run_window(cell, seconds, sync,
                     trace_units=int(traffic.get("trace_units", 1)),
                     profiler=prof)
    on_card = torch.device(device).type == "cuda"
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    ctx = {"window_s": win["window_s"], "units": win["units"],
           "latencies_s": win["latencies_s"], "work": cell.work,
           "facts": cell.facts(), "setup_s": setup_s, "config": config,
           "traffic": traffic}
    if trace:
        tr = win["trace"]
        traced = min(win["units"], int(traffic.get("trace_units", 1)))
        ctx.update(trace=tr, units=traced, window_s=tr["window_s"],
                   spans=cell.spans(traced) if hasattr(cell, "spans")
                   else {})
    metrics: Dict[str, dict] = {}
    for m in cell_metrics(manifest, workload, trace):
        value = reader(m["name"], root)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    verdict = cell.check()
    checks = verdict["checks"]
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    if on_card:
        dev["power"] = power_limit()
    line = {"correct": win["units"] > 0 and all(c["ok"] for c in checks),
            "attempted": win["units"], "failed": verdict["failed"],
            "metrics": metrics, "device": dev}
    if trace:
        tr = win["trace"]
        dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                      for c in checks}
    return line


def main(argv=None, t_start: Optional[float] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError as e:
        print(f"portbench: torch is not importable ({e})", file=sys.stderr)
        return 2
    manifest = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    wl = {w["name"]: w for w in manifest["workloads"]}.get(args.workload)
    if wl is None:
        print(f"portbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(wl["chips"]):
        print(f"portbench: needs {wl['chips']} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        importlib.import_module("repro_torch")
    except ImportError as e:
        print(f"portbench: the port is not importable ({e})", file=sys.stderr)
        return 2
    line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                    t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
