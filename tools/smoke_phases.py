#!/usr/bin/env python3
"""Run named phases of ``chip_smoke.py`` alone, on one NVIDIA GPU.

    python3 tools/smoke_phases.py serve_splitkv serve_2d [...]

Builds the port's kernels, then calls ``chip_smoke.phase_<name>`` for
each name in turn, in this process, with a fresh plan-cache directory:
each phase prints its JSON line as in the smoke, and this script a
``SECONDS <name> <s>`` line after it (or the traceback, and goes on).
The first line is the card's name and power limit.  What the whole
smoke adds around a phase (the Recorders, the kernels line, the parked
inputs) is left out, so a phase that reads another's result (``dryrun``
prints serve_2d's peak) reads what ran before it here.  Needs a CUDA GPU
and nvcc.
"""
import os
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def main(names) -> int:
    import torch
    import chip_smoke as C
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        print("smoke_phases: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    C.SCRATCH["root"] = tempfile.mkdtemp(prefix="smoke-phases-")
    os.environ["REPRO_PLAN_CACHE"] = os.path.join(C.SCRATCH["root"],
                                                  "plans")
    t0 = time.perf_counter()
    _build.build()
    _build.library()
    print(f"BUILD {time.perf_counter() - t0}", flush=True)
    failed = 0
    for name in names:
        C.PHASE["name"] = name
        t0 = time.perf_counter()
        try:
            getattr(C, "phase_" + name)(torch)
        except Exception:
            traceback.print_exc()
            failed += 1
        print(f"SECONDS {name} {time.perf_counter() - t0}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
