#!/usr/bin/env python3
"""Readings that set a cell's limits: the program's compared numbers on
many seeds, and the control's.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--seconds 2]

For each seed, in one process: the cell's set-up, a short window
(``--seconds``), the check against the plain reference (the program's
readings), then the control: the reference computed one precision lower
(``bfloat16`` for the float32 cells) in the program's place, held to the
same comparison.  One JSON line a seed.  Not part of a benchmark run.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def readings(workload: str, seed: int, seconds: float, device: str,
             overrides=None, with_control: bool = True) -> dict:
    """The program's and the control's compared numbers for one seed."""
    from portbench import harness
    cell = harness.build_cell(workload, seed, device, ROOT, overrides)[3]
    sync = harness.device_sync(device)
    win = harness.run_window(cell, seconds, sync)
    verdict = cell.check()
    out = {"seed": seed, "units": win["units"],
           "program": {c["name"]: c["value"] for c in verdict["checks"]}}
    if hasattr(cell, "detail"):
        out["detail"] = cell.detail()
    if with_control:
        out["control"] = cell.control()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--control-seeds", type=int, default=None,
                    help="run the control on the first N seeds only")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    n_ctl = len(seeds) if args.control_seeds is None else args.control_seeds
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        out = readings(args.workload, seed, args.seconds, args.device,
                       with_control=i < n_ctl)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    os.environ["REPRO_PLAN_CACHE"] = os.path.join(ROOT, "build",
                                                  "portbench_plans")
    sys.exit(main())
