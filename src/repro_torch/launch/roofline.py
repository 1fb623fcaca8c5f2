"""Roofline table from the port's dry-run JSONs (reference: ``repro.launch.roofline``).

    PYTHONPATH=src python -m repro_torch.launch.roofline [--dir results/dryrun_torch]

Per (arch x shape) on one mesh: the three roofline terms in H100 seconds
a step a chip (compute: traced FLOPs over the bf16 peak; memory: the
unfused op bytes over HBM's rate, an upper bound; collective: exchange
bytes over NVLink's rate each way), the bottleneck, the useful-compute
ratio (model FLOPs / traced FLOPs) and whether the modeled memory fits
one H100's 80 GB.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, Tuple

from repro_torch.configs import ARCHS, ASSIGNED_SHAPES


def load_results(dirname: str, mesh: str = "16x16", sync: str = "ring"
                 ) -> Dict[Tuple[str, str], dict]:
    """``{(arch, shape): result}`` of the dry-run JSONs of one mesh / sync
    (untagged runs only)."""
    out = {}
    for f in glob.glob(os.path.join(dirname, f"*_{mesh}_{sync}.json")):
        with open(f) as fh:
            d = json.load(fh)
        out[(d["arch"], d["shape"])] = d
    return out


def fmt_row(arch: str, shape: str, d) -> str:
    """One markdown row."""
    if d is None:
        return f"| {arch} | {shape} | — | — | — | not run | — | — |"
    if "skipped" in d:
        return f"| {arch} | {shape} | — | — | — | skip (DESIGN.md) | — | — |"
    ratio = d.get("useful_compute_ratio")
    return (f"| {arch} | {shape} | {d['t_compute_s']:.4f} | "
            f"{d['t_memory_s']:.4f} | {d['t_collective_s']:.4f} | "
            f"**{d['bottleneck']}** | {f'{ratio:.2f}' if ratio else '—'} | "
            f"{'yes' if d.get('fits_hbm') else 'NO'} |")


def table(res: Dict[Tuple[str, str], dict], mesh: str) -> str:
    """The markdown table and the bottleneck distribution."""
    lines = [f"### Roofline table — {mesh} mesh (H100 seconds a step a "
             f"chip)", "",
             "| arch | shape | compute s | memory s (unfused bound) | "
             "collective s | bottleneck | useful ratio | fits 80GB |",
             "|---|---|---|---|---|---|---|---|"]
    lines += [fmt_row(a, s, res.get((a, s))) for a in ARCHS
              for s in ASSIGNED_SHAPES]
    bn: Dict[str, int] = {}
    for d in res.values():
        if "bottleneck" in d:
            bn[d["bottleneck"]] = bn.get(d["bottleneck"], 0) + 1
    lines += ["", f"bottleneck distribution: {bn}"]
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--sync", default="ring")
    args = ap.parse_args(argv)
    print(table(load_results(args.dir, args.mesh, args.sync), args.mesh))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
