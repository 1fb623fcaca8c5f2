"""Dry run: trace a train, prefill or decode step on meta tensors on the production mesh (reference: ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b \
        --shape decode_32k [--mesh single|multi|both] [--serve2d] \
        [--sync ring|hier|sparse] [--out DIR]

The reference lowers and compiles each (arch x shape) pair on 512 forced
host devices and reads the compiled program.  The port runs the step
itself on the meta device (``launch.specs``: parameters, optimizer
state, batches and caches as shapes only, nothing allocated) on the
stacked production mesh (``launch.mesh``: 16 x 16, or 2 x 16 x 16), under
the exchange and op censuses (``repro_torch.analysis.auditor``) and a
``FlopCounterMode``, and reports the reference's keys with its ``hlo_*``
readings replaced by named torch analogues (``launch.trace_stats``):

* ``traced_flops`` / ``traced_matmul_flops``: the FLOP counter's totals
  over the whole stacked mesh, divided by the chips;
* ``unfused_op_bytes``: every op's input and output bytes over the mesh,
  divided by the chips -- an upper bound on the memory traffic (no
  fusion);
* ``collectives`` / ``collective_bytes``: every exchange's bytes by the
  reference's formulas, for one position of the stacked mesh: a data
  position over the data axes -- it holds its leaves whole, so an
  operand the reference splits over the model axis counts tp times what
  one of its chips moves -- and a (data, model) position over the model
  axis;
* the roofline terms in H100 seconds (``core.netmodel``'s data-sheet
  figures: bf16 peak, HBM rate, NVLink each way), ``bottleneck``,
  ``model_flops_per_chip`` (flops factor x active params x tokens /
  chips) and ``useful_compute_ratio``; ``modeled_memory`` and
  ``fits_hbm`` against 80 GB (``launch.memmodel``).

On the stacked mesh the model axis holds every leaf whole and runs each
product whose function tp does not change once per data row, so the
traced FLOPs are the mesh's, and their share per chip assumes an even
split.  The sparse gradient sync traces like the dense ones: its plan's
capacities are static (``sparse_tokens_hint``), and the one value its
path reads back on the host, the largest duplicate group of the sort
merge's ``segment_compact``, is on meta tensors the stage's degree (the
k unique runs merged can repeat an index at most k times), so the trace
counts that loop's worst case.  Every pair traces its
whole step, op by op, on the host: at 256 stacked positions a decode
pair takes seconds, qwen1.5-0.5b's train_4k half a minute and
jamba-1.5-large's twenty (``PERF.md`` has the times).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis.auditor import ExchangeCensus, OpCensus
from repro_torch.configs import (ARCHS, ASSIGNED_SHAPES, SHAPES, get_config,
                                 pair_plan)
from repro_torch.core.netmodel import (HBM_BYTES_PER_S, NVLINK_BYTES_PER_S,
                                       PEAK_FLOPS_BF16)
from repro_torch.launch import trace_stats as TS
from repro_torch.launch.memmodel import fits, modeled_memory
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import (decode_arg_specs, opt_specs,
                                      params_specs, prefill_batch_specs,
                                      train_batch_specs)
from repro_torch.train.step import (MeshCtx, make_decode_step,
                                    make_prefill_step, make_train_step)


def _auto_microbatch(global_batch: int, seq: int, mc: MeshCtx,
                     target_tokens: int = 8192) -> int:
    """Smallest divisor of a data position's rows whose microbatch holds
    at most ``target_tokens`` tokens (the reference's rule)."""
    b_loc = max(1, global_batch // mc.dp)
    need = max(1, -(-b_loc * seq // target_tokens))
    for micro in range(need, b_loc + 1):
        if b_loc % micro == 0:
            return micro
    return b_loc


def lower_pair(arch: str, shape_name: str, mc: MeshCtx, sync: str = "ring",
               overrides: Optional[Dict[str, Any]] = None,
               microbatch: Optional[int] = None,
               dp_degrees: Optional[Dict[str, tuple]] = None,
               serve2d: bool = False, cfg=None):
    """``(run, cfg, meta)``: ``run()`` executes the pair's step on meta
    tensors on ``mc``; ``run`` is None for a pair the long-context policy
    skips (``meta["skipped"]``).  ``overrides``: ``dataclasses.replace``
    fields of the config; ``cfg`` replaces the registry's config."""
    variant = pair_plan(arch, shape_name) if cfg is None else "given"
    if variant is None:
        return None, None, {"skipped": "long_500k inapplicable (DESIGN.md)"}
    cfg = cfg if cfg is not None else get_config(arch, variant)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    micro = 1
    if shape.kind == "train":
        micro = microbatch or _auto_microbatch(shape.global_batch,
                                               shape.seq_len, mc)
        step, _ = make_train_step(cfg, mc, sync=sync, microbatch=micro,
                                  dp_degrees=dp_degrees)
        params = params_specs(cfg, mc.tp)
        args = (params, opt_specs(cfg, mc.tp, params),
                train_batch_specs(cfg, shape))
        tokens, flops_factor = shape.global_batch * shape.seq_len, 6.0
    elif shape.kind == "prefill":
        step, _ = make_prefill_step(cfg, mc, max_seq=shape.seq_len)
        args = (params_specs(cfg, mc.tp), prefill_batch_specs(cfg, shape))
        tokens, flops_factor = shape.global_batch * shape.seq_len, 2.0
    else:
        seq_sharded = shape.kind == "decode_long"
        step, _ = make_decode_step(cfg, mc, seq_sharded=seq_sharded,
                                   serve2d=serve2d)
        token, pos, cache, extras = decode_arg_specs(cfg, shape, mc,
                                                     seq_sharded)
        args = (params_specs(cfg, mc.tp), token, pos, cache) + extras
        tokens, flops_factor = shape.global_batch, 2.0
    meta = {"variant": variant, "tokens": tokens,
            "flops_factor": flops_factor,
            "active_params": cfg.active_param_count(),
            "total_params": cfg.param_count(), "n_periods": cfg.n_periods,
            "microbatch": micro, "serve2d": serve2d,
            "cfg_obj": cfg, "shape_obj": shape}
    return (lambda: step(*args)), cfg, meta


def analyse(run, cfg, meta, mc: MeshCtx) -> Dict[str, Any]:
    """Run the traced step under the censuses and the FLOP counter and
    read the reference's keys off them (module docstring)."""
    chips = mc.dp * mc.tp
    ex, ops = ExchangeCensus(), OpCensus()
    counter = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with ex, counter, ops:
        run()
    out: Dict[str, Any] = {k: v for k, v in meta.items()
                           if k not in ("cfg_obj", "shape_obj")}
    out.update({"chips": chips, "trace_s": time.perf_counter() - t0,
                "mesh": "x".join(str(v) for v in mc.shape.values())})
    mm = modeled_memory(meta["cfg_obj"], meta["shape_obj"], mc,
                        meta.get("microbatch", 1))
    out["modeled_memory"] = {k: v / 1e9 for k, v in mm.items()}
    out["fits_hbm"] = fits(mm)
    fl = TS.flops(counter)
    out["traced_flops"] = fl["total"] / chips
    out["traced_matmul_flops"] = fl["matmul"] / chips
    out["unfused_op_bytes"] = ops.op_bytes / chips
    out["aten_ops"] = sum(ops.ops.values())
    stats = TS.collective_stats(ex.records)
    out["collectives"] = stats
    out["collective_bytes"] = TS.total_collective_bytes(stats)
    out["exchanges"] = {a: dict(ex.counts(a)) for a in ("data", "model")}
    out["t_compute_s"] = out["traced_flops"] / PEAK_FLOPS_BF16
    out["t_memory_s"] = out["unfused_op_bytes"] / HBM_BYTES_PER_S
    out["t_collective_s"] = out["collective_bytes"] / NVLINK_BYTES_PER_S
    terms = {"compute": out["t_compute_s"], "memory": out["t_memory_s"],
             "collective": out["t_collective_s"]}
    out["bottleneck"] = max(terms, key=terms.get)
    model_flops = meta["flops_factor"] * meta["active_params"] \
        * meta["tokens"] / chips
    out["model_flops_per_chip"] = model_flops
    out["useful_compute_ratio"] = model_flops / out["traced_flops"] \
        if out["traced_flops"] > 0 else None
    return out


def run_pair(arch: str, shape_name: str, multi_pod: bool, sync: str,
             outdir: Optional[str], overrides: Optional[Dict[str, Any]] = None,
             microbatch: Optional[int] = None,
             dp_degrees: Optional[Dict[str, tuple]] = None,
             serve2d: bool = False, tag_suffix: str = "",
             mc: Optional[MeshCtx] = None) -> Dict[str, Any]:
    """Trace one pair on the production mesh (or ``mc``), write its JSON
    under ``outdir`` (when given) and return it."""
    mc = mc or make_production_mesh(multi_pod=multi_pod)
    run, cfg, meta = lower_pair(arch, shape_name, mc, sync,
                                overrides=overrides, microbatch=microbatch,
                                dp_degrees=dp_degrees, serve2d=serve2d)
    if run is None:
        res = dict(meta, arch=arch, shape=shape_name,
                   mesh="x".join(str(v) for v in mc.shape.values()))
    else:
        res = analyse(run, cfg, meta, mc)
        res.update({"arch": arch, "shape": shape_name, "sync": sync,
                    "overrides": overrides or {}})
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        tag = f"{arch}_{shape_name}_{res['mesh']}_{sync}{tag_suffix}"
        with open(os.path.join(outdir, tag + ".json"), "w") as f:
            json.dump(res, f, indent=2, default=str)
    return res


def main(argv=None) -> int:
    """The reference's flags (``--no-hlo`` has no counterpart: nothing is
    compiled), plus ``--serve2d``."""
    ap = argparse.ArgumentParser(description="production-mesh dry run on "
                                             "meta tensors")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--sync", default="ring",
                    choices=["ring", "hier", "sparse"])
    ap.add_argument("--serve2d", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)
    archs = list(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(ASSIGNED_SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch} x {shape} x {'2x16x16' if mp else '16x16'}"
                try:
                    r = run_pair(arch, shape, mp, args.sync, args.out,
                                 serve2d=args.serve2d)
                except Exception as e:
                    failures.append((tag, str(e)))
                    print(f"FAIL {tag}: {e}")
                    traceback.print_exc()
                    continue
                if "skipped" in r:
                    print(f"SKIP {tag}: {r['skipped']}")
                    continue
                print(f"OK   {tag}: trace {r['trace_s']:.1f}s modeled "
                      f"{r['modeled_memory']['total']:.2f}GB flops/chip "
                      f"{r['traced_flops']:.3g} coll "
                      f"{r['collective_bytes'] / 1e6:.1f}MB "
                      f"bottleneck={r['bottleneck']}", flush=True)
    if failures:
        print(f"\n{len(failures)} FAILURES")
        return 1
    print("\nall dry-runs green")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

