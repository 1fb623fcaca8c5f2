#!/usr/bin/env python3
"""Where a full-width train step's time goes, on one CUDA GPU.

    PYTHONPATH=src python3 tools/train_step_profile.py [--sync sparse]
        [--merge fused] [--wire raw] [--steps 3] [--profile]
        [--arch qwen1.5-0.5b] [--data-axis 8] [--degrees 4,2]
        [--layers N]

Builds ``make_train_step`` on ``--arch`` untied (default: the smoke's
train phase, qwen1.5-0.5b on M = 8 stacked data positions, degrees (4,
2); granite-moe-3b-a800m with ``--data-axis 2 --degrees 2`` is the
smoke's train_moe, xlstm-1.3b its train_ssm, whisper-base its
train_encdec, internvl2-26b with ``--data-axis 4 --degrees 2,2 --layers
4`` its train_vlm; ``--layers`` cuts the depth), batch 8 x seq 256 (and
the config's stub frames or image tokens), the
parameters and optimizer state donated, runs ``--steps`` steps
and prints, per step, the forward + backward, sync and update
milliseconds by CUDA events and the host wall time of the step.  With
``--profile`` one more step runs under
``torch.profiler`` and the script prints the largest device and host
operators of that step (``key_averages``), so a slow stage can be named.
Prints one JSON line per step and, last, a summary line.
"""
import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))


def main() -> int:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import batch_stream
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.step import make_train_step, mesh_ctx

    ap = argparse.ArgumentParser()
    ap.add_argument("--sync", default="sparse",
                    choices=["ring", "hier", "sparse"])
    ap.add_argument("--merge", default="fused",
                    choices=["sort", "fused", "banded"])
    ap.add_argument("--wire", default="raw")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--rows", type=int, default=25,
                    help="operators printed per profiler table")
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--data-axis", type=int, default=8)
    ap.add_argument("--degrees", default="4,2")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: as published)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_step_profile: no CUDA device", file=sys.stderr)
        return 2

    cfg = get_config(args.arch, "untied")
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    mc = mesh_ctx(args.data_axis)
    degrees = tuple(int(x) for x in args.degrees.split(","))
    step, _ = make_train_step(
        cfg, mc, sync=args.sync, dp_degrees={"data": degrees},
        sparse_tokens_hint=8 * 256 // mc.dp, sync_merge=args.merge,
        sync_wire=args.wire)
    params = T.init_params(cfg, 1, seed=0)
    st = AdamW().init(params)
    stream = batch_stream(cfg, 8, 256, seed=0)
    rows = []
    for i in range(args.steps):
        ev = {s: torch.cuda.Event(enable_timing=True)
              for s in ("start", "fwd_bwd", "sync", "update")}
        batch = next(stream)       # drawn before the clock: img_embeds
        torch.cuda.synchronize()   # alone are 8 x 1,024 x 6,144 normals
        t0 = time.perf_counter()
        ev["start"].record()
        params, st, m = step(params, st, batch,
                             mark=lambda s: ev[s].record())
        torch.cuda.synchronize()
        row = {"step": i, "wall_ms": (time.perf_counter() - t0) * 1e3,
               "fwd_bwd_ms": ev["start"].elapsed_time(ev["fwd_bwd"]),
               "sync_ms": ev["fwd_bwd"].elapsed_time(ev["sync"]),
               "update_ms": ev["sync"].elapsed_time(ev["update"]),
               "loss": float(m["loss"]),
               "max_memory_allocated": torch.cuda.max_memory_allocated()}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        batch = next(stream)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            params, st, m = step(params, st, batch)
            torch.cuda.synchronize()
        avg = prof.key_averages()
        print(avg.table(sort_by="cuda_time_total", row_limit=args.rows))
        print(avg.table(sort_by="cpu_time_total", row_limit=args.rows))
        dev = [(getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0), e.count)
               for e in avg if e.device_type != torch.autograd.DeviceType.CPU]
        print(json.dumps({"device_ms": sum(us for us, _ in dev) / 1e3,
                          "device_launches": sum(n for us, n in dev if us)}))
    print(json.dumps({"summary": True, "arch": cfg.name, "sync": args.sync,
                      "layers": cfg.n_layers, "fsdp": cfg.fsdp,
                      "merge": args.merge, "wire": args.wire,
                      "device": torch.cuda.get_device_name(0),
                      "steps": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
