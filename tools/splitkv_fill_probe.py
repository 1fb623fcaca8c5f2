#!/usr/bin/env python3
"""How the split-KV check of ``chip_smoke.py`` reads under other cache fills, on one NVIDIA GPU.

    python3 tools/splitkv_fill_probe.py [K,V ...]     # default 0.1,0.1 0.1,1 0.3,0.3 1,1

For each (k scale, v scale) fill of the cache and each of the smoke's
two split-KV configurations (``SPLITKV``: qwen1.5-0.5b ``swa`` at
524,288 slots; ``SPLITKV_BASE``: the base variant at 32,768 slots, 4
rows), runs ``chip_smoke.layout_pair`` without its asserts and prints
one JSON line: the largest logit error of the split-KV decode against
the one-position gather decode over its 16 steps, the control (the
gather decode with the spec's ``drop`` slots zeroed) against it, and the
write readings.  The first line is the card's name and power limit.
A fill is good for the smoke when the error sits well under
``SERVE_REL_BOUND`` and the control well over it.
"""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def main(fills) -> int:
    import numpy as np
    import torch
    import chip_smoke as C
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.train.step import (init_cache_global, make_decode_step,
                                        mesh_ctx)
    if not torch.cuda.is_available():
        print("splitkv_fill_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for spec in (C.SPLITKV, C.SPLITKV_BASE):
        cfg = get_config(C.SERVE_ARCH, spec["variant"])
        mc = mesh_ctx(spec["data"], device=C.DEVICE)
        one = mesh_ctx(1, device=C.DEVICE)
        params = T.init_params(cfg, 1, seed=0, device=C.DEVICE)
        cache = init_cache_global(cfg, mc, spec["rows"], spec["slots"],
                                  seq_sharded=True)
        layout = make_decode_step(cfg, mc, seq_sharded=True)[0]
        twin = make_decode_step(cfg, one)[0]
        tok = np.random.RandomState(2).randint(0, cfg.vocab, spec["rows"])
        for fill in fills:
            C.fill_cache(torch, cache, 1, fill)
            r, _ = C.layout_pair(torch, cfg, params, layout, twin, tok,
                                 np.asarray(spec["pos"], np.int64), cache,
                                 C.DECODE_STEPS, spec["drop"], check=False)
            print(json.dumps({"variant": spec["variant"], "fill": fill,
                              **{k: r[k] for k in (
                                  "rel_err_max", "control_rel_err",
                                  "write_err_max", "unwritten_min",
                                  "bound")}}), flush=True)
        del params, cache, layout, twin
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    args = sys.argv[1:] or ["0.1,0.1", "0.1,1", "0.3,0.3", "1,1"]
    sys.exit(main([tuple(float(x) for x in a.split(",")) for a in args]))
