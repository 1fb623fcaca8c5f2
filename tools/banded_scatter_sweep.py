#!/usr/bin/env python3
"""Sweep the block shape of the banded scatter kernel on one NVIDIA GPU.

    python3 tools/banded_scatter_sweep.py [--old PATH]

Drives the port's union path (``merge="banded"``, the raw, delta+bf16 and
delta+int8ef wires) on ``chip_smoke.py``'s mini-batch inputs and records
the banded scatter's inputs at each (butterfly layer, value dtype) the
main path hands it: f32, bf16 and int8 + scale at layer 0 ([64, 262144]
positions, 262,144 rows) and layer 1 ([64, 524288], 131,072 rows).  Then
builds variants of ``src/repro_torch/kernels/csrc/banded_onehot_scatter.cu``
(threads per block x window entries per thread and pass x blocks an SM
must hold), each into its own shared library under ``build/banded_sweep/``
(one ``nvcc`` per variant, all started together), and for every variant
and tile height (output rows per block, a launch argument) checks the
result bit for bit against the plain version (on the card for dyadic
values, on a CPU copy for the int8 wire's general scales) and times its C
entry point (window table and scatter) with CUDA events, the table launch
alone beside it.  ``--old PATH`` also builds an earlier
``banded_onehot_scatter.cu`` (the entry point without a window table) and
times it on the same inputs, in turns with the shipped shape (old, new,
new, old).  Prints the card's name and power limit, each variant's
registers and spills (``ptxas -v``), then one JSON line per call with the
ms of each variant.  Needs a CUDA GPU and nvcc.
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
OUT = os.path.join(ROOT, "build", "banded_sweep")
# (THREADS, ITEMS, MIN_BLOCKS): scatter block, window entries per thread
# and pass, blocks an SM must hold (the register cap)
SHAPES = [(128, 4, 8), (256, 2, 4), (256, 4, 4), (256, 4, 6), (256, 8, 4),
          (512, 4, 2)]
TILE_ROWS = (1024, 2048, 4096, 8192, 16384)
WIRES = {"raw": "f32", "delta+bf16": "bf16", "delta+int8ef": "scaled"}
P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def variant(name: str, consts) -> str:
    """The shipped source with each ``constexpr int NAME = value;`` of
    ``consts`` set, written under OUT as ``name``.cu; returns its path."""
    text = open(os.path.join(CSRC, "banded_onehot_scatter.cu")).read()
    for const, value in consts.items():
        text, n = re.subn(rf"constexpr int {const} = \d+;",
                          f"constexpr int {const} = {value};", text)
        assert n == 1, const
    path = os.path.join(OUT, name + ".cu")
    with open(path, "w") as f:
        f.write(text)
    return path


def build(sources):
    """Compile each source into its own shared library, in parallel."""
    from repro_torch.kernels import _build
    procs = []
    for name, path in sources.items():
        so = os.path.join(OUT, name + ".so")
        procs.append((name, so, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-shared", path, "-o", so],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs, ptxas = {}, {}
    for name, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        ptxas[name] = [ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln]
        lib = ctypes.CDLL(so)
        if name == "old":
            lib.repro_banded_onehot_scatter_add.argtypes = (P, P, P, P, LL, LL,
                                                            LL, I, I, P)
        else:
            lib.repro_banded_onehot_scatter_add.argtypes = (
                P, P, P, P, LL, LL, LL, I, I, P, LL, P)
            lib.repro_banded_windows.argtypes = (P, P, LL, LL, LL, LL, P)
        libs[name] = lib
    print(json.dumps({"ptxas": ptxas}), flush=True)
    return libs


def cuda_ms(torch, fn, reps: int = 20) -> float:
    """Mean milliseconds per call of ``fn`` by CUDA events, after two
    warm-up calls."""
    for _ in range(2):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main_path_inputs(torch):
    """{(dtype, pos shape): (pos, val, rows, scale)}: the banded scatter's
    first input at each main-path (layer, dtype), from union reduces on
    ``chip_smoke.py``'s mini-batch inputs."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from repro_torch.core.allreduce import shape_bucket
    from repro_torch.core.api import SparseAllreduce
    from repro_torch.kernels import ops
    idx, val, want_idx, _ = chip_smoke.union_wire_inputs()
    ti, tv = torch.as_tensor(idx, device="cuda"), torch.as_tensor(
        val, device="cuda")
    seen, inner = {}, ops.banded_onehot_scatter_add

    def record(pos, v, rows, *, band, scale=None):
        dtype = "scaled" if scale is not None else (
            "bf16" if v.dtype == torch.bfloat16 else "f32")
        seen.setdefault((dtype, tuple(pos.shape)), (pos, v, rows, scale))
        return inner(pos, v, rows, band=band, scale=scale)

    ops.banded_onehot_scatter_add = record
    try:
        for wire in WIRES:
            ar = SparseAllreduce(chip_smoke.M, chip_smoke.DEGREES,
                                 backend="device", merge="banded", wire=wire)
            ar.union_reduce(ti, tv, shape_bucket(len(want_idx)))
    finally:
        ops.banded_onehot_scatter_add = inner
    torch.cuda.synchronize()
    return seen


def main() -> int:
    import torch
    parser = argparse.ArgumentParser()
    parser.add_argument("--old", help="an earlier banded_onehot_scatter.cu")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("banded_scatter_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import onehot_scatter, ref
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    os.makedirs(OUT, exist_ok=True)
    sources = {f"t{t}_i{i}_b{b}": variant(f"t{t}_i{i}_b{b}", {
        "THREADS": t, "ITEMS": i, "MIN_BLOCKS": b}) for t, i, b in SHAPES}
    if args.old:
        sources["old"] = args.old
    libs = build(sources)
    inputs = main_path_inputs(torch)
    stream = torch.cuda.current_stream().cuda_stream
    dtypes = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
    text = open(os.path.join(CSRC, "banded_onehot_scatter.cu")).read()
    shipped = "t{}_i{}_b{}".format(*(
        re.search(rf"constexpr int {k} = (\d+);", text).group(1)
        for k in ("THREADS", "ITEMS", "MIN_BLOCKS"))), \
        onehot_scatter.BANDED_ROWS
    for (kind, shape), (pos, val, rows, scale) in sorted(
            inputs.items(), key=lambda kv: (kv[0][1], kv[0][0])):
        b, c = pos.shape
        w = val.shape[-1]
        sp = None if scale is None else scale.data_ptr()
        if scale is None:
            want = ref.onehot_scatter_add_ref(pos, val, rows)
        else:
            want = ref.onehot_scatter_add_ref(pos.cpu(), val.cpu(), rows,
                                              scale.cpu()).cuda()
        out = torch.empty_like(want)
        kept = int(((pos >= 0) & (pos < rows)).sum())
        line = {"dtype": kind, "shape": [b, c, w, rows], "kept": kept,
                "ms": {}, "table_ms": {}}

        def new_call(lib, bm, table):
            return lambda: lib.repro_banded_onehot_scatter_add(
                pos.data_ptr(), val.data_ptr(), sp, out.data_ptr(), b, c,
                rows, w, dtypes[val.dtype], table.data_ptr(), bm, stream)

        for bm in TILE_ROWS:
            table = torch.empty(b, -(-rows // bm) + 1, dtype=torch.int64,
                                device="cuda")
            for name, lib in libs.items():
                if name == "old":
                    continue
                call = new_call(lib, bm, table)
                out.fill_(float("nan"))
                assert call() == 0, name
                torch.cuda.synchronize()
                assert torch.equal(out, want), (name, bm, kind, shape)
                line["ms"][f"{name}_bm{bm}"] = cuda_ms(torch, call)
            lib = libs[shipped[0]]
            line["table_ms"][bm] = cuda_ms(torch, lambda: lib.repro_banded_windows(
                pos.data_ptr(), table.data_ptr(), b, c, rows, bm, stream))
        if "old" in libs:
            old = lambda: libs["old"].repro_banded_onehot_scatter_add(
                pos.data_ptr(), val.data_ptr(), sp, out.data_ptr(), b, c,
                rows, w, dtypes[val.dtype], stream)
            out.fill_(float("nan"))
            assert old() == 0
            torch.cuda.synchronize()
            assert torch.equal(out, want), ("old", kind, shape)
            table = torch.empty(b, -(-rows // shipped[1]) + 1,
                                dtype=torch.int64, device="cuda")
            new = new_call(libs[shipped[0]], shipped[1], table)
            turns = {"old": [], "new": []}
            for name in ("old", "new", "new", "old"):
                turns[name].append(cuda_ms(torch, old if name == "old"
                                           else new))
            line["turns_ms"] = turns
            line["shipped"] = f"{shipped[0]}_bm{shipped[1]}"
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
