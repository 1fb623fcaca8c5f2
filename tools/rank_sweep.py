#!/usr/bin/env python3
"""Sweep the block shapes of the two merge-rank kernels on one NVIDIA GPU.

    python3 tools/rank_sweep.py

Builds variants of ``src/repro_torch/kernels/csrc/rank_merge_banded.cu``
(threads per block x bytes of frontier staged at a time) and of
``csrc/rank_merge.cu`` (threads per block x outputs per thread), each into
its own shared library under ``build/rank_sweep/`` (one ``nvcc`` per
variant, all started together), plus the dense kernel with its one-launch
shared-memory tree switched off; checks every variant against the plain
version and times its C entry point (all its CUDA launches) with CUDA
events on runs like the smoke's: sorted random 32-bit values with a
SENTINEL tail, about 39 % valid at [64, 16, 16384], 61 % at
[64, 4, 131072] (union_wire's layers) and 70 % at [64, 4, 2048] (union's
layer 1).  At that last shape a call is host-bound, so the two dense
paths are also timed through a Python launch like the port's wrapper
(output and scratch allocated per call), in turns, beside one
``searchsorted`` over the same run pairs.  Prints the card's name and
power limit, then one JSON line per shape with the ms of each variant.
Needs a CUDA GPU and nvcc.
"""
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
OUT = os.path.join(ROOT, "build", "rank_sweep")
BANDED = [(64, 16), (128, 8), (256, 4)]        # THREADS, MAX_PER_THREAD
STAGES = (16384, 32768, 49152)
DENSE = [(256, 8), (256, 4), (128, 4), (256, 2), (512, 4),
         (512, 2)]                                 # THREADS, ITEMS
# (groups, k, cap, valid entries per run): union_wire's two layers, and
# union's layer 1, whose groups fit in shared memory
SHAPES = [(64, 16, 16384, 6430), (64, 4, 131072, 80000), (64, 4, 2048, 1441)]


def variant(src: str, name: str, consts, subs=()) -> str:
    """Write ``src`` with each ``constexpr int NAME = value;`` of
    ``consts`` set to its value and each (old, new) of ``subs`` replaced
    (each must occur once), under OUT as ``name``.cu; returns its path."""
    text = open(os.path.join(CSRC, src)).read()
    for const, value in consts.items():
        text, n = re.subn(rf"constexpr int {const} = \d+;",
                          f"constexpr int {const} = {value};", text)
        assert n == 1, (src, const)
    for old, new in subs:
        assert text.count(old) == 1, (src, old)
        text = text.replace(old, new)
    path = os.path.join(OUT, name + ".cu")
    with open(path, "w") as f:
        f.write(text)
    return path


def build(sources):
    """Compile each variant into its own shared library, in parallel."""
    from repro_torch.kernels import _build
    procs = []
    for name, path in sources.items():
        so = os.path.join(OUT, name + ".so")
        procs.append((name, so, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-shared", path, "-o", so],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(so)
        if name.startswith("banded"):
            lib.repro_rank_counts_banded.argtypes = (P, P, P, P, P, LL, I, LL,
                                                     I, LL, I, I, I, I, P)
            lib.repro_rank_counts_banded_scratch.argtypes = (LL, LL, I)
            lib.repro_rank_counts_banded_scratch.restype = LL
        else:
            lib.repro_rank_counts.argtypes = (P, P, P, P, LL, I, LL, I, LL, I,
                                              P)
            lib.repro_rank_counts_scratch.argtypes = (LL, I, LL, I)
            lib.repro_rank_counts_scratch.restype = LL
        libs[name] = lib
    return libs


def cuda_ms(torch, fn, reps: int = 10) -> float:
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


def through_python(torch, lib, runs):
    """One call of ``lib``'s dense entry as the port's wrapper makes it:
    output and scratch allocated, device and stream looked up."""
    g, k, cap = runs.shape
    out = torch.empty(runs.shape, dtype=torch.int32, device=runs.device)
    nbytes = lib.repro_rank_counts_scratch(g, k, cap, 2)
    scratch = (torch.empty(nbytes, dtype=torch.uint8, device=runs.device)
               if nbytes else None)
    with torch.cuda.device(runs.device):
        err = lib.repro_rank_counts(
            runs.data_ptr(), runs.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), g, k, cap, k,
            cap, 2, torch.cuda.current_stream(runs.device).cuda_stream)
    assert err == 0
    return out


def runs_of(torch, gen, g, k, cap, valid):
    """[g, k, cap] sorted int64 runs: random 32-bit values, each run with
    valid +- 10 % of them before its SENTINEL tail."""
    x = torch.randint(0, 2**32 - 1, (g, k, cap), generator=gen, device="cuda",
                      dtype=torch.int64)
    n = torch.randint(int(valid * 0.9), int(valid * 1.1), (g, k, 1),
                      generator=gen, device="cuda")
    x = torch.where(torch.arange(cap, device="cuda") < n, x, 2**32 - 1)
    return torch.sort(x, -1).values.contiguous()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("rank_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import ref
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    os.makedirs(OUT, exist_ok=True)
    sources = {}
    for threads, most in BANDED:
        sources[f"banded_t{threads}"] = variant(
            "rank_merge_banded.cu", f"banded_t{threads}",
            {"THREADS": threads, "MAX_PER_THREAD": most})
    for threads, items in DENSE:
        sources[f"dense_t{threads}_i{items}"] = variant(
            "rank_merge.cu", f"dense_t{threads}_i{items}",
            {"THREADS": threads, "ITEMS": items})
    # the shipped shape with the one-launch shared-memory tree switched off
    sources["dense_levels_only"] = variant(
        "rank_merge.cu", "dense_levels_only", {},
        [("return (long long)k * cap * 16 <= smem_limit();",
          "return false;")])
    libs = build(sources)
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for g, k, cap, valid in SHAPES:
        runs = runs_of(torch, gen, g, k, cap, valid)
        want = ref.merge_ranks_ref(runs)
        out = torch.empty(runs.shape, dtype=torch.int32, device="cuda")
        ptr = runs.data_ptr()
        row = {}
        for name, lib in libs.items():
            if name.startswith("banded"):
                scratch = torch.empty(
                    lib.repro_rank_counts_banded_scratch(g * k, cap, 512),
                    dtype=torch.uint8, device="cuda")
                for stage in STAGES:
                    call = lambda: lib.repro_rank_counts_banded(
                        ptr, ptr, out.data_ptr(), scratch.data_ptr(), None, g,
                        k, cap, k, cap, 2, 512, 512, stage, stream)
                    assert call() == 0, name
                    torch.cuda.synchronize()
                    assert torch.equal(out, want), (name, stage)
                    row[f"{name}_stage{stage}"] = cuda_ms(torch, call)
            else:
                scratch = torch.empty(lib.repro_rank_counts_scratch(g, k, cap, 2),
                                      dtype=torch.uint8, device="cuda")
                call = lambda: lib.repro_rank_counts(
                    ptr, ptr, out.data_ptr(), scratch.data_ptr(), g, k, cap, k,
                    cap, 2, stream)
                assert call() == 0, name
                torch.cuda.synchronize()
                assert torch.equal(out, want), name
                row[name] = cuda_ms(torch, call)
        line = {"shape": [g, k, cap], "valid_per_run": valid, "ms": row}
        if cap == SHAPES[-1][2]:
            seq = runs.unsqueeze(1).expand(g, k, k, cap).contiguous()
            qry = runs.unsqueeze(2).expand(g, k, k, cap).contiguous()
            turns = {"dense_t256_i4": [], "dense_levels_only": [],
                     "searchsorted": []}
            for _ in range(4):
                for name in ("dense_t256_i4", "dense_levels_only",
                             "dense_levels_only", "dense_t256_i4"):
                    lib = libs[name]
                    assert torch.equal(through_python(torch, lib, runs), want)
                    turns[name].append(cuda_ms(
                        torch, lambda: through_python(torch, lib, runs), 200))
                turns["searchsorted"].append(cuda_ms(
                    torch, lambda: torch.searchsorted(seq, qry), 200))
            line["through_python_ms"] = turns
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
