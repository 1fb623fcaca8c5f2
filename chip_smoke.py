#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` and
drives its main path through the user entry points, then holds every
kernel against its plain PyTorch version on the main path's own inputs.
Every phase asserts, and any failure exits non-zero.  Phases (one JSON
line each, after the ``nvidia-smi`` name/power-limit line):

1. build   -- the kernels' library (``nvcc`` for sm_90a, in parallel);
2. planned -- ``SparseAllreduce(64, (16, 4), backend="device")`` config +
   reduce on the PageRank partitions' index sets, against the float64
   ``backend="sim"`` oracle;
3. union   -- ``union_reduce`` on 64 nodes x 16,384 coalesced Zipf(1.4)
   hashed indices with dyadic values: ``merge="fused"`` equals
   ``merge="sort"`` bit for bit, and both equal a numpy dense oracle;
4. pagerank -- ``pagerank(backend="device")`` on a 2^18-vertex, 2 M-edge
   power-law graph over M=64 nodes, degrees (16, 4), 10 rounds, through
   the stacked-CSR SpMV kernel, against the float64 dense reference; the
   CSR's nonzeros and bytes, peak device memory during the entry point
   (``max_memory_allocated``: all that is allocated, the earlier phases'
   leftovers included, as PR 12's smoke reported it; and its rise over
   what was allocated before the call), then per-round wall time;
5. hadi -- ``hadi(backend="device")`` on the same graph, 16 hops of 4 x
   24-bit FM strings (W = 96 values an index) through the width-W product
   on the stacked CSR: bitstrings, curve, effective diameter and hops run
   equal to a float64 global OR iteration of the same start strings (a
   scipy CSR product of the whole graph, clamped), one engine run; ms per
   hop, state and trajectory bytes, peak memory, the product's ms;
6. spectral -- ``power_iteration(backend="device")``, 30 rounds on the
   symmetrized graph (3.96 M nonzeros) through the CSR SpMV kernel and
   the whole-mesh sum: eigenvalue within 1e-4 relative and eigenvector
   cosine above 1 - 1e-6 of the float64 ``power_iteration_reference``,
   30 kernel launches; ms per round;
7. pagerank_large -- the same at 2^20 vertices and 10 M edges, a graph
   whose padded ELL tables would need some 288 GB: rtol 1e-4 against the
   float64 dense reference, round wall time, peak memory, host set-up;
8. union_wire -- ``union_reduce`` at mini-batch scale: 64 nodes x
   262,144 Zipf(1.1) draws over 2^24 hashed features each (about 103,000
   unique per node, a ~3.96 M-entry union), for all 12 (merge, wire)
   pairs: indices exact everywhere, raw/delta values exact against the
   float64 oracle, delta+bf16 bit-identical across merges, delta+int8ef
   merges within 1e-5 x max|union| of each other and 0.05 x max|union|
   of the exact sum; CUDA-event ms and launches per reduce of each pair,
   and for the fused and banded merges under the raw wire the device ms
   of one reduce and its twelve largest kernels (profiler);
9. replicated_planned -- ``SparseAllreduce(64, (16, 4), replication=2,
   dead=D)`` (128 physical nodes) config + reduce on PageRank's index sets
   with dyadic values: bit for bit equal to the unreplicated reduce and to
   the sim backend with the same replication and dead set;
   ``reconfig_dead(D2)`` the same bits with ``config_cache == "repair"``; a
   dead set that covers a replica group raises ``DeadLogicalNode`` and
   leaves the instance usable (D, D2: the first two steps of
   ``make_schedule("random", 128, 8, seed=0)`` that lose no group);
10. replicated_union -- ``union_reduce`` of 32 logical nodes, degrees (8,
   4), r = 2 (64 physical nodes, a degree-2 replica-merge stage first) on
   the first 32 nodes of union_wire's input, with a dead set from
   ``make_schedule("random", 64, 8, seed=0)``: merges sort, fused and
   banded under the raw wire equal the unreplicated 32-node reduce of the
   same merge bit for bit and the float64 oracle; banded under
   delta+int8ef indices exact and within 0.05 x max|union| of it; ms of
   each replicated and unreplicated reduce, peak memory;
11. plan_cache -- ``SparseAllreduce.config`` on PageRank's index sets
   served fresh, from the memo, from disk (memo cleared) and from disk in
   a restarted process (this script with ``--plan-cache-probe``): the same
   reduce bits on normal floats from all four, the seconds of each tier;
   ``degrees="auto"`` tuned, then cached;
12. calibrate -- ``calibrate_fabric`` over 64 stacked nodes (stage
   degrees 2-64, 256 / 4,096 / 32,768 entries): alpha, beta, gamma and the
   fit residual; ``select_plan`` with ``measure_plan`` trials (fused) of
   the top five, modeled and measured ms; ``resolve_degrees`` under the
   fit for PageRank's nnz (the trials are timing, not main-path calls);
13. resilient_planned -- ``ResilientAllreduce(64, (16, 4),
   replication=2)`` on PageRank's index sets, dyadic values: a
   replica-absorbed dead set repaired in place (bits unchanged), a lost
   group shrunk to 63 survivors (explicit degrees: ``tune``'s), equal to
   a fresh reduce over them, the shrink reused, a loss below quorum
   raising ``QuorumLost``; then with ``degrees="auto"`` the same loss
   shrunk with the degrees ``resolve_degrees(shrunk_from=64)`` gives
   through the base's plan cache (which then serves them), equal to the
   same fresh reduce; ms of each;
14. resilient_union -- replicated_union's input (32 logical x 2) with
   both replicas of one shard dead: 31 survivors at r = 2 over one flat
   layer of 31 runs (an odd merge tree), fused and banded, bit for bit
   equal to a fresh reduce over the survivors and the float64 oracle; ms
   and peak memory;
15. supervised_pagerank -- ``SupervisedEngineLoop`` (M = 64 over a pool of
   80, 10 rounds, checkpoints every 2) under ``make_schedule("rack", 80,
   5, rack_size=5)`` from round 3 (the first seed whose rack hits an
   engine position): final state and last_q equal the fault-free run bit
   for bit, with the remaps' seconds and config tiers;
16. soak_resume -- ``python -m repro_torch.launch.soak --job pagerank`` at
   the same graph size in subprocesses: baseline, a rack-fault run killed
   at round 4 (exit 17), its ``--resume``; final.npz equal array by array;
17. kernels -- each kernel on the inputs it got on the main path (phases
   2-15, layer 0 / first round; the two merge-rank kernels at every shape
   the main path handed them, the replica stage's [64, 2, C] and the
   survivors' flat [62, 31, C] included, the dense scatter also at the
   replica stage and the survivor layer, the CSR SpMV at each graph
   phase, and the banded scatters at every (phase, butterfly layer, value
   dtype): f32, bf16 and int8 + scale, each
   with its main-path calls, its two CUDA launches and device ms per
   stage, a byte bound over what it must move (the kept sources, the
   window table and the output) and one over every ``pos`` entry, and
   its window table equal to ``searchsorted``), against its
   plain version (ranks exact, the banded kernel's own tile counts equal
   to ``rank_tile_stats`` summed over the layer-0 run pairs,
   scatters bit-exact on dyadic inputs else rtol 1e-6, the scaled banded
   scatter bit-exact against its plain version on a CPU copy, and
   repeatable;
   the dense scatter at the wire shape also bit-exact on general floats
   against its plain version on a CPU copy, with its layout equal to a
   stable argsort; the ELL SpMV rtol 1e-5; the CSR SpMV rtol 1e-5 on
   PageRank's first graph, and on the other graphs within 1e-5 x (|A|
   |x|) of the float64 product and 1e-4 x (|A| |x|) of the plain version,
   and repeatable), with
   CUDA-event times of kernel, plain version and the nearest single
   PyTorch call, and the least time the card needs.  The ELL kernel, off
   the main path now, is held to its plain version on ELL tables built
   for that row alone from the same graph.

The launch counts of the ``kernels`` line are those of the main-path
calls alone (``config`` + ``reduce``, the first ``union_reduce`` of each
(merge, wire), the ``pagerank``, ``hadi`` and ``power_iteration`` entry
points, the supervised reduces and engine runs): each starts with every
count at 0 and is read right after, before any timing loop runs.  The
soak's kernels run in its subprocesses, which print their own counts
(the soak_resume line).  Each phase starts from an empty plan cache (a
directory of its own under the run's temporary root, removed at exit)
and an empty memo, so its config times are those of a fresh config
unless its line says otherwise (``config_cache``).  Profiler traces
(union_wire's and the kernels line's device ms and CUDA launches per
call) are taken in a fresh process that shares the tensors through CUDA
IPC; the ``profiler`` line counts its calls and traces.
The last line is ``{"ok": true, "device": {...}}``.  Needs one CUDA GPU;
exits non-zero without one or outside a checkout of the repository.
"""
import contextlib
import json
import math
import os
import queue
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
DEVICE = "cuda"
M, DEGREES = 64, (16, 4)
N_VERTICES, N_EDGES, ROUNDS, DAMPING = 262_144, 2_000_000, 10, 0.85
LARGE_VERTICES, LARGE_EDGES = 1_048_576, 10_000_000
UNION_C, UNION_RANGE, UNION_ALPHA = 16_384, 1 << 22, 1.4
WIRE_DRAWS, WIRE_C, WIRE_RANGE, WIRE_ALPHA = 262_144, 131_072, 1 << 24, 1.1
MERGES = ("sort", "fused", "banded")
HADI_HOPS, HADI_BITS, HADI_TRIALS = 16, 24, 4
SPECTRAL_ITERS = 30
REPLICATION = 2
REP_UNION_NODES, REP_UNION_DEGREES = 32, (8, 4)
# supervised PageRank and the soak: M partitions over a pool of POOL
# positions, a rack of RACK positions lost from round FAULT_AT on
POOL, RACK, FAULT_AT, CKPT_EVERY = 80, 5, 3, 2
# the phases whose recorded kernel inputs make up the shapes of a row, in
# the order the rows list them
ROW_PHASES = ("union_wire", "replicated_union", "resilient_union", "union")
GRAPH_PHASES = ("pagerank", "spectral", "pagerank_large",
                "supervised_pagerank")
# phases whose scatter calls are told apart by shape (one per layer)
SHAPED_SCATTER_PHASES = ("resilient_union",)
WIRES = ("raw", "delta", "delta+bf16", "delta+int8ef")


def emit(obj) -> None:
    """One JSON line on stdout."""
    print(json.dumps(obj), flush=True)


# the phase the main path is in, read by the Recorders' keys, and whether
# a main-path call is running (the Recorders count only those calls)
PHASE = {"name": None, "main": False}


def main_path(call):
    """``(call(), launches)``: the kernels' launch counts of this one
    main-path call, zeroed just before it and read just after."""
    from repro_torch.kernels import _build
    _build.reset_launches()
    PHASE["main"] = True
    try:
        out = call()
    finally:
        PHASE["main"] = False
    return out, dict(_build.LAUNCHES)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Recorder:
    """Wraps a kernel wrapper where the main path looks it up and keeps
    the arguments of its first main-path call of each variant (``key(args,
    kwargs)``), i.e. the layer-0 / first-round inputs of that variant,
    and the number of main-path calls of each variant."""

    def __init__(self, module, name, key=lambda args, kwargs: "first"):
        self.module, self.name, self.key = module, name, key
        self.fn = getattr(module, name)
        self.args, self.calls = {}, {}
        setattr(module, name, self)

    def __call__(self, *args, **kwargs):
        if PHASE["main"]:
            key = self.key(args, kwargs)
            self.args.setdefault(key, (args, kwargs))
            self.calls[key] = self.calls.get(key, 0) + 1
        return self.fn(*args, **kwargs)

    def restore(self):
        setattr(self.module, self.name, self.fn)


def scatter_variant(args, kwargs):
    """Recorder key of a scatter call: the phase, and ``scaled`` or the
    value dtype."""
    if kwargs.get("scale") is not None:
        key = PHASE["name"], "scaled"
    else:
        key = PHASE["name"], "bf16" if args[1].dtype.itemsize == 2 else "f32"
    if PHASE["name"] in SHAPED_SCATTER_PHASES:
        key += (tuple(args[0].shape),)
    return key


def banded_variant(args, kwargs):
    """Recorder key of a banded scatter call: the phase, the dtype and the
    positions' shape (each butterfly layer hands the kernel its own)."""
    return scatter_variant(args, kwargs)[:2] + (tuple(args[0].shape),)


def rank_variant(args, kwargs):
    """Recorder key of a merge-rank call: the phase, the kernel and the
    runs' shape (each butterfly layer hands the kernels its own)."""
    return (PHASE["name"], "banded" if kwargs.get("banded") else "dense",
            tuple(args[0].shape))


def phase_planned(torch, parts):
    """Planned reduce on the PageRank index sets vs the float64 sim."""
    from repro_torch.core.api import SparseAllreduce
    out_sets = [p.out_idx.astype(np.uint32) for p in parts]
    in_sets = [p.in_idx.astype(np.uint32) for p in parts]
    rng = np.random.RandomState(1)
    values = [rng.randn(len(o)).astype(np.float32) for o in out_sets]
    dev = SparseAllreduce(M, DEGREES, backend="device", device=DEVICE)
    t0 = time.perf_counter()
    _, config_launches = main_path(lambda: dev.config(out_sets, in_sets))
    config_s = time.perf_counter() - t0
    got, launches = main_path(lambda: dev.reduce(values))
    launches = {k: v + config_launches[k] for k, v in launches.items()}
    # the down half's sums run in a fixed order: repeats give equal bits
    for _ in range(2):
        assert all(np.array_equal(a, b) for a, b in
                   zip(dev.reduce(values), got)), "planned reduce repeat"
    sim = SparseAllreduce(M, DEGREES, backend="sim")
    sim.config(out_sets, in_sets)
    want = sim.reduce(values)
    err = 0.0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        err = max(err, float(np.max(np.abs(g - w), initial=0.0)))
    planned, _ = dev.planned_parts()
    routing = planned.device_args(DEVICE)
    staged = torch.zeros((M, planned.u_cap), device=DEVICE)
    reduce_ms = cuda_ms(lambda: dev.reduce_fn(staged), reps=10)
    emit({"phase": "planned", "ok": True, "max_abs_err": err,
          "tolerance": "rtol 1e-5, atol 1e-5 vs float64 sim; three reduces "
                       "of the same normal floats bit-identical",
          "config_s": config_s, "config_cache": dev.config_cache,
          "u_cap": planned.u_cap, "uin_cap": planned.uin_cap,
          "q_cap": planned.q_cap,
          "sum_fans": [routing.user_scatter.fan]
          + [layer[2].fan for layer in routing.layers],
          "reduce_ms": reduce_ms, "launches": launches})
    return launches


def union_inputs():
    """[M, C] hashed sorted SENTINEL-padded indices + dyadic values."""
    from repro_torch.core.sparse_vec import SENTINEL, HashPerm
    rng = np.random.RandomState(2)
    perm = HashPerm.make(3)
    idx = np.full((M, UNION_C), SENTINEL, np.int64)
    val = np.zeros((M, UNION_C), np.float32)
    all_h, all_v = [], []
    for n in range(M):
        raw = (rng.zipf(UNION_ALPHA, UNION_C) - 1) % UNION_RANGE
        h = perm.fwd_np(raw.astype(np.uint32)).astype(np.int64)
        v = rng.randint(-8, 9, UNION_C).astype(np.float64) / 1024
        u, inv = np.unique(h, return_inverse=True)
        s = np.zeros(len(u))
        np.add.at(s, inv, v)
        idx[n, : len(u)] = u
        val[n, : len(u)] = s
        all_h.append(u)
        all_v.append(s)
    want_idx, inv = np.unique(np.concatenate(all_h), return_inverse=True)
    want_val = np.zeros(len(want_idx))
    np.add.at(want_val, inv, np.concatenate(all_v))
    return idx, val, want_idx, want_val


def phase_union(torch):
    """Union reduce, fused vs sort vs numpy dense oracle."""
    from repro_torch.core.allreduce import shape_bucket
    from repro_torch.core.api import SparseAllreduce
    idx, val, want_idx, want_val = union_inputs()
    out_cap = shape_bucket(len(want_idx))
    res, ms, launches = {}, {}, {}
    for merge in ("sort", "fused"):
        ar = SparseAllreduce(M, DEGREES, backend="device", merge=merge,
                             device=DEVICE)
        ti = torch.as_tensor(idx, device=DEVICE)
        tv = torch.as_tensor(val, device=DEVICE)
        res[merge], launches[merge] = main_path(
            lambda: ar.union_reduce(ti, tv, out_cap))
        ms[merge] = cuda_ms(lambda: ar.union_reduce(ti, tv, out_cap), reps=3,
                            warmup=1)
    (si, sv, so), (fi, fv, fo) = res["sort"], res["fused"]
    assert torch.equal(si, fi) and torch.equal(so, fo), "fused != sort (idx)"
    assert torch.equal(sv, fv), "fused != sort (values)"
    assert int(fo.sum()) == 0, f"overflow {fo.tolist()}"
    n = len(want_idx)
    oi, ov = fi.cpu().numpy(), fv.cpu().numpy()
    assert np.array_equal(oi[:, :n], np.broadcast_to(want_idx, (M, n)))
    assert np.all(oi[:, n:] == 0xFFFFFFFF)
    assert np.array_equal(ov[:, :n].astype(np.float64),
                          np.broadcast_to(want_val, (M, n)))
    emit({"phase": "union", "ok": True, "union_count": n,
          "out_capacity": out_cap, "fused_equals_sort": True,
          "max_abs_err": 0.0, "sort_ms": ms["sort"], "fused_ms": ms["fused"],
          "layers": len(DEGREES), "launches": launches})
    return {k: launches["sort"][k] + launches["fused"][k]
            for k in launches["fused"]}


def union_wire_inputs(nodes=None):
    """[nodes, WIRE_C] hashed sorted coalesced indices of WIRE_DRAWS Zipf
    draws per node, values ``randint(-8, 9) / 1024`` summed per index, and
    the float64 union oracle (fewer nodes: the first ones of the same
    draws)."""
    from repro_torch.core.sparse_vec import SENTINEL, HashPerm
    nodes = nodes or M
    rng = np.random.RandomState(5)
    perm = HashPerm.make(6)
    idx = np.full((nodes, WIRE_C), SENTINEL, np.int64)
    val = np.zeros((nodes, WIRE_C), np.float32)
    all_h, all_v = [], []
    for n in range(nodes):
        raw = (rng.zipf(WIRE_ALPHA, WIRE_DRAWS) - 1) % WIRE_RANGE
        h = perm.fwd_np(raw.astype(np.uint32)).astype(np.int64)
        v = rng.randint(-8, 9, WIRE_DRAWS).astype(np.float64) / 1024
        u, inv = np.unique(h, return_inverse=True)
        s = np.bincount(inv, weights=v)
        assert len(u) <= WIRE_C, (n, len(u))
        idx[n, : len(u)] = u
        val[n, : len(u)] = s
        all_h.append(u)
        all_v.append(s)
    want_idx, inv = np.unique(np.concatenate(all_h), return_inverse=True)
    vals = np.concatenate(all_v)
    # every partial f32 sum of these multiples of 2^-10 is exact
    assert np.bincount(inv, weights=np.abs(vals)).max() < 2.0 ** 14
    want_val = np.bincount(inv, weights=vals)
    return idx, val, want_idx, want_val


def phase_union_wire(torch):
    """Union reduce at mini-batch scale for every (merge, wire) pair."""
    from repro_torch.core.allreduce import shape_bucket
    from repro_torch.core.api import SparseAllreduce
    from repro_torch.core.sparse_vec import SENTINEL
    t0 = time.perf_counter()
    idx, val, want_idx, want_val = union_wire_inputs()
    inputs_s = time.perf_counter() - t0
    n = len(want_idx)
    out_cap = shape_bucket(n)
    torch.cuda.reset_peak_memory_stats()
    ti = torch.as_tensor(idx, device=DEVICE)
    tv = torch.as_tensor(val, device=DEVICE)
    want_i = torch.as_tensor(want_idx, device=DEVICE).expand(M, n)
    want_v = torch.as_tensor(want_val.astype(np.float32),
                             device=DEVICE).expand(M, n)
    amax = float(np.abs(want_val).max())
    first, pairs, total = {}, [], {}
    for wire in WIRES:
        for merge in MERGES:
            ar = SparseAllreduce(M, DEGREES, backend="device", merge=merge,
                                 wire=wire, device=DEVICE)
            (oi, ov, of), launches = main_path(
                lambda: ar.union_reduce(ti, tv, out_cap))
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            assert int(of.sum()) == 0, (merge, wire, of.tolist())
            assert torch.equal(oi[:, :n], want_i), (merge, wire, "idx")
            assert bool((oi[:, n:] == SENTINEL).all()), (merge, wire)
            got = ov[:, :n]
            err = float((got - want_v).abs().max())
            if wire in ("raw", "delta"):
                assert torch.equal(got, want_v), (merge, wire, err)
            elif wire in first:
                gap = float((got - first[wire]).abs().max())
                bound = 0.0 if wire == "delta+bf16" else 1e-5 * amax
                assert gap <= bound, (merge, wire, gap, bound)
            else:
                first[wire] = got.clone()
            if wire == "delta+int8ef":
                assert err <= 0.05 * amax, (merge, wire, err, amax)
            del oi, ov, of, got
            ms = cuda_ms(lambda: ar.union_reduce(ti, tv, out_cap), reps=3,
                         warmup=1)
            pairs.append({"merge": merge, "wire": wire, "ms": ms,
                          "max_abs_err": err,
                          "launches": {k: v for k, v in launches.items()
                                       if v}})
    peak = torch.cuda.max_memory_allocated()
    # where a reduce's device time goes, by kernel (profiler); the cache is
    # released first, for the profiler's process allocates a reduce's own
    torch.cuda.empty_cache()
    with fresh_profiler():
        for entry in pairs:
            if entry["wire"] == "raw" and entry["merge"] != "sort":
                stages = fresh_profile(
                    ("repro_torch.core.api", "SparseAllreduce",
                     {"num_nodes": M, "degrees": DEGREES, "backend": "device",
                      "merge": entry["merge"], "wire": "raw",
                      "device": DEVICE}, "union_reduce"),
                    (ti, tv, out_cap), reps=2)
                entry["device_ms"] = sum(m for m, _ in stages.values())
                entry["top_kernels_ms"] = dict(sorted(
                    ((k, m) for k, (m, _) in stages.items()),
                    key=lambda kv: -kv[1])[:12])
    banded_i8 = next(p["launches"] for p in pairs
                     if p["merge"] == "banded" and p["wire"] == "delta+int8ef")
    assert banded_i8 == {"rank_counts_banded": len(DEGREES),
                         "banded_onehot_scatter_add_scaled": len(DEGREES)}, \
        banded_i8
    emit({"phase": "union_wire", "ok": True, "union_count": n,
          "out_capacity": out_cap, "in_capacity": WIRE_C,
          "draws_per_node": WIRE_DRAWS,
          "valid_per_node_mean": float((idx != SENTINEL).sum(1).mean()),
          "max_abs_union": amax, "inputs_s": inputs_s,
          "max_memory_allocated": int(peak), "pairs": pairs,
          "tolerance": "idx exact; raw/delta exact vs float64; bf16 equal "
                       "across merges; int8ef merges within 1e-5 x max, "
                       "each within 0.05 x max of exact"})
    del first, ti, tv, want_i, want_v
    return total


def phase_pagerank(torch, edges, parts, n_vertices):
    """PageRank through the device entry point vs the float64 reference,
    then the engine's wall time per round after a warm-up run."""
    from repro_torch.graph.engine import GraphEngine
    from repro_torch.graph.pagerank import (make_pagerank_app, pagerank,
                                            pagerank_dense_reference,
                                            pagerank_state)
    t0 = time.perf_counter()
    ref = pagerank_dense_reference(edges, n_vertices, iters=ROUNDS,
                                   damping=DAMPING)
    reference_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    (got, stats), launches = main_path(lambda: pagerank(
        edges, n_vertices, m=M, degrees=DEGREES, iters=ROUNDS,
        damping=DAMPING, backend="device", device=DEVICE))
    total_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-10)
    rel = float(np.max(np.abs(got - ref) / np.abs(ref)))
    assert launches["spmv_csr"] == ROUNDS and launches["spmv_ell"] == 0, \
        launches
    fresh_plan_cache()      # time a fresh config, as the entry point's
    t0 = time.perf_counter()
    app, out_sets, in_sets = make_pagerank_app(parts, n_vertices, DAMPING)
    engine = GraphEngine(out_sets, in_sets, app, degrees=DEGREES,
                         device=DEVICE)
    config_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    extras, p0 = pagerank_state(parts, n_vertices, engine.u_cap,
                                engine.uin_cap, device=DEVICE)
    torch.cuda.synchronize()
    state_s = time.perf_counter() - t0
    first_state, first_q, _ = engine.run(ROUNDS, p0, extras)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, last_q, _ = engine.run(ROUNDS, p0, extras)
    torch.cuda.synchronize()
    round_s = (time.perf_counter() - t0) / ROUNDS
    assert torch.equal(state, first_state) and torch.equal(last_q, first_q), \
        "two PageRank runs differ"
    csr_bytes = sum(int(t.numel() * t.element_size())
                    for t in extras.values())
    emit({"phase": PHASE["name"], "ok": True, "vertices": n_vertices,
          "edges": int(len(edges)), "nodes": M, "degrees": list(DEGREES),
          "rounds": ROUNDS, "max_abs_err": float(np.max(np.abs(got - ref))),
          "max_rel_err": rel, "tolerance": "rtol 1e-4 vs float64 dense",
          "csr_nnz": int(extras["cols"].numel()),
          "csr_rows": int(extras["row_ptr"].numel() - 1),
          "csr_bins": int(extras["bins"].numel() - 1),
          "csr_bytes": csr_bytes, "u_cap": engine.u_cap,
          "uin_cap": engine.uin_cap,
          "max_memory_allocated": int(peak),
          "max_memory_over_call": int(peak - base),
          "memory_allocated_before": int(base), "entry_point_s": total_s,
          "host_config_s": config_s, "config_cache": engine.config_cache,
          "csr_state_s": state_s, "reference_s": reference_s,
          "round_wall_s": round_s, "two_runs_bit_identical": True,
          "engine": stats["engine"], "launches": launches})
    del engine, extras, p0, last_q, state, first_state, first_q
    return launches


def hadi_oracle(edges, n_vertices, b0):
    """HADI's float64 global OR iteration of ``b0`` [n, trials, bits] with
    the sim loop's plateau stop: ``(b, curve, eff, hops_run)``.  Each hop
    is one scipy CSR product of the whole graph, clamped to 1."""
    import scipy.sparse as sp
    from repro_torch.graph.hadi import _effective_diameter, _fm_estimate
    adj = sp.csr_matrix((np.ones(len(edges)), (edges[:, 1], edges[:, 0])),
                        shape=(n_vertices, n_vertices))
    b = b0.reshape(n_vertices, -1)
    curve = [_fm_estimate(b0)]
    for _ in range(HADI_HOPS):
        b = np.maximum(b, np.minimum(adj @ b, 1.0))
        curve.append(_fm_estimate(b.reshape(b0.shape)))
        if curve[-1] <= curve[-2] * 1.0001:
            break
    eff, curve = _effective_diameter(curve)
    return b.reshape(b0.shape), curve, eff, len(curve) - 1


def phase_hadi(torch, edges, parts, n_vertices):
    """HADI through the device entry point vs the float64 global OR
    oracle (bit for bit), then the engine's ms per hop."""
    from repro_torch.graph.engine import csr_matvec_wide
    from repro_torch.graph.hadi import hadi, make_hadi_engine
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    (eff, curve, stats), launches = main_path(lambda: hadi(
        edges, n_vertices, m=M, degrees=DEGREES, max_hops=HADI_HOPS,
        bits=HADI_BITS, trials=HADI_TRIALS, backend="device", device=DEVICE))
    total_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    want_b, want_curve, want_eff, want_hops = hadi_oracle(
        edges, n_vertices, stats["b0"])
    oracle_s = time.perf_counter() - t0
    assert np.array_equal(stats["b_final"], want_b), "bitstrings"
    assert np.array_equal(curve, want_curve), (curve, want_curve)
    assert (eff, stats["hops_run"]) == (want_eff, want_hops), \
        (eff, stats["hops_run"], want_eff, want_hops)
    assert stats["engine"]["dispatches"] == 1, stats["engine"]
    hops = stats["hops_run"]
    req = [np.union1d(p.in_idx, p.out_idx).astype(np.uint32) for p in parts]
    engine, extras, state0 = make_hadi_engine(
        parts, req, DEGREES, HADI_BITS, HADI_TRIALS, stats["b0"],
        device=DEVICE)
    engine.run(hops, state0, extras)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run(hops, state0, extras)
    torch.cuda.synchronize()
    hop_s = (time.perf_counter() - t0) / hops
    rp, cols, wts = extras["row_ptr"], extras["cols"], extras["wts"]
    product_ms = cuda_ms(lambda: csr_matvec_wide(rp, cols, wts, state0),
                         reps=10)
    nnz, width = int(cols.numel()), int(state0.shape[-1])
    out_rows = int(rp.numel() - 1)
    state_bytes = int(state0.numel() * 4)
    emit({"phase": "hadi", "ok": True, "vertices": n_vertices,
          "edges": int(len(edges)), "nodes": M, "degrees": list(DEGREES),
          "max_hops": HADI_HOPS, "bits": HADI_BITS, "trials": HADI_TRIALS,
          "width": width, "hops_run": hops, "effective_diameter": eff,
          "curve": [float(c) for c in curve],
          "tolerance": "b_final, curve, eff, hops_run equal to the float64 "
                       "global OR iteration",
          "u_cap": engine.u_cap, "uin_cap": engine.uin_cap,
          "state_bytes": state_bytes,
          "trajectory_bytes": state_bytes * HADI_HOPS,
          "max_memory_allocated": int(peak),
          "max_memory_over_call": int(peak - base),
          "entry_point_s": total_s, "oracle_s": oracle_s,
          "hop_wall_s": hop_s, "engine": stats["engine"],
          "wide_product": {
              "nnz": nnz, "width": width, "ms": product_ms,
              "bound_ms": bound_ms(nnz * 8 + rp.numel() * rp.element_size()
                                   + state0.numel() * 4
                                   + out_rows * width * 4),
              "bound_by": "bytes",
              "route": "plain torch ops (gather, index_add_)"},
          "launches": launches})
    del engine, extras, state0, stats
    torch.cuda.empty_cache()
    return launches


def phase_spectral(torch, edges, n_vertices):
    """Power iteration through the device entry point vs the float64
    reference, then the engine's ms per round."""
    from repro_torch.graph.pagerank import build_partitions
    from repro_torch.graph.spectral import (make_spectral_engine,
                                            power_iteration,
                                            power_iteration_reference)
    t0 = time.perf_counter()
    lam_r, v_r = power_iteration_reference(edges, n_vertices,
                                           iters=SPECTRAL_ITERS)
    reference_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (lam, v, stats), launches = main_path(lambda: power_iteration(
        edges, n_vertices, m=M, degrees=DEGREES, iters=SPECTRAL_ITERS,
        backend="device", device=DEVICE))
    total_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    rel = abs(lam - lam_r) / lam_r
    cos = float(abs(v @ v_r) / (np.linalg.norm(v) * np.linalg.norm(v_r)))
    assert rel < 1e-4 and cos > 1 - 1e-6, (rel, cos)
    assert launches["spmv_csr"] == SPECTRAL_ITERS, launches
    assert stats["engine"]["dispatches"] == 1, stats["engine"]
    sym = np.concatenate([edges, edges[:, ::-1]], axis=0)
    parts = build_partitions(sym, n_vertices, M)
    for p in parts:
        p.inv_outdeg = np.ones_like(p.inv_outdeg)
    engine, extras, state0 = make_spectral_engine(parts, n_vertices, DEGREES,
                                                  device=DEVICE)
    engine.run(SPECTRAL_ITERS, state0, extras)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run(SPECTRAL_ITERS, state0, extras)
    torch.cuda.synchronize()
    round_s = (time.perf_counter() - t0) / SPECTRAL_ITERS
    emit({"phase": "spectral", "ok": True, "vertices": n_vertices,
          "nnz": int(extras["cols"].numel()), "nodes": M,
          "degrees": list(DEGREES), "iters": SPECTRAL_ITERS,
          "eigenvalue": lam, "reference_eigenvalue": lam_r,
          "eigenvalue_rel_err": rel, "cosine": cos,
          "tolerance": "eigenvalue rel err < 1e-4, cosine > 1 - 1e-6 vs "
                       "float64 power_iteration_reference",
          "u_cap": engine.u_cap, "uin_cap": engine.uin_cap,
          "max_memory_allocated": int(peak), "entry_point_s": total_s,
          "reference_s": reference_s, "round_wall_s": round_s,
          "mesh_sums": engine.transport.sums, "engine": stats["engine"],
          "launches": launches})
    del engine, extras, state0
    return launches


def good_dead_sets(m_physical, count):
    """The first ``count`` steps of ``make_schedule("random", m_physical,
    8, seed=0)`` that lose no replica group."""
    from repro_torch.core.faults import make_schedule
    from repro_torch.core.replication import lost_logical_shards
    sched = make_schedule("random", m_physical, 8, seed=0)
    out = [d for d in sched.steps(64)
           if not lost_logical_shards(m_physical, REPLICATION, d)]
    assert len(out) >= count, out
    return out[:count]


def phase_replicated_planned(torch, parts):
    """Replicated planned reduce with a dead set vs the unreplicated
    reduce and the sim backend, bit for bit; repair; a lost group."""
    from repro_torch.core.api import SparseAllreduce
    from repro_torch.core.replication import DeadLogicalNode, replica_groups
    out_sets = [p.out_idx.astype(np.uint32) for p in parts]
    in_sets = [p.in_idx.astype(np.uint32) for p in parts]
    rng = np.random.RandomState(7)
    values = [(rng.randint(-8, 9, len(o)) / 1024).astype(np.float32)
              for o in out_sets]
    d1, d2 = good_dead_sets(REPLICATION * M, 2)
    base = SparseAllreduce(M, DEGREES, backend="device", device=DEVICE)
    base.config(out_sets, in_sets)
    want = base.reduce(values)
    ar = SparseAllreduce(M, DEGREES, backend="device", device=DEVICE,
                         replication=REPLICATION, dead=d1)
    t0 = time.perf_counter()
    _, config_launches = main_path(lambda: ar.config(out_sets, in_sets))
    config_s = time.perf_counter() - t0
    config_cache = ar.config_cache
    got, launches = main_path(lambda: ar.reduce(values))
    launches = {k: v + config_launches[k] for k, v in launches.items()}
    sim = SparseAllreduce(M, DEGREES, backend="sim", replication=REPLICATION,
                          dead=d1)
    sim.config(out_sets, in_sets)
    for g, w, s in zip(got, want, sim.reduce(values)):
        assert np.array_equal(g, w), "replicated != unreplicated"
        assert np.array_equal(g, np.asarray(s, np.float32)), "!= sim"
    t0 = time.perf_counter()
    ar.reconfig_dead(d2)
    repair_s = time.perf_counter() - t0
    assert ar.config_cache == "repair", ar.config_cache
    for g, w in zip(ar.reduce(values), want):
        assert np.array_equal(g, w), "repaired != unreplicated"
    lost = set(replica_groups(REPLICATION * M, REPLICATION)[5])
    try:
        ar.reconfig_dead(lost)
        raise AssertionError("a lost replica group was accepted")
    except DeadLogicalNode:
        assert ar.dead == d2
    for g, w in zip(ar.reduce(values), want):
        assert np.array_equal(g, w), "after the refused repair"
    planned, _ = ar.planned_parts()
    staged = torch.zeros((REPLICATION * M, planned.u_cap), device=DEVICE)
    reduce_ms = cuda_ms(lambda: ar.reduce_fn(staged), reps=10)
    staged1 = torch.zeros((M, base.planned_parts()[0].u_cap), device=DEVICE)
    base_ms = cuda_ms(lambda: base.reduce_fn(staged1), reps=10)
    emit({"phase": "replicated_planned", "ok": True, "logical_nodes": M,
          "physical_nodes": REPLICATION * M, "replication": REPLICATION,
          "degrees": list(DEGREES), "dead": sorted(d1),
          "dead_repaired": sorted(d2), "lost_group_raised": sorted(lost),
          "max_abs_err": 0.0,
          "tolerance": "bit for bit vs unreplicated and vs sim (dyadic)",
          "config_s": config_s, "config_cache_before_repair": config_cache,
          "repair_s": repair_s,
          "u_cap": planned.u_cap, "uin_cap": planned.uin_cap,
          "depth": planned.depth, "reduce_ms": reduce_ms,
          "unreplicated_reduce_ms": base_ms, "launches": launches})
    return launches


def phase_replicated_union(torch):
    """Replicated union reduce with a dead set vs the unreplicated
    32-node reduce of each merge."""
    from repro_torch.core.allreduce import shape_bucket
    from repro_torch.core.api import SparseAllreduce
    from repro_torch.core.sparse_vec import SENTINEL
    nodes = REP_UNION_NODES
    idx, val, want_idx, want_val = union_wire_inputs(nodes)
    n = len(want_idx)
    out_cap = shape_bucket(n)
    (dead,) = good_dead_sets(REPLICATION * nodes, 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ti = torch.as_tensor(idx, device=DEVICE)
    tv = torch.as_tensor(val, device=DEVICE)
    want_i = torch.as_tensor(want_idx, device=DEVICE).expand(nodes, n)
    want_v = torch.as_tensor(want_val.astype(np.float32),
                             device=DEVICE).expand(nodes, n)
    amax = float(np.abs(want_val).max())
    pairs, total = [], {}
    for merge, wire in [(m, "raw") for m in MERGES] + [("banded",
                                                        "delta+int8ef")]:
        kw = dict(merge=merge, wire=wire, device=DEVICE, backend="device")
        ar = SparseAllreduce(nodes, REP_UNION_DEGREES, replication=REPLICATION,
                             dead=dead, **kw)
        (oi, ov, of), launches = main_path(
            lambda: ar.union_reduce(ti, tv, out_cap))
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        assert int(of.sum()) == 0, (merge, wire, of.tolist())
        assert torch.equal(oi[:, :n], want_i), (merge, wire, "idx")
        assert bool((oi[:, n:] == SENTINEL).all()), (merge, wire)
        err = float((ov[:, :n] - want_v).abs().max())
        base = SparseAllreduce(nodes, REP_UNION_DEGREES, **kw)
        bi, bv, _ = base.union_reduce(ti, tv, out_cap)
        assert torch.equal(oi, bi), (merge, wire, "idx vs unreplicated")
        if wire == "raw":
            assert torch.equal(ov, bv), (merge, "values vs unreplicated")
            assert err == 0.0, (merge, err)
        else:
            assert err <= 0.05 * amax, (merge, wire, err, amax)
        del oi, ov, of, bi, bv
        ms = cuda_ms(lambda: ar.union_reduce(ti, tv, out_cap), reps=3,
                     warmup=1)
        base_ms = cuda_ms(lambda: base.union_reduce(ti, tv, out_cap), reps=3,
                          warmup=1)
        pairs.append({"merge": merge, "wire": wire, "ms": ms,
                      "unreplicated_ms": base_ms, "max_abs_err": err,
                      "launches": {k: v for k, v in launches.items() if v}})
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": "replicated_union", "ok": True, "logical_nodes": nodes,
          "physical_nodes": REPLICATION * nodes, "replication": REPLICATION,
          "degrees": list(REP_UNION_DEGREES), "dead": sorted(dead),
          "union_count": n, "out_capacity": out_cap, "in_capacity": WIRE_C,
          "max_abs_union": amax, "max_memory_allocated": int(peak),
          "pairs": pairs,
          "tolerance": "idx exact; raw values bit for bit vs the "
                       "unreplicated reduce and the float64 oracle; "
                       "int8ef within 0.05 x max of exact"})
    del ti, tv, want_i, want_v
    return total


def fresh_plan_cache() -> str:
    """Point the plan cache at a new empty directory (under the run's
    scratch root) and drop the in-process memo, so each phase configures
    from nothing, as its numbers in PERF.md assume; returns the root."""
    import tempfile
    from repro_torch.core import autotune
    root = tempfile.mkdtemp(prefix="plans-", dir=SCRATCH["root"])
    os.environ[autotune.CACHE_ENV] = root
    autotune.clear_plan_memo()
    return root


# the run's scratch directory (plan caches, checkpoints), removed at exit
SCRATCH = {"root": None}


def pagerank_sets(parts):
    """PageRank's per-node out / in index sets."""
    return ([p.out_idx.astype(np.uint32) for p in parts],
            [p.in_idx.astype(np.uint32) for p in parts])


def plan_cache_probe(root: str, inputs: str, output: str) -> int:
    """``chip_smoke.py --plan-cache-probe ROOT IN OUT``: a restarted
    process configures PageRank's index sets from the plan cache at ROOT
    and writes its reduce of IN's values to OUT (the plan_cache phase)."""
    import torch
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core.api import SparseAllreduce
    from repro_torch.core.autotune import PlanCache
    with np.load(inputs) as f:
        out_sets = [f[f"o{i}"] for i in range(M)]
        in_sets = [f[f"i{i}"] for i in range(M)]
        values = [f[f"v{i}"] for i in range(M)]
    ar = SparseAllreduce(M, DEGREES, backend="device", device=DEVICE,
                         plan_cache=PlanCache(root=root))
    t0 = time.perf_counter()
    ar.config(out_sets, in_sets)
    torch.cuda.synchronize()
    config_s = time.perf_counter() - t0
    np.savez(output, *ar.reduce(values))
    emit({"config_cache": ar.config_cache, "config_s": config_s})
    return 0


def phase_plan_cache(torch, parts):
    """Config tiers on PageRank's index sets: fresh, memo, disk (memo
    cleared), disk again in a restarted process; the same reduce bits on
    normal floats from all four; ``degrees="auto"`` tuned, then cached."""
    from repro_torch.core import autotune
    from repro_torch.core.api import SparseAllreduce
    root = os.environ[autotune.CACHE_ENV]
    out_sets, in_sets = pagerank_sets(parts)
    rng = np.random.RandomState(21)
    values = [rng.randn(len(o)).astype(np.float32) for o in out_sets]
    tiers, results, total = {}, [], {}
    for want in ("fresh", "memo", "disk"):
        if want == "disk":
            autotune.clear_plan_memo()
        ar = SparseAllreduce(M, DEGREES, backend="device", device=DEVICE)
        t0 = time.perf_counter()
        _, launches = main_path(lambda: ar.config(out_sets, in_sets))
        torch.cuda.synchronize()
        tiers[want] = time.perf_counter() - t0
        assert ar.config_cache == want, (want, ar.config_cache)
        got, more = main_path(lambda: ar.reduce(values))
        for k in launches:
            total[k] = total.get(k, 0) + launches[k] + more[k]
        results.append(got)
        if want == "fresh":
            first = ar
        elif want == "memo":
            assert ar.reduce_fn is first.reduce_fn
    inputs = os.path.join(root, "probe_in.npz")
    output = os.path.join(root, "probe_out.npz")
    np.savez(inputs, **{f"o{i}": o for i, o in enumerate(out_sets)},
             **{f"i{i}": x for i, x in enumerate(in_sets)},
             **{f"v{i}": v for i, v in enumerate(values)})
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--plan-cache-probe", root, inputs, output],
                          capture_output=True, text=True, timeout=300,
                          check=True)
    restart_s = time.perf_counter() - t0
    probe = json.loads(proc.stdout.strip().splitlines()[-1])
    assert probe["config_cache"] == "disk", probe
    with np.load(output) as f:
        results.append([f[f"arr_{i}"] for i in range(M)])
    for other in results[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(results[0], other)), \
            "config tiers reduce to different bits"
    n0 = float(np.mean([len(o) for o in out_sets]))
    sources = [SparseAllreduce(M, "auto", backend="device", device=DEVICE,
                               expected_nnz=n0, index_range=N_VERTICES
                               ).degrees_source for _ in range(2)]
    assert sources == ["tuned", "cache"], sources
    emit({"phase": "plan_cache", "ok": True, "nodes": M,
          "degrees": list(DEGREES),
          "config_s": {"fresh": tiers["fresh"], "memo": tiers["memo"],
                       "disk": tiers["disk"],
                       "disk_restarted_process": probe["config_s"]},
          "restarted_process_s": restart_s,
          "auto_degrees_sources": sources,
          "tolerance": "reduce bits of normal floats equal across fresh, "
                       "memo, disk and disk in a restarted process",
          "launches": total})
    return total


def phase_calibrate(torch, parts):
    """Fabric fit over the stacked transport, timed-trial plan selection
    (fused merge) and resolve_degrees under the fit.  The trials are
    timing tools, not main-path calls: their launches are reported here
    and counted nowhere else."""
    import functools
    from repro_torch.core import autotune
    from repro_torch.core.topology import ButterflyPlan
    from repro_torch.kernels import _build
    out_sets, _ = pagerank_sets(parts)
    n0 = float(np.mean([len(o) for o in out_sets]))
    t0 = time.perf_counter()
    fabric = autotune.calibrate_fabric(M, device=DEVICE, store=True)
    calibrate_s = time.perf_counter() - t0
    backend = autotune.backend_name(DEVICE)
    meta, _ = autotune.default_cache().load(autotune.fabric_cache_key(
        backend=backend, num_devices=M))
    assert autotune.calibrated_fabric(backend=backend,
                                      num_devices=M) == fabric
    _build.reset_launches()
    t0 = time.perf_counter()
    report = autotune.select_plan(
        M, n0, N_VERTICES, fabric, top_k=5,
        confirm=functools.partial(autotune.measure_plan, device=DEVICE,
                                  merge="fused"))
    select_s = time.perf_counter() - t0
    trial_launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    _build.reset_launches()
    degrees, source = autotune.resolve_degrees(M, n0=n0,
                                               total_range=N_VERTICES,
                                               fabric=fabric)
    assert source == "tuned" and math.prod(degrees) == M
    emit({"phase": "calibrate", "ok": True, "nodes": M,
          "stage_degrees": list(autotune.stage_degrees(M)),
          "payload_entries": [256, 4096, 32768],
          "alpha_s": fabric.alpha_s, "beta_bytes_per_s":
          fabric.beta_bytes_per_s, "gamma_s": fabric.gamma_s,
          "fit_residual": meta["fit_residual"], "calibrate_s": calibrate_s,
          "select": {"n0": n0, "total_range": N_VERTICES, "merge": "fused",
                     "candidates": [
                         {"degrees": list(d), "modeled_ms": t * 1e3,
                          "measured_ms": report.measured_s[
                              str(ButterflyPlan(M, d))] * 1e3}
                         for t, d in report.candidates],
                     "winner": list(report.plan.degrees),
                     "decreasing": report.decreasing, "seconds": select_s},
          "resolved_degrees": list(degrees), "resolved_source": source,
          "trial_launches": trial_launches, "launches": {}})
    return {}


def phase_resilient_planned(torch, parts):
    """``ResilientAllreduce(64, (16, 4), replication=2)`` on PageRank's
    index sets (dyadic values): a replica-absorbed dead set repaired in
    place, a lost group shrunk to 63 survivors equal to a fresh reduce
    over them, the shrink reused, and a deeper loss raising
    ``QuorumLost``; then, with ``degrees="auto"``, the same loss shrunk
    with degrees from ``resolve_degrees(shrunk_from=64)`` on the base's
    plan cache (which then serves them), equal to the same reduce."""
    from repro_torch.core import autotune
    from repro_torch.core.api import SparseAllreduce
    from repro_torch.core.replication import replica_groups
    from repro_torch.core.topology import tune
    from repro_torch.resilience import (DegradedPolicy, QuorumLost,
                                        ResilientAllreduce)
    out_sets, in_sets = pagerank_sets(parts)
    n0 = float(np.mean([len(o) for o in out_sets]))
    rng = np.random.RandomState(8)
    values = [(rng.randint(-8, 9, len(o)) / 1024).astype(np.float32)
              for o in out_sets]
    groups = replica_groups(REPLICATION * M, REPLICATION)
    (absorbed,) = good_dead_sets(REPLICATION * M, 1)
    lost = set(groups[5])
    deep = set().union(*groups[:M // 2 + 1])
    deads = [None, absorbed, lost, lost, deep]
    ra = ResilientAllreduce(M, DEGREES, replication=REPLICATION,
                            probe=lambda step, attempt: deads[step],
                            policy=DegradedPolicy(max_retries=0),
                            device=DEVICE, expected_nnz=n0,
                            index_range=N_VERTICES)
    total, ms = {}, {}

    def step(i, sup=ra):
        t0 = time.perf_counter()
        out, launches = main_path(lambda: sup.reduce(values, step=i))
        ms[i] = (time.perf_counter() - t0) * 1e3
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        return out

    t0 = time.perf_counter()
    main_path(lambda: ra.config(out_sets, in_sets))
    config_s = time.perf_counter() - t0
    base = step(0)
    assert not base.degraded
    rep = step(1)
    assert rep.event.klass == "replica-absorbed" and not rep.degraded
    assert ra.base.config_cache == "repair"
    assert all(np.array_equal(rep.values[i], base.values[i])
               for i in range(M)), "repair changed bits"
    shrink = step(2)
    sh = shrink.shrink
    surv = shrink.event.survivors
    assert shrink.degraded and len(surv) == M - 1 and 5 not in surv
    want_degrees = autotune.resolve_degrees(
        M - 1, n0=n0, total_range=N_VERTICES, replication=REPLICATION,
        shrunk_from=M, cache=autotune.PlanCache(
            os.path.join(os.environ[autotune.CACHE_ENV], "resolve")))[0]
    assert sh["degrees"] == want_degrees == tune(
        M - 1, n0=n0, total_range=N_VERTICES).degrees, sh
    assert sh["replication"] == REPLICATION
    fresh = SparseAllreduce(M - 1, sh["degrees"], backend="device",
                            replication=REPLICATION, device=DEVICE)
    fresh.config([out_sets[i] for i in surv], [in_sets[i] for i in surv])
    want = fresh.reduce([values[i] for i in surv])
    assert all(np.array_equal(shrink.values[sid], want[k])
               for k, sid in enumerate(surv)), "shrink != fresh survivors"
    again = step(3)
    assert ra.stats["shrinks"] == 1 and ra.stats["shrink_reuses"] == 1
    assert all(np.array_equal(again.values[s], shrink.values[s])
               for s in surv)
    try:
        step(4)
        raise AssertionError("a loss below quorum was accepted")
    except QuorumLost:
        pass
    auto = ResilientAllreduce(M, "auto", replication=REPLICATION,
                              probe=lambda step, attempt: lost
                              if step == 6 else None,
                              policy=DegradedPolicy(max_retries=0),
                              device=DEVICE, expected_nnz=n0,
                              index_range=N_VERTICES)
    main_path(lambda: auto.config(out_sets, in_sets))
    assert not step(5, auto).degraded
    auto_shrink = step(6, auto)
    ash = auto_shrink.shrink
    assert ash["degrees_source"] == "tuned", ash
    assert autotune.resolve_degrees(
        M - 1, n0=n0, total_range=N_VERTICES, replication=REPLICATION,
        shrunk_from=M, cache=auto.base.plan_cache) == \
        (ash["degrees"], "cache"), "auto shrink did not store its degrees"
    assert all(np.array_equal(auto_shrink.values[sid], want[k])
               for k, sid in enumerate(surv)), "auto shrink != survivors"
    emit({"phase": "resilient_planned", "ok": True, "logical_nodes": M,
          "replication": REPLICATION, "degrees": list(DEGREES),
          "absorbed_dead": sorted(absorbed), "lost_group": sorted(lost),
          "survivors": len(surv), "shrink_degrees": list(sh["degrees"]),
          "shrink_degrees_source": sh["degrees_source"],
          "shrink_config_cache": sh["config_cache"],
          "quorum_lost_dead": len(deep), "config_s": config_s,
          "reduce_ms": ms[0], "repair_ms": ms[1], "first_shrink_ms": ms[2],
          "reused_shrink_ms": ms[3], "stats": ra.stats,
          "auto_degrees": list(auto.base.plan.degrees),
          "auto_shrink_degrees": list(ash["degrees"]),
          "auto_shrink_degrees_source": ash["degrees_source"],
          "auto_shrink_ms": ms[6],
          "tolerance": "bit for bit: repair vs fault-free, shrink and "
                       "auto shrink vs a fresh reduce over the survivors "
                       "(dyadic)",
          "launches": total})
    return total


def survivor_oracle(idx, val, rows):
    """float64 union (indices, sums) of the chunks of ``rows``."""
    from repro_torch.core.sparse_vec import SENTINEL
    sel = idx[rows]
    keep = sel != SENTINEL
    u, inv = np.unique(sel[keep], return_inverse=True)
    return u, np.bincount(inv, weights=val[rows][keep].astype(np.float64))


def phase_resilient_union(torch):
    """``ResilientAllreduce`` on replicated_union's input (32 logical
    nodes, (8, 4), r = 2) with both replicas of one shard dead: 31
    survivors at r = 2 over one flat layer of 31 runs, fused and banded,
    equal to a fresh reduce over the survivors and the float64 oracle."""
    from repro_torch.core.allreduce import shape_bucket
    from repro_torch.core.api import SparseAllreduce
    from repro_torch.core.sparse_vec import SENTINEL
    from repro_torch.core.topology import tune
    from repro_torch.resilience import DegradedPolicy, ResilientAllreduce
    nodes, lost = REP_UNION_NODES, 5
    idx, val, _, _ = union_wire_inputs(nodes)
    surv = [i for i in range(nodes) if i != lost]
    want_idx, want_val = survivor_oracle(idx, val, surv)
    n = len(want_idx)
    out_cap = shape_bucket(n)
    ti = torch.as_tensor(idx, device=DEVICE)
    tv = torch.as_tensor(val, device=DEVICE)
    want_i = torch.as_tensor(want_idx, device=DEVICE)
    want_v = torch.as_tensor(want_val.astype(np.float32), device=DEVICE)
    pairs, total = [], {}
    for merge in ("fused", "banded"):
        ra = ResilientAllreduce(
            nodes, REP_UNION_DEGREES, replication=REPLICATION,
            probe=lambda step, attempt: {lost, lost + nodes},
            policy=DegradedPolicy(max_retries=0), merge=merge,
            device=DEVICE, index_range=WIRE_RANGE)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res, launches = main_path(lambda: ra.union_reduce(ti, tv, out_cap))
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        assert res.degraded and res.event.survivors == tuple(surv)
        # 31 survivors: prime, so tune falls back to one flat layer
        assert res.shrink["degrees"] == tune(
            nodes - 1, n0=ra.expected_nnz, total_range=WIRE_RANGE).degrees \
            and res.shrink["replication"] == REPLICATION, res.shrink
        fresh = SparseAllreduce(nodes - 1, res.shrink["degrees"],
                                backend="device",
                                replication=REPLICATION, merge=merge,
                                device=DEVICE)
        fi, fv, fo = fresh.union_reduce(ti[surv], tv[surv], out_cap)
        for k, sid in enumerate(surv):
            gi, gv, go = res.values[sid]
            assert torch.equal(gi, fi[k]) and torch.equal(gv, fv[k]), \
                (merge, sid, "vs fresh")
            assert int(go) == int(fo[k]) == 0, (merge, sid, int(go))
            assert torch.equal(gi[:n], want_i) and \
                bool((gi[n:] == SENTINEL).all()), (merge, sid, "idx")
            assert torch.equal(gv[:n], want_v), (merge, sid, "vs oracle")
        del fi, fv, fo, res
        ms = cuda_ms(lambda: ra.union_reduce(ti, tv, out_cap), reps=3,
                     warmup=1)
        assert ra.stats["shrinks"] == 1 and ra.stats["shrink_reuses"] >= 1
        degrees = ra.last_shrink["degrees"]
        pairs.append({"merge": merge, "first_call_ms": first_ms,
                      "reused_shrink_ms": ms, "max_memory_allocated":
                      int(peak), "launches": {k: v for k, v in
                                              launches.items() if v}})
    emit({"phase": "resilient_union", "ok": True, "logical_nodes": nodes,
          "replication": REPLICATION, "degrees": list(REP_UNION_DEGREES),
          "lost_shard": lost, "survivors": len(surv),
          "survivor_degrees": list(degrees), "union_count": n,
          "out_capacity": out_cap, "pairs": pairs,
          "tolerance": "bit for bit vs a fresh reduce over the survivors "
                       "and the float64 oracle (dyadic)",
          "launches": total})
    del ti, tv, want_i, want_v
    return total


def soak_seed() -> int:
    """The first seed whose rack schedule over the POOL positions kills an
    engine position (one of the first M) at a round where the loop
    consults it (block starts from FAULT_AT on)."""
    from repro_torch.core.faults import make_schedule
    checked = [r for r in range(0, ROUNDS, CKPT_EVERY) if r >= FAULT_AT]
    for seed in range(100):
        sched = make_schedule("rack", POOL, RACK, seed=seed, rack_size=RACK)
        if any(min(sched.dead_at(r)) < M for r in checked):
            return seed
    raise AssertionError("no seed hits an engine position")


def phase_supervised_pagerank(torch, parts):
    """``SupervisedEngineLoop`` (M = 64 over a pool of 80, 10 rounds,
    checkpoints every 2) with a rack schedule from round 3: final state
    and last_q equal the fault-free run bit for bit, with a remap."""
    from repro_torch.core.faults import make_schedule
    from repro_torch.graph.pagerank import make_pagerank_app, pagerank_state
    from repro_torch.resilience import SupervisedEngineLoop
    seed = soak_seed()
    app, out_sets, in_sets = make_pagerank_app(parts, N_VERTICES, DAMPING)
    runs, total = {}, {}
    for name in ("clean", "rack"):
        sched = None if name == "clean" else make_schedule(
            "rack", POOL, RACK, seed=seed, rack_size=RACK)
        ckpt = os.path.join(SCRATCH["root"], f"supervised-{name}")
        loop = SupervisedEngineLoop(out_sets, in_sets, app, degrees=DEGREES,
                                    schedule=sched, fault_at=FAULT_AT,
                                    ckpt_dir=ckpt, ckpt_every=CKPT_EVERY,
                                    pool=POOL, device=DEVICE)
        remaps = []
        supervise = loop._supervise

        def timed(rnd, loop=loop, supervise=supervise, remaps=remaps):
            before = loop.remaps
            t0 = time.perf_counter()
            supervise(rnd)
            if loop.remaps != before:
                remaps.append({"round": rnd,
                               "seconds": time.perf_counter() - t0,
                               "config_cache": loop.engine.config_cache,
                               "nodes_first": loop.engine.nodes[0]})
        loop._supervise = timed
        extras, p0 = pagerank_state(parts, N_VERTICES, loop.engine.u_cap,
                                    loop.engine.uin_cap, device=DEVICE)
        t0 = time.perf_counter()
        (state, last_q), launches = main_path(
            lambda: loop.run(ROUNDS, p0, extras))
        torch.cuda.synchronize()
        runs[name] = {"state": state, "last_q": last_q, "remaps": remaps,
                      "seconds": time.perf_counter() - t0,
                      "events": [e.klass for e in loop.events]}
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        del extras, p0
    clean, rack = runs["clean"], runs["rack"]
    assert len(rack["remaps"]) >= 1, rack["events"]
    assert torch.equal(clean["state"], rack["state"]) and \
        torch.equal(clean["last_q"], rack["last_q"]), "remapped run differs"
    emit({"phase": "supervised_pagerank", "ok": True,
          "vertices": N_VERTICES, "nodes": M, "pool": POOL,
          "degrees": list(DEGREES), "rounds": ROUNDS,
          "ckpt_every": CKPT_EVERY, "schedule": {
              "kind": "rack", "num_failures": RACK, "rack_size": RACK,
              "seed": seed, "fault_at": FAULT_AT},
          "events": rack["events"], "remaps": rack["remaps"],
          "clean_run_s": clean["seconds"], "rack_run_s": rack["seconds"],
          "tolerance": "final state and last_q bit for bit vs the "
                       "fault-free run",
          "launches": total})
    del runs
    return total


def phase_soak_resume(torch):
    """``python -m repro_torch.launch.soak --job pagerank`` at the smoke's
    graph size in subprocesses: a fault-free baseline, a rack-fault run
    killed at round 4 (exit 17), and its ``--resume``; final.npz equal to
    the baseline's array by array.  The kernels run in the subprocesses,
    so their launches (as each run prints them) are reported here and
    kept apart from the in-process main-path counts."""
    seed = soak_seed()
    base_args = ["--job", "pagerank", "--vertices", str(N_VERTICES),
                 "--edges", str(N_EDGES), "--graph-nodes", str(M),
                 "--pool", str(POOL), "--steps", str(ROUNDS),
                 "--ckpt-every", str(CKPT_EVERY), "--seed", str(seed),
                 "--device", DEVICE]
    rack = ["--faults", "rack", "--fault-at", str(FAULT_AT),
            "--num-failures", str(RACK), "--rack-size", str(RACK)]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    runs = {}

    def soak(name, out, extra, rc):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m",
                               "repro_torch.launch.soak", "--out", out,
                               *base_args, *extra], env=env, cwd=ROOT,
                              capture_output=True, text=True, timeout=600)
        assert proc.returncode == rc, (name, proc.returncode,
                                       proc.stdout[-2000:],
                                       proc.stderr[-4000:])
        launches = [json.loads(line.split(" ", 1)[1]) for line in
                    proc.stdout.splitlines()
                    if line.startswith("SOAK_LAUNCHES ")]
        runs[name] = {"seconds": time.perf_counter() - t0, "rc": rc,
                      "launches": {k: v for k, v in launches[0].items() if v}
                      if launches else None}
        return proc.stdout

    base = os.path.join(SCRATCH["root"], "soak-base")
    faulted = os.path.join(SCRATCH["root"], "soak-faulted")
    soak("baseline", base, [], 0)
    out = soak("killed", faulted, rack + ["--kill-at", "4"], 17)
    assert "KILL round 4" in out, out
    out = soak("resumed", faulted, rack + ["--resume"], 0)
    assert "resumed at round 4" in out, out
    with np.load(os.path.join(base, "final.npz")) as a, \
            np.load(os.path.join(faulted, "final.npz")) as b:
        assert sorted(a.files) == ["last_q", "scores", "state"]
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k
    with open(os.path.join(faulted, "final.meta.json")) as f:
        meta = json.load(f)
    emit({"phase": "soak_resume", "ok": True, "seed": seed,
          "args": base_args + rack, "runs": runs,
          "remaps": meta["remaps"], "events": meta["events"],
          "tolerance": "final.npz (state, last_q, scores) equal array by "
                       "array to the fault-free baseline",
          "launches": {}})
    return {}


def bound_ms(nbytes: int) -> float:
    """Least milliseconds to move ``nbytes`` at the card's memory rate."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def index_add_call(torch, pos, val, num_rows):
    """One ``index_add_`` computing the same scatter (library yardstick),
    its flat destinations and buffer built outside the timed call."""
    b2 = pos.shape[0]
    flat = (torch.arange(b2, device=pos.device).unsqueeze(1) * (num_rows + 1)
            + torch.where((pos < 0) | (pos >= num_rows), num_rows,
                          pos.long())).reshape(-1)
    buf = torch.zeros(b2 * (num_rows + 1), val.shape[-1], device=pos.device)
    vflat = val.reshape(-1, val.shape[-1]).float()
    return lambda: buf.index_add_(0, flat, vflat)


def rank_timing(torch, runs, banded, calls):
    """One shape of a merge-rank kernel (``calls`` main-path calls there):
    exact against its plain version and the dense plain version, two calls
    bit-identical, then kernel, plain and library (``searchsorted`` over
    the same k*k run pairs) ms, the byte bound, and the CUDA launches and
    device ms per kernel stage of one call (profiler)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.rank_merge import BM, BN, merge_ranks
    got = merge_ranks(runs, banded=banded)
    plain = lambda: ref.merge_ranks_ref(runs, (BM, BN) if banded else None)
    assert torch.equal(got, plain()), "merge ranks differ from plain"
    assert torch.equal(got, ref.merge_ranks_ref(runs)), "ranks differ"
    assert torch.equal(got, merge_ranks(runs, banded=banded)), "not repeatable"
    g, k, cap = runs.shape
    seq = runs.unsqueeze(1).expand(g, k, k, cap).contiguous()
    qry = runs.unsqueeze(2).expand(g, k, k, cap).contiguous()
    # calls of tens of microseconds need many reps to be timed; the
    # profiler runs after the timings (its tracing slows launches)
    reps = min(200, max(10, (1 << 25) // runs.numel()))
    out = {"shape": list(runs.shape), "launches": calls,
           "ms": cuda_ms(lambda: merge_ranks(runs, banded=banded), reps=reps,
                         warmup=5),
           "plain_ms": cuda_ms(plain, reps=3, warmup=1),
           "bound_ms": bound_ms(runs.numel() * 8 + got.numel() * 4),
           "library_ms": cuda_ms(lambda: torch.searchsorted(seq, qry),
                                 reps=max(3, reps // 4), warmup=2),
           "reps": reps}
    stages = fresh_profile(("repro_torch.kernels.rank_merge", "merge_ranks"),
                           (runs,), {"banded": banded})
    out["cuda_launches_per_call"] = sum(n for _, n in stages.values())
    out["stage_ms"] = {name: ms for name, (ms, _) in stages.items()}
    del seq, qry, got
    return out


def tile_counts_check(torch, runs):
    """The banded kernel's own full / skipped / frontier tile counts on
    ``runs`` equal ``rank_tile_stats`` summed over every group and ordered
    run pair (strict for s > r), computed on a CPU copy."""
    from repro_torch.kernels.rank_merge import merge_tile_stats
    got = merge_tile_stats(runs)
    want = merge_tile_stats(runs.cpu())
    assert got == want, (got, want)
    return got


def rank_row(torch, recorded, banded, launches):
    """A merge-rank kernel at every shape the main path handed it
    (``recorded``: [(runs, calls)], the layer-0 union_wire shape first),
    in the main path's launch form, against its plain version; the
    two-stream form (modes 0/1) checked on two runs of each shape."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.rank_merge import rank_counts
    name = "rank_counts_banded" if banded else "rank_counts"
    shapes = []
    for runs, calls, phase in recorded:
        a, b = runs[:, 0].contiguous(), runs[:, 1].contiguous()
        for strict, side in ((True, "left"), (False, "right")):
            got = rank_counts(a, b, strict=strict, banded=banded)
            assert torch.equal(got, ref.rank_counts_ref(a, b, side)), \
                "counts differ"
            assert torch.equal(got, rank_counts(a, b, strict=strict,
                                                banded=banded)), "repeat"
        shapes.append(dict(rank_timing(torch, runs, banded, calls),
                           phase=phase))
    assert sum(e["launches"] for e in shapes) == launches[name], \
        (name, [e["launches"] for e in shapes], launches[name])
    row = {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/"
                  + ("rank_merge_banded.cu" if banded else "rank_merge.cu"),
        "replaces": "src/repro/kernels/rank_merge.py:"
                    + ("165" if banded else "142"),
        "launches": launches[name], "max_abs_err": 0,
        "check": "exact vs plain at every shape (the replica stage's k = 2 "
                 "and the survivors' flat k = 31 included), modes 0/1/2, "
                 "repeat identical",
        "bound_by": "bytes"}
    row.update({k: shapes[0][k] for k in ("shape", "ms", "plain_ms",
                                          "bound_ms", "library_ms")})
    row["shapes"] = shapes
    if banded:
        row["tile_counts"] = tile_counts_check(torch, recorded[0][0])
        row["check"] += ("; tile counts equal rank_tile_stats summed over "
                         "the layer-0 run pairs")
    return row


def general_inputs(torch, pos, val, scale):
    """General floats at the main path's positions: normal f32 / bf16
    values, or int8 values with a uniform (0, 1) scale."""
    gen = torch.Generator(device=pos.device).manual_seed(11)
    if scale is None:
        v = torch.randn(val.shape, generator=gen, device=pos.device)
        return v.to(val.dtype), None
    q = torch.randint(-127, 128, val.shape, generator=gen, device=pos.device,
                      dtype=torch.int32).to(torch.int8)
    return q, torch.rand(scale.shape, generator=gen, device=pos.device)


# profiler traces run in a fresh process (``fresh_profiler``): late in
# this script's own process, traces lost the device events of their first
# calls (runs S1, F, F2, F4 and R1 of PR 17), which a fresh process has
# not shown (tools/profiler_window.py: 513 whole traces in 4 minutes)
FRESH = {"proc": None, "jobs": None, "results": None, "calls": 0,
         "traces": 0}
PROFILER = {"traces": 0}


@contextlib.contextmanager
def fresh_profiler():
    """A fresh process that runs ``fresh_profile``'s jobs while the block
    runs; stopped when it ends."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    FRESH["jobs"], FRESH["results"] = ctx.Queue(), ctx.Queue()
    FRESH["proc"] = proc = ctx.Process(
        target=profiler_child, args=(FRESH["jobs"], FRESH["results"]),
        daemon=True)
    proc.start()
    try:
        yield
    finally:
        FRESH["jobs"].put(None)
        proc.join(timeout=60)
        if proc.is_alive():
            proc.terminate()
            proc.join()


def fresh_profile(target, args, kwargs=None, reps: int = 5):
    """``profile_kernels`` of one call of ``target`` in ``fresh_profiler``'s
    process: ``(module, name)`` names a function, ``(module, class, init
    kwargs, method)`` a method of a new instance; the tensors of ``args``
    and ``kwargs`` are shared with it through CUDA IPC, not copied."""
    FRESH["jobs"].put((target, args, kwargs or {}, reps))
    while True:
        try:
            status, out, traces = FRESH["results"].get(timeout=5)
            break
        except queue.Empty:
            if not FRESH["proc"].is_alive():
                raise RuntimeError("profiler process exited with code "
                                   f"{FRESH['proc'].exitcode}") from None
    if status != "ok":
        raise RuntimeError("profiler process failed:\n" + out)
    FRESH["calls"] += 1
    FRESH["traces"] += traces
    return out


def profiler_child(jobs, results):
    """``fresh_profiler``'s process: ``profile_kernels`` of each job until
    ``None``; a failure's traceback goes back to the caller, which
    raises."""
    import importlib
    import traceback
    import torch
    sys.path.insert(0, os.path.join(ROOT, "src"))
    for target, args, kwargs, reps in iter(jobs.get, None):
        obj = getattr(importlib.import_module(target[0]), target[1])
        fn = getattr(obj(**target[2]), target[3]) if len(target) > 2 else obj
        before = PROFILER["traces"]
        try:
            stages = profile_kernels(torch, lambda: fn(*args, **kwargs), reps)
            # idle, the shared tensors released, before the caller goes on
            del args, kwargs, fn, obj
            torch.cuda.synchronize()
            results.put(("ok", stages, PROFILER["traces"] - before))
        except Exception:
            results.put(("error", traceback.format_exc(), 0))


def profile_kernels(torch, fn, reps: int = 5, tries: int = 5):
    """``{name: (device ms, launches)}`` per call of each kernel ``fn``
    launches (template instances summed under one name), from a
    ``torch.profiler`` trace of ``reps`` calls; only the device's own
    events count (an operator's or a launch call's device time is its
    kernels' again).  Each trace starts with a warm-up step of one call
    that is not recorded, and the calls sit 20 ms of host time inside the
    recorded window on both sides.  A trace is taken again, up to
    ``tries`` times in all, unless it holds device events and every
    kernel was launched the same whole number of times in each of the
    ``reps`` calls; otherwise this raises."""
    fn()
    torch.cuda.synchronize()
    counts = None
    for _ in range(tries):
        total = trace_once(torch, fn, reps)
        PROFILER["traces"] += 1
        if total and all(n % reps == 0 for _, n in total.values()):
            return {name: (ms / reps, n // reps)
                    for name, (ms, n) in total.items()}
        counts = {name: n for name, (_, n) in total.items()}
    raise RuntimeError(f"profiler: no whole trace of {reps} calls in {tries} "
                       f"tries; the last held {counts}")


def trace_once(torch, fn, reps: int) -> dict:
    """``{name: (device ms, launches)}`` summed over one profiler trace of
    ``reps`` calls of ``fn`` (after one unrecorded warm-up call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    traces = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: traces.append(p.key_averages())
                 ) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(0.02)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.02)
        prof.step()
    total = {}
    for evt in traces.pop():
        if (evt.device_type == DeviceType.CPU
                or evt.key.startswith("ProfilerStep")):
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us > 0:
            key = evt.key.replace("(anonymous namespace)::", "")
            key = key[5:] if key.startswith("void ") else key
            name = re.split(r"[<(]", key)[0].split("::")[-1]
            ms, n = total.get(name, (0.0, 0))
            total[name] = (ms + us / 1e3, n + evt.count)
    return total


def dense_scatter_large(torch, fn, pos, val, num_rows, scale):
    """The dense scatter at the union_wire layer-0 shape on general
    floats: bit for bit against its plain version on a CPU copy, two
    launches identical, its layout equal to a stable argsort; returns
    the check and ``index_add_``'s ms on the same inputs."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.onehot_scatter import row_order
    gv, gs = general_inputs(torch, pos, val, scale)
    got = fn(pos, gv, num_rows, scale=gs)
    want = ref.onehot_scatter_add_ref(pos.cpu(), gv.cpu(), num_rows,
                                      None if gs is None else gs.cpu())
    assert torch.equal(got.cpu(), want), "dense scatter != plain on CPU"
    assert torch.equal(got, fn(pos, gv, num_rows, scale=gs)), "not repeatable"
    perm, off = row_order(pos, num_rows)
    wperm, woff = ref.row_order_ref(pos, num_rows)
    assert torch.equal(perm, wperm) and torch.equal(off, woff), "layout"
    del perm, off, wperm, woff, want, got
    return ("bit-exact vs plain on a CPU copy on general floats, repeat "
            "identical, layout equal to a stable argsort")


def scatter_row(torch, name, fn, args, kwargs, launches, library):
    """One scatter kernel on its recorded inputs vs its plain version:
    bit-exact on dyadic inputs; with a general scale, bit-exact against
    the plain version on the CPU (``index_add_`` there sums in source
    order, the kernel's) and within rtol 1e-6 + 1e-6 x max|out| of the
    plain version on the card (whose ``index_add_`` sums in atomic order,
    so sums that cancel to ~0 differ in absolute terms); two launches
    bit-identical."""
    from repro_torch.kernels import ref
    pos, val, num_rows = args
    scale = kwargs.get("scale")
    got = fn(*args, **kwargs)
    want = ref.onehot_scatter_add_ref(pos, val, num_rows, scale)
    if scale is None:
        assert torch.equal(got, want), f"{name} differs from plain"
        check = "bit-exact (dyadic), repeat identical"
    else:
        on_cpu = ref.onehot_scatter_add_ref(
            pos.cpu(), val.cpu(), num_rows, scale.cpu())
        assert torch.equal(got.cpu(), on_cpu), f"{name} differs from CPU plain"
        torch.testing.assert_close(got, want, rtol=1e-6,
                                   atol=1e-6 * float(want.abs().max()))
        check = ("bit-exact vs plain on CPU; rtol 1e-6 + 1e-6 x max vs plain "
                 "on card (general scale); repeat identical")
    assert torch.equal(got, fn(*args, **kwargs)), f"{name} not repeatable"
    line = {"onehot_scatter_add": "80", "onehot_scatter_add_scaled": "58"}
    return {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/onehot_scatter.cu",
        "replaces": "src/repro/kernels/onehot_scatter.py:" + line[name],
        "launches": launches[name],
        "max_abs_err": float((got - want).abs().max()), "check": check,
        **scatter_timing(torch, fn, args, kwargs, library)}


def scatter_timing(torch, fn, args, kwargs, library, reps: int = 10):
    """Shape, dtype, kernel / plain / library ms and byte bound of one
    scatter call."""
    from repro_torch.kernels import ref
    pos, val, num_rows = args
    scale = kwargs.get("scale")
    # every destination is read; values and scales of kept sources only
    kept = int(((pos >= 0) & (pos < num_rows)).sum())
    nbytes = (pos.numel() * 4 + kept * val.shape[-1] * val.element_size()
              + (0 if scale is None else kept * 4)
              + pos.shape[0] * num_rows * val.shape[-1] * 4)
    return {
        "shape": [pos.shape[0], pos.shape[1], int(val.shape[-1]),
                  int(num_rows)],
        "val_dtype": str(val.dtype).replace("torch.", ""),
        "ms": cuda_ms(lambda: fn(*args, **kwargs), reps=reps),
        "plain_ms": cuda_ms(lambda: ref.onehot_scatter_add_ref(
            pos, val, num_rows, scale), reps=10),
        "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
        "library_ms": None if library is None else cuda_ms(library,
                                                           reps=reps)}


def banded_call(torch, args, kwargs, calls):
    """The banded scatter at one (layer, dtype) of the main path
    (``calls`` main-path calls there): bit-exact against its plain version
    (on the card for dyadic values, on a CPU copy with the int8 wire's
    general scales), two calls identical, its window table equal to
    ``searchsorted`` of the tile boundaries; kernel, plain and
    ``index_add_`` ms; the byte bound of what the kernel must move (the
    kept sources' ``pos``, values and scales, the window table and the
    output; the parked tail is never read) and, beside it, the bound over
    every ``pos`` entry; the CUDA launches (two) and device ms per stage
    of one call (profiler)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.onehot_scatter import (BANDED_ROWS,
                                                    banded_onehot_scatter_add,
                                                    banded_windows)
    pos, val, num_rows = args
    scale = kwargs.get("scale")
    fn = banded_onehot_scatter_add
    got = fn(*args, **kwargs)
    want = ref.onehot_scatter_add_ref(pos, val, num_rows, scale)
    if scale is None:
        assert torch.equal(got, want), "banded differs from plain"
        check = "bit-exact vs plain (dyadic)"
    else:
        on_cpu = ref.onehot_scatter_add_ref(pos.cpu(), val.cpu(), num_rows,
                                            scale.cpu())
        assert torch.equal(got.cpu(), on_cpu), "banded differs from CPU plain"
        torch.testing.assert_close(got, want, rtol=1e-6,
                                   atol=1e-6 * float(want.abs().max()))
        check = ("bit-exact vs plain on a CPU copy (general scales); rtol "
                 "1e-6 + 1e-6 x max vs plain on card")
        del on_cpu
    err = float((got - want).abs().max())
    assert torch.equal(got, fn(*args, **kwargs)), "banded not repeatable"
    keys = torch.clamp(torch.arange(-(-num_rows // BANDED_ROWS) + 1,
                                    device=pos.device) * BANDED_ROWS,
                       max=num_rows).to(torch.int32)
    assert torch.equal(banded_windows(pos, num_rows), torch.searchsorted(
        pos, keys.expand(pos.shape[0], -1).contiguous())), "window table"
    kept = int(((pos >= 0) & (pos < num_rows)).sum())
    del got, want
    # the library yardstick: index_add_ of the (widened) values; for the
    # int8 wire it leaves out the scale, as row 4's does
    out = {"calls": calls, "check": check + "; repeat identical; window "
           "table = searchsorted", "max_abs_err": err, "kept_sources": kept,
           **scatter_timing(torch, fn, args, kwargs,
                            index_add_call(torch, pos, val, num_rows),
                            reps=50)}
    out["bound_all_pos_ms"] = out["bound_ms"]
    out["bound_ms"] = bound_ms(
        kept * (4 + val.shape[-1] * val.element_size()
                + (0 if scale is None else 4))
        + keys.numel() * pos.shape[0] * 8
        + pos.shape[0] * num_rows * val.shape[-1] * 4)
    stages = fresh_profile(("repro_torch.kernels.onehot_scatter",
                            "banded_onehot_scatter_add"), args, kwargs)
    out["cuda_launches_per_call"] = sum(n for _, n in stages.values())
    assert out["cuda_launches_per_call"] == 2, stages
    out["stage_ms"] = {name: ms for name, (ms, _) in stages.items()}
    return out


def banded_rows(torch, rec, launches):
    """Rows 5 and 6: the banded scatter at every (phase, butterfly layer,
    value dtype) the main path handed it, union_wire's layer 0 first; each
    row's top-level numbers are that call's (f32, or int8 + scale)."""
    rows = []
    for name, kinds in (("banded_onehot_scatter_add", ("f32", "bf16")),
                        ("banded_onehot_scatter_add_scaled", ("scaled",))):
        keys = sorted((k for k in rec.args if k[1] in kinds),
                      key=lambda k: (ROW_PHASES.index(k[0]), k[2][1],
                                     kinds.index(k[1])))
        shapes = [dict(banded_call(torch, *rec.args[k], rec.calls[k]),
                       phase=k[0]) for k in keys]
        assert sum(e["calls"] for e in shapes) == launches[name], \
            (name, [e["calls"] for e in shapes], launches[name])
        line = "177" if name == "banded_onehot_scatter_add" else "156"
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/banded_onehot_scatter.cu",
            "replaces": "src/repro/kernels/onehot_scatter.py:" + line,
            "launches": launches[name],
            "max_abs_err": max(e["max_abs_err"] for e in shapes),
            "check": "bit-exact at every (layer, dtype) of the main path: "
                     "dyadic vs plain, scaled vs plain on a CPU copy (and "
                     "rtol 1e-6 vs plain on card); repeat identical; window "
                     "table = searchsorted",
            **{k: shapes[0][k] for k in ("shape", "val_dtype", "ms",
                                         "plain_ms", "bound_ms", "bound_by",
                                         "library_ms", "bound_all_pos_ms")},
            "shapes": shapes})
    return rows


def csr_library(torch, row_ptr, cols, wts, x):
    """One library CSR matvec over the same nonzeros (block-diagonal CSR of
    all nodes times the flattened x): ``(call, its result)``."""
    m, n = x.shape
    r = row_ptr.numel() - 1
    lens = (row_ptr[1:] - row_ptr[:-1]).long()
    node = torch.repeat_interleave(
        torch.arange(r, device=x.device) // (r // m), lens)
    csr = torch.sparse_csr_tensor(row_ptr.long(), cols.long() + node * n, wts,
                                  size=(r, m * n))
    xv = x.reshape(-1, 1)
    call = lambda: csr @ xv
    return call, call().reshape(m, r // m)


def csr_product64(torch, row_ptr, cols, wts, x, absolute=False):
    """The stacked-CSR product in float64 (of |A| and |x| with
    ``absolute``), [M, n_rows]: the exact sum to hold a float32 one to,
    and the scale its rounding grows with."""
    m, r = x.shape[0], row_ptr.numel() - 1
    lens = (row_ptr[1:] - row_ptr[:-1]).long()
    row = torch.repeat_interleave(torch.arange(r, device=x.device), lens)
    xi = (row // (r // m)) * x.shape[-1] + cols.long()
    w, xv = wts.double(), x.reshape(-1).double()[xi]
    prod = (w.abs() * xv.abs()) if absolute else w * xv
    return torch.zeros(r, dtype=torch.float64, device=x.device).index_add_(
        0, row, prod).reshape(m, r // m)


def spmv_csr_call(torch, args, calls, first):
    """The SpMV kernel on one graph phase's first-round inputs (``calls``
    main-path launches there), repeat identical.  PageRank's first graph
    (``first``): within rtol 1e-5 of the plain version and the library
    CSR matvec.  The others: within 1e-5 x (|A| |x|) + 1e-9 per row of
    the float64 product, and 1e-4 x (|A| |x|) + 1e-9 of the plain version
    and the library, whose float32 sums run in atomic order (spectral's x
    has both signs, so its rows cancel, and |A| |x|, not the result, sets
    the rounding; where x >= 0 the two are equal)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.spmv_csr import spmv_csr
    row_ptr, cols, wts, x, bins = args
    got = spmv_csr(row_ptr, cols, wts, x, bins)
    plain = lambda: ref.spmv_csr_ref(row_ptr, cols, wts, x)
    want = plain()
    library, lib = csr_library(torch, row_ptr, cols, wts, x)
    if first:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-9)
        torch.testing.assert_close(lib, got, rtol=1e-5, atol=1e-9)
        check = "rtol 1e-5 vs plain and vs CSR library"
    else:
        scale = csr_product64(torch, row_ptr, cols, wts, x, absolute=True)
        exact = csr_product64(torch, row_ptr, cols, wts, x)
        for other, rtol in ((exact, 1e-5), (want, 1e-4), (lib, 1e-4)):
            gap = float(((got.double() - other).abs() - rtol * scale).max())
            assert gap <= 1e-9, (rtol, gap)
        check = ("within 1e-5 x (|A| |x|) of the float64 product, 1e-4 x "
                 "(|A| |x|) of plain and CSR library")
        del scale, exact
    assert torch.equal(got, spmv_csr(row_ptr, cols, wts, x, bins)), \
        "spmv_csr not repeatable"
    nnz = int(cols.numel())
    nbytes = (nnz * 8 + row_ptr.numel() * row_ptr.element_size()
              + x.numel() * 4 + got.numel() * 4)
    return {
        "launches": calls, "max_abs_err": float((got - want).abs().max()),
        "check": check + ", repeat identical",
        "shape": [int(row_ptr.numel() - 1), int(x.shape[-1])], "nnz": nnz,
        "bins": int(bins.numel() - 1),
        "ms": cuda_ms(lambda: spmv_csr(row_ptr, cols, wts, x, bins), reps=20),
        "plain_ms": cuda_ms(plain, reps=5, warmup=1),
        "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
        "library_ms": cuda_ms(library, reps=20)}


def spmv_csr_row(torch, rec, launches):
    """The SpMV kernel at each graph phase's first round on the stacked
    CSR (main path); the top-level numbers are PageRank's."""
    keys = sorted(rec.args, key=lambda key: GRAPH_PHASES.index(key[0]))
    shapes = [dict(spmv_csr_call(torch, rec.args[key][0], rec.calls[key],
                                 key[0] == "pagerank"), phase=key[0])
              for key in keys]
    assert sum(e["launches"] for e in shapes) == launches["spmv_csr"], \
        ([e["launches"] for e in shapes], launches["spmv_csr"])
    row = {"name": "spmv_csr", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/spmv_csr.cu",
           "replaces": "src/repro/kernels/spmv_ell.py:34",
           "launches": launches["spmv_csr"],
           "max_abs_err": max(e["max_abs_err"] for e in shapes),
           "check": "; ".join(f"{e['phase']}: {e['check']}"
                              for e in shapes)}
    row.update({k: shapes[0][k] for k in ("shape", "nnz", "bins", "ms",
                                          "plain_ms", "bound_ms", "bound_by",
                                          "library_ms")})
    row["shapes"] = shapes
    return row


def spmv_ell_row(torch, parts, row_ptr, cols, wts, x, launches):
    """The ELL kernel, off the main path: stacked ELL tables of the same
    partitions built for this row alone (and freed after), the first
    round's x, against its plain version and the CSR library matvec."""
    from repro_torch.graph.engine import stack_ell
    from repro_torch.graph.pagerank import LazyTables
    from repro_torch.kernels import ref
    from repro_torch.kernels.spmv_ell import spmv_ell
    m, n = x.shape
    u_cap = (row_ptr.numel() - 1) // m
    ec, ew = stack_ell(LazyTables(parts, "ell"), u_cap,
                       kmax=max(p.ell_width() for p in parts), device=DEVICE,
                       n_cols=n)
    got = spmv_ell(ec, ew, x)
    step = 8  # plain version in slices of nodes (its gathers are large)
    plain = lambda: torch.cat([ref.spmv_ell_ref(
        ec[i:i + step], ew[i:i + step], x[i:i + step])
        for i in range(0, m, step)])
    want = plain()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-9)
    library, lib = csr_library(torch, row_ptr, cols, wts, x)
    torch.testing.assert_close(lib, got, rtol=1e-5, atol=1e-9)
    nnz = int(cols.numel())
    row = {
        "name": "spmv_ell", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/spmv_ell.cu",
        "replaces": "src/repro/kernels/spmv_ell.py:34",
        "launches": launches["spmv_ell"], "main_path": False,
        "max_abs_err": float((got - want).abs().max()),
        "check": "rtol 1e-5 vs plain and vs CSR library",
        "shape": list(ec.shape), "nnz": nnz,
        "ell_bytes": int(ec.numel() * 8),
        "ms": cuda_ms(lambda: spmv_ell(ec, ew, x), reps=5),
        "plain_ms": cuda_ms(plain, reps=2, warmup=1),
        "bound_ms": bound_ms(nnz * 8 + x.numel() * 4 + got.numel() * 4),
        "bound_by": "bytes",
        "library_ms": cuda_ms(library, reps=5)}
    del ec, ew, got, want
    torch.cuda.empty_cache()
    return row


def rank_shapes(rec, kind):
    """[(runs, main-path calls, phase)] of one merge-rank kernel, one per
    (phase, shape): union_wire's first, in butterfly-layer order, then
    replicated_union's (its degree-2 replica stage first), then union's."""
    keys = [key for key in rec.args if key[1] == kind]
    keys.sort(key=lambda key: ROW_PHASES.index(key[0]))
    return [(rec.args[key][0][0], rec.calls[key], key[0]) for key in keys]


def kernel_rows(torch, rec, launches, parts):
    """Every kernel on its recorded main-path inputs vs its plain version,
    in the order of the TPU kernel table."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.onehot_scatter import onehot_scatter_add
    scat = rec["scatter"].args
    rows = [rank_row(torch, rank_shapes(rec["rank"], kind), kind == "banded",
                     launches) for kind in ("dense", "banded")]
    args, kwargs = scat[("union", "f32")]
    row = scatter_row(torch, "onehot_scatter_add", onehot_scatter_add, args,
                      kwargs, launches, index_add_call(torch, *args))
    (pos, val, num_rows), kw = scat[("union_wire", "bf16")]
    assert torch.equal(onehot_scatter_add(pos, val, num_rows, **kw),
                       ref.onehot_scatter_add_ref(pos, val, num_rows)), "bf16"
    row["large"] = {
        "check": dense_scatter_large(torch, onehot_scatter_add, pos, val,
                                     num_rows, None)
        + "; bit-exact vs plain on card (dyadic)",
        "stage_ms": {name: ms for name, (ms, _) in fresh_profile(
            ("repro_torch.kernels.onehot_scatter", "onehot_scatter_add"),
            (pos, val, num_rows), kw).items()},
        "dropped_sources": int(((pos < 0) | (pos >= num_rows)).sum()),
        **scatter_timing(torch, onehot_scatter_add, (pos, val, num_rows), kw,
                         index_add_call(torch, pos, val, num_rows))}
    args, kwargs = scat[("replicated_union", "f32")]
    row["replica_stage"] = dict(
        scatter_row(torch, "onehot_scatter_add", onehot_scatter_add, args,
                    kwargs, launches, index_add_call(torch, *args)),
        calls=rec["scatter"].calls[("replicated_union", "f32")])
    for key in ("name", "route", "source", "replaces", "launches"):
        del row["replica_stage"][key]
    # the survivors' flat layer of 31 runs (resilient_union, fused)
    ((_, _, (_, k31, cap31)),) = [key for key in rec["rank"].args
                             if key[0] == "resilient_union"
                             and key[1] == "dense" and key[2][1] > 2]
    (skey,) = [key for key in scat if key[:2] == ("resilient_union", "f32")
               and key[2][1] == k31 * cap31]
    args, kwargs = scat[skey]
    row["survivor_layer"] = dict(
        scatter_row(torch, "onehot_scatter_add", onehot_scatter_add, args,
                    kwargs, launches, index_add_call(torch, *args)),
        calls=rec["scatter"].calls[skey], k=k31)
    for key in ("name", "route", "source", "replaces", "launches"):
        del row["survivor_layer"][key]
    rows.append(row)
    args, kwargs = scat[("union_wire", "scaled")]
    row = scatter_row(torch, "onehot_scatter_add_scaled", onehot_scatter_add,
                      args, kwargs, launches, index_add_call(torch, *args))
    row["check"] += "; " + dense_scatter_large(
        torch, onehot_scatter_add, *args, kwargs["scale"])
    rows.append(row)
    rows.extend(banded_rows(torch, rec["banded"], launches))
    csr_args = rec["spmv"].args[("pagerank", "first")][0]
    rows.append(spmv_ell_row(torch, parts, *csr_args[:4], launches))
    rows.append(spmv_csr_row(torch, rec["spmv"], launches))
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--plan-cache-probe"]:
        return plan_cache_probe(*sys.argv[2:5])
    SCRATCH["root"] = tempfile.mkdtemp(prefix="chip-smoke-")
    try:
        return smoke(torch)
    finally:
        shutil.rmtree(SCRATCH["root"], ignore_errors=True)


def smoke(torch) -> int:
    """Every phase, then the kernels line and the last line."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.data.pipeline import powerlaw_graph
    from repro_torch.graph import engine
    from repro_torch.graph.pagerank import build_partitions
    from repro_torch.kernels import _build, ops

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    ptxas = [ln.strip() for ln in open(str(lib) + ".log")
             if "registers" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "ok": True, "seconds": time.perf_counter() - t0,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "ptxas": ptxas})

    t0 = time.perf_counter()
    edges = powerlaw_graph(N_VERTICES, N_EDGES, alpha=2.0, seed=0)
    parts = build_partitions(edges, N_VERTICES, M)
    graph_s = time.perf_counter() - t0

    rec = {"rank": Recorder(ops, "merge_ranks", rank_variant),
           "scatter": Recorder(ops, "onehot_scatter_add", scatter_variant),
           "banded": Recorder(ops, "banded_onehot_scatter_add",
                              banded_variant),
           "spmv": Recorder(engine, "spmv_csr",
                            lambda a, kw: (PHASE["name"], "first"))}

    def run(name, fn, *args):
        PHASE["name"] = name
        fresh_plan_cache()
        return fn(torch, *args)

    per_phase = {"planned": run("planned", phase_planned, parts),
                 "union": run("union", phase_union),
                 "pagerank": run("pagerank", phase_pagerank, edges, parts,
                                 N_VERTICES),
                 "hadi": run("hadi", phase_hadi, edges, parts, N_VERTICES),
                 "spectral": run("spectral", phase_spectral, edges,
                                 N_VERTICES)}
    t0 = time.perf_counter()
    big = powerlaw_graph(LARGE_VERTICES, LARGE_EDGES, alpha=2.0, seed=0)
    big_parts = build_partitions(big, LARGE_VERTICES, M)
    emit({"phase": "pagerank_large_graph", "seconds":
          time.perf_counter() - t0})
    per_phase["pagerank_large"] = run("pagerank_large", phase_pagerank, big,
                                      big_parts, LARGE_VERTICES)
    del big, big_parts
    per_phase["union_wire"] = run("union_wire", phase_union_wire)
    per_phase["replicated_planned"] = run("replicated_planned",
                                          phase_replicated_planned, parts)
    per_phase["replicated_union"] = run("replicated_union",
                                        phase_replicated_union)
    per_phase["plan_cache"] = run("plan_cache", phase_plan_cache, parts)
    per_phase["calibrate"] = run("calibrate", phase_calibrate, parts)
    per_phase["resilient_planned"] = run("resilient_planned",
                                         phase_resilient_planned, parts)
    per_phase["resilient_union"] = run("resilient_union",
                                       phase_resilient_union)
    per_phase["supervised_pagerank"] = run("supervised_pagerank",
                                           phase_supervised_pagerank, parts)
    per_phase["soak_resume"] = run("soak_resume", phase_soak_resume)
    torch.cuda.synchronize()
    launches = {k: sum(p.get(k, 0) for p in per_phase.values())
                for k in _build.LAUNCHES}
    for r in rec.values():
        r.restore()
    emit({"phase": "main_path_launches", "launches": launches,
          "per_phase": per_phase, "graph_s": graph_s,
          "note": "in-process main-path calls; the soak's subprocess "
                  "launches are in its phase line"})
    # off the main path: the ELL kernel (PageRank runs the CSR kernel), the
    # dense scatter's layout stages and the banded scatter's window table,
    # each launched on its own
    off_path = ("spmv_ell", "row_order", "banded_windows")
    assert all(launches[k] == 0 for k in off_path), launches
    assert all(v > 0 for k, v in launches.items() if k not in off_path), \
        launches

    reserved = torch.cuda.memory_reserved()
    torch.cuda.empty_cache()
    emit({"phase": "kernels_start", "memory_allocated":
          torch.cuda.memory_allocated(), "memory_reserved_before": reserved,
          "memory_reserved": torch.cuda.memory_reserved()})
    with fresh_profiler():
        rows = kernel_rows(torch, rec, launches, parts)
    emit({"phase": "profiler", "process": "fresh", "calls": FRESH["calls"],
          "traces": FRESH["traces"]})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
