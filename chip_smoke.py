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
11. kernels -- each kernel on the inputs it got on the main path (phases
   2-10, layer 0 / first round; the two merge-rank kernels at every shape
   the main path handed them, the replica stage's [64, 2, C] included, the
   dense scatter also at the replica stage, the CSR SpMV at each graph
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
points): each starts with every count at 0 and is read right after,
before any timing loop runs.
The last line is ``{"ok": true, "device": {...}}``.  Needs one CUDA GPU;
exits non-zero without one or outside a checkout of the repository.
"""
import json
import os
import re
import subprocess
import sys
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
# the phases whose recorded kernel inputs make up the shapes of a row, in
# the order the rows list them
ROW_PHASES = ("union_wire", "replicated_union", "union")
GRAPH_PHASES = ("pagerank", "spectral", "pagerank_large")
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
        return PHASE["name"], "scaled"
    return PHASE["name"], "bf16" if args[1].dtype.itemsize == 2 else "f32"


def banded_variant(args, kwargs):
    """Recorder key of a banded scatter call: the scatter key and the
    positions' shape (each butterfly layer hands the kernel its own)."""
    return scatter_variant(args, kwargs) + (tuple(args[0].shape),)


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
    sim = SparseAllreduce(M, DEGREES, backend="sim")
    sim.config(out_sets, in_sets)
    want = sim.reduce(values)
    err = 0.0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        err = max(err, float(np.max(np.abs(g - w), initial=0.0)))
    planned, _ = dev.planned_parts()
    staged = torch.zeros((M, planned.u_cap), device=DEVICE)
    reduce_ms = cuda_ms(lambda: dev.reduce_fn(staged), reps=10)
    emit({"phase": "planned", "ok": True, "max_abs_err": err,
          "tolerance": "rtol 1e-5, atol 1e-5 vs float64 sim",
          "config_s": config_s, "u_cap": planned.u_cap,
          "uin_cap": planned.uin_cap, "q_cap": planned.q_cap,
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
            if wire == "raw" and merge != "sort":
                # where a reduce's device time goes, by kernel (profiler)
                stages = profile_kernels(torch, lambda: ar.union_reduce(
                    ti, tv, out_cap), reps=2)
                pairs[-1]["device_ms"] = sum(m for m, _ in stages.values())
                pairs[-1]["top_kernels_ms"] = dict(sorted(
                    ((k, m) for k, (m, _) in stages.items()),
                    key=lambda kv: -kv[1])[:12])
    peak = torch.cuda.max_memory_allocated()
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
    engine.run(ROUNDS, p0, extras)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, last_q, _ = engine.run(ROUNDS, p0, extras)
    torch.cuda.synchronize()
    round_s = (time.perf_counter() - t0) / ROUNDS
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
          "host_config_s": config_s, "csr_state_s": state_s,
          "reference_s": reference_s,
          "round_wall_s": round_s, "engine": stats["engine"],
          "launches": launches})
    del engine, extras, p0, last_q
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
          "config_s": config_s, "repair_s": repair_s,
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
    stages = profile_kernels(torch, lambda: merge_ranks(runs, banded=banded))
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
                 "included), modes 0/1/2, repeat identical",
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


def stage_ms(torch, fn, reps: int = 5):
    """Device ms per call of each kernel ``fn`` launches, by name, from a
    ``torch.profiler`` trace of ``reps`` calls."""
    return {name: ms for name, (ms, _) in
            profile_kernels(torch, fn, reps).items()}


def profile_kernels(torch, fn, reps: int = 5, tries: int = 5):
    """``{name: (device ms, launches)}`` per call of each kernel ``fn``
    launches (template instances summed under one name), from a
    ``torch.profiler`` trace of ``reps`` calls; only the device's own
    events count (an operator's or a launch call's device time is its
    kernels' again).  The profiler now and then drops the device events
    of whole calls at a trace's edges, so each trace starts with a
    warm-up step of one call that is not recorded, the calls sit 5 ms of
    host time inside the recorded window on both sides, and a trace is
    taken again, up to ``tries`` times in all, unless it holds device
    events and every kernel was launched the same whole number of times
    in each of the ``reps`` calls; the last such failure raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    traces = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: traces.append(p.key_averages())
                     ) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            time.sleep(0.005)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.005)
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
        if total and all(n % reps == 0 for _, n in total.values()):
            return {name: (ms / reps, n // reps)
                    for name, (ms, n) in total.items()}
    raise RuntimeError(f"profiler: no whole trace of {reps} calls in {tries} "
                       f"tries; the last held {total}")


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
    out = {"calls": calls, "check": check + "; repeat identical; window "
           "table = searchsorted", "max_abs_err": err, "kept_sources": kept,
           **scatter_timing(torch, fn, args, kwargs, None if scale is not None
                            else index_add_call(torch, pos, val, num_rows),
                            reps=50)}
    out["bound_all_pos_ms"] = out["bound_ms"]
    out["bound_ms"] = bound_ms(
        kept * (4 + val.shape[-1] * val.element_size()
                + (0 if scale is None else 4))
        + keys.numel() * pos.shape[0] * 8
        + pos.shape[0] * num_rows * val.shape[-1] * 4)
    stages = profile_kernels(torch, lambda: fn(*args, **kwargs))
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
        "stage_ms": stage_ms(torch, lambda: onehot_scatter_add(
            pos, val, num_rows, **kw)),
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
    torch.cuda.synchronize()
    launches = {k: sum(p.get(k, 0) for p in per_phase.values())
                for k in _build.LAUNCHES}
    for r in rec.values():
        r.restore()
    emit({"phase": "main_path_launches", "launches": launches,
          "per_phase": per_phase, "graph_s": graph_s})
    # off the main path: the ELL kernel (PageRank runs the CSR kernel), the
    # dense scatter's layout stages and the banded scatter's window table,
    # each launched on its own
    off_path = ("spmv_ell", "row_order", "banded_windows")
    assert all(launches[k] == 0 for k in off_path), launches
    assert all(v > 0 for k, v in launches.items() if k not in off_path), \
        launches

    rows = kernel_rows(torch, rec, launches, parts)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
