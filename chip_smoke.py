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
   power-law graph over M=64 nodes, degrees (16, 4), 10 rounds, against
   the float64 dense reference; then per-round wall time of the engine;
5. kernels -- each kernel on the inputs it got in phases 2-4, against its
   plain version (ranks exact, scatter bit-exact and repeatable, SpMV
   rtol 1e-5), with CUDA-event times of kernel, plain version and the
   nearest single PyTorch call, and the least time the card needs.

The launch counts of the ``kernels`` line are those of the main-path
calls alone (``config`` + ``reduce``, the first ``union_reduce`` of each
merge, the ``pagerank`` entry point): each starts with every count at 0
and is read right after, before any timing loop runs.
The last line is ``{"ok": true, "device": {...}}``.  Needs one CUDA GPU;
exits non-zero without one or outside a checkout of the repository.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
DEVICE = "cuda"
M, DEGREES = 64, (16, 4)
N_VERTICES, N_EDGES, ROUNDS, DAMPING = 262_144, 2_000_000, 10, 0.85
UNION_C, UNION_RANGE, UNION_ALPHA = 16_384, 1 << 22, 1.4


def emit(obj) -> None:
    """One JSON line on stdout."""
    print(json.dumps(obj), flush=True)


def main_path(call):
    """``(call(), launches)``: the kernels' launch counts of this one
    main-path call, zeroed just before it and read just after."""
    from repro_torch.kernels import _build
    _build.reset_launches()
    out = call()
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
    the arguments of its first call (the layer-0 / first-round shapes)."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.args = None
        setattr(module, name, self)

    def __call__(self, *args, **kwargs):
        if self.args is None:
            self.args = (args, kwargs)
        return self.fn(*args, **kwargs)

    def restore(self):
        setattr(self.module, self.name, self.fn)


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


def phase_pagerank(torch, edges, parts):
    """PageRank through the device entry point vs the float64 reference,
    then the engine's wall time per round after a warm-up run."""
    from repro_torch.graph.pagerank import (make_pagerank_engine, pagerank,
                                            pagerank_dense_reference)
    ref = pagerank_dense_reference(edges, N_VERTICES, iters=ROUNDS,
                                   damping=DAMPING)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (got, stats), launches = main_path(lambda: pagerank(
        edges, N_VERTICES, m=M, degrees=DEGREES, iters=ROUNDS,
        damping=DAMPING, backend="device", device=DEVICE))
    total_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-10)
    rel = float(np.max(np.abs(got - ref) / np.abs(ref)))
    engine, extras, p0 = make_pagerank_engine(parts, N_VERTICES, DEGREES,
                                              DAMPING, device=DEVICE)
    engine.run(ROUNDS, p0, extras)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, last_q, _ = engine.run(ROUNDS, p0, extras)
    torch.cuda.synchronize()
    round_s = (time.perf_counter() - t0) / ROUNDS
    cols = extras["cols"]
    emit({"phase": "pagerank", "ok": True, "vertices": N_VERTICES,
          "edges": int(len(edges)), "nodes": M, "degrees": list(DEGREES),
          "rounds": ROUNDS, "max_abs_err": float(np.max(np.abs(got - ref))),
          "max_rel_err": rel, "tolerance": "rtol 1e-4 vs float64 dense",
          "ell_shape": list(cols.shape),
          "ell_bytes": int(cols.numel() * 8),
          "max_memory_allocated": int(peak), "entry_point_s": total_s,
          "round_wall_s": round_s, "engine": stats["engine"],
          "launches": launches})
    del engine, extras, p0, last_q
    return launches


def kernel_rows(torch, rec, launches):
    """Each kernel on its recorded main-path inputs vs its plain version."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.onehot_scatter import onehot_scatter_add
    from repro_torch.kernels.rank_merge import merge_ranks, rank_counts
    from repro_torch.kernels.spmv_ell import spmv_ell
    rows = []

    # row 1: merge ranks of layer 0 (the main path's launch form)
    (runs,), _ = rec["rank"].args
    got = merge_ranks(runs)
    assert torch.equal(got, ref.merge_ranks_ref(runs)), "merge ranks differ"
    a, b = runs[:, 0].contiguous(), runs[:, 1].contiguous()
    for strict, side in ((True, "left"), (False, "right")):
        assert torch.equal(rank_counts(a, b, strict=strict),
                           ref.rank_counts_ref(a, b, side)), "counts differ"
    g, k, cap = runs.shape
    # the same k*k searches as one library call over stacked run pairs
    seq = runs.unsqueeze(1).expand(g, k, k, cap).contiguous()
    qry = runs.unsqueeze(2).expand(g, k, k, cap).contiguous()
    rows.append({
        "name": "rank_counts", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rank_merge.cu",
        "replaces": "src/repro/kernels/rank_merge.py:142",
        "launches": launches["rank_counts"], "max_abs_err": 0,
        "shape": list(runs.shape),
        "ms": cuda_ms(lambda: merge_ranks(runs), reps=20),
        "plain_ms": cuda_ms(lambda: ref.merge_ranks_ref(runs), reps=5),
        "bound_ms": (runs.numel() * 8 + got.numel() * 4)
        / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": cuda_ms(lambda: torch.searchsorted(seq, qry), reps=5)})
    del seq, qry

    # row 3: the fused merge's scatter-add at layer 0
    (pos, val, num_rows), _ = rec["scatter"].args
    got = onehot_scatter_add(pos, val, num_rows)
    assert torch.equal(got, ref.onehot_scatter_add_ref(pos, val, num_rows)), \
        "scatter differs from plain"
    assert torch.equal(got, onehot_scatter_add(pos, val, num_rows)), \
        "scatter not repeatable"
    b2, c = pos.shape
    flat = (torch.arange(b2, device=pos.device).unsqueeze(1) * (num_rows + 1)
            + torch.where((pos < 0) | (pos >= num_rows), num_rows,
                          pos.long())).reshape(-1)
    buf = torch.zeros(b2 * (num_rows + 1), val.shape[-1], device=pos.device)
    vflat = val.reshape(-1, val.shape[-1])
    rows.append({
        "name": "onehot_scatter_add", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/onehot_scatter.cu",
        "replaces": "src/repro/kernels/onehot_scatter.py:80",
        "launches": launches["onehot_scatter_add"], "max_abs_err": 0,
        "shape": [b2, c, int(val.shape[-1]), int(num_rows)],
        "ms": cuda_ms(lambda: onehot_scatter_add(pos, val, num_rows), reps=10),
        "plain_ms": cuda_ms(
            lambda: ref.onehot_scatter_add_ref(pos, val, num_rows), reps=10),
        "bound_ms": (pos.numel() * 4 + val.numel() * 4 + got.numel() * 4)
        / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": cuda_ms(lambda: buf.index_add_(0, flat, vflat), reps=10)})

    # row 7: the first PageRank round's SpMV on the stacked ELL tables
    (cols, wts, x), _ = rec["spmv"].args
    got = spmv_ell(cols, wts, x)
    nnz = int((cols >= 0).sum())
    # plain version in slices of nodes (its gathers would not fit at once)
    step = 8
    want = torch.cat([ref.spmv_ell_ref(cols[i:i + step], wts[i:i + step],
                                       x[i:i + step])
                      for i in range(0, cols.shape[0], step)])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-9)
    rows.append({
        "name": "spmv_ell", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/spmv_ell.cu",
        "replaces": "src/repro/kernels/spmv_ell.py:34",
        "launches": launches["spmv_ell"],
        "max_abs_err": float((got - want).abs().max()),
        "shape": list(cols.shape), "nnz": nnz,
        "ms": cuda_ms(lambda: spmv_ell(cols, wts, x), reps=5),
        "plain_ms": cuda_ms(lambda: [ref.spmv_ell_ref(
            cols[i:i + step], wts[i:i + step], x[i:i + step])
            for i in range(0, cols.shape[0], step)], reps=2, warmup=1),
        "bound_ms": (nnz * 8 + x.numel() * 4 + got.numel() * 4)
        / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": None})
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

    rec = {"rank": Recorder(ops, "merge_ranks"),
           "scatter": Recorder(ops, "onehot_scatter_add"),
           "spmv": Recorder(engine, "spmv_ell")}
    per_phase = {"planned": phase_planned(torch, parts),
                 "union": phase_union(torch),
                 "pagerank": phase_pagerank(torch, edges, parts)}
    torch.cuda.synchronize()
    launches = {k: sum(p[k] for p in per_phase.values())
                for k in _build.LAUNCHES}
    for r in rec.values():
        r.restore()
    emit({"phase": "main_path_launches", "launches": launches,
          "per_phase": per_phase, "graph_s": graph_s})
    assert all(v > 0 for v in launches.values()), launches

    rows = kernel_rows(torch, rec, launches)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
