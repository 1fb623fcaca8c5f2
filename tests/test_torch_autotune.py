"""PyTorch port, autotuner and plan cache held to ``repro.core.autotune``.

The reference module is imported in-process (its host half is numpy, as
in test_torch_host.py): the fabric fit, plan selection (with its prime
and depth-extended fallbacks), ``resolve_degrees``, the cache keys and
the frozen-plan artifacts must equal the reference's, apart from the
``"backend": "torch"`` field the port adds to every key it writes.  An
artifact the reference's ``PlanCache`` wrote loads into the port and
reduces to the reference's bits (dyadic values); reference and port
entries under one root never serve each other.  The port's own config
tiers (fresh, memo, disk, and disk again in a restarted process) give
identical reduce bits on general floats.  ``kernels.costmodel`` reports
equal the reference's.  All on the CPU, small shapes.
"""
import functools
import json
import math
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from repro.core import autotune as jat
from repro.core.netmodel import EC2_2013 as JEC2
from repro.core.netmodel import Fabric as JFabric
from repro.kernels import costmodel as jcost

from repro_torch.core import autotune as at
from repro_torch.core.api import SparseAllreduce
from repro_torch.core.netmodel import EC2_2013, Fabric
from repro_torch.core.topology import ButterflyPlan
from repro_torch.kernels import costmodel as cost

# one intra-op thread a test process: pytest-xdist runs several workers
# at once, and their OpenMP threads would oversubscribe the cores
torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
GT = dict(name="gt", beta_bytes_per_s=2e8, alpha_s=5e-3, gamma_s=2e-4)


@pytest.fixture
def roots(tmp_path):
    """A port cache and a reference cache over one shared root."""
    root = str(tmp_path / "plans")
    return at.PlanCache(root=root), jat.PlanCache(root=root)


def _no_backend(key: dict) -> dict:
    assert key.pop("backend") == "torch"
    return key


# ---------------------------------------------------------------------------
# calibration fit and selection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("serial", [True, False])
@pytest.mark.parametrize("noise", [0.0, 0.05])
def test_fit_fabric_matches_reference(serial, noise):
    kw = dict(payload_bytes=[1e3, 1e4, 1e5, 1e6], fanouts=[1, 3, 7, 15],
              serial=serial, noise=noise, seed=3)
    mine = at.synth_stage_samples(Fabric(**GT), **kw)
    ref = jat.synth_stage_samples(JFabric(**GT), **kw)
    assert [(s.nbytes, s.fanout, s.time_s) for s in mine] == \
        [(s.nbytes, s.fanout, s.time_s) for s in ref]
    fit = at.fit_fabric(mine, serial=serial)
    want = jat.fit_fabric(ref, serial=serial)
    assert fit.as_meta() == want.as_meta()
    assert at.fit_error(fit, mine, serial=serial) == \
        jat.fit_error(want, ref, serial=serial)


def test_fit_degenerate_sweeps_match_reference():
    one_fanout = at.synth_stage_samples(Fabric(**GT), [1e3, 1e4, 1e5], [3])
    with pytest.warns(UserWarning, match="one fanout"):
        fit = at.fit_fabric(one_fanout)
    with pytest.warns(UserWarning, match="one fanout"):
        want = jat.fit_fabric(jat.synth_stage_samples(
            JFabric(**GT), [1e3, 1e4, 1e5], [3]))
    assert fit.gamma_s == 0.0 and fit.as_meta() == want.as_meta()
    with pytest.raises(ValueError, match="3 samples"):
        at.fit_fabric(one_fanout[:2])
    with pytest.raises(ValueError, match="payload"):
        at.fit_fabric(at.synth_stage_samples(Fabric(**GT), [1e3], [1, 3, 7]))


@pytest.mark.parametrize("m,n0,total,kw", [
    (64, 12.1e6, 60e6, {}), (16, 1e5, 1e6, {"top_k": 3}),
    (31, 1e5, 1e6, {}),                       # prime: the flat plan
    (128, 1e5, 1e6, {}),                      # Omega = 7 > max_depth 6
    (64, 1e5, 1e6, {"wire": "delta+bf16"}),
    (64, 1e5, 1e6, {"overlap_compute_s": 1e-3})])
def test_select_plan_matches_reference(m, n0, total, kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mine = at.select_plan(m, n0, total, EC2_2013, **kw)
        ref = jat.select_plan(m, n0, total, JEC2, **kw)
    assert mine.plan.degrees == ref.plan.degrees
    for f in ("modeled_s", "decreasing", "fallback", "candidates",
              "rate_optimal_s", "rate_fraction", "overlap_compute_s"):
        assert getattr(mine, f) == getattr(ref, f), f
    if m == 31:
        assert mine.fallback == "prime" and mine.plan.degrees == (31,)
    if m == 128:
        assert mine.fallback == "depth-extended"


def test_select_plan_confirm_reranks_by_measurement():
    rep0 = at.select_plan(64, 12.1e6, 60e6, top_k=3)
    target = rep0.candidates[1][1]
    rep = at.select_plan(64, 12.1e6, 60e6, top_k=3,
                         confirm=lambda p: 0.1 if p.degrees == target else 1.0)
    assert rep.plan.degrees == target and len(rep.measured_s) == 3


@pytest.mark.parametrize("m,kw", [
    (64, {}), (63, {"shrunk_from": 64, "replication": 2}),
    (31, {"shrunk_from": 32}), (128, {"merge": "banded", "width": 4}),
    (64, {"wire": "delta"})])
def test_resolve_degrees_matches_reference(tmp_path, m, kw):
    """Same degrees and sources, each package in its own root."""
    mine_c = at.PlanCache(str(tmp_path / "mine"))
    ref_c = jat.PlanCache(str(tmp_path / "ref"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for want_src in ("tuned", "cache"):
            mine = at.resolve_degrees(m, n0=1e5, total_range=1e6,
                                      cache=mine_c, **kw)
            ref = jat.resolve_degrees(m, n0=1e5, total_range=1e6,
                                      cache=ref_c, **kw)
            assert mine == ref and mine[1] == want_src
    # the stored meta is the reference's, key apart
    key = at.plan_cache_key(mesh=(("nodes", m),), nnz=1e5, index_range=1e6,
                            merge=kw.get("merge", "sort"),
                            replication=kw.get("replication", 1),
                            width=kw.get("width", 1), fabric=EC2_2013,
                            shrunk_from=kw.get("shrunk_from"),
                            wire=kw.get("wire", "raw"))
    jkey = jat.plan_cache_key(**{**dict(
        mesh=(("nodes", m),), nnz=1e5, index_range=1e6,
        merge=kw.get("merge", "sort"), replication=kw.get("replication", 1),
        width=kw.get("width", 1), fabric=JEC2,
        shrunk_from=kw.get("shrunk_from"), wire=kw.get("wire", "raw"))})
    with open(mine_c.path(key) + ".meta.json") as f:
        mine_meta = json.load(f)
    with open(ref_c.path(jkey) + ".meta.json") as f:
        ref_meta = json.load(f)
    assert _no_backend(mine_meta.pop("key")) == ref_meta.pop("key")
    assert mine_meta == ref_meta


def test_resolve_degrees_guards_and_retune(tmp_path):
    cache = at.PlanCache(str(tmp_path))
    with pytest.raises(ValueError, match="mesh_sig"):
        at.resolve_degrees(64, n0=1e5, total_range=1e6,
                           mesh_sig=(("nodes", 32),), cache=cache)
    d1, s1 = at.resolve_degrees(16, n0=1e5, total_range=1e6, cache=cache)
    d2, s2 = at.resolve_degrees(16, n0=1e5, total_range=1e6, cache=cache,
                                retune=True)
    assert (s1, s2) == ("tuned", "tuned") and d1 == d2
    assert cache.stats["stores"] == 2
    # the API honours retune: a cached entry is bypassed and rewritten
    ar = SparseAllreduce(16, "auto", plan_cache=cache, retune=True)
    assert ar.degrees_source == "tuned" and cache.stats["stores"] == 3
    assert SparseAllreduce(16, "auto", plan_cache=cache).degrees_source \
        == "cache"


# ---------------------------------------------------------------------------
# keys: the reference's, plus the backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("change", [
    {}, {"nnz": 4e5}, {"merge": "banded"}, {"replication": 2},
    {"width": 4}, {"serial_nic": False}, {"mesh": (("data", 64),)},
    {"wire": "delta+bf16"}, {"shrunk_from": 128},
    {"overlap_compute_s": 2e-3}])
def test_cache_keys_equal_reference_but_backend(change):
    base = {**dict(mesh=(("nodes", 64),), nnz=1e5, index_range=1e6,
                   merge="sort", replication=1, width=1, serial_nic=True),
            **change}
    mine = at.plan_cache_key(**base, fabric=EC2_2013)
    ref = jat.plan_cache_key(**base, fabric=JEC2)
    assert at._digest(mine) != jat._digest(ref)
    assert _no_backend(mine) == ref
    assert _no_backend(at.planned_cache_key("abc")) == \
        jat.planned_cache_key("abc")
    assert at.fabric_cache_key(backend="torch-cuda", num_devices=64) == \
        jat.fabric_cache_key(backend="torch-cuda", num_devices=64)


def test_reference_and_port_entries_never_serve_each_other(roots):
    mine_c, ref_c = roots
    kw = dict(n0=12.1e6, total_range=60e6)
    assert jat.resolve_degrees(64, cache=ref_c, **kw)[1] == "tuned"
    assert at.resolve_degrees(64, cache=mine_c, **kw)[1] == "tuned"
    assert jat.resolve_degrees(64, cache=ref_c, **kw)[1] == "cache"
    assert at.resolve_degrees(64, cache=mine_c, **kw)[1] == "cache"
    names = sorted(os.listdir(mine_c.root))
    assert len([n for n in names if n.endswith(".meta.json")]) == 2, names


# ---------------------------------------------------------------------------
# frozen-plan artifacts
# ---------------------------------------------------------------------------

def _pattern(seed=0, m=8, r=4000):
    rng = np.random.RandomState(seed)
    outs = [np.unique(rng.choice(r, 300).astype(np.uint32)) for _ in range(m)]
    ins = [np.unique(rng.choice(r, 200).astype(np.uint32)) for _ in range(m)]
    return outs, ins


@pytest.mark.parametrize("replication,dead", [(1, None), (2, {3, 12})])
def test_planned_artifact_matches_reference(replication, dead):
    from repro.core.allreduce import make_device_plan as jmake
    from repro.core.planned import plan_sparse_allreduce as jplan
    from repro_torch.core.allreduce import make_device_plan
    from repro_torch.core.planned import plan_sparse_allreduce
    outs, ins = _pattern()
    m = len(outs)
    args = ([("nodes", m * replication)], {"nodes": (4, 2)})
    kw = dict(in_capacity=max(map(len, outs)),
              out_capacity=sum(map(len, outs)), replication=replication)
    mine = at.planned_to_artifact(plan_sparse_allreduce(
        make_device_plan(*args, **kw), outs, ins, dead=dead))
    ref = jat.planned_to_artifact(jplan(jmake(*args, **kw), outs, ins,
                                        dead=dead))
    assert mine[1] == ref[1]
    assert sorted(mine[0]) == sorted(ref[0])
    for name in ref[0]:
        np.testing.assert_array_equal(mine[0][name], ref[0][name])


def test_reference_artifact_reduces_to_reference_bits(roots):
    """A plan frozen and stored by the reference's PlanCache loads through
    the port's (same path, same format) and reduces, dyadic values, to
    the reference simulator's bits."""
    from repro.core.allreduce import make_device_plan as jmake
    from repro.core.api import SparseAllreduce as JSparseAllreduce
    from repro.core.planned import plan_sparse_allreduce as jplan
    from repro.core.sparse_vec import HashPerm as JHashPerm
    mine_c, ref_c = roots
    outs, ins = _pattern(seed=5)
    m = len(outs)
    planned = jplan(jmake([("nodes", m)], {"nodes": (4, 2)},
                          in_capacity=max(map(len, outs)),
                          out_capacity=sum(map(len, outs))),
                    outs, ins, perm=JHashPerm.make(0))
    arrays, meta = jat.planned_to_artifact(planned)
    key = jat.planned_cache_key("ref-fingerprint")
    ref_c.store(key, meta, arrays)
    hit = mine_c.load(key)
    assert hit is not None and mine_c.stats["hits"] == 1
    meta2, arrays2 = hit
    port = at.planned_from_artifact(arrays2, meta2, {"nodes": (4, 2)},
                                    device="cpu")
    rng = np.random.RandomState(6)
    vals = [(rng.randint(-64, 65, len(o)) / 32.0).astype(np.float32)
            for o in outs]
    staged = np.zeros((m, port.u_cap), np.float32)
    for n, v in enumerate(vals):
        staged[n, : len(v)] = v
    got = port.make_reduce_fn("cpu")(torch.from_numpy(staged)).numpy()
    sim = JSparseAllreduce(m, (4, 2), backend="sim")
    sim.config(outs, ins)
    for n, want in enumerate(sim.reduce(vals)):
        np.testing.assert_array_equal(got[n, : len(ins[n])],
                                      np.asarray(want, np.float32))


def test_corrupt_entries_degrade_to_replan(tmp_path):
    cache = at.PlanCache(str(tmp_path))
    d1, _ = at.resolve_degrees(16, n0=1e5, total_range=1e6, cache=cache)
    key = at.plan_cache_key(mesh=(("nodes", 16),), nnz=1e5, index_range=1e6,
                            merge="sort", replication=1, width=1,
                            fabric=EC2_2013)
    with open(cache.path(key) + ".meta.json", "w") as f:
        f.write("{ not json")
    d2, src = at.resolve_degrees(16, n0=1e5, total_range=1e6, cache=cache)
    assert d2 == d1 and src == "tuned" and cache.stats["errors"] >= 1
    # a corrupt frozen plan replans: config reads "fresh", not "disk"
    outs, ins = _pattern(seed=9)
    at.clear_plan_memo()
    SparseAllreduce(8, (4, 2), backend="device", device="cpu",
                    plan_cache=cache).config(outs, ins)
    for name in os.listdir(cache.root):
        if name.startswith("planned-") and name.endswith(".npz"):
            with open(os.path.join(cache.root, name), "wb") as f:
                f.write(b"truncated")
    at.clear_plan_memo()
    ar = SparseAllreduce(8, (4, 2), backend="device", device="cpu",
                         plan_cache=cache)
    ar.config(outs, ins)
    assert ar.config_cache == "fresh"


def test_plan_memo_is_lru_bounded(monkeypatch):
    at.clear_plan_memo()
    monkeypatch.setattr(at, "PLANNED_MEMO_MAX", 3)
    try:
        for i in range(4):
            at.memo_store(f"fp{i}", (i,))
        assert at.memo_lookup("fp0") is None
        assert at.memo_lookup("fp1") == (1,)
        at.memo_store("fp4", (4,))
        assert at.memo_lookup("fp2") is None
        assert at.memo_lookup("fp1") == (1,)
        assert len(at._PLANNED_MEMO) == 3
    finally:
        at.clear_plan_memo()


def test_stats_meta_and_fabric_roundtrip(tmp_path):
    from repro_torch.core.simulator import ReduceStats, StageStats
    st = ReduceStats(config_time_s=1.5, reduce_time_s=0.25, overflow=3,
                     stages=[StageStats(layer=0, phase="down",
                                        max_msg_bytes=10.0, total_bytes=99.0,
                                        num_messages=7, time_s=0.5)])
    meta = at.stats_to_meta(st)
    assert meta == jat.stats_to_meta(jat.stats_from_meta(meta))
    assert at.stats_from_meta(meta) == st
    cache = at.PlanCache(str(tmp_path))
    assert at.calibrated_fabric(backend="torch-cpu", num_devices=8,
                                cache=cache, default=EC2_2013) is EC2_2013
    at.store_calibrated_fabric(Fabric(**GT), backend="torch-cpu",
                               num_devices=8, cache=cache, residual=0.02)
    assert at.calibrated_fabric(backend="torch-cpu", num_devices=8,
                                cache=cache) == Fabric(**GT)


# ---------------------------------------------------------------------------
# the API's three config tiers
# ---------------------------------------------------------------------------

RESTART_CODE = r"""
import sys
import numpy as np, torch
from repro_torch.core.api import SparseAllreduce
from repro_torch.core.autotune import PlanCache
inp = np.load(sys.argv[1])
outs = [inp[f"o{i}"] for i in range(8)]
ins = [inp[f"i{i}"] for i in range(8)]
vals = [inp[f"v{i}"] for i in range(8)]
ar = SparseAllreduce(8, (4, 2), backend="device", device="cpu",
                     plan_cache=PlanCache(root=sys.argv[2]))
ar.config(outs, ins)
np.savez(sys.argv[3], *ar.reduce(vals))
print("FIRST=" + ar.config_cache)
"""


def test_config_tiers_give_identical_bits(tmp_path):
    """fresh -> memo (the same plan object and reduce callable) -> disk
    (memo cleared) -> disk in a restarted process: identical reduce
    bits on general floats; a CPU plan is never served to another
    device key, and other positions are a different entry."""
    cache = at.PlanCache(str(tmp_path / "plans"))
    outs, ins = _pattern(seed=1)
    rng = np.random.RandomState(2)
    vals = [rng.rand(len(o)).astype(np.float32) for o in outs]
    at.clear_plan_memo()
    kw = dict(backend="device", device="cpu", plan_cache=cache)
    results, tiers = [], []
    for step in range(3):
        if step == 2:
            at.clear_plan_memo()
        ar = SparseAllreduce(8, (4, 2), **kw)
        ar.config(outs, ins)
        tiers.append(ar.config_cache)
        results.append(ar.reduce(vals))
        if step == 0:
            first = ar
        if step == 1:
            assert ar._planned is first._planned
            assert ar.reduce_fn is first.reduce_fn
    assert tiers == ["fresh", "memo", "disk"]
    moved = SparseAllreduce(8, (4, 2), nodes=range(8, 16), **kw)
    moved.config(outs, ins)
    assert moved.config_cache == "fresh"
    results.append(moved.reduce(vals))
    inp = tmp_path / "inp.npz"
    np.savez(inp, **{f"o{i}": o for i, o in enumerate(outs)},
             **{f"i{i}": x for i, x in enumerate(ins)},
             **{f"v{i}": v for i, v in enumerate(vals)})
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", RESTART_CODE, str(inp),
                        cache.root, str(tmp_path / "out.npz")], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "FIRST=disk" in r.stdout, r.stderr
    with np.load(tmp_path / "out.npz") as f:
        results.append([f[f"arr_{i}"] for i in range(8)])
    for other in results[1:]:
        for a, b in zip(results[0], other):
            assert np.array_equal(a, b)
    # fresh bits equal the sim backend within the float32 tolerance
    sim = SparseAllreduce(8, (4, 2))
    sim.config(outs, ins)
    for a, b in zip(results[0], sim.reduce(vals)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_api_plan_cache_argument_validation():
    assert SparseAllreduce(8, (4, 2)).plan_cache is at.default_cache()
    assert SparseAllreduce(8, (4, 2), plan_cache=False).plan_cache is None
    with pytest.raises(ValueError, match="plan_cache"):
        SparseAllreduce(8, (4, 2), plan_cache="yes")
    with pytest.raises(ValueError, match="pool positions"):
        SparseAllreduce(8, (4, 2), nodes=range(7))


# ---------------------------------------------------------------------------
# calibration on the bound device (the CPU here), and the cost model
# ---------------------------------------------------------------------------

def test_calibration_and_timed_trials_on_cpu(tmp_path):
    cache = at.PlanCache(str(tmp_path))
    samples = at.measure_stage_samples(8, device="cpu",
                                       payload_entries=(64, 512),
                                       degrees=(2, 8), repeats=1)
    assert [(s.nbytes, s.fanout) for s in samples] == \
        [(512.0, 1), (4096.0, 1), (512.0, 7), (4096.0, 7)]
    assert all(s.time_s > 0 for s in samples)
    with pytest.raises(ValueError, match="divide"):
        at.measure_stage_samples(8, device="cpu", degrees=(3,))
    fab = at.calibrate_fabric(8, device="cpu", store=True, cache=cache,
                              payload_entries=(64, 512), repeats=1)
    assert at.backend_name("cpu") == "torch-cpu"
    assert at.calibrated_fabric(backend="torch-cpu", num_devices=8,
                                cache=cache) == fab
    t = at.measure_plan(ButterflyPlan(8, (4, 2)), entries_per_node=64,
                        device="cpu", merge="fused", repeats=1)
    assert t > 0
    rep = at.select_plan(8, 512, 1 << 20, fab, top_k=2, confirm=functools
                         .partial(at.measure_plan, entries_per_node=64,
                                  device="cpu", repeats=1))
    assert len(rep.measured_s) == 2 and math.prod(rep.plan.degrees) == 8


@pytest.mark.parametrize("mode", ["sort", "fused", "banded"])
def test_costmodel_reports_match_reference(mode):
    rng = np.random.RandomState(4)
    k, cap = 4, 1500
    runs = np.full((k, cap), 0xFFFFFFFF, np.uint32)
    for r in range(k):
        n = rng.randint(cap // 2, cap)
        runs[r, :n] = np.unique(rng.randint(0, 1 << 24, 2 * cap))[:n]
    mine = cost.merge_tile_report(runs, 4096, mode=mode)
    import jax.numpy as jnp
    ref = jcost.merge_tile_report(jnp.asarray(runs), 4096, mode=mode)
    assert mine == ref
    assert cost.merge_tile_report(torch.as_tensor(runs.astype(np.int64)),
                                  4096, mode=mode) == ref
    assert cost.scatter_tile_report(6000, 3, 4096, mode=mode, band=k) == \
        jcost.scatter_tile_report(6000, 3, 4096, mode=mode, band=k)
    for wire in ("raw", "delta", "delta+bf16", "delta+int8ef"):
        assert cost.wire_bytes_report(cap, 13, wire=wire, fabric=EC2_2013,
                                      fanout=3) == \
            jcost.wire_bytes_report(cap, 13, wire=wire, fabric=JEC2,
                                    fanout=3)
