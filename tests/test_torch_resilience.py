"""PyTorch port, supervised recovery held to ``repro.resilience``.

One JAX subprocess (16 forced host devices, as in tests/test_resilience.py)
runs the reference's survivor parity sweep -- ``ResilientAllreduce`` on
the planned path over degrees (4,), (2, 2), (4, 2) at r in {1, 2}, and on
the union path for merges sort / fused / banded at r in {1, 2}, each
losing one replica group -- the engine remap run, and the PageRank soak's
fault-free final arrays, and saves inputs and outputs.  The port runs the
same sweep on the CPU: planned and union results, and the survivor
degrees, equal the reference's bit for bit (dyadic values); the engine
and soak arrays agree within rtol 1e-5 (the PageRank tolerance of
test_torch_graph.py); the port's own remap and kill-and-resume equal its
fault-free run bit for bit (the soak through subprocesses with
``--device cpu``), for the PageRank job and for the reduced train job
(the reference's acceptance test: a rack fault at step 3 with r = 2,
killed at step 4, resumed).  Without JAX: the checkpoint store (round trip,
atomicity, corruption, list/latest, and each package reading the other's
artifacts), ``classify`` against the reference, retry and backoff, the
policy checks and the absorbed / shrink-reuse / fail / quorum lifecycle.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.checkpoint import store as jstore
from repro.resilience import classify as jclassify

from repro_torch.checkpoint import store
from repro_torch.core.api import SparseAllreduce
from repro_torch.core.faults import make_schedule
from repro_torch.core.replication import DeadLogicalNode
from repro_torch.resilience import (GROUP_LOST, NO_FAULT, QUORUM_LOST,
                                    REPLICA_ABSORBED, DegradedPolicy,
                                    QuorumLost, ResilientAllreduce,
                                    SupervisedEngineLoop, classify,
                                    retry_until_alive)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
_ENV = dict(os.environ,
            XLA_FLAGS="--xla_force_host_platform_device_count=16",
            PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
PLANNED = [((4,), 1), ((4,), 2), ((2, 2), 1), ((2, 2), 2), ((4, 2), 1),
           ((4, 2), 2)]
UNION = [(m, r) for m in ("sort", "fused", "banded") for r in (1, 2)]
RANGE, CAP = 300, 24
SOAK_ARGS = ("--job", "pagerank", "--steps", 8, "--ckpt-every", 2,
             "--vertices", 200, "--edges", 800, "--graph-nodes", 4,
             "--seed", 0)
RACK = ("--faults", "rack", "--fault-at", 3, "--num-failures", 5,
        "--rack-size", 5)

REFERENCE_CODE = r"""
import sys, tempfile
import numpy as np
from repro.core.faults import make_schedule
from repro.data.pipeline import powerlaw_graph
from repro.graph.pagerank import (build_partitions, make_pagerank_app,
                                  pagerank_state)
from repro.launch import soak
from repro.resilience import (DegradedPolicy, ResilientAllreduce,
                              SupervisedEngineLoop)

out = {}
rng = np.random.RandomState(7)
RANGE, CAP = %(range)d, %(cap)d

def dyadic(n):
    return (rng.randint(-128, 129, n) / 64.0).astype(np.float32)

def make_sets(m):
    outs = [np.sort(rng.choice(RANGE, 40, replace=False)).astype(np.uint32)
            for _ in range(m)]
    ins = [np.sort(rng.choice(RANGE, 40, replace=False)).astype(np.uint32)
           for _ in range(m)]
    return outs, ins, [dyadic(len(o)) for o in outs]

for degrees, r in %(planned)r:
    M = int(np.prod(degrees))
    tag = "p_%%s_r%%d" %% ("x".join(map(str, degrees)), r)
    outs, ins, vals = make_sets(M)
    for i in range(M):
        out[f"{tag}_out{i}"], out[f"{tag}_in{i}"] = outs[i], ins[i]
        out[f"{tag}_val{i}"] = vals[i]
    dead = {1} if r == 1 else {1, 1 + M}
    ra = ResilientAllreduce(M, degrees, replication=r, dead=dead,
                            policy=DegradedPolicy(max_retries=0),
                            seed=0, expected_nnz=40, index_range=RANGE)
    ra.config(outs, ins)
    res = ra.reduce(vals)
    assert res.degraded
    for sid, v in res.values.items():
        out[f"{tag}_got{sid}"] = np.asarray(v)
    out[f"{tag}_degrees"] = np.array(ra.last_shrink["degrees"])
    out[f"{tag}_r2"] = np.array(ra.last_shrink["replication"])

M = 4
idx = np.stack([np.sort(rng.choice(RANGE, CAP, replace=False))
                for _ in range(M)]).astype(np.uint32)
uval = np.stack([dyadic(CAP) for _ in range(M)])
out["u_idx"], out["u_val"] = idx, uval
for merge, r in %(union)r:
    tag = f"u_{merge}_r{r}"
    dead = {2} if r == 1 else {2, 2 + M}
    ra = ResilientAllreduce(M, (2, 2), replication=r, dead=dead,
                            policy=DegradedPolicy(max_retries=0), seed=0,
                            merge=merge, expected_nnz=CAP, index_range=RANGE)
    res = ra.union_reduce(idx, uval, 4 * CAP)
    assert res.degraded and res.event.survivors == (0, 1, 3)
    for sid, (gi, gv, gf) in res.values.items():
        out[f"{tag}_idx{sid}"] = np.asarray(gi)
        out[f"{tag}_val{sid}"] = np.asarray(gv)
        out[f"{tag}_ovf{sid}"] = np.asarray(gf)
    out[f"{tag}_degrees"] = np.array(ra.last_shrink["degrees"])

N, M = 300, 4
edges = powerlaw_graph(N, 1500, seed=0)
parts = build_partitions(edges, N, M, seed=0)
app, out_sets, in_sets = make_pagerank_app(parts, N)
for name, sched in (("clean", None),
                    ("rack", make_schedule("rack", 16, 5, seed=1,
                                           rack_size=5))):
    loop = SupervisedEngineLoop(out_sets, in_sets, app, degrees=(M,),
                                seed=0, schedule=sched, fault_at=2,
                                ckpt_every=2)
    extras, p0 = pagerank_state(parts, N, loop.engine.u_cap,
                                loop.engine.uin_cap)
    state, last_q = loop.run(8, p0, extras)
    out[f"e_{name}_state"] = np.asarray(state)
    out[f"e_{name}_last_q"] = np.asarray(last_q)
    out[f"e_{name}_remaps"] = np.array(loop.remaps)

d = tempfile.mkdtemp()
assert soak.main(["--out", d] + [str(a) for a in %(soak)r]) == 0
with np.load(d + "/final.npz") as f:
    for k in f.files:
        out["s_" + k] = f[k]
np.savez(sys.argv[1], **out)
print("REFERENCE_OK")
""" % {"range": RANGE, "cap": CAP, "planned": PLANNED, "union": UNION,
       "soak": SOAK_ARGS}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's inputs and outputs (one 16-device subprocess)."""
    path = tmp_path_factory.mktemp("ref") / "ref.npz"
    r = subprocess.run([sys.executable, "-c", REFERENCE_CODE, str(path)],
                       env=_ENV, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "REFERENCE_OK" in r.stdout, \
        f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


# ---------------------------------------------------------------------------
# survivor parity with the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("degrees,r", PLANNED)
def test_planned_shrink_matches_reference(ref, degrees, r):
    """Losing shard 1's group: the port's survivor reduce, its degrees and
    replication, equal the reference's, and a fresh port reduce over the
    survivors, bit for bit."""
    m = int(np.prod(degrees))
    tag = "p_%s_r%d" % ("x".join(map(str, degrees)), r)
    outs = [ref[f"{tag}_out{i}"] for i in range(m)]
    ins = [ref[f"{tag}_in{i}"] for i in range(m)]
    vals = [ref[f"{tag}_val{i}"] for i in range(m)]
    dead = {1} if r == 1 else {1, 1 + m}
    ra = ResilientAllreduce(m, degrees, replication=r, dead=dead,
                            policy=DegradedPolicy(max_retries=0), seed=0,
                            expected_nnz=40, index_range=RANGE, device="cpu")
    ra.config(outs, ins)
    res = ra.reduce(vals)
    surv = tuple(i for i in range(m) if i != 1)
    assert res.degraded and res.event.klass == GROUP_LOST
    assert res.event.survivors == surv
    sh = ra.last_shrink
    assert sh["degrees"] == tuple(ref[f"{tag}_degrees"].tolist())
    assert sh["replication"] == int(ref[f"{tag}_r2"])
    alive = [i for i in range(m * r) if i not in dead]
    assert sh["nodes"] == tuple(alive[: len(surv) * sh["replication"]])
    fresh = SparseAllreduce(len(surv), sh["degrees"], backend="device",
                            replication=sh["replication"], seed=0,
                            device="cpu")
    fresh.config([outs[i] for i in surv], [ins[i] for i in surv])
    want = fresh.reduce([vals[i] for i in surv])
    for k, sid in enumerate(surv):
        assert np.array_equal(res.values[sid], ref[f"{tag}_got{sid}"])
        assert np.array_equal(res.values[sid], want[k])


@pytest.mark.parametrize("merge,r", UNION)
def test_union_shrink_matches_reference(ref, merge, r):
    idx, val = ref["u_idx"], ref["u_val"]
    dead = {2} if r == 1 else {2, 6}
    tag = f"u_{merge}_r{r}"
    ra = ResilientAllreduce(4, (2, 2), replication=r, dead=dead,
                            policy=DegradedPolicy(max_retries=0), seed=0,
                            merge=merge, expected_nnz=CAP, index_range=RANGE,
                            device="cpu")
    res = ra.union_reduce(idx, val, 4 * CAP)
    assert res.degraded and res.event.survivors == (0, 1, 3)
    assert ra.last_shrink["degrees"] == tuple(ref[f"{tag}_degrees"].tolist())
    for sid, (gi, gv, gf) in res.values.items():
        np.testing.assert_array_equal(gi.numpy().astype(np.uint32),
                                      ref[f"{tag}_idx{sid}"])
        np.testing.assert_array_equal(gv.numpy(), ref[f"{tag}_val{sid}"])
        assert int(gf) == int(ref[f"{tag}_ovf{sid}"])


def test_engine_remap_matches_reference_and_is_exact(ref):
    from repro_torch.data.pipeline import powerlaw_graph
    from repro_torch.graph.pagerank import (build_partitions,
                                            make_pagerank_app,
                                            pagerank_state)
    n, m = 300, 4
    parts = build_partitions(powerlaw_graph(n, 1500, seed=0), n, m, seed=0)
    app, out_sets, in_sets = make_pagerank_app(parts, n)
    got = {}
    for name, sched in (("clean", None),
                        ("rack", make_schedule("rack", 16, 5, seed=1,
                                               rack_size=5))):
        loop = SupervisedEngineLoop(out_sets, in_sets, app, degrees=(m,),
                                    seed=0, schedule=sched, fault_at=2,
                                    ckpt_every=2, pool=16, device="cpu")
        extras, p0 = pagerank_state(parts, n, loop.engine.u_cap,
                                    loop.engine.uin_cap, device="cpu")
        state, last_q = loop.run(8, p0, extras)
        got[name] = (state.numpy(), last_q.numpy(), loop)
    assert got["rack"][2].remaps == int(ref["e_rack_remaps"]) >= 1
    loop = got["rack"][2]
    assert loop.engine.nodes == tuple(loop.pool[p] for p in loop.assignment)
    for i in (0, 1):
        assert np.array_equal(got["clean"][i], got["rack"][i])
    np.testing.assert_allclose(got["clean"][0], ref["e_clean_state"],
                               rtol=1e-5, atol=1e-10)
    np.testing.assert_allclose(got["clean"][1], ref["e_clean_last_q"],
                               rtol=1e-5, atol=1e-10)


def _soak(out_dir, *extra, expect_rc=0):
    cmd = [sys.executable, "-m", "repro_torch.launch.soak", "--out",
           str(out_dir), "--device", "cpu", "--pool", "16",
           *map(str, extra)]
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run(cmd, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == expect_rc, \
        f"rc={r.returncode}\nstdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return r.stdout


def test_soak_pagerank_kill_and_resume(ref, tmp_path):
    """A PageRank soak under a rack schedule, killed at round 4 (exit 17)
    and resumed, ends with final.npz equal to the fault-free run's array
    for array; that baseline agrees with the reference's."""
    base, faulted = tmp_path / "base", tmp_path / "faulted"
    assert "SOAK_OK job=pagerank" in _soak(base, *SOAK_ARGS)
    out = _soak(faulted, *SOAK_ARGS, *RACK, "--kill-at", 4, expect_rc=17)
    assert "KILL round 4" in out
    out = _soak(faulted, *SOAK_ARGS, *RACK, "--resume")
    assert "resumed at round 4" in out and "SOAK_OK job=pagerank" in out
    with np.load(base / "final.npz") as a, \
            np.load(faulted / "final.npz") as b:
        assert sorted(a.files) == ["last_q", "scores", "state"]
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k
            np.testing.assert_allclose(a[k], ref["s_" + k], rtol=1e-5,
                                       atol=1e-10)
    meta = store.load_flat(str(faulted / "final"))[1]
    assert meta["remaps"] >= 1 and GROUP_LOST in meta["events"]


TRAIN_ARGS = ("--job", "train", "--reduced", "--steps", 6,
              "--ckpt-every", 2, "--batch", 4, "--seq", 32, "--dp", 4,
              "--replication", 2, "--seed", 0)


def test_soak_quorum_and_train_job(tmp_path):
    from repro_torch.launch import soak
    # the reduced train job runs in this process and checkpoints
    assert soak.main(["--job", "train", "--reduced", "--steps", "2",
                      "--batch", "2", "--seq", "16", "--dp", "2",
                      "--device", "cpu", "--out", str(tmp_path / "t")]) == 0
    arrays, meta = store.load_flat(str(tmp_path / "t" / "final"))
    assert len(meta["losses"]) == 2 and np.isfinite(meta["losses"]).all()
    assert int(arrays["opt_step"]) == 2 and meta["events"] == []
    assert store.list_checkpoints(str(tmp_path / "t"))[0][0] == 2
    # a pool without spares cannot remap: exit 3
    out = _soak(tmp_path / "q", *SOAK_ARGS, "--faults", "rack", "--pool", 4,
                "--num-failures", 2, "--rack-size", 2, expect_rc=3)
    assert "QUORUM_LOST" in out


def test_soak_train_kill_and_resume_bit_identical(tmp_path):
    """The reference's acceptance on the port: a training run under a
    mid-run rack schedule, killed at step 4 and resumed, ends with final
    parameters and optimizer state bit-identical to the uninterrupted
    fault-free run, and the same losses."""
    import json
    base, faulted = tmp_path / "base", tmp_path / "faulted"
    out = _soak(base, *TRAIN_ARGS)
    assert "SOAK_OK job=train" in out
    out = _soak(faulted, *TRAIN_ARGS, *RACK, "--kill-at", 4, expect_rc=17)
    assert "KILL step 4" in out
    out = _soak(faulted, *TRAIN_ARGS, *RACK, "--resume")
    assert "resumed at step 4" in out and "SOAK_OK job=train" in out
    with np.load(base / "final.npz") as a, np.load(faulted / "final.npz") as b:
        assert set(a.files) == set(b.files) and len(a.files) > 10
        for k in a.files:
            assert np.array_equal(a[k], b[k]), f"{k} differs"
    ma = json.loads((base / "final.meta.json").read_text())
    mb = json.loads((faulted / "final.meta.json").read_text())
    assert ma["losses"] == mb["losses"]
    assert ma["events"] == [] and mb["events"] != []


# ---------------------------------------------------------------------------
# checkpoint store
# ---------------------------------------------------------------------------

def test_store_roundtrip_and_tensor_like(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": np.ones(4, np.int32)}, "l": [np.zeros(2)]}
    base = str(tmp_path / "ckpt-1")
    store.save(base, tree, meta={"step": 1})
    arrays, meta = store.load_flat(base)
    assert meta == {"step": 1} and sorted(arrays) == ["a", "b/c", "l/#0"]
    back = store.load(base, tree)
    assert isinstance(back["a"], torch.Tensor) and \
        back["a"].device == tree["a"].device
    assert torch.equal(back["a"], tree["a"])
    assert isinstance(back["b"]["c"], np.ndarray)
    with pytest.raises(ValueError, match="shape"):
        store.load(base, {"a": torch.zeros(3, 2), "b": {"c": np.ones(4)},
                          "l": [np.zeros(2)]})
    assert sorted(os.listdir(tmp_path)) == ["ckpt-1.meta.json", "ckpt-1.npz"]


def test_store_reads_reference_artifacts_and_back(tmp_path):
    tree = {"x": np.arange(5, dtype=np.float32), "y": {"z": np.eye(2)}}
    jstore.save(str(tmp_path / "ref"), tree, meta={"by": "reference"})
    arrays, meta = store.load_flat(str(tmp_path / "ref"))
    assert meta == {"by": "reference"}
    np.testing.assert_array_equal(arrays["y/z"], np.eye(2))
    store.save(str(tmp_path / "port"), {"x": torch.arange(5.0),
                                        "y": {"z": np.eye(2)}},
               meta={"by": "port"})
    arrays, meta = jstore.load_flat(str(tmp_path / "port"))
    assert meta == {"by": "port"}
    np.testing.assert_array_equal(arrays["x"], tree["x"])


def test_store_corruption_and_missing(tmp_path):
    base = str(tmp_path / "ckpt-3")
    store.save(base, {"x": np.arange(1000, dtype=np.float64)},
               meta={"step": 3})
    with open(base + ".npz", "r+b") as f:
        f.truncate(os.path.getsize(base + ".npz") // 2)
    with pytest.raises(store.CheckpointError, match="corrupt or truncated"):
        store.load_flat(base)
    with pytest.raises(FileNotFoundError):
        store.load_flat(str(tmp_path / "nope"))
    store.save(base, {"x": np.zeros(2)}, meta={"step": 4})
    with open(base + ".meta.json", "w") as f:
        f.write('{"step": 4')
    with pytest.raises(store.CheckpointError, match="sidecar"):
        store.load_flat(base)


def test_store_crash_mid_save_keeps_previous(tmp_path, monkeypatch):
    base = str(tmp_path / "ckpt-5")
    store.save(base, {"x": np.full(8, 1.0)}, meta={"v": 1})

    def boom(f, **kw):
        f.write(b"partial garbage")
        raise RuntimeError("disk died")

    monkeypatch.setattr(np, "savez", boom)
    with pytest.raises(RuntimeError, match="disk died"):
        store.save(base, {"x": np.full(8, 2.0)}, meta={"v": 2})
    monkeypatch.undo()
    arrays, meta = store.load_flat(base)
    np.testing.assert_array_equal(arrays["x"], np.full(8, 1.0))
    assert meta == {"v": 1}
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


def test_list_latest_and_resume_skips_corrupt(tmp_path):
    from repro_torch.launch.soak import _latest_valid
    for step in (2, 10, 6):
        store.save(str(tmp_path / f"ckpt-{step}"), {"x": np.full(3, step)},
                   meta={"step": step})
    store.save(str(tmp_path / "final"), {"x": np.zeros(1)})
    (tmp_path / "ckpt-bogus.npz").write_bytes(b"junk")
    assert [s for s, _ in store.list_checkpoints(str(tmp_path))] == \
        [10, 6, 2]
    step, base = store.latest_checkpoint(str(tmp_path))
    assert step == 10 and base.endswith("ckpt-10")
    assert store.latest_checkpoint(str(tmp_path / "empty")) is None
    with open(tmp_path / "ckpt-10.npz", "r+b") as f:
        f.truncate(10)
    step, arrays, meta = _latest_valid(str(tmp_path))
    assert step == 6 and meta["step"] == 6
    np.testing.assert_array_equal(arrays["x"], np.full(3, 6))


# ---------------------------------------------------------------------------
# classification, retry, policies
# ---------------------------------------------------------------------------

def test_classify_severities():
    assert classify(8, 2, None).klass == NO_FAULT
    ev = classify(8, 2, {5})
    assert ev.klass == REPLICA_ABSORBED and ev.lost == ()
    ev = classify(8, 2, {1, 5})
    assert ev.klass == GROUP_LOST and ev.lost == (1,) and \
        ev.survivors == (0, 2, 3)
    assert classify(8, 2, {0, 4, 1, 5, 2, 6}).klass == QUORUM_LOST
    assert classify(8, 2, {1, 5, 2, 6}, quorum_frac=0.75).klass == \
        QUORUM_LOST
    with pytest.raises(ValueError):
        classify(8, 2, {8})


@given(st.integers(1, 10), st.integers(1, 3), st.integers(0, 10_000),
       st.floats(0.0, 1.0), st.sampled_from([0.25, 0.5, 1.0]))
@settings(max_examples=80, deadline=None)
def test_classify_matches_reference(m_logical, r, seed, frac, quorum):
    m_phys = m_logical * r
    rng = np.random.RandomState(seed)
    dead = set(rng.choice(m_phys, size=int(round(frac * m_phys)),
                          replace=False).tolist())
    mine = classify(m_phys, r, dead, quorum_frac=quorum, step=3, attempt=1)
    want = jclassify(m_phys, r, dead, quorum_frac=quorum, step=3, attempt=1)
    assert (mine.step, mine.attempt, mine.dead, mine.klass, mine.lost,
            mine.survivors) == (want.step, want.attempt, want.dead,
                                want.klass, want.lost, want.survivors)


def test_retry_backoff_with_injected_clock():
    seen = [{1, 5}, {1, 5}, {5}]
    sleeps = []
    pol = DegradedPolicy(max_retries=3, backoff_s=0.05, backoff_mult=2.0)
    ev, evs = retry_until_alive(lambda a: seen[a], pol, 8, 2,
                                sleep=sleeps.append)
    assert ev.klass == REPLICA_ABSORBED and ev.attempt == 2
    assert [e.klass for e in evs] == [GROUP_LOST, GROUP_LOST,
                                      REPLICA_ABSORBED]
    assert sleeps == [0.05, 0.1]
    sleeps.clear()
    ev, evs = retry_until_alive(lambda a: {1, 5}, pol, 8, 2,
                                sleep=sleeps.append)
    assert ev.klass == GROUP_LOST and ev.attempt == 3 and len(evs) == 4
    assert sleeps == [0.05, 0.1, 0.2]
    ev, evs = retry_until_alive(lambda a: {1, 5},
                                DegradedPolicy(max_retries=0), 8, 2,
                                sleep=lambda s: pytest.fail("slept"))
    assert len(evs) == 1


@pytest.mark.parametrize("kw", [{"mode": "limp"}, {"max_retries": -1},
                                {"backoff_s": -0.1}, {"backoff_mult": 0.5},
                                {"quorum_frac": 0.0},
                                {"quorum_frac": 1.5}])
def test_degraded_policy_validation(kw):
    with pytest.raises(ValueError):
        DegradedPolicy(**kw)


def _lifecycle_sets(m=4, rng_range=200):
    rng = np.random.RandomState(11)
    outs = [np.sort(rng.choice(rng_range, 30, replace=False))
            .astype(np.uint32) for _ in range(m)]
    ins = [np.sort(rng.choice(rng_range, 30, replace=False))
           .astype(np.uint32) for _ in range(m)]
    vals = [(rng.randint(-128, 129, len(o)) / 64.0).astype(np.float32)
            for o in outs]
    return outs, ins, vals


def test_absorbed_repair_shrink_reuse_fail_and_quorum():
    outs, ins, vals = _lifecycle_sets()
    kw = dict(replication=2, policy=DegradedPolicy(max_retries=0), seed=0,
              expected_nnz=30, index_range=200, device="cpu")
    deads = [None, {5}, {5, 6}, {5}]
    ra = ResilientAllreduce(4, (2, 2), probe=lambda s, a: deads[s], **kw)
    ra.config(outs, ins)
    base = ra.reduce(vals, step=0)
    for s in range(1, 4):
        res = ra.reduce(vals, step=s)
        assert not res.degraded and res.event.klass == REPLICA_ABSORBED
        for i in range(4):
            assert np.array_equal(res.values[i], base.values[i])
    assert ra.stats["absorbed"] == 3 and ra.base.config_cache == "repair"
    ra2 = ResilientAllreduce(4, (2, 2),
                             probe=lambda s, a: {1, 5} if s % 2 else None,
                             **kw)
    ra2.config(outs, ins)
    for s in range(4):
        res = ra2.reduce(vals, step=s)
        assert res.degraded == bool(s % 2)
    assert ra2.stats["shrinks"] == 1 and ra2.stats["shrink_reuses"] == 1
    fail = dict(kw, policy=DegradedPolicy(mode="fail", max_retries=0))
    ra3 = ResilientAllreduce(4, (2, 2), dead={1, 5}, **fail)
    ra3.config(outs, ins)
    with pytest.raises(DeadLogicalNode):
        ra3.reduce(vals)
    ra4 = ResilientAllreduce(4, (2, 2), dead={0, 4, 1, 5, 2, 6}, **kw)
    ra4.config(outs, ins)
    with pytest.raises(QuorumLost):
        ra4.reduce(vals)
    assert ra4.stats["quorum_lost"] == 1
    drop = dict(kw, policy=DegradedPolicy(mode="drop_replication",
                                          max_retries=0))
    ra5 = ResilientAllreduce(4, (2, 2), dead={1, 5}, pool=range(10, 18),
                             **drop)
    ra5.config(outs, ins)
    res = ra5.reduce(vals)
    assert res.shrink["replication"] == 1 and \
        res.shrink["nodes"] == (10, 12, 13)
    with pytest.raises(ValueError, match="pool"):
        ResilientAllreduce(4, (2, 2), pool=6, **kw)


def test_auto_degrees_shrink_resolves_through_the_plan_cache(tmp_path):
    """With ``degrees="auto"`` a group-lost shrink takes its survivor
    degrees from ``resolve_degrees(shrunk_from=)`` on the base's plan
    cache (explicit degrees take ``tune``): the first supervisor tunes
    and stores them, a second one on the same root is served them, and
    the two shrinks reduce to the same bits."""
    from repro_torch.core.autotune import (PlanCache, clear_plan_memo,
                                           resolve_degrees)
    from repro_torch.core.replication import replica_groups
    outs, ins, vals = _lifecycle_sets(m=8)
    lost = set(replica_groups(16, 2)[3])
    shrinks = []
    for source in ("tuned", "cache"):
        clear_plan_memo()
        ra = ResilientAllreduce(
            8, "auto", replication=2, probe=lambda s, a: lost if s else None,
            policy=DegradedPolicy(max_retries=0), seed=0, expected_nnz=30,
            index_range=200, device="cpu",
            plan_cache=PlanCache(root=str(tmp_path)))
        ra.config(outs, ins)
        assert not ra.reduce(vals, step=0).degraded
        res = ra.reduce(vals, step=1)
        assert res.degraded and res.shrink["degrees_source"] == source
        shrinks.append(res)
    degrees = shrinks[0].shrink["degrees"]
    assert shrinks[1].shrink["degrees"] == degrees
    assert resolve_degrees(7, n0=30, total_range=200, replication=2,
                           shrunk_from=8,
                           cache=PlanCache(root=str(tmp_path))) == \
        (degrees, "cache")
    for sid in shrinks[0].event.survivors:
        assert np.array_equal(shrinks[0].values[sid], shrinks[1].values[sid])


def test_engine_loop_without_spares():
    from repro_torch.graph.engine import EngineApp
    sets = [np.arange(4, dtype=np.uint32) + 2 * i for i in range(4)]
    app = EngineApp(out_fn=lambda s, e: s, update_fn=lambda s, i, e, t: i)
    sched = make_schedule("rolling", 4, 1)
    loop = SupervisedEngineLoop(sets, sets, app, degrees=(4,),
                                schedule=sched, device="cpu")
    with pytest.raises(QuorumLost, match="repartition"):
        loop.run(2, torch.ones(4, loop.engine.uin_cap))
    with pytest.raises(ValueError, match="pool"):
        SupervisedEngineLoop(sets, sets, app, degrees=(4,), pool=3,
                             device="cpu")
