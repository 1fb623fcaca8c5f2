"""PyTorch port, r-way replication with failures (paper §V) on both reduce
paths, held to the JAX package's device backend.

One JAX subprocess per file (16 forced host devices, as in
tests/test_fault_tolerance.py) runs the reference's replicated
``SparseAllreduce(backend="device", replication=r, dead=...)`` planned
``reduce`` and ``union_reduce`` (``merge="sort"``; the reference holds
its three merges equal bit for bit) over degrees (4,), (2, 2), (4, 2), r
in {1, 2} and the reference sweep's dead sets.  The port runs the same
inputs on its CPU stacked mesh -- the planned path, and the union path
under all three merges -- and must equal the reference, its own
unreplicated run and the simulator bit for bit (dyadic values).
In-process: ``DeadLogicalNode`` on both paths, ``reconfig_dead``, the
failure schedules, the replication helpers and a replicated reference
plan-cache artifact.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import faults as jfaults
from repro.core import replication as jrep
from repro.core.allreduce import make_device_plan as jmake_plan
from repro.core.autotune import planned_to_artifact
from repro.core.planned import plan_sparse_allreduce as jplan
from repro.core.sparse_vec import HashPerm as JHashPerm

from repro_torch.core import faults, replication as rep
from repro_torch.core.allreduce import make_device_plan, run_union_allreduce
from repro_torch.core.api import SparseAllreduce
from repro_torch.core.planned import (plan_sparse_allreduce,
                                      planned_from_reference)
from repro_torch.core.replication import DeadLogicalNode, replica_groups
from repro_torch.core.simulator import SimSparseAllreduce
from repro_torch.core.sparse_vec import HashPerm
from repro_torch.core.topology import ButterflyPlan

# one intra-op thread a test process: pytest-xdist runs several workers
# at once, and their OpenMP threads would oversubscribe the cores
torch.set_num_threads(1)

DEGREES = [(4,), (2, 2), (4, 2)]
R_IDX, C = 400, 24
_ENV = dict(os.environ,
            XLA_FLAGS="--xla_force_host_platform_device_count=16",
            PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src")
            + os.pathsep + os.environ.get("PYTHONPATH", ""))

# the reference sweep's inputs and dead sets (tests/test_fault_tolerance.py)
PRELUDE = r"""
import numpy as np

def survivable(m_phys, r, dead):
    return all(any(d not in dead for d in g)
               for g in replica_groups(m_phys, r))

def dead_sets(m_phys, r, seed):
    out = [set()]
    if r > 1:
        sched = make_schedule("random", m_phys, 1, seed=seed)
        out += [d for d in sched.steps(4) if survivable(m_phys, r, d)][:2]
        out.append(set(replica_groups(m_phys, r)[0][: r - 1]))
    return out

def workload(M, seed, R_IDX=%(r_idx)d, C=%(c)d):
    rng = np.random.RandomState(seed)
    out_idx = [rng.choice(R_IDX, rng.randint(8, 24),
                          replace=False).astype(np.uint32) for _ in range(M)]
    out_val = [(rng.randint(-128, 129, len(o)) / 64.0).astype(np.float32)
               for o in out_idx]
    rng = np.random.RandomState(M + 1)
    in_idx = [rng.choice(R_IDX, rng.randint(5, 16),
                         replace=False).astype(np.uint32) for _ in range(M)]
    perm = HashPerm.make(M)
    idx = np.full((M, C), 0xFFFFFFFF, np.uint32)
    val = np.zeros((M, C), np.float32)
    for n in range(M):
        h = perm.fwd_np(out_idx[n]); o = np.argsort(h)
        idx[n, :len(h)] = h[o]; val[n, :len(h)] = out_val[n][o]
    return out_idx, out_val, in_idx, idx, val
""" % {"r_idx": R_IDX, "c": C}

REFERENCE_CODE = r"""
import sys
import jax
from repro.core.api import SparseAllreduce
from repro.core.faults import make_schedule
from repro.core.replication import replica_groups
from repro.core.sparse_vec import HashPerm
""" + PRELUDE + r"""
DEVS = np.array(jax.devices())
C = %(c)d
out = {}
for degs in %(degrees)r:
    M = int(np.prod(degs))
    tag = "x".join(map(str, degs))
    out_idx, out_val, in_idx, idx, val = workload(M, seed=M)
    for r in (1, 2):
        mesh = jax.sharding.Mesh(DEVS[:M * r], ("nodes",))
        for j, dead in enumerate(dead_sets(M * r, r, seed=M)):
            key = f"{tag}_r{r}_d{j}"
            out["dead_" + key] = np.array(sorted(dead), np.int64)
            ar = SparseAllreduce(M, degs, backend="device", replication=r,
                                 dead=dead or None, mesh=mesh, seed=M,
                                 plan_cache=False)
            ar.config(out_idx, in_idx)
            for n, g in enumerate(ar.reduce(out_val)):
                out[f"p_{key}_n{n}"] = g
            oi, ov, ovf = ar.union_reduce(idx, val, out_capacity=M * C)
            assert int(np.asarray(ovf).sum()) == 0
            out["ui_" + key] = np.asarray(oi)
            out["uv_" + key] = np.asarray(ov)
np.savez(sys.argv[1], **out)
print("REFERENCE_OK")
""" % {"degrees": DEGREES, "c": C}

_NS = {"make_schedule": faults.make_schedule, "replica_groups": replica_groups,
       "HashPerm": HashPerm}
exec(PRELUDE, _NS)
dead_sets, workload = _NS["dead_sets"], _NS["workload"]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Reference replicated device reduces from one 16-device JAX
    subprocess."""
    path = tmp_path_factory.mktemp("ref_replication") / "out.npz"
    r = subprocess.run([sys.executable, "-c", REFERENCE_CODE, str(path)],
                       env=_ENV, capture_output=True, text=True, timeout=560)
    assert r.returncode == 0 and "REFERENCE_OK" in r.stdout, r.stderr[-4000:]
    return dict(np.load(path))


def _cases(degs):
    m = int(np.prod(degs))
    tag = "x".join(map(str, degs))
    for r in (1, 2):
        for j, dead in enumerate(dead_sets(m * r, r, seed=m)):
            yield r, dead, f"{tag}_r{r}_d{j}"


@pytest.mark.parametrize("degs", DEGREES)
def test_planned_replicated_matches_reference(reference, degs):
    """Replicated planned config/reduce on the port's device backend ==
    the reference's device backend == the port's unreplicated reduce ==
    the simulator, bit for bit, under the reference sweep's dead sets
    (which the port's schedules reproduce)."""
    m = int(np.prod(degs))
    out_idx, out_val, in_idx, _, _ = workload(m, seed=m)
    base = SparseAllreduce(m, degs, backend="device", device="cpu", seed=m)
    base.config(out_idx, in_idx)
    want = base.reduce(out_val)
    for r, dead, key in _cases(degs):
        assert sorted(dead) == reference["dead_" + key].tolist()
        ar = SparseAllreduce(m, degs, backend="device", replication=r,
                             dead=dead or None, device="cpu", seed=m)
        ar.config(out_idx, in_idx)
        assert ar.num_physical == m * r
        got = ar.reduce(out_val)
        sim = SimSparseAllreduce(ButterflyPlan(m, degs), replication=r,
                                 dead=dead or None, perm=HashPerm.make(m))
        sim.config(out_idx, in_idx)
        for n, (g, s) in enumerate(zip(got, sim.reduce(out_val))):
            np.testing.assert_array_equal(g, reference[f"p_{key}_n{n}"],
                                          err_msg=key)
            np.testing.assert_array_equal(g, want[n], err_msg=key)
            np.testing.assert_array_equal(g, np.asarray(s, np.float32),
                                          err_msg=key)
        assert ar.staging_metadata()["first_alive"] == list(
            rep.first_alive_replicas(m * r, r, dead))


@pytest.mark.parametrize("merge", ["sort", "fused", "banded"])
@pytest.mark.parametrize("degs", DEGREES)
def test_union_replicated_matches_reference(reference, degs, merge):
    """Replicated union reduce under each merge == the reference's device
    union reduce == the port's unreplicated run of the same merge, indices
    and values bit for bit, every node, no overflow."""
    m = int(np.prod(degs))
    _, _, _, idx, val = workload(m, seed=m)
    base = SparseAllreduce(m, degs, backend="device", device="cpu", seed=m,
                           merge=merge)
    bi, bv, _ = base.union_reduce(idx, val, m * C)
    for r, dead, key in _cases(degs):
        ar = SparseAllreduce(m, degs, backend="device", replication=r,
                             dead=dead or None, device="cpu", seed=m,
                             merge=merge)
        oi, ov, ovf = ar.union_reduce(idx, val, m * C)
        assert oi.shape == (m, m * C) and int(ovf.sum()) == 0, key
        np.testing.assert_array_equal(oi.numpy(), reference["ui_" + key]
                                      .astype(np.int64), err_msg=key)
        np.testing.assert_array_equal(ov.numpy(), reference["uv_" + key],
                                      err_msg=key)
        assert torch.equal(oi, bi) and torch.equal(ov, bv), key


@pytest.mark.parametrize("merge", ["sort", "fused", "banded"])
def test_int8_wire_replicated_keeps_zero_row_guard(merge):
    """Under ``delta+int8ef`` the zero-weighted replicas' rows quantize
    to zeros (the codec's scale guard), so the replicated union keeps the
    unreplicated one's indices and stays within the wire's bound of the
    exact sum; ``delta`` stays bit-identical."""
    m, degs = 8, (4, 2)
    _, _, _, idx, val = workload(m, seed=m)
    exact = SparseAllreduce(m, degs, backend="device", device="cpu",
                            merge=merge).union_reduce(idx, val, m * C)
    amax = float(exact[1].abs().max())
    for wire in ("delta", "delta+int8ef"):
        ar = SparseAllreduce(m, degs, backend="device", replication=2,
                             dead={3, 8}, device="cpu", merge=merge,
                             wire=wire)
        oi, ov, ovf = ar.union_reduce(idx, val, m * C)
        assert torch.equal(oi, exact[0]) and int(ovf.sum()) == 0
        err = float((ov - exact[1]).abs().max())
        assert err == 0.0 if wire == "delta" else err <= 0.05 * amax, err


def test_dead_group_raises_on_both_paths():
    """A dead set covering a whole replica group raises DeadLogicalNode on
    the planned config, the union reduce and their lower layers; with r =
    1 any dead node raises; out-of-range ids raise ValueError."""
    m, degs = 4, (2, 2)
    out_idx, _, in_idx, idx, val = workload(m, seed=m)
    lost = set(replica_groups(2 * m, 2)[1])
    ar = SparseAllreduce(m, degs, backend="device", replication=2, dead=lost,
                         device="cpu")
    with pytest.raises(DeadLogicalNode):
        ar.config(out_idx, in_idx)
    with pytest.raises(DeadLogicalNode):
        ar.union_reduce(idx, val, m * C)
    with pytest.raises(DeadLogicalNode):
        SparseAllreduce(m, degs, backend="device", dead={2},
                        device="cpu").config(out_idx, in_idx)
    dplan = make_device_plan([("n", 2 * m)], {"n": degs}, 32, 64,
                             replication=2)
    with pytest.raises(DeadLogicalNode):
        plan_sparse_allreduce(dplan, out_idx, in_idx, dead=lost)
    with pytest.raises(DeadLogicalNode):
        run_union_allreduce(dplan, torch.as_tensor(np.tile(idx, (2, 1))
                                                   .astype(np.int64)),
                            torch.as_tensor(np.tile(val, (2, 1))), dead=lost)
    planned = plan_sparse_allreduce(dplan, out_idx, in_idx)
    with pytest.raises(DeadLogicalNode):
        planned.with_dead(lost)
    with pytest.raises(ValueError):
        planned.with_dead({2 * m})
    with pytest.raises(ValueError, match="logical index lists"):
        plan_sparse_allreduce(dplan, out_idx * 2, in_idx * 2)


def test_reconfig_dead_swaps_weights_and_caches():
    """``reconfig_dead`` gives the fresh config's bits for the new dead
    set without a replan, reads ``config_cache == "repair"``, reuses its
    repaired plan per dead set, and on a lost group raises before any
    state changes."""
    from repro_torch.core import autotune
    m, degs = 8, (4, 2)
    out_idx, out_val, in_idx, _, _ = workload(m, seed=m)
    d1, d2 = {1, 10}, {0, 13}
    # a first config of this pattern: no memo entry, no disk entry
    autotune.clear_plan_memo()
    ar = SparseAllreduce(m, degs, backend="device", replication=2, dead=d1,
                         device="cpu", seed=m, plan_cache=False)
    ar.config(out_idx, in_idx)
    assert ar.config_cache == "fresh"
    first = ar.reduce(out_val)
    planned1 = ar.planned_parts()[0]
    ar.reconfig_dead(d2)
    assert ar.config_cache == "repair" and ar.dead == d2
    planned2 = ar.planned_parts()[0]
    assert planned2 is not planned1
    assert planned2.user_scatter is planned1.user_scatter   # no replan
    fresh = SparseAllreduce(m, degs, backend="device", replication=2,
                            dead=d2, device="cpu", seed=m)
    fresh.config(out_idx, in_idx)
    for a, b, c in zip(ar.reduce(out_val), fresh.reduce(out_val), first):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert ar.staging_metadata()["first_alive"] == \
        fresh.staging_metadata()["first_alive"]
    with pytest.raises(DeadLogicalNode):
        ar.reconfig_dead(set(replica_groups(2 * m, 2)[3]))
    assert ar.dead == d2 and ar.planned_parts()[0] is planned2
    ar.reconfig_dead(d1)
    ar.reconfig_dead(d2)
    assert ar.planned_parts()[0] is planned2                 # cached
    with pytest.raises(ValueError):
        SparseAllreduce(m, degs).reconfig_dead(d1)


@pytest.mark.parametrize("kind", ["random", "rack", "rolling", "cascade"])
def test_fault_schedules_match_reference(kind):
    for m_phys, f, seed in ((16, 3, 0), (128, 8, 0), (24, 5, 7)):
        mine = faults.make_schedule(kind, m_phys, f, seed=seed, rack_size=4)
        ref = jfaults.make_schedule(kind, m_phys, f, seed=seed, rack_size=4)
        assert list(mine.steps(6)) == list(ref.steps(6))
    assert faults.completion_probability(16, 2, 4, trials=50, kind=kind) == \
        jfaults.completion_probability(16, 2, 4, trials=50, kind=kind)
    with pytest.raises(ValueError):
        faults.make_schedule(kind, 8, 9)


def test_replication_helpers_match_reference():
    for m_phys, r, dead in ((8, 2, {1, 5}), (12, 3, {0, 4, 8, 1}),
                            (4, 1, {2}), (6, 2, set())):
        assert rep.lost_logical_shards(m_phys, r, dead) == \
            jrep.lost_logical_shards(m_phys, r, dead)
        assert rep.surviving_logical_shards(m_phys, r, dead) == \
            jrep.surviving_logical_shards(m_phys, r, dead)
    with pytest.raises(ValueError):
        rep.lost_logical_shards(4, 2, {4})
    assert rep.simulate_random_failures(16, 2, 5, trials=40, seed=3) == \
        jrep.simulate_random_failures(16, 2, 5, trials=40, seed=3)
    for args in ((32, 2, 8), (32, 1, 1), (16, 3, 2)):
        assert faults.analytic_completion_probability(*args) == \
            jfaults.analytic_completion_probability(*args)


def test_device_plan_replica_groups():
    """Stage 0 of a replicated plan is the replica merge: its groups are
    the replica groups, and the physical node ids are ``i + j * M``."""
    dplan = make_device_plan([("n", 16)], {"n": (4, 2)}, 32, 64,
                             replication=2)
    assert dplan.num_logical == 8 and dplan.logical.degrees == (2, 4, 2)
    groups = [list(g) for g in dplan.stages[0].axis_index_groups]
    assert sorted(groups) == sorted(dplan.replica_groups())
    assert dplan.replica_groups() == replica_groups(16, 2)


def test_planned_from_reference_loads_replicated_artifact():
    """A replicated reference plan with a dead set, carried over through
    its plan-cache artifact, keeps its weights and reduces like the
    port's own plan."""
    m, degs = 4, (2, 2)
    out_idx, out_val, in_idx, _, _ = workload(m, seed=m)
    dead = {1}
    jdplan = jmake_plan([("d", 2 * m)], {"d": degs}, 32, 64, replication=2)
    arrays, meta = planned_to_artifact(jplan(
        jdplan, out_idx, in_idx, perm=JHashPerm.make(5), dead=dead))
    assert "weights" in arrays
    got = planned_from_reference(arrays, meta, {"d": degs}, device="cpu")
    mine = plan_sparse_allreduce(
        make_device_plan([("d", 2 * m)], {"d": degs}, 32, 64, replication=2),
        out_idx, in_idx, perm=HashPerm.make(5), dead=dead)
    np.testing.assert_array_equal(got.weights, mine.weights)
    assert got.dplan.replication == 2
    vals = np.zeros((2 * m, mine.u_cap), np.float32)
    for n, v in enumerate(out_val * 2):
        vals[n, : len(v)] = v
    assert torch.equal(got.make_reduce_fn("cpu")(vals),
                       mine.make_reduce_fn("cpu")(vals))
    assert not (mine.with_dead({2}).weights == mine.weights).all()
