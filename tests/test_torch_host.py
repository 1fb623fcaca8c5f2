"""PyTorch port, host layer: held to the JAX package on the same inputs.

Topology, tuning, hash permutation, replication, the message-level
simulator, the planned reduce's frozen routing tensors, ELL construction
and the synthetic graph must all equal the reference exactly (they are
numpy copies).  Also the import guard: nothing in ``src/repro_torch`` or
``chip_smoke.py`` imports jax or the reference package, and importing the
port's entry points leaves jax out of ``sys.modules``.
"""
import ast
import os
from dataclasses import asdict
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import replication as jrep
from repro.core import topology as jtop
from repro.core.netmodel import EC2_2013 as JEC2
from repro.core.planned import plan_sparse_allreduce as jplan
from repro.core.allreduce import make_device_plan as jmake_plan
from repro.core.simulator import SimSparseAllreduce as JSim
from repro.core.sparse_vec import HashPerm as JHashPerm
from repro.data.pipeline import powerlaw_graph as jpowerlaw
from repro.data.pipeline import random_edge_partition as jpartition
from repro.graph.engine import build_ell as jbuild_ell

from repro_torch.core import replication as rep
from repro_torch.core import topology as top
from repro_torch.core.allreduce import make_device_plan, shape_bucket
from repro_torch.core.netmodel import EC2_2013, rate_optimal_allreduce_s
from repro_torch.core.planned import plan_sparse_allreduce
from repro_torch.core.simulator import SimSparseAllreduce, dense_oracle
from repro_torch.core.sparse_vec import (HashPerm, merge_add_np,
                                         sort_coalesce_np, tree_sum_np)
from repro_torch.data.pipeline import powerlaw_graph, random_edge_partition
from repro_torch.graph.engine import build_ell

# one intra-op thread a test process: pytest-xdist runs several workers
# at once, and their OpenMP threads would oversubscribe the cores
torch.set_num_threads(1)

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))

PLANS = [(8, (4, 2)), (8, (2, 2, 2)), (8, (8,)), (12, (3, 2, 2)),
         (16, (4, 4)), (6, (2, 3)), (64, (16, 4))]


def _workload(rng, m, r=2000, alpha=1.5, max_n=120):
    out_i, out_v, in_i = [], [], []
    for _ in range(m):
        n = rng.randint(5, max_n)
        out_i.append((rng.zipf(alpha, n) % r).astype(np.uint32))
        out_v.append(rng.randn(n))
        in_i.append(rng.choice(r, rng.randint(5, max_n),
                               replace=False).astype(np.uint32))
    return out_i, out_v, in_i


@pytest.mark.parametrize("m,degs", PLANS)
def test_butterfly_plan_matches_reference(m, degs):
    """Edges at every layer and the stage groups equal the reference's."""
    mine, ref = top.ButterflyPlan(m, degs), jtop.ButterflyPlan(m, degs)
    assert mine.strides() == ref.strides()
    for l in range(mine.depth):
        assert mine.axis_index_groups(l) == ref.axis_index_groups(l)
        np.testing.assert_array_equal(mine.all_edges(l), ref.all_edges(l))
    for n in range(m):
        assert mine.range_at(n, mine.depth) == ref.range_at(n, ref.depth)


@pytest.mark.parametrize("m", [8, 12, 16, 64, 128])
@pytest.mark.parametrize("n0,total", [(1e5, 1e6), (1e3, 1e7)])
def test_tune_picks_match_reference(m, n0, total):
    """``tune`` ranks the same degree sequences with the same times."""
    mine = top.tune(m, n0, total, top=5)
    ref = jtop.tune(m, n0, total, top=5)
    assert [p.degrees for _, p in mine] == [p.degrees for _, p in ref]
    assert [t for t, _ in mine] == [t for t, _ in ref]
    assert top.ordered_factorizations(m) == jtop.ordered_factorizations(m)
    assert top.roundrobin_plan(m).degrees == jtop.roundrobin_plan(m).degrees


def test_binary_plan_and_wire_checks():
    assert top.binary_plan(16).degrees == jtop.binary_plan(16).degrees
    with pytest.raises(ValueError):
        top.binary_plan(12)
    assert top.check_wire("raw") == "raw"
    with pytest.raises(ValueError):
        top.check_wire("zip")


def test_netmodel_matches_reference():
    assert EC2_2013.as_meta() == JEC2.as_meta()
    for nbytes, fan in [(10.0, 1), (4e6, 15), (1e3, 3)]:
        assert EC2_2013.stage_time(nbytes, fan) == JEC2.stage_time(nbytes, fan)
        assert EC2_2013.stage_split(nbytes, fan) == JEC2.stage_split(nbytes, fan)
    assert rate_optimal_allreduce_s(1e6, 64, EC2_2013) > 0


@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
def test_hash_perm_matches_reference(seed):
    """fwd/inv on numpy and on torch int64 equal the reference's uint32."""
    mine, ref = HashPerm.make(seed), JHashPerm.make(seed)
    assert (mine.mult, mine.xor) == (ref.mult, ref.xor)
    x = np.random.RandomState(seed).randint(0, 2**32, 5000,
                                            dtype=np.uint64).astype(np.uint32)
    want = ref.fwd_np(x)
    np.testing.assert_array_equal(mine.fwd_np(x), want)
    got = mine.fwd(torch.as_tensor(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    back = mine.inv(got)
    np.testing.assert_array_equal(back.numpy().astype(np.uint32), x)
    np.testing.assert_array_equal(mine.inv_np(want), x)


def test_host_sparse_helpers_match_reference():
    from repro.core import sparse_vec as jsv
    rng = np.random.RandomState(0)
    parts = [(rng.randint(0, 50, 30).astype(np.uint32), rng.randn(30))
             for _ in range(5)]
    a = sort_coalesce_np(*parts[0])
    b = jsv.sort_coalesce_np(*parts[0])
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(merge_add_np(*parts[0], *parts[1])[1],
                                  jsv.merge_add_np(*parts[0], *parts[1])[1])
    np.testing.assert_array_equal(tree_sum_np(parts)[1],
                                  jsv.tree_sum_np(parts)[1])


def test_replication_matches_reference():
    for m, r, dead in [(8, 2, {1, 6}), (12, 3, {0, 4}), (4, 1, set())]:
        np.testing.assert_array_equal(
            rep.contribution_weights(m, r, dead),
            jrep.contribution_weights(m, r, dead))
        np.testing.assert_array_equal(
            rep.first_alive_replicas(m, r, dead),
            jrep.first_alive_replicas(m, r, dead))
        assert rep.replica_groups(m, r) == jrep.replica_groups(m, r)
    with pytest.raises(rep.DeadLogicalNode):
        rep.contribution_weights(4, 2, {0, 2})
    assert rep.expected_tolerated_failures(64) == \
        jrep.expected_tolerated_failures(64)


@pytest.mark.parametrize("m,degs,r,dead", [(8, (4, 2), 1, set()),
                                           (8, (2, 2, 2), 2, {3, 12}),
                                           (12, (3, 2, 2), 1, set()),
                                           (6, (6,), 3, {0, 7})])
def test_simulator_matches_reference(m, degs, r, dead):
    """Same outputs and the same ReduceStats, replication included."""
    rng = np.random.RandomState(m + len(degs) + r)
    out_i, out_v, in_i = _workload(rng, m)
    perm = HashPerm.make(3)
    mine = SimSparseAllreduce(top.ButterflyPlan(m, degs), replication=r,
                              dead=dead, perm=perm)
    ref = JSim(jtop.ButterflyPlan(m, degs), replication=r, dead=dead,
               perm=JHashPerm.make(3))
    assert asdict(mine.config(out_i, in_i)) == asdict(ref.config(out_i, in_i))
    got, want = mine.reduce(out_v), ref.reduce(out_v)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert asdict(mine.reduce_stats) == asdict(ref.reduce_stats)
    oracle = dense_oracle(out_i, out_v, in_i, perm)
    for g, w in zip(got, oracle):
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("m,degs", [(8, (4, 2)), (8, (2, 2, 2)), (6, (3, 2))])
def test_plan_routing_tensors_match_reference(m, degs):
    """The port's frozen routing equals the reference's byte for byte."""
    rng = np.random.RandomState(11 * m)
    out_i, _, in_i = _workload(rng, m)
    dplan = make_device_plan([("d", m)], {"d": degs}, 128, 1024)
    jd = jmake_plan([("d", m)], {"d": degs}, 128, 1024)
    assert [(s.degree, s.axis_index_groups, s.bucket_capacity,
             s.merged_capacity) for s in dplan.stages] == \
        [(s.degree, s.axis_index_groups, s.bucket_capacity,
          s.merged_capacity) for s in jd.stages]
    mine = plan_sparse_allreduce(dplan, out_i, in_i, perm=HashPerm.make(5))
    ref = jplan(jd, out_i, in_i, perm=JHashPerm.make(5))
    for name in ("user_scatter", "bottom_gather", "bottom_hit", "user_gather"):
        np.testing.assert_array_equal(getattr(mine, name), getattr(ref, name))
    assert (mine.sorted_size, mine.in_user_len) == \
        (ref.sorted_size, ref.in_user_len)
    for a, b in zip(mine.layers, ref.layers):
        for name in ("send_gather", "merge_scatter", "up_send_gather",
                     "up_recv_scatter", "merged_size", "up_size"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


@pytest.mark.parametrize("n_rows,n_edges", [(1, 1), (7, 40), (64, 500), (5, 0)])
def test_build_ell_matches_reference(n_rows, n_edges):
    rng = np.random.RandomState(n_rows * 1000 + n_edges)
    rows = rng.randint(0, n_rows, n_edges)
    cols = rng.randint(0, 50, n_edges)
    wts = rng.randn(n_edges).astype(np.float32)
    for got, want in zip(build_ell(rows, cols, wts, n_rows),
                         jbuild_ell(rows, cols, wts, n_rows)):
        np.testing.assert_array_equal(got, want)


def test_powerlaw_graph_and_partition_match_reference():
    edges = powerlaw_graph(1000, 5000, alpha=2.0, seed=4)
    np.testing.assert_array_equal(edges, jpowerlaw(1000, 5000, alpha=2.0,
                                                   seed=4))
    for a, b in zip(random_edge_partition(edges, 8, seed=2),
                    jpartition(edges, 8, seed=2)):
        np.testing.assert_array_equal(a, b)


def test_shape_bucket():
    assert [shape_bucket(n) for n in (0, 8, 9, 1000)] == [8, 8, 16, 1024]
    with pytest.raises(ValueError):
        shape_bucket(-1)


# ---------------------------------------------------------------------------
# import guard
# ---------------------------------------------------------------------------

def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return files


def _forbidden(name: str) -> bool:
    top_name = name.split(".")[0]
    return top_name in ("jax", "jaxlib", "repro")


def test_port_imports_no_jax_nor_reference():
    """No module of the port, nor chip_smoke.py, imports jax, jaxlib or
    the reference package ``repro``."""
    files = _port_files()
    assert len(files) >= 18, files
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                bad += [(path, a.name) for a in node.names
                        if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                if _forbidden(node.module or ""):
                    bad.append((path, node.module))
    assert not bad, bad


def test_port_import_leaves_jax_unloaded():
    code = ("import sys; import repro_torch.core.api, "
            "repro_torch.graph.pagerank, repro_torch.kernels.ops, "
            "repro_torch.core.autotune, repro_torch.kernels.costmodel, "
            "repro_torch.checkpoint.store, repro_torch.resilience, "
            "repro_torch.launch.soak; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules); print('NOJAX')")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "NOJAX" in r.stdout, r.stderr


def test_device_entry_points_default_to_cuda():
    """Without ``device=`` the device backend binds the current CUDA
    device, and raises where there is none -- never a silent CPU run."""
    from repro_torch.core.api import SparseAllreduce
    from repro_torch.core.transport import resolve_device
    rng = np.random.RandomState(0)
    out_i, _, in_i = _workload(rng, 8)
    ar = SparseAllreduce(8, (4, 2), backend="device")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ar.config(out_i, in_i)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device()
    assert resolve_device("cpu").type == "cpu"
