"""PyTorch port, graph layer: PageRank on the stacked-mesh engine held to
the JAX package's device engine.

One JAX subprocess per file (8 forced host devices) runs the reference's
``pagerank(backend="device")``; the port runs the same graph through its
engine on the CPU (plain kernel versions) and must agree within rtol 1e-5
(both float32, summed in different orders).  In-process: the sim
backends agree exactly, the engine keeps the reference's report and
caches, and the ELL helpers match.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.graph.engine import ell_matvec as j_ell_matvec
from repro.graph.engine import stack_ell as j_stack_ell
from repro.graph.pagerank import pagerank as j_pagerank

from repro_torch.data.pipeline import powerlaw_graph
from repro_torch.graph.engine import (EngineApp, GraphEngine, ell_matvec,
                                      stack_ell)
from repro_torch.graph.pagerank import (assemble_pagerank_scores,
                                        build_partitions,
                                        make_pagerank_engine, pagerank,
                                        pagerank_dense_reference)

# one intra-op thread a test process: pytest-xdist runs several workers
# at once, and their OpenMP threads would oversubscribe the cores
torch.set_num_threads(1)

N, E = 500, 3000
CONFIGS = [(8, (4, 2), False), (4, (2, 2), True), (8, (2, 2, 2), False)]
_ENV = dict(os.environ,
            XLA_FLAGS="--xla_force_host_platform_device_count=8",
            PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src")
            + os.pathsep + os.environ.get("PYTHONPATH", ""))

REFERENCE_CODE = r"""
import sys
import numpy as np, jax
from repro.data.pipeline import powerlaw_graph
from repro.graph.pagerank import pagerank

devs = np.array(jax.devices())
edges = powerlaw_graph(%(n)d, %(e)d, seed=1)
out = {}
for m, degs, use_kernel in %(configs)r:
    got, stats = pagerank(edges, %(n)d, m=m, degrees=degs, iters=10,
                          backend="device", use_kernel=use_kernel,
                          mesh=jax.sharding.Mesh(devs[:m], ("nodes",)))
    assert stats["engine"]["dispatches"] == 1
    out["x".join(map(str, degs)) + f"_{m}"] = got
np.savez(sys.argv[1], **out)
print("REFERENCE_OK")
""" % {"n": N, "e": E, "configs": CONFIGS}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Reference device-engine PageRank scores from one 8-device JAX
    subprocess."""
    path = tmp_path_factory.mktemp("ref_graph") / "out.npz"
    r = subprocess.run([sys.executable, "-c", REFERENCE_CODE, str(path)],
                       env=_ENV, capture_output=True, text=True, timeout=560)
    assert r.returncode == 0 and "REFERENCE_OK" in r.stdout, r.stderr[-4000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def graph():
    return powerlaw_graph(N, E, seed=1)


@pytest.mark.parametrize("m,degs,use_kernel", CONFIGS)
def test_pagerank_device_matches_reference_engine(reference, graph, m, degs,
                                                  use_kernel):
    got, stats = pagerank(graph, N, m=m, degrees=degs, iters=10,
                          backend="device", use_kernel=use_kernel,
                          device="cpu")
    np.testing.assert_allclose(got, reference["x".join(map(str, degs))
                                              + f"_{m}"],
                               rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(got, pagerank_dense_reference(graph, N, 10),
                               rtol=1e-4, atol=1e-10)
    eng = stats["engine"]
    assert (eng["dispatches"], eng["rounds"], eng["step_traces"]) == (1, 10, 1)
    assert eng["reduce_collectives_per_round"] == 2 * len(degs)


def test_pagerank_sim_matches_reference_sim_exactly(graph):
    got, st = pagerank(graph, N, m=8, degrees=(4, 2), iters=5)
    want, jst = j_pagerank(graph, N, m=8, degrees=(4, 2), iters=5)
    np.testing.assert_array_equal(got, want)
    assert st["reduce_time_s"] == jst["reduce_time_s"]


def test_engine_runs_cache_and_trajectory(graph):
    """Repeated runs reuse the k-round callable; each run is one host
    round-trip; every round costs 2*depth exchanges; a trajectory stacks
    each round's state and ends at the final state."""
    parts = build_partitions(graph, N, 4)
    engine, extras, p0 = make_pagerank_engine(parts, N, (2, 2), device="cpu")
    tr = engine.transport
    calls = tr.calls
    f1, q1, _ = engine.run(3, p0, extras)
    assert tr.calls - calls == 3 * 2 * 2
    f2, q2, _ = engine.run(3, p0, extras)
    assert torch.equal(f1, f2) and torch.equal(q1, q2)
    # the CPU runs the eager loop: no graph is captured or replayed
    assert engine.report == {"dispatches": 2, "rounds": 6, "step_traces": 1,
                             "graph_launches": 0, "captures": 0}
    final, last, traj = engine.run(3, p0, extras, collect="trajectory")
    assert traj.shape == (3,) + tuple(p0.shape)
    assert torch.equal(traj[-1], final) and torch.equal(final, f1)
    assert engine.sync_report()["host_roundtrips"] == 3
    scores = assemble_pagerank_scores(parts, last, N, 0.85)
    np.testing.assert_allclose(scores, pagerank_dense_reference(graph, N, 3),
                               rtol=1e-4, atol=1e-10)
    with pytest.raises(ValueError):
        engine.run(0, p0, extras)
    with pytest.raises(ValueError):
        engine.run(2, p0, extras, collect="all")


def test_engine_guards():
    app = EngineApp(out_fn=lambda s, e: s, update_fn=lambda s, i, e, t: i)
    sets = [np.arange(4, dtype=np.uint32)] * 2
    # the rotated schedule (overlap=True) is ported: the engine takes it
    # and reports it
    rotated = GraphEngine(sets, sets, app, degrees=(2,), device="cpu",
                          overlap=True)
    assert rotated.sync_report()["overlap"] is True
    # the plan cache (ROADMAP item 10) is ported: the engine takes it,
    # reports the tier its config came from, and serves a second engine
    # on the same pattern from the memo
    first = GraphEngine(sets, sets, app, degrees=(2,), device="cpu",
                        plan_cache=True, nodes=(5, 9))
    assert first.sync_report()["config_cache"] in ("fresh", "memo", "disk")
    again = GraphEngine(sets, sets, app, degrees=(2,), device="cpu",
                        plan_cache=True, nodes=(5, 9))
    assert again.config_cache == "memo" and again.planned is first.planned
    moved = first.remesh((1, 2))
    assert moved.nodes == (1, 2) and moved.ar.plan.degrees == (2,)
    s0 = torch.tensor([[1.0, 2.0, 3.0, 4.0], [5.0, 6.0, 7.0, 8.0]])
    assert torch.equal(moved.run(1, s0)[0], first.run(1, s0)[0])


def test_identity_app_round_trips_values():
    """An app whose outbound values are its state: one round of the
    engine is one planned reduce (sum over the nodes that hold an index)."""
    sets = [np.array([1, 5, 9], np.uint32), np.array([5, 7], np.uint32)]
    app = EngineApp(out_fn=lambda s, e: s, update_fn=lambda s, i, e, t: i)
    engine = GraphEngine(sets, sets, app, degrees=(2,), device="cpu")
    s0 = torch.tensor([[1.0, 2.0, 3.0], [10.0, 20.0, 0.0]])
    final, _, _ = engine.run(1, s0)
    np.testing.assert_array_equal(final.numpy(),
                                  [[1.0, 12.0, 3.0], [12.0, 20.0, 0.0]])


def test_stack_ell_and_ell_matvec_match_reference():
    rng = np.random.RandomState(0)
    tables = [(rng.randint(-1, 9, (r, k)).astype(np.int32),
               rng.rand(r, k).astype(np.float32))
              for r, k in ((5, 3), (7, 1), (2, 4))]
    cols, wts = stack_ell(tables, 8, device="cpu")
    jc, jw = j_stack_ell(tables, 8)
    checked = stack_ell(tables, 8, device="cpu", n_cols=9)
    assert all(torch.equal(a, b) for a, b in zip(checked, (cols, wts)))
    with pytest.raises(ValueError, match="n_cols 8"):
        stack_ell(tables, 8, device="cpu", n_cols=8)
    np.testing.assert_array_equal(cols.numpy(), jc)
    np.testing.assert_array_equal(wts.numpy(), jw)
    x = rng.rand(3, 9).astype(np.float32)
    x2 = rng.rand(3, 9, 2).astype(np.float32)
    for xv in (x, x2):
        got = ell_matvec(cols, wts, torch.as_tensor(xv))
        for i in range(3):
            want = np.asarray(j_ell_matvec(jc[i], jw[i], xv[i]))
            np.testing.assert_allclose(got[i].numpy(), want, rtol=1e-6,
                                       atol=1e-7)
