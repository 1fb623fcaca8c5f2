"""PyTorch port, graph apps: HADI and spectral power iteration on the
stacked-mesh engine held to the JAX package's device engine.

One JAX subprocess per file (8 forced host devices) runs the reference's
``hadi(backend="device")`` and ``power_iteration(backend="device")``; the
port runs the same graphs through its engine on the CPU.  HADI must agree
bit for bit (its 0/1 sums are exact in float32 in any order: bitstrings,
curve, effective diameter, hops run); spectral within 1e-5 relative (both
float32, summed in different orders).  In-process: both apps' sim
backends equal the reference's exactly, the width-W CSR product equals
the reference's ``ell_matvec``, ``SparseChunk.from_dense`` / ``to_dense``
and the whole-mesh sum match.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core.sparse_vec import SparseChunk as JChunk
from repro.graph import hadi as jhadi
from repro.graph import spectral as jspec
from repro.graph.engine import build_ell as j_build_ell
from repro.graph.engine import ell_matvec as j_ell_matvec

from repro_torch.core.sparse_vec import SENTINEL, SparseChunk
from repro_torch.core.topology import ButterflyPlan
from repro_torch.core.transport import StackedTransport
from repro_torch.data.pipeline import powerlaw_graph
from repro_torch.graph import hadi as thadi
from repro_torch.graph import spectral as tspec
from repro_torch.graph.engine import build_csr, csr_matvec_wide, stack_csr

N, E = 500, 3000
CONFIGS = [(4, (4,)), (8, (4, 2))]
SPECTRAL_ITERS = 20
_ENV = dict(os.environ,
            XLA_FLAGS="--xla_force_host_platform_device_count=8",
            PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src")
            + os.pathsep + os.environ.get("PYTHONPATH", ""))

REFERENCE_CODE = r"""
import sys
import numpy as np, jax
from repro.data.pipeline import powerlaw_graph
from repro.graph.hadi import hadi
from repro.graph.spectral import power_iteration

devs = np.array(jax.devices())
edges = powerlaw_graph(%(n)d, %(e)d, seed=1)
out = {}
for m, degs in %(configs)r:
    tag = "x".join(map(str, degs)) + f"_{m}"
    mesh = jax.sharding.Mesh(devs[:m], ("nodes",))
    eff, curve, st = hadi(edges, %(n)d, m=m, degrees=degs, backend="device",
                          mesh=mesh)
    assert st["engine"]["dispatches"] == 1
    out["hadi_b_" + tag] = st["b_final"]
    out["hadi_curve_" + tag] = curve
    out["hadi_eff_" + tag] = np.array(eff)
    out["hadi_hops_" + tag] = np.array(st["hops_run"])
    lam, v, st = power_iteration(edges, %(n)d, m=m, degrees=degs,
                                 iters=%(iters)d, seed=2, backend="device",
                                 mesh=mesh)
    out["spec_lam_" + tag] = np.array(lam)
    out["spec_v_" + tag] = v
np.savez(sys.argv[1], **out)
print("REFERENCE_OK")
""" % {"n": N, "e": E, "configs": CONFIGS, "iters": SPECTRAL_ITERS}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Reference device-engine HADI and spectral results from one 8-device
    JAX subprocess."""
    path = tmp_path_factory.mktemp("ref_graph_apps") / "out.npz"
    r = subprocess.run([sys.executable, "-c", REFERENCE_CODE, str(path)],
                       env=_ENV, capture_output=True, text=True, timeout=560)
    assert r.returncode == 0 and "REFERENCE_OK" in r.stdout, r.stderr[-4000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def graph():
    return powerlaw_graph(N, E, seed=1)


def _tag(m, degs):
    return "x".join(map(str, degs)) + f"_{m}"


@pytest.mark.parametrize("m,degs", CONFIGS)
def test_hadi_device_matches_reference_engine(reference, graph, m, degs):
    """Bitstrings, curve, effective diameter and hops run equal the
    reference's device engine bit for bit; one run, every hop's reduce
    2 * depth exchanges."""
    eff, curve, st = thadi.hadi(graph, N, m=m, degrees=degs,
                                backend="device", device="cpu")
    tag = _tag(m, degs)
    np.testing.assert_array_equal(st["b_final"], reference["hadi_b_" + tag])
    np.testing.assert_array_equal(curve, reference["hadi_curve_" + tag])
    assert eff == int(reference["hadi_eff_" + tag])
    assert st["hops_run"] == int(reference["hadi_hops_" + tag])
    refb = thadi.hadi_bitstring_reference(graph, N,
                                          st["b0"].reshape(N, -1),
                                          st["hops_run"])
    np.testing.assert_array_equal(st["b_final"].reshape(N, -1), refb)
    eng = st["engine"]
    assert (eng["dispatches"], eng["rounds"], eng["step_traces"]) == (1, 16, 1)
    assert eng["reduce_collectives_per_round"] == 2 * len(degs)


@pytest.mark.parametrize("m,degs", CONFIGS)
def test_spectral_device_matches_reference_engine(reference, graph, m, degs):
    """Eigenvalue and eigenvector within 1e-5 relative of the reference's
    device engine, and within the reference test's bounds of the float64
    power iteration; one whole-mesh sum per round."""
    lam, v, st = tspec.power_iteration(graph, N, m=m, degrees=degs,
                                       iters=SPECTRAL_ITERS, seed=2,
                                       backend="device", device="cpu")
    tag = _tag(m, degs)
    want_lam, want_v = float(reference["spec_lam_" + tag]), \
        reference["spec_v_" + tag]
    assert abs(lam - want_lam) <= 1e-5 * want_lam, (lam, want_lam)
    assert np.max(np.abs(v - want_v)) <= 1e-5 * np.max(np.abs(want_v))
    lam_r, v_r = tspec.power_iteration_reference(graph, N,
                                                 iters=SPECTRAL_ITERS, seed=2)
    assert abs(lam - lam_r) / lam_r < 1e-4
    assert abs(v @ v_r) / (np.linalg.norm(v) * np.linalg.norm(v_r)) > 1 - 1e-6
    eng = st["engine"]
    assert (eng["dispatches"], eng["rounds"]) == (1, SPECTRAL_ITERS)


def test_spectral_engine_sums_once_per_round(graph):
    """The normalisation's whole-mesh sum is counted in ``sums``, one per
    round; the reduce keeps exactly ``2 * depth`` exchanges a round."""
    from repro_torch.graph.pagerank import build_partitions
    parts = build_partitions(graph, N, 4)
    e, extras, state0 = tspec.make_spectral_engine(parts, N, (2, 2),
                                                   device="cpu")
    e.run(3, state0, extras)
    assert (e.transport.calls, e.transport.sums) == (3 * 2 * 2, 3)


def test_hadi_sim_matches_reference_sim_exactly(graph):
    got = thadi.hadi(graph, N, m=8, degrees=(4, 2), max_hops=6, trials=2,
                     bits=12)
    want = jhadi.hadi(graph, N, m=8, degrees=(4, 2), max_hops=6, trials=2,
                      bits=12)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    for key in ("b0", "b_final"):
        np.testing.assert_array_equal(got[2][key], want[2][key])
    assert got[2]["hops_run"] == want[2]["hops_run"]


def test_spectral_sim_matches_reference_sim_exactly(graph):
    lam, v, _ = tspec.power_iteration(graph, N, m=4, degrees=(2, 2), iters=8)
    jlam, jv, _ = jspec.power_iteration(graph, N, m=4, degrees=(2, 2),
                                        iters=8)
    assert lam == jlam
    np.testing.assert_array_equal(v, jv)


def test_oracles_match_reference():
    """The float64 oracles (global OR iteration, BFS neighbourhoods, power
    iteration) equal the reference's."""
    edges = powerlaw_graph(60, 200, seed=3)
    b0 = thadi.fm_bitstrings(60, 8, 2, np.random.RandomState(0)).reshape(
        60, -1)
    np.testing.assert_array_equal(
        thadi.hadi_bitstring_reference(edges, 60, b0, 3),
        jhadi.hadi_bitstring_reference(edges, 60, b0, 3))
    np.testing.assert_array_equal(
        thadi.bfs_neighbourhood_reference(edges, 60, 6),
        jhadi.bfs_neighbourhood_reference(edges, 60, 6))
    lam, v = tspec.power_iteration_reference(edges, 60, iters=5, seed=1)
    jlam, jv = jspec.power_iteration_reference(edges, 60, iters=5, seed=1)
    assert lam == jlam
    np.testing.assert_array_equal(v, jv)


@pytest.mark.parametrize("w", [2, 5, 96])
def test_csr_matvec_wide_matches_reference_ell_matvec(w):
    """The width-W product on the stacked CSR equals the reference's W > 1
    ``ell_matvec`` on the same triplets, node by node (rtol 1e-6: both
    float32, summed in different orders); on 0/1 values both are exact
    and equal bit for bit."""
    rng = np.random.RandomState(w)
    m, n_rows, n_cols = 3, 9, 11
    trip = []
    for i in range(m):
        nnz = rng.randint(0, 40)
        trip.append((rng.randint(0, n_rows - i, nnz),
                     rng.randint(0, n_cols, nnz),
                     rng.rand(nnz).astype(np.float32)))
    row_ptr, cols, wts, _ = stack_csr(
        [build_csr(r, c, v, n_rows - i) for i, (r, c, v) in enumerate(trip)],
        n_rows, device="cpu", n_cols=n_cols)
    for bits in (False, True):
        x = rng.rand(m, n_cols, w).astype(np.float32)
        if bits:
            x = (x < 0.5).astype(np.float32)
            wts = torch.ones_like(wts)
        got = csr_matvec_wide(row_ptr, cols, wts, torch.as_tensor(x))
        assert got.shape == (m, n_rows, w)
        for i, (r, c, v) in enumerate(trip):
            ec, ew = j_build_ell(r, c, np.ones_like(v) if bits else v,
                                 n_rows - i)
            want = np.asarray(j_ell_matvec(ec, ew, x[i]))
            if bits:
                np.testing.assert_array_equal(got[i, : n_rows - i].numpy(),
                                              want)
            else:
                np.testing.assert_allclose(got[i, : n_rows - i].numpy(),
                                           want, rtol=1e-6, atol=1e-7)
            assert not got[i, n_rows - i:].any()


@pytest.mark.parametrize("w", [None, 3])
def test_sparse_chunk_from_dense_to_dense_match_reference(w):
    rng = np.random.RandomState(7)
    shape = (40,) if w is None else (40, w)
    dense = rng.randn(*shape).astype(np.float32)
    dense[rng.rand(40) < 0.6] = 0.0
    nz = int(np.count_nonzero(np.abs(dense).reshape(40, -1).sum(-1)))
    for cap in (nz + 5, nz - 3):
        got = SparseChunk.from_dense(torch.as_tensor(dense), cap)
        want = JChunk.from_dense(dense, cap)
        np.testing.assert_array_equal(got.idx.numpy(),
                                      np.asarray(want.idx).astype(np.int64))
        np.testing.assert_array_equal(got.val.numpy(), np.asarray(want.val))
        assert int(got.count()) == min(cap, nz)
        np.testing.assert_array_equal(got.to_dense(40).numpy(),
                                      np.asarray(want.to_dense(40)))
    batched = SparseChunk(
        idx=torch.tensor([[3, 1, SENTINEL], [0, 0, 2]]),
        val=torch.tensor([[1.0, 2.0, 9.0], [1.0, 0.5, 4.0]]))
    np.testing.assert_array_equal(batched.to_dense(4).numpy(),
                                  [[0, 2, 0, 1], [1.5, 0, 4, 0]])


@pytest.mark.parametrize("m,degs", [(8, (4, 2)), (6, (3, 2)), (5, (5,))])
def test_transport_psum_fixed_order(m, degs):
    """The whole-mesh sum equals a numpy pairwise tree in float32 bit for
    bit, reaches every node, repeats identically, and counts in ``sums``,
    not ``calls``."""
    tr = StackedTransport(ButterflyPlan(m, degs), "cpu")
    x = torch.as_tensor(np.random.RandomState(m).randn(m, 3)
                        .astype(np.float32) * 1e4)
    got = tr.psum(x)
    rows = [r for r in x.numpy()]
    while len(rows) > 1:
        rows = [rows[i] + rows[i + 1] for i in range(0, len(rows) - 1, 2)] \
            + rows[len(rows) - len(rows) % 2:]
    np.testing.assert_array_equal(got.numpy(), np.broadcast_to(rows[0],
                                                               (m, 3)))
    assert torch.equal(got, tr.psum(x))
    assert (tr.calls, tr.sums) == (0, 2)
    with pytest.raises(ValueError):
        tr.psum(x[:-1])


def test_apps_default_to_cuda_and_import_no_jax(graph):
    """Without ``device=`` the device backends bind the current CUDA
    device, raising where there is none; the new modules leave jax and the
    reference package unloaded."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            thadi.hadi(graph, N, m=4, degrees=(4,), max_hops=1,
                       backend="device")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tspec.power_iteration(graph, N, m=4, degrees=(4,), iters=1,
                                  backend="device")
    code = ("import sys; import repro_torch.graph.hadi, "
            "repro_torch.graph.spectral, repro_torch.core.faults; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules); print('NOJAX')")
    r = subprocess.run([sys.executable, "-c", code], env=_ENV,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "NOJAX" in r.stdout, r.stderr
