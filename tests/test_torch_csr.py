"""PyTorch port, PageRank's stacked CSR: held to the ELL layout and to the
JAX package's ``ell_matvec``.

The same numpy COO tables go through ``build_csr`` / ``stack_csr`` /
``csr_matvec`` (the CSR kernel's plain version on CPU tensors), through
the port's ``build_ell`` / ``stack_ell`` / ``ell_matvec`` and through the
reference's jnp ``ell_matvec`` (in process, JAX on the CPU): exact on
dyadic weights and x, where every partial sum is exact, and rtol 1e-6
otherwise (float32 sums in another order).  The cases hold empty rows, a
hub row of thousands of entries, nodes with fewer rows than the stack, and
nnz = 0.  The kernel's work split (``csr_bins``) is checked against the
bounds the CUDA kernel's short path needs, and PageRank's device path,
which now runs on the CSR, against the float64 dense reference.
"""
import numpy as np
import pytest
import torch

from repro.graph.engine import ell_matvec as j_ell_matvec

from repro_torch.data.pipeline import powerlaw_graph
from repro_torch.graph.engine import (build_csr, build_ell, csr_matvec,
                                      ell_matvec, stack_csr, stack_ell)
from repro_torch.graph.pagerank import (LazyTables, build_partitions,
                                        make_pagerank_engine, pagerank,
                                        pagerank_dense_reference,
                                        pagerank_state)
from repro_torch.kernels.spmv_csr import (CSR_BIN_NNZ, CSR_BIN_ROWS,
                                          CSR_LONG, csr_bins, spmv_csr)

# one intra-op thread a test process: pytest-xdist runs several workers
# at once, and their OpenMP threads would oversubscribe the cores
torch.set_num_threads(1)


def _coo(rng, n_rows, n_cols, nnz, hub=0, dyadic=False):
    """COO triplets with rows clustered low (rows >= n_rows // 2 empty but
    for a few), plus ``hub`` entries on row 1."""
    rows = np.minimum(rng.zipf(1.6, nnz) - 1, n_rows - 1)
    rows = np.concatenate([rows, np.ones(hub, np.int64)]).astype(np.int64)
    cols = rng.randint(0, n_cols, len(rows))
    w = (rng.randint(1, 64, len(rows)) / 64.0 if dyadic
         else rng.rand(len(rows)))
    return rows, cols, w


def _nodes(rng, dyadic):
    """Per-node COO of four nodes with 30 columns, stacked at 40 rows:
    node 1 has a 3,000-entry hub row, node 2 no nonzero at all, node 3
    fewer rows than the stack."""
    specs = [(40, 200, 0), (40, 100, 3000), (40, 0, 0), (17, 50, 0)]
    return [(n_rows,) + _coo(rng, n_rows, 30, nnz, hub, dyadic)
            for n_rows, nnz, hub in specs]


def _x(rng, m, n, dyadic):
    if dyadic:
        return (rng.randint(-32, 33, (m, n)) / 32.0).astype(np.float32)
    return rng.randn(m, n).astype(np.float32)


@pytest.mark.parametrize("dyadic", [True, False])
def test_stack_csr_matvec_matches_ell_and_reference(dyadic):
    rng = np.random.RandomState(0 if dyadic else 1)
    nodes = _nodes(rng, dyadic)
    csr = [build_csr(r, c, w, n) for n, r, c, w in nodes]
    ell = [build_ell(r, c, w, n) for n, r, c, w in nodes]
    row_ptr, cols, wts, bins = stack_csr(csr, 40, device="cpu", n_cols=30)
    assert row_ptr.dtype == torch.int32 and int(row_ptr[-1]) == sum(
        len(r) for _, r, _, _ in nodes)
    ec, ew = stack_ell(ell, 40, device="cpu", n_cols=30)
    x = _x(rng, 4, 30, dyadic)
    got = csr_matvec(row_ptr, cols, wts, torch.as_tensor(x), bins)
    want_ell = ell_matvec(ec, ew, torch.as_tensor(x))
    want_ref = np.stack([np.asarray(j_ell_matvec(ec[i].numpy(), ew[i].numpy(),
                                                 x[i])) for i in range(4)])
    assert got.shape == (4, 40)
    if dyadic:
        assert torch.equal(got, want_ell)
        np.testing.assert_array_equal(got.numpy(), want_ref)
    else:
        torch.testing.assert_close(got, want_ell, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), want_ref, rtol=1e-6,
                                   atol=1e-6)
    assert not got[2].any() and not got[3, 17:].any()
    # int64 row offsets give the same product
    assert torch.equal(got, spmv_csr(row_ptr.long(), cols, wts,
                                     torch.as_tensor(x), bins))


def test_build_csr_keeps_build_ell_row_order():
    """Each CSR row holds its ELL row's valid slots, in the same order."""
    rng = np.random.RandomState(2)
    rows, cols, w = _coo(rng, 50, 20, 400, hub=2500)
    rp, c, wt = build_csr(rows, cols, w, 50)
    ec, ew = build_ell(rows, cols, w, 50)
    assert rp.dtype == np.int64 and c.dtype == np.int32
    assert wt.dtype == np.float32 and rp[-1] == len(rows)
    for r in range(50):
        k = rp[r + 1] - rp[r]
        np.testing.assert_array_equal(c[rp[r]:rp[r + 1]], ec[r, :k])
        np.testing.assert_array_equal(wt[rp[r]:rp[r + 1]], ew[r, :k])
        assert (ec[r, k:] == -1).all()
    assert rp[2] - rp[1] >= 2500
    with pytest.raises(ValueError, match=r"\[0, 50\)"):
        build_csr(np.array([50]), np.array([0]), np.array([1.0]), 50)


def test_stack_csr_checks_and_empty():
    rng = np.random.RandomState(3)
    tables = [build_csr(*_coo(rng, 10, 9, 30), 10) for _ in range(3)]
    stack_csr(tables, 10, device="cpu", n_cols=9)
    with pytest.raises(ValueError, match="n_cols 8"):
        stack_csr(tables, 10, device="cpu", n_cols=8)
    with pytest.raises(ValueError, match="rows"):
        stack_csr(tables, 9, device="cpu")
    with pytest.raises(ValueError, match="nonzeros"):
        stack_csr(tables, 10, nnz=5, device="cpu")
    # nnz = 0: every row empty, the product is zero
    empty = [build_csr(np.zeros(0, np.int64), np.zeros(0), np.zeros(0), 6)
             for _ in range(2)]
    row_ptr, cols, wts, bins = stack_csr(empty, 8, device="cpu", n_cols=3)
    assert cols.numel() == 0 and not row_ptr.any()
    assert bins.tolist() == [0, 8, 16]
    y = csr_matvec(row_ptr, cols, wts, torch.ones(2, 3), bins)
    assert y.shape == (2, 8) and not y.any()


@pytest.mark.parametrize("m,n_vertices,n_edges", [(4, 20_000, 200_000),
                                                  (16, 3_000, 60_000)])
def test_csr_bins_fit_the_kernel(m, n_vertices, n_edges):
    """Every bin is either one row longer than CSR_LONG, or at most
    CSR_BIN_ROWS rows of one node with at most CSR_BIN_NNZ nonzeros and
    no row longer than CSR_LONG; the bins tile all rows."""
    edges = powerlaw_graph(n_vertices, n_edges, alpha=2.0, seed=0)
    parts = build_partitions(edges, n_vertices, m)
    n_rows = max(len(p.out_idx) for p in parts) + 5
    row_ptr, _, _, bins = stack_csr(LazyTables(parts), n_rows, device="cpu")
    rp = row_ptr.numpy().astype(np.int64)
    b = bins.numpy().astype(np.int64)
    assert b[0] == 0 and b[-1] == m * n_rows and (np.diff(b) > 0).all()
    assert np.array_equal(b, csr_bins(rp, n_rows))
    lens = np.diff(rp)
    assert lens.max() > CSR_LONG                 # the graph has hub rows
    for r0, r1 in zip(b[:-1], b[1:]):
        if r1 - r0 == 1 and lens[r0] > CSR_LONG:
            continue
        assert r1 - r0 <= CSR_BIN_ROWS
        assert rp[r1] - rp[r0] <= CSR_BIN_NNZ
        assert lens[r0:r1].max() <= CSR_LONG
        assert r0 // n_rows == (r1 - 1) // n_rows


def test_pagerank_state_is_csr_and_matches_dense_reference():
    """The device path's state is the unpadded CSR (as many nonzeros as
    edges), its tables give the ELL tables' product, and PageRank on it
    stays within rtol 1e-4 of the float64 dense reference."""
    n, e = 800, 6000
    edges = powerlaw_graph(n, e, seed=4)
    parts = build_partitions(edges, n, 8)
    engine, extras, p0 = make_pagerank_engine(parts, n, (4, 2), device="cpu")
    assert set(extras) == {"row_ptr", "cols", "wts", "bins"}
    assert extras["cols"].numel() == len(edges)
    ec, ew = stack_ell(LazyTables(parts, "ell"), engine.u_cap, device="cpu")
    torch.testing.assert_close(
        csr_matvec(extras["row_ptr"], extras["cols"], extras["wts"], p0,
                   extras["bins"]),
        ell_matvec(ec, ew, p0), rtol=1e-6, atol=1e-9)
    again, _ = pagerank_state(parts, n, engine.u_cap, engine.uin_cap,
                              device="cpu")
    assert all(torch.equal(again[k], extras[k]) for k in extras)
    got, stats = pagerank(edges, n, m=8, degrees=(4, 2), iters=10,
                          backend="device", device="cpu")
    np.testing.assert_allclose(got, pagerank_dense_reference(edges, n, 10),
                               rtol=1e-4, atol=1e-10)
    assert stats["engine"]["rounds"] == 10
    with pytest.raises(ValueError, match="layout"):
        LazyTables(parts, "coo")
