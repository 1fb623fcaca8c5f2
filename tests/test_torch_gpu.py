"""PyTorch port on the card: each CUDA kernel against its plain version.

Marked ``gpu``; each test decides inside a fixture whether a CUDA device
is present and skips without one (never at import, so every worker
collects the same tests).  The file imports no jax, so it also runs where
only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Ranks and the scatter are compared exactly (the scatter on dyadic values,
plus a second launch bit-identical to the first); the SpMV within rtol
1e-5 (float32 sums in another order).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.onehot_scatter import onehot_scatter_add
from repro_torch.kernels.rank_merge import merge_ranks, rank_counts
from repro_torch.kernels.spmv_ell import spmv_ell

SENT = 0xFFFFFFFF


def _sorted_stream(rng, n, real):
    """Sorted uint32 stream of length n: ``real`` distinct values, then
    SENTINEL padding."""
    out = np.full(n, SENT, np.uint32)
    vals = np.unique(rng.randint(0, 2**32 - 1, 4 * real + 64, dtype=np.uint64))
    out[:real] = np.sort(rng.permutation(vals)[:real])
    return out


@pytest.fixture
def cuda():
    """The CUDA device, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ for sm_90a")
    return torch.device("cuda")


@pytest.mark.gpu
def test_rank_counts_kernel_matches_plain_on_gpu(cuda):
    rng = np.random.RandomState(0)
    for g, k, cap in [(3, 4, 700), (2, 16, 33), (64, 4, 513)]:
        runs = np.stack([np.stack([_sorted_stream(rng, cap,
                                                  rng.randint(0, cap + 1))
                                   for _ in range(k)]) for _ in range(g)])
        x = torch.as_tensor(runs.astype(np.int64), device=cuda)
        assert torch.equal(merge_ranks(x), ref.merge_ranks_ref(x))
        a, b = x[:, 0].contiguous(), x[:, -1].contiguous()
        for strict, side in ((True, "left"), (False, "right")):
            assert torch.equal(rank_counts(a, b, strict=strict),
                               ref.rank_counts_ref(a, b, side))


@pytest.mark.gpu
def test_onehot_scatter_kernel_matches_plain_on_gpu(cuda):
    rng = np.random.RandomState(1)
    for b, c, w, rows in [(2, 1000, 1, 300), (3, 513, 3, 100), (64, 4096, 1, 2048)]:
        pos = torch.as_tensor(rng.randint(-1, rows + 2, (b, c)).astype(np.int32),
                              device=cuda)
        val = torch.as_tensor((rng.randint(-1000, 1000, (b, c, w)) / 1024)
                              .astype(np.float32), device=cuda)
        got = onehot_scatter_add(pos, val, rows)
        assert torch.equal(got, ref.onehot_scatter_add_ref(pos, val, rows))
        assert torch.equal(got, onehot_scatter_add(pos, val, rows))


@pytest.mark.gpu
def test_spmv_ell_kernel_matches_plain_on_gpu(cuda):
    rng = np.random.RandomState(2)
    for b, r, k, n in [(2, 300, 40, 100), (3, 17, 1, 5), (8, 1000, 300, 5000)]:
        cols = torch.as_tensor(rng.randint(-1, n, (b, r, k)).astype(np.int32),
                               device=cuda)
        w = torch.rand(b, r, k, device=cuda)
        x = torch.rand(b, n, device=cuda)
        torch.testing.assert_close(spmv_ell(cols, w, x),
                                   ref.spmv_ell_ref(cols, w, x),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_union_fused_equals_sort_on_gpu(cuda):
    """The fused merge (both kernels) equals the sort path bit for bit on
    the card, on dyadic values, and every node gets the whole union."""
    from repro_torch.core.api import SparseAllreduce
    rng = np.random.RandomState(3)
    m, c = 16, 512
    idx = np.full((m, c), SENT, np.int64)
    val = np.zeros((m, c), np.float32)
    for n in range(m):
        u = np.sort(rng.permutation(np.unique(rng.randint(
            0, 2**32 - 1, c, dtype=np.uint64)))[:c // 2]).astype(np.int64)
        idx[n, : len(u)] = u
        val[n, : len(u)] = rng.randint(-64, 64, len(u)) / 64.0
    out = {}
    for merge in ("sort", "fused"):
        ar = SparseAllreduce(m, (4, 4), backend="device", merge=merge)
        out[merge] = ar.union_reduce(idx, val, m * c)
    assert int(out["fused"][2].sum()) == 0
    for a, b in zip(out["sort"], out["fused"]):
        assert a.device.type == cuda.type and torch.equal(a, b)
    want = np.unique(idx[idx != SENT])
    got = out["fused"][0].cpu().numpy()
    assert np.array_equal(got[:, : len(want)], np.broadcast_to(want, (m, len(want))))


@pytest.mark.gpu
def test_pagerank_runs_on_cuda_by_default(cuda):
    from repro_torch.data.pipeline import powerlaw_graph
    from repro_torch.graph.pagerank import pagerank, pagerank_dense_reference
    edges = powerlaw_graph(2000, 12000, seed=1)
    got, stats = pagerank(edges, 2000, m=8, degrees=(4, 2), iters=10,
                          backend="device")
    np.testing.assert_allclose(got, pagerank_dense_reference(edges, 2000, 10),
                               rtol=1e-4, atol=1e-10)
    assert stats["engine"]["rounds"] == 10
