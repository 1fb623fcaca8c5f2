"""PyTorch port on the card: each CUDA kernel against its plain version.

Marked ``gpu``; each test decides inside a fixture whether a CUDA device
is present and skips without one (never at import, so every worker
collects the same tests).  The file imports no jax, so it also runs where
only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Ranks are compared exactly (dense and banded kernels); the scatters
bit for bit on dyadic values and dyadic scales, plus a second launch
bit-identical to the first, and within rtol 1e-6 of the plain version
where a general scale is applied (the plain version's ``index_add_`` sums
with atomics on the card); the dense scatter also bit for bit against its
plain version run on a CPU copy (which sums in source order, the kernel's
order) on general floats, and its counting layout (``row_order``) exactly
against a stable argsort; the banded scatter the same way on the window
table's adversarial cases, and its table (``banded_windows``) exactly
against ``searchsorted``; the SpMVs within rtol 1e-5 (float32 sums in
another order), the CSR kernel also bit-identical across two launches.
The training stack: a reduced train step through the merge kernels
repeated on the card gives the same bits (and the CPU run's losses
within rtol 1e-4), for the dense, MoE, SSM, encoder-decoder and FSDP
VLM models alike, and with a model axis (reduced qwen at 2 x 2); the MoE and
SSM blocks on the card equal their CPU run within rtol 1e-4; and both
scatters at the training width (w = 1,024) equal their plain versions
on a CPU copy bit for bit.  The graph engine's ``run`` replays one CUDA
graph: bit for bit its eager loop (plain and rotated, PageRank, HADI and
spectral), the kernels a profiler trace of n replays holds are n times
those its capture enqueued, and a replay calls no kernel wrapper;
the bucketed sync and the pod mesh equal their plain counterparts bit
for bit on the card; the query-chunked attention at T = 8,192 is within
bfloat16 rounding of the unchunked one.  Serving: continuous batching
equals the sequential oracle on the card (dense, tp = 2, MoE at 2 x 2,
xLSTM, jamba), the prefill and decode steps equal their CPU run within
rtol 1e-4 and repeat bit for bit, the dispatch's tail unions launch the
merge kernels, and the serve launcher takes the card by default.  The
decode layouts: split-KV equals the one-position batch-sharded decode
and serve2d the gather decode on the card, each as its CPU run; the
audit sweep is clean on the card (one graph replay an engine run, no
host read or DtoH copy in the greedy steps).  The spans
(``repro_torch.obs``): an engine captured and replayed under the
profiler, each run one ``engine.run`` span with device time, no event
recorded inside a capture; and the union reduce's kernel launches
inside its span on the device trace's clock.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.graph.engine import GraphEngine
from repro_torch.kernels import _build, ref
from repro_torch.kernels.onehot_scatter import (BANDED_ROWS,
                                                banded_onehot_scatter_add,
                                                banded_windows,
                                                onehot_scatter_add, row_order)
from repro_torch.kernels.rank_merge import merge_ranks, rank_counts
from repro_torch.kernels.spmv_csr import spmv_csr
from repro_torch.kernels.spmv_ell import spmv_ell

# one intra-op thread a test process: pytest-xdist runs several workers
# at once, and their OpenMP threads would oversubscribe the cores
torch.set_num_threads(1)

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
    _build.reset_launches()
    got, stats = pagerank(edges, 2000, m=8, degrees=(4, 2), iters=10,
                          backend="device")
    np.testing.assert_allclose(got, pagerank_dense_reference(edges, 2000, 10),
                               rtol=1e-4, atol=1e-10)
    assert stats["engine"]["rounds"] == 10
    assert stats["engine"]["graph_launches"] == 1
    # the capture's warm-up round, then the 10 rounds enqueued into the
    # graph (its replay calls no wrapper)
    assert _build.LAUNCHES["spmv_csr"] == 10 + GraphEngine.WARMUP_ROUNDS
    assert _build.LAUNCHES["spmv_ell"] == 0


def _random_stacked_csr(rng, m, n_rows, n, hub):
    """Per-node COO with empty rows, one hub row of ``hub`` entries and
    power-law-ish short rows, stacked by ``stack_csr`` on the CPU."""
    from repro_torch.graph.engine import build_csr, stack_csr
    tables = []
    for i in range(m):
        rows = np.minimum(rng.zipf(1.8, 40 * n_rows) - 1, n_rows - 1)
        rows = rows[rows % 7 != 3]                  # empty rows
        rows = np.concatenate([rows, np.full(hub if i % 2 else 0, 5)])
        cols = rng.randint(0, n, len(rows))
        tables.append(build_csr(rows, cols, rng.rand(len(rows)), n_rows))
    return stack_csr(tables, n_rows, device="cpu", n_cols=n)


@pytest.mark.gpu
def test_spmv_csr_kernel_matches_plain_on_gpu(cuda):
    """Short bins, hub rows (own bins, block-wide sums), empty rows, nodes
    of different sizes; int32 and int64 row offsets; repeat identical.
    Held to a float64 oracle, and to the plain version where hub rows stay
    within 3,000 entries (the plain version's sequential f32 sum of a
    20,000-entry row is itself ~1e-5 off)."""
    rng = np.random.RandomState(7)
    for m, n_rows, n, hub in [(3, 500, 97, 3000), (8, 4000, 5000, 20000),
                              (64, 257, 300, 700)]:
        rp, cols, wts, bins = (t.to(cuda) for t in
                               _random_stacked_csr(rng, m, n_rows, n, hub))
        x = torch.rand(m, n, device=cuda)
        plain = ref.spmv_csr_ref(rp, cols, wts, x)
        rows = np.repeat(np.arange(m * n_rows), np.diff(rp.cpu().numpy()))
        exact = np.zeros(m * n_rows)
        np.add.at(exact, rows, wts.cpu().double().numpy() * x.cpu().double()
                  .numpy().reshape(-1)[(rows // n_rows) * n
                                       + cols.cpu().numpy()])
        exact = torch.as_tensor(exact.reshape(m, n_rows), dtype=torch.float32)
        for row_ptr in (rp, rp.to(torch.int64)):
            got = spmv_csr(row_ptr, cols, wts, x, bins)
            torch.testing.assert_close(got.cpu(), exact, rtol=1e-5, atol=1e-6)
            if hub <= 3000:
                torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-6)
            assert torch.equal(got, spmv_csr(row_ptr, cols, wts, x, bins))
    empty = torch.zeros(4 * 10 + 1, dtype=torch.int32, device=cuda)
    nothing = torch.zeros(0, dtype=torch.int32, device=cuda)
    got = spmv_csr(empty, nothing, nothing.float(), torch.rand(4, 3,
                                                               device=cuda),
                   torch.as_tensor([0, 10, 20, 30, 40], dtype=torch.int32,
                                   device=cuda))
    assert got.shape == (4, 10) and not got.any()


def _general_values(rng, shape, dtype, cuda):
    """(values, scale or None) of general floats: f32 / bf16 normals, or
    int8 with a uniform (0, 1) scale."""
    if dtype == torch.int8:
        q = torch.as_tensor(rng.randint(-127, 128, shape).astype(np.int8),
                            device=cuda)
        s = torch.as_tensor(rng.rand(*shape[:-1]).astype(np.float32),
                            device=cuda)
        return q, s
    return torch.as_tensor(rng.randn(*shape).astype(np.float32),
                           device=cuda).to(dtype), None


def _check_dense_scatter(pos, val, rows, scale):
    """The dense scatter equals its plain version on a CPU copy bit for
    bit, twice; its layout equals the stable argsort exactly, counted as
    one ``row_order`` launch."""
    got = onehot_scatter_add(pos, val, rows, scale=scale)
    want = ref.onehot_scatter_add_ref(
        pos.cpu(), val.cpu(), rows, None if scale is None else scale.cpu())
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, onehot_scatter_add(pos, val, rows, scale=scale))
    before = dict(_build.LAUNCHES)
    perm, off = row_order(pos, rows)
    wperm, woff = ref.row_order_ref(pos.cpu(), rows)
    assert torch.equal(perm.cpu(), wperm) and torch.equal(off.cpu(), woff)
    assert {k: v - before[k] for k, v in _build.LAUNCHES.items()
            if v != before[k]} == {"row_order": 1}


@pytest.mark.gpu
def test_onehot_scatter_counting_layout_on_gpu(cuda):
    """Adversarial inputs of the counting layout: every source to one row,
    C not a multiple of the 2,048-source tile, batch 64, rows needing one
    to four digit passes, drop bins; f32, bf16 and int8 + scale on general
    floats."""
    rng = np.random.RandomState(8)
    cases = [(2, 5000, 1, "one"), (3, 4097, 300, "one"),
             (64, 3000, 2500, "random"), (2, 2048, 70000, "random"),
             (1, 9000, 2**24 + 5, "random"), (2, 1000, 64, "dropped"),
             (2, 0, 10, "random")]
    for b, c, rows, kind in cases:
        if kind == "one":
            pos = np.full((b, c), rows // 2)
        elif kind == "dropped":
            pos = rng.choice([-1, rows], (b, c))
        else:
            pos = rng.randint(-1, rows + 2, (b, c))
        pos = torch.as_tensor(pos.astype(np.int32), device=cuda)
        for dtype in (torch.float32, torch.bfloat16, torch.int8):
            val, scale = _general_values(rng, (b, c, 2), dtype, cuda)
            _check_dense_scatter(pos, val, rows, scale)


@pytest.mark.gpu
def test_onehot_scatter_on_fused_merge_positions_on_gpu(cuda, monkeypatch):
    """The dense scatter on the positions a real fused merge hands it
    (k runs of hashed indices, ranks gathered through the compaction)."""
    from repro_torch.kernels import ops
    rng = np.random.RandomState(9)
    g, k, cap = 4, 8, 1500
    runs = np.stack([np.stack([_sorted_stream(rng, cap,
                                              rng.randint(cap // 2, cap + 1))
                               for _ in range(k)]) for _ in range(g)])
    # shared indices across runs, so rows get several sources
    runs[:, 1::2, : cap // 4] = runs[:, 0:1, : cap // 4]
    runs = np.sort(runs, -1)
    seen = []
    inner = ops.onehot_scatter_add
    monkeypatch.setattr(ops, "onehot_scatter_add",
                        lambda *a, **kw: seen.append((a, kw)) or inner(*a, **kw))
    idx = torch.as_tensor(runs.astype(np.int64), device=cuda)
    val = torch.as_tensor(rng.randn(g, k, cap).astype(np.float32),
                          device=cuda)
    ops.merge_sorted_runs(idx, val, k * cap, mode="fused")
    (pos, v, rows), kw = seen[0]
    assert kw.get("scale") is None and pos.shape == (g, k * cap)
    _check_dense_scatter(pos, v, rows, None)
    _check_dense_scatter(pos, v.to(torch.bfloat16), rows, None)


@pytest.mark.gpu
def test_banded_rank_counts_kernel_matches_plain_on_gpu(cuda):
    rng = np.random.RandomState(4)
    for g, k, cap, bm in [(3, 4, 700, 512), (2, 16, 33, 128), (64, 4, 513, 7)]:
        runs = np.stack([np.stack([_sorted_stream(rng, cap,
                                                  rng.randint(0, cap + 1))
                                   for _ in range(k)]) for _ in range(g)])
        x = torch.as_tensor(runs.astype(np.int64), device=cuda)
        assert torch.equal(merge_ranks(x, banded=True, bm=bm),
                           ref.merge_ranks_ref(x))
        a, b = x[:, 0].contiguous(), x[:, -1].contiguous()
        for strict, side in ((True, "left"), (False, "right")):
            assert torch.equal(rank_counts(a, b, strict=strict, banded=True,
                                           bm=bm, bn=64),
                               ref.rank_counts_ref(a, b, side))
    for fill in (77, SENT):          # all-equal and SENTINEL-only streams
        a = torch.full((2, 600), fill, dtype=torch.int64, device=cuda)
        b = torch.full((2, 530), fill, dtype=torch.int64, device=cuda)
        for strict, side in ((True, "left"), (False, "right")):
            assert torch.equal(rank_counts(a, b, strict=strict, banded=True),
                               ref.rank_counts_ref(a, b, side))


def _hashed_runs(g, k, cap, seed, tails=True):
    """[g, k, cap] int64 runs of hashed distinct indices (the butterfly's
    case), each sorted with a SENTINEL tail of its own length."""
    from repro_torch.core.sparse_vec import HashPerm
    rng = np.random.RandomState(seed)
    perm = HashPerm.make(seed)
    runs = np.full((g, k, cap), SENT, np.int64)
    for i in range(g):
        for r in range(k):
            n = rng.randint(cap // 4, cap + 1) if tails else cap
            raw = rng.choice(8 * cap, n, replace=False).astype(np.uint32)
            runs[i, r, :n] = np.sort(perm.fwd_np(raw))
    return runs


def _check_ranks(cuda, runs, **kw):
    """merge_ranks on the card == plain version, twice bit-identical."""
    x = torch.as_tensor(runs, device=cuda)
    got = merge_ranks(x, **kw)
    assert torch.equal(got, ref.merge_ranks_ref(x))
    assert torch.equal(got, merge_ranks(x, **kw))


@pytest.mark.gpu
def test_merge_path_rank_kernel_shapes_on_gpu(cuda):
    """The merge path in modes 0/1 (batch dims, Ca != Cb, several tiles of
    1,024 outputs, all-equal and SENTINEL-only streams) and mode 2 (k from
    1 to 16, odd k, caps that are no power of two, the union_wire layer-1
    shape [., 4, 131072] at 8 groups), against the plain version, repeat
    identical."""
    rng = np.random.RandomState(12)
    for shape_a, shape_b in [((2, 3, 5000), (2, 3, 777)), ((4, 1), (4, 9000)),
                             ((3, 2048), (3, 2048))]:
        a = torch.as_tensor(np.sort(rng.randint(0, 3000, shape_a), -1),
                            device=cuda)
        b = torch.as_tensor(np.sort(rng.randint(0, 3000, shape_b), -1),
                            device=cuda)
        for strict, side in ((True, "left"), (False, "right")):
            got = rank_counts(a, b, strict=strict)
            assert torch.equal(got, ref.rank_counts_ref(a, b, side))
            assert torch.equal(got, rank_counts(a, b, strict=strict))
    for fill in (77, SENT):
        a = torch.full((2, 3000), fill, dtype=torch.int64, device=cuda)
        b = torch.full((2, 2500), fill, dtype=torch.int64, device=cuda)
        for strict, side in ((True, "left"), (False, "right")):
            assert torch.equal(rank_counts(a, b, strict=strict),
                               ref.rank_counts_ref(a, b, side))
    a = torch.as_tensor(_hashed_runs(2, 1, 900, seed=3)[:, 0], device=cuda)
    empty = torch.zeros((2, 0), dtype=torch.int64, device=cuda)
    for banded in (False, True):          # an empty b counts nothing
        for strict in (True, False):
            assert not rank_counts(a, empty, strict=strict, banded=banded).any()
    for g, k, cap in [(3, 1, 700), (2, 2, 4097), (3, 3, 1000), (2, 5, 3001),
                      (4, 16, 1500), (8, 4, 131072)]:
        _check_ranks(cuda, _hashed_runs(g, k, cap, seed=k + cap))
    _check_ranks(cuda, np.full((2, 5, 900), 9, np.int64))
    _check_ranks(cuda, np.full((2, 3, 900), SENT, np.int64))


@pytest.mark.gpu
def test_banded_rank_tiles_and_shared_memory_on_gpu(cuda):
    """The tile-triage kernel against the plain version in modes 0, 1 and
    2 for query tiles and b-blocks that do not divide the streams, b-blocks
    whose staging needs more than 48 KB of shared memory (16,384 and the
    largest, 49,152, entries), the union_wire layer-1 shape at 8 groups;
    its own tile counts equal ``rank_tile_stats`` summed over the run
    pairs; tiles past the limits raise."""
    from repro_torch.kernels.rank_merge import BN_MAX, merge_tile_stats
    for g, k, cap, bm, bn in [(3, 4, 700, 512, 512), (2, 5, 3001, 100, 37),
                              (2, 16, 1500, 1024, 64), (2, 3, 40000, 512, 16384),
                              (2, 2, 60000, 7, BN_MAX), (8, 4, 131072, 512, 512)]:
        runs = _hashed_runs(g, k, cap, seed=bm + bn)
        _check_ranks(cuda, runs, banded=True, bm=bm, bn=bn)
        x = torch.as_tensor(runs, device=cuda)
        a, b = x[:, 0, : cap // 2 + 3].contiguous(), x[:, -1].contiguous()
        for strict, side in ((True, "left"), (False, "right")):
            got = rank_counts(a, b, strict=strict, banded=True, bm=bm, bn=bn)
            assert torch.equal(got, ref.rank_counts_ref(a, b, side))
        if cap <= 3001:
            assert merge_tile_stats(x, bm=bm, bn=bn) == \
                merge_tile_stats(x.cpu(), bm=bm, bn=bn)
    x = torch.as_tensor(_hashed_runs(2, 3, 100, seed=1), device=cuda)
    for bm, bn in ((2048, 512), (512, BN_MAX + 1), (512, 65536)):
        with pytest.raises(ValueError, match="bn|bm"):
            merge_ranks(x, banded=True, bm=bm, bn=bn)


def _wire_values(rng, shape, dtype, cuda):
    """(values, scale or None): dyadic f32 / bf16, or int8 + dyadic scale."""
    if dtype == torch.int8:
        q = torch.as_tensor(rng.randint(-127, 128, shape).astype(np.int8),
                            device=cuda)
        s = torch.as_tensor((2.0 ** rng.randint(-8, 0, shape[:-1]))
                            .astype(np.float32), device=cuda)
        return q, s
    v = torch.as_tensor((rng.randint(-512, 512, shape) / 64.0)
                        .astype(np.float32), device=cuda)
    return v.to(dtype), None


@pytest.mark.gpu
def test_wire_typed_scatter_kernels_match_plain_on_gpu(cuda):
    """Rows 3 (bf16 values) and 4 (int8 + scale) on arbitrary pos; rows 5
    and 6 on monotone pos, with a C that is a multiple of the kernel's
    chunk and empty output blocks past the last destination."""
    rng = np.random.RandomState(5)
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        b, c, w, rows = 3, 1500, 2, 400
        pos = torch.as_tensor(rng.randint(-1, rows + 2, (b, c))
                              .astype(np.int32), device=cuda)
        val, scale = _wire_values(rng, (b, c, w), dtype, cuda)
        got = onehot_scatter_add(pos, val, rows, scale=scale)
        assert torch.equal(got, ref.onehot_scatter_add_ref(pos, val, rows,
                                                           scale))
        assert torch.equal(got, onehot_scatter_add(pos, val, rows, scale=scale))
        for band, mult_rows, rows in [(4, 300, 1000), (16, 128, 128),
                                      (1, 4096, 4096)]:
            mono = np.sort(np.concatenate([
                np.repeat(np.arange(mult_rows),
                          rng.randint(0, band + 1, mult_rows)),
                np.full(rng.randint(0, 50), rows)]))
            mono = np.broadcast_to(mono, (2, len(mono))).astype(np.int32)
            pos = torch.as_tensor(np.ascontiguousarray(mono), device=cuda)
            val, scale = _wire_values(rng, pos.shape + (w,), dtype, cuda)
            got = banded_onehot_scatter_add(pos, val, rows, band=band,
                                            scale=scale)
            assert torch.equal(got, ref.onehot_scatter_add_ref(pos, val, rows,
                                                               scale))
            assert torch.equal(got, banded_onehot_scatter_add(
                pos, val, rows, band=band, scale=scale))
    pos = torch.arange(2048, device=cuda, dtype=torch.int32).reshape(1, -1)
    val = torch.ones(1, 2048, 1, device=cuda)
    got = banded_onehot_scatter_add(pos // 8, val, 4096, band=8)
    assert got[0, :256, 0].eq(8).all() and got[0, 256:].eq(0).all()
    scale = torch.as_tensor(rng.rand(2, 700).astype(np.float32), device=cuda)
    q = torch.as_tensor(rng.randint(-127, 128, (2, 700, 1)).astype(np.int8),
                        device=cuda)
    pos = torch.as_tensor(np.sort(rng.randint(0, 300, (2, 700)), axis=1)
                          .astype(np.int32), device=cuda)
    torch.testing.assert_close(
        banded_onehot_scatter_add(pos, q, 300, band=700, scale=scale),
        ref.onehot_scatter_add_ref(pos, q, 300, scale), rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
def test_union_banded_bf16_equals_fused_on_gpu(cuda):
    """The banded merge equals the fused merge bit for bit on the card
    under the bf16 wire, and each launches its own kernels."""
    from repro_torch.core.api import SparseAllreduce
    rng = np.random.RandomState(6)
    m, c = 16, 512
    idx = np.full((m, c), SENT, np.int64)
    val = np.zeros((m, c), np.float32)
    for n in range(m):
        u = np.sort(rng.permutation(np.unique(rng.randint(
            0, 2**32 - 1, c, dtype=np.uint64)))[:c // 2]).astype(np.int64)
        idx[n, : len(u)] = u
        val[n, : len(u)] = rng.randint(-64, 64, len(u)) / 64.0
    out, launches = {}, {}
    for merge in ("fused", "banded"):
        ar = SparseAllreduce(m, (4, 4), backend="device", merge=merge,
                             wire="delta+bf16")
        _build.reset_launches()
        out[merge] = ar.union_reduce(idx, val, m * c)
        torch.cuda.synchronize()
        launches[merge] = dict(_build.LAUNCHES)
    for a, b in zip(out["fused"], out["banded"]):
        assert torch.equal(a, b)
    assert int(out["banded"][2].sum()) == 0
    assert launches["banded"]["rank_counts_banded"] == 2
    assert launches["banded"]["banded_onehot_scatter_add"] == 2
    assert launches["banded"]["rank_counts"] == 0
    assert launches["fused"]["onehot_scatter_add"] == 2


def _banded_pos(mult, lead=0, tail=0, rows=None):
    """int32 monotone positions: ``lead`` entries at -1, row r repeated
    ``mult[r]`` times, then ``tail`` entries parked at rows, rows + 1, ..."""
    rows = len(mult) if rows is None else rows
    return np.concatenate([np.full(lead, -1),
                           np.repeat(np.arange(len(mult)), mult),
                           rows + np.arange(tail) // 7]).astype(np.int32)


def _banded_cases(rng):
    """(name, band, pos [B, C], rows) -- the window table's hard cases."""
    b = BANDED_ROWS
    cases = []
    rows = 5 * b + 77                  # empty tiles in the middle and tail
    mult = rng.randint(0, 5, rows)
    mult[b:2 * b] = 0
    mult[3 * b:] = 0
    mult[3 * b + 5] = 3
    cases.append(("empty_tiles", 4, _banded_pos(mult, 3, 900)[None], rows))
    rows = 3 * b + 1                   # gap rows inside a tile
    mult = rng.randint(0, 3, rows) * (rng.rand(rows) < 0.5)
    mult[100:1600] = 0
    mult[b + 1:2 * b - 1] = 0          # only the tile's edge rows are set
    cases.append(("gaps", 2, _banded_pos(mult, 0, 5)[None], rows))
    rows = 4 * b                       # runs at tile edges and long runs
    mult = rng.randint(0, 3, rows)
    for r in (b - 1, b, 2 * b - 1, 2 * b, 3 * b - 1):
        mult[r] = 16
    mult[b + 700: b + 760] = 16        # runs across pass and segment edges
    cases.append(("edges", 16, _banded_pos(mult, 1, 3)[None], rows))
    rows = 2 * b + 3                   # windows larger than many passes
    mult = rng.randint(0, 2, rows)
    mult[5] = 700
    mult[b + 2] = 3000
    cases.append(("band700", 3000, _banded_pos(mult, 0, 11)[None], rows))
    rows = 3 * b - 5                   # a batch of very different windows
    parts = [np.full(7000, rows), _banded_pos(np.ones(rows, int)),
             _banded_pos(np.eye(1, rows, 2 * b + 9, dtype=int)[0], 50),
             _banded_pos(rng.randint(0, 4, rows))]
    c = max(len(x) for x in parts) + 13
    pos = np.stack([np.concatenate([x, np.full(c - len(x), rows)])
                    for x in parts]).astype(np.int32)
    cases.append(("batch", 3, pos, rows))
    cases.append(("tiny", 2, np.array([[0, 0, 1, 4, 9, 9, 10, 10]],
                                      np.int32), 10))
    return cases


def _check_banded(pos, val, rows, band, scale):
    """The banded scatter equals the plain version on the card and on a
    CPU copy bit for bit, twice, one launch counted per call."""
    before = dict(_build.LAUNCHES)
    got = banded_onehot_scatter_add(pos, val, rows, band=band, scale=scale)
    name = "banded_onehot_scatter_add" + ("" if scale is None else "_scaled")
    assert {k: v - before[k] for k, v in _build.LAUNCHES.items()
            if v != before[k]} == {name: 1}
    assert torch.equal(got, ref.onehot_scatter_add_ref(pos, val, rows, scale))
    assert torch.equal(got.cpu(), ref.onehot_scatter_add_ref(
        pos.cpu(), val.cpu(), rows, None if scale is None else scale.cpu()))
    assert torch.equal(got, banded_onehot_scatter_add(pos, val, rows,
                                                      band=band, scale=scale))


@pytest.mark.gpu
def test_banded_scatter_window_cases_on_gpu(cuda):
    """Rows 5 and 6 (the window-table kernel) on whole empty tiles in the
    middle and at the tail, gap rows inside a tile, runs at tile edges and
    across the kernel's passes, windows many passes long (a 3,000-source
    run), C and rows that are no multiple of the tile, a batch of very
    different windows; f32 W = 1, bf16 W = 3, int8 + dyadic scale, f32
    W = 7, all dyadic so every order sums alike."""
    rng = np.random.RandomState(13)
    for name, band, pos_np, rows in _banded_cases(rng):
        pos = torch.as_tensor(pos_np, device=cuda)
        for dtype, w in ((torch.float32, 1), (torch.bfloat16, 3),
                         (torch.int8, 2), (torch.float32, 7)):
            val, scale = _wire_values(rng, pos.shape + (w,), dtype, cuda)
            _check_banded(pos, val, rows, band, scale)


@pytest.mark.gpu
def test_banded_scatter_general_scale_on_gpu(cuda):
    """The scaled kernel on general floats (int8 + uniform scale, bf16 +
    uniform scale): bit for bit against the plain version on a CPU copy
    (which sums in source order), twice."""
    rng = np.random.RandomState(14)
    for name, band, pos_np, rows in _banded_cases(rng)[2:4]:
        pos = torch.as_tensor(pos_np, device=cuda)
        for dtype in (torch.int8, torch.bfloat16):
            val, scale = _general_values(rng, pos.shape + (2,), dtype, cuda)
            if scale is None:
                scale = torch.rand(pos.shape, device=cuda)
            got = banded_onehot_scatter_add(pos, val, rows, band=band,
                                            scale=scale)
            want = ref.onehot_scatter_add_ref(pos.cpu(), val.cpu(), rows,
                                              scale.cpu())
            assert torch.equal(got.cpu(), want), name
            assert torch.equal(got, banded_onehot_scatter_add(
                pos, val, rows, band=band, scale=scale))


@pytest.mark.gpu
def test_banded_window_table_on_gpu(cuda):
    """The window table equals ``searchsorted`` of the tile boundaries
    min(t * BANDED_ROWS, rows), t = 0 .. ceil(rows / BANDED_ROWS), exactly,
    on the hard cases and on 64 rows of the union path's layer-0 shape;
    one ``banded_windows`` launch per call."""
    rng = np.random.RandomState(15)
    cases = [(pos, rows) for _, _, pos, rows in _banded_cases(rng)]
    big = np.stack([_banded_pos(1 + (rng.rand(77000) < 0.3), 0, 262144,
                                rows=262144)[:262144] for _ in range(64)])
    cases.append((big, 262144))
    cases.append((np.zeros((2, 0), np.int32), 10))
    for pos_np, rows in cases:
        pos = torch.as_tensor(np.ascontiguousarray(pos_np), device=cuda)
        before = _build.LAUNCHES["banded_windows"]
        got = banded_windows(pos, rows)
        assert _build.LAUNCHES["banded_windows"] == before + 1
        t = -(-rows // BANDED_ROWS)
        keys = torch.clamp(torch.arange(t + 1, device=cuda) * BANDED_ROWS,
                           max=rows).to(torch.int32)
        want = torch.searchsorted(pos, keys.expand(pos.shape[0], -1)
                                  .contiguous())
        assert got.dtype == torch.int64 and torch.equal(got, want)
        assert torch.equal(got.cpu(), ref.banded_windows_ref(
            pos.cpu(), rows, BANDED_ROWS))


@pytest.mark.gpu
def test_rank_kernels_at_replica_stage_k2_on_gpu(cuda):
    """The replica-merge stage hands both rank kernels k = 2 runs that are
    equal (each replica sends the same bucket): mode 2 and modes 0/1 on
    such pairs, on pairs with their own tails, and at the smoke's
    [64, 2, 131072] shape, against the plain version, repeat identical."""
    for g, cap in [(3, 700), (4, 5000), (64, 131072)]:
        runs = _hashed_runs(g, 2, cap, seed=cap)
        twins = np.repeat(runs[:, :1], 2, axis=1)
        for banded in (False, True):
            _check_ranks(cuda, twins, banded=banded)
            _check_ranks(cuda, runs, banded=banded)
        a = torch.as_tensor(twins[:, 0], device=cuda)
        for banded in (False, True):
            for strict, side in ((True, "left"), (False, "right")):
                assert torch.equal(rank_counts(a, a, strict=strict,
                                               banded=banded),
                                   ref.rank_counts_ref(a, a, side))


@pytest.mark.gpu
def test_replicated_union_and_planned_on_gpu(cuda):
    """r = 2 with a dead set on the card: the union reduce under each
    merge (scatters and rank kernels at the replica stage) equals the
    unreplicated reduce bit for bit, and so does the planned reduce;
    a lost replica group raises."""
    from repro_torch.core.api import SparseAllreduce
    from repro_torch.core.replication import DeadLogicalNode, replica_groups
    from repro_torch.core.sparse_vec import HashPerm
    m, degs, c = 8, (4, 2), 512
    rng = np.random.RandomState(4)
    perm = HashPerm.make(m)
    idx = np.full((m, c), SENT, np.int64)
    val = np.zeros((m, c), np.float32)
    out_idx, out_val = [], []
    for n in range(m):
        raw = rng.choice(6000, rng.randint(100, c), replace=False)
        v = (rng.randint(-128, 129, len(raw)) / 64.0).astype(np.float32)
        h = perm.fwd_np(raw.astype(np.uint32)).astype(np.int64)
        o = np.argsort(h)
        idx[n, :len(h)], val[n, :len(h)] = h[o], v[o]
        out_idx.append(raw.astype(np.uint32))
        out_val.append(v)
    dead = {1, 10, 12}
    for merge in ("sort", "fused", "banded"):
        want = SparseAllreduce(m, degs, backend="device", merge=merge,
                               seed=m).union_reduce(idx, val, m * c)
        got = SparseAllreduce(m, degs, backend="device", merge=merge, seed=m,
                              replication=2, dead=dead).union_reduce(
                                  idx, val, m * c)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), merge
    base = SparseAllreduce(m, degs, backend="device", seed=m)
    base.config(out_idx, out_idx)
    ar = SparseAllreduce(m, degs, backend="device", seed=m, replication=2,
                         dead=dead)
    ar.config(out_idx, out_idx)
    for a, b in zip(ar.reduce(out_val), base.reduce(out_val)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(DeadLogicalNode):
        ar.reconfig_dead(set(replica_groups(2 * m, 2)[2]))


@pytest.mark.gpu
def test_csr_matvec_wide_on_gpu(cuda):
    """The width-W product on the card equals its CPU result: bit for bit
    on 0/1 values (HADI's case), within rtol 1e-6 on general floats."""
    from repro_torch.graph.engine import build_csr, csr_matvec_wide, stack_csr
    rng = np.random.RandomState(9)
    m, n_rows, n_cols, w = 6, 300, 400, 96
    tables = [build_csr(rng.randint(0, n_rows, 5000),
                        rng.randint(0, n_cols, 5000),
                        np.ones(5000, np.float32), n_rows) for _ in range(m)]
    cpu = stack_csr(tables, n_rows, device="cpu", n_cols=n_cols)[:3]
    gpu = [t.to(cuda) for t in cpu]
    bits = (rng.rand(m, n_cols, w) < 0.3).astype(np.float32)
    x = torch.as_tensor(bits)
    assert torch.equal(csr_matvec_wide(*gpu, x.to(cuda)).cpu(),
                       csr_matvec_wide(*cpu, x))
    x = torch.as_tensor(rng.randn(m, n_cols, w).astype(np.float32))
    torch.testing.assert_close(csr_matvec_wide(*gpu, x.to(cuda)).cpu(),
                               csr_matvec_wide(*cpu, x), rtol=1e-6,
                               atol=1e-5)


@pytest.mark.gpu
def test_graph_apps_run_on_cuda_by_default(cuda):
    """HADI on the card equals the sim bit for bit; power iteration is
    within the reference test's bounds of the float64 oracle and launches
    the CSR kernel once a round."""
    from repro_torch.data.pipeline import powerlaw_graph
    from repro_torch.graph.hadi import hadi
    from repro_torch.graph.spectral import (power_iteration,
                                            power_iteration_reference)
    edges = powerlaw_graph(2000, 12000, seed=1)
    eff, curve, st = hadi(edges, 2000, m=8, degrees=(4, 2), max_hops=6,
                          backend="device")
    seff, scurve, sst = hadi(edges, 2000, m=8, degrees=(4, 2), max_hops=6)
    assert eff == seff and st["hops_run"] == sst["hops_run"]
    np.testing.assert_array_equal(curve, scurve)
    np.testing.assert_array_equal(st["b_final"], sst["b_final"])
    _build.reset_launches()
    lam, v, _ = power_iteration(edges, 2000, m=8, degrees=(4, 2), iters=20,
                                backend="device")
    assert _build.LAUNCHES["spmv_csr"] == 20 + GraphEngine.WARMUP_ROUNDS
    lam_r, v_r = power_iteration_reference(edges, 2000, iters=20)
    assert abs(lam - lam_r) / lam_r < 1e-4
    assert abs(v @ v_r) / (np.linalg.norm(v) * np.linalg.norm(v_r)) > 1 - 1e-6


@pytest.mark.gpu
def test_planned_reduce_repeats_bit_identical_on_gpu(cuda):
    """The planned reduce's fixed-order sums on the card: general floats
    reduce to the same bits on every call, at W = 1 and W = 3, and agree
    with the CPU run within rtol 1e-6."""
    from repro_torch.core.api import SparseAllreduce
    rng = np.random.RandomState(12)
    m, degs = 16, (4, 4)
    out_idx = [rng.randint(0, 20000, rng.randint(500, 2000))
               .astype(np.uint32) for _ in range(m)]
    in_idx = [rng.choice(20000, 800, replace=False).astype(np.uint32)
              for _ in range(m)]
    for width in (1, 3):
        shape = (lambda n: (n, width)) if width > 1 else (lambda n: (n,))
        vals = [rng.randn(*shape(len(o))).astype(np.float32)
                for o in out_idx]
        gpu = SparseAllreduce(m, degs, backend="device", value_width=width)
        gpu.config(out_idx, in_idx)
        cpu = SparseAllreduce(m, degs, backend="device", value_width=width,
                              device="cpu")
        cpu.config(out_idx, in_idx)
        first = gpu.reduce(vals)
        for _ in range(2):
            for a, b in zip(gpu.reduce(vals), first):
                assert np.array_equal(a, b)
        for a, b in zip(first, cpu.reduce(vals)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
def test_resilient_union_odd_survivors_on_gpu(cuda):
    """Losing both replicas of one of 8 logical shards at r = 2 leaves 7
    survivors (prime: one flat layer of 7 runs, an odd merge tree): the
    fused and banded survivor reduces on the card equal their CPU runs
    bit for bit (dyadic values)."""
    from repro_torch.resilience import DegradedPolicy, ResilientAllreduce
    rng = np.random.RandomState(13)
    m, c = 8, 700
    idx = np.full((m, c), SENT, np.int64)
    val = np.zeros((m, c), np.float32)
    for n in range(m):
        k = rng.randint(300, c)
        # distinct sorted indices (never choice(2**30, replace=False): it
        # permutes all 2**30 values)
        u = np.unique(rng.randint(0, 1 << 30, 2 * c, dtype=np.int64))
        idx[n, :k] = np.sort(rng.permutation(u)[:k])
        val[n, :k] = rng.randint(-128, 129, k) / 64.0
    for merge in ("fused", "banded"):
        outs = {}
        for dev in ("cuda", "cpu"):
            ra = ResilientAllreduce(m, (4, 2), replication=2, dead={3, 11},
                                    policy=DegradedPolicy(max_retries=0),
                                    merge=merge, device=dev)
            res = ra.union_reduce(idx, val, m * c)
            assert res.shrink["degrees"] == (7,) and \
                res.shrink["replication"] == 2
            outs[dev] = res.values
        for sid, (gi, gv, gf) in outs["cuda"].items():
            ci, cv, cf = outs["cpu"][sid]
            assert torch.equal(gi.cpu(), ci) and torch.equal(gv.cpu(), cv)
            assert int(gf) == int(cf)


@pytest.mark.gpu
def test_soak_runs_on_cuda_by_default(cuda, tmp_path):
    """The PageRank soak without ``--device`` runs on the card: killed and
    resumed under a rack schedule it ends bit for bit on its fault-free
    run, and within rtol 1e-5 of the CPU run."""
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=src)
    args = ["--job", "pagerank", "--steps", "8", "--ckpt-every", "2",
            "--vertices", "3000", "--edges", "20000", "--graph-nodes", "8",
            "--pool", "16"]
    rack = ["--faults", "rack", "--fault-at", "3", "--num-failures", "5",
            "--rack-size", "5"]

    def soak(out, *extra, rc=0):
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.soak",
                            "--out", str(tmp_path / out), *args, *extra],
                           env=env, capture_output=True, text=True,
                           timeout=600)
        assert r.returncode == rc, r.stdout + r.stderr
        return r.stdout

    out = soak("base")
    launches = json.loads(out.split("SOAK_LAUNCHES ")[1].splitlines()[0])
    # one warm-up round and the capture of the 2-round graph; its four
    # replays call no wrapper
    assert launches["spmv_csr"] == 2 + GraphEngine.WARMUP_ROUNDS
    soak("cpu", "--device", "cpu")
    soak("faulted", *rack, "--kill-at", "4", rc=17)
    assert "resumed at round 4" in soak("faulted", *rack, "--resume")
    with np.load(tmp_path / "base" / "final.npz") as a, \
            np.load(tmp_path / "faulted" / "final.npz") as b, \
            np.load(tmp_path / "cpu" / "final.npz") as c:
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k
            np.testing.assert_allclose(a[k], c[k], rtol=1e-5, atol=1e-10)


def _train_run(device, merge, wire="raw", steps=2, arch="qwen1.5-0.5b",
               m=8, tp=1, degrees=(4, 2), **cfg_kw):
    """Two reduced untied steps of ``arch`` over ``m`` stacked data
    positions of ``tp`` model positions each."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.train import batch_stream
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.step import make_train_step, mesh_ctx
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              tie_embeddings=False, **cfg_kw)
    step, _ = make_train_step(cfg, mesh_ctx(m, tp, device=device),
                              sync="sparse", dp_degrees={"data": degrees},
                              sync_merge=merge, sync_wire=wire,
                              sparse_tokens_hint=8 * 32 // m)
    params = T.init_params(cfg, tp, seed=0, device="cpu")
    params = T.tree_from_leaves(params, [(p, t.to(device)) for p, t
                                         in T.tree_leaves(params)])
    st = AdamW().init(params)
    stream = batch_stream(cfg, 8, 32, seed=0)
    losses = []
    for _ in range(steps):
        params, st, m = step(params, st, next(stream))
        losses.append(float(m["loss"]))
    return losses, [t.cpu() for _, t in T.tree_leaves(params)]


@pytest.mark.gpu
@pytest.mark.parametrize("merge,wire", [("fused", "raw"), ("banded", "raw"),
                                        ("banded", "delta+int8ef")])
def test_train_step_repeats_bit_identical_on_gpu(cuda, merge, wire):
    """The reduced train step through the merge kernels: two runs on the
    card give the same losses and parameters bit for bit (the embedding's
    backward and every sum in a fixed order), within rtol 1e-4 of the CPU
    run's losses."""
    from repro_torch.kernels import _build
    _build.reset_launches()
    la, pa = _train_run(cuda, merge, wire)
    name = "rank_counts" if merge == "fused" else "rank_counts_banded"
    assert _build.LAUNCHES[name] == 4
    lb, pb = _train_run(cuda, merge, wire)
    assert la == lb
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))
    lc, _ = _train_run("cpu", merge, wire)
    np.testing.assert_allclose(la, lc, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("merge", ["fused", "banded"])
def test_model_axis_train_steps_on_gpu_equal_cpu(cuda, merge):
    """Reduced untied qwen at (data, model) = (2, 2): the sparse sync's one
    union reduce per vocab shard runs through the merge kernels (one
    launch a layer for both columns, degrees (2,)); two runs on the card
    give the same losses and parameters bit for bit, within rtol 1e-4 of
    the CPU run's losses."""
    from repro_torch.kernels import _build
    run = dict(m=2, tp=2, degrees=(2,))
    _build.reset_launches()
    la, pa = _train_run(cuda, merge, **run)
    name = "rank_counts" if merge == "fused" else "rank_counts_banded"
    assert _build.LAUNCHES[name] == 2
    lb, pb = _train_run(cuda, merge, **run)
    assert la == lb
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))
    lc, _ = _train_run("cpu", merge, **run)
    np.testing.assert_allclose(la, lc, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,capacity", [
    ("granite-moe-3b-a800m", 2.0), ("granite-moe-3b-a800m", 0.5),
    ("xlstm-1.3b", 2.0), ("jamba-1.5-large-398b", 2.0)])
def test_moe_ssm_train_step_repeats_bit_identical_on_gpu(cuda, arch,
                                                         capacity):
    """Reduced MoE and SSM models through the sparse / fused sync: two runs
    on the card give the same losses and parameters bit for bit (the MoE
    dispatch's gathers, whose backward accumulates, repeat an index only
    where the gradient is 0; at capacity 0.5 copies are dropped), within
    rtol 1e-4 of the CPU run's losses."""
    la, pa = _train_run(cuda, "fused", arch=arch, moe_capacity=capacity)
    lb, pb = _train_run(cuda, "fused", arch=arch, moe_capacity=capacity)
    assert la == lb
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))
    lc, _ = _train_run("cpu", "fused", arch=arch, moe_capacity=capacity)
    np.testing.assert_allclose(la, lc, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,fsdp", [("whisper-base", False),
                                       ("internvl2-26b", True)])
def test_frontend_train_steps_on_gpu_equal_cpu(cuda, arch, fsdp):
    """Reduced untied whisper-base (encoder, cross attention) and
    internvl2 with ``fsdp=True`` (image tokens; the FSDP gather's
    reduce-scatter in the backward) through the sparse / fused sync from
    the same weights and batches: two runs on the card give the same
    losses and parameters bit for bit, within rtol 1e-4 of the CPU run's
    losses."""
    la, pa = _train_run(cuda, "fused", arch=arch, fsdp=fsdp)
    lb, pb = _train_run(cuda, "fused", arch=arch, fsdp=fsdp)
    assert la == lb
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))
    lc, _ = _train_run("cpu", "fused", arch=arch, fsdp=fsdp)
    np.testing.assert_allclose(la, lc, rtol=1e-4)


def _block_case(kind, device, t):
    """A reduced block's float32 parameters (seed 5) and input [2, t, d]
    on ``device``: (fn(x) -> y, params, x)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as MOE, ssm as SSM
    from repro_torch.models import transformer as T
    arch = {"moe": "granite-moe-3b-a800m", "mamba": "jamba-1.5-large-398b",
            "mlstm": "xlstm-1.3b", "slstm": "xlstm-1.3b"}[kind]
    cfg = get_config(arch).reduced()
    params = T.init_params(cfg, 1, seed=5, device="cpu")
    blk = next(b for b in params["blocks"].values() if kind in b)
    p = {k: v[0].to(device) for k, v in blk[kind].items()}
    x = torch.randn(2, t, cfg.d_model, generator=torch.Generator()
                    .manual_seed(6)).to(device)
    if kind == "moe":
        fn = lambda x: MOE.moe_ffn(p, x, cfg, capacity_factor=0.5)
    else:
        train = {"mamba": SSM.mamba_train, "mlstm": SSM.mlstm_train,
                 "slstm": SSM.slstm_train}[kind]
        fn = lambda x: (train(p, x, cfg),)
    return fn, x


@pytest.mark.gpu
@pytest.mark.parametrize("kind,t", [("moe", 64), ("mamba", 512),
                                    ("mlstm", 256), ("slstm", 64)])
def test_moe_and_ssm_blocks_on_gpu_equal_cpu(cuda, kind, t):
    """``moe_ffn`` (capacity 0.5: copies dropped) and the three SSM blocks
    on the card against their CPU run on the same float32 inputs: outputs
    and input gradients within rtol 1e-4 + 1e-5 x max (float32 sums in
    another order; ``allow_tf32`` is off), the MoE's aux within rtol 1e-5
    and its dropped fraction exact; a second card run bit-identical."""
    assert not torch.backends.cuda.matmul.allow_tf32
    outs = {}
    for dev in ("cpu", cuda, cuda):
        fn, x = _block_case(kind, dev, t)
        x.requires_grad_(True)
        out = fn(x)
        ct = torch.ones_like(out[0]).cumsum(-1) / out[0].shape[-1]
        (gx,) = torch.autograd.grad(out[0], x, ct)
        outs.setdefault(str(torch.device(dev).type), []).append(
            [o.detach().cpu() for o in out] + [gx.cpu()])
    (want,), (got, again) = outs["cpu"], outs["cuda"]
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for a, b in ((got[0], want[0]), (got[-1], want[-1])):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-5 * float(b.abs().max()))
    assert torch.isfinite(got[-1]).all()
    if kind == "moe":
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)
        assert float(got[2]) == float(want[2]) > 0


def _wide_scatter_inputs(device, banded, scaled, rows=512, c=1024, w=1024):
    """pos [8, c] int32 (banded: non-decreasing, at most 4 sources a row,
    the tail parked at ``rows``), values [8, c, w] normal floats (int8
    with a uniform scale when ``scaled``)."""
    rng = np.random.RandomState(21)
    pos = np.full((8, c), rows, np.int32)
    for b in range(8):
        if banded:
            mult = rng.randint(0, 5, rows)
            p = np.repeat(np.arange(rows), mult)[:c]
            pos[b, :len(p)] = p
        else:
            pos[b] = rng.randint(-1, rows + 1, c)
    if scaled:
        val = rng.randint(-127, 128, (8, c, w)).astype(np.int8)
        scale = rng.rand(8, c).astype(np.float32)
    else:
        val = rng.randn(8, c, w).astype(np.float32)
        scale = None
    t = lambda x: None if x is None else torch.as_tensor(x, device=device)
    return t(pos), t(val), rows, t(scale)


@pytest.mark.gpu
@pytest.mark.parametrize("banded", [False, True])
@pytest.mark.parametrize("scaled", [False, True])
def test_scatters_at_width_1024_equal_plain_on_cpu(cuda, banded, scaled):
    """Both scatter kernels at the training sync's width (w = 1,024 floats
    a row): bit for bit equal to their plain version on a CPU copy on
    general floats, and a second launch identical."""
    pos, val, rows, scale = _wide_scatter_inputs(cuda, banded, scaled)
    if banded:
        got = banded_onehot_scatter_add(pos, val, rows, band=4, scale=scale)
        again = banded_onehot_scatter_add(pos, val, rows, band=4, scale=scale)
    else:
        got = onehot_scatter_add(pos, val, rows, scale=scale)
        again = onehot_scatter_add(pos, val, rows, scale=scale)
    want = ref.onehot_scatter_add_ref(pos.cpu(), val.cpu(), rows,
                                      None if scale is None else scale.cpu())
    assert got.shape == (8, rows, 1024)
    assert torch.equal(got.cpu(), want) and torch.equal(got, again)


def _graph_engines(device, overlap):
    """PageRank, HADI and spectral engines on a small power-law graph:
    ``[(name, engine, state, extras, k)]``."""
    from repro_torch.data.pipeline import powerlaw_graph
    from repro_torch.graph.hadi import fm_bitstrings, make_hadi_engine
    from repro_torch.graph.pagerank import (build_partitions,
                                            make_pagerank_app, pagerank_state)
    from repro_torch.graph.spectral import make_spectral_engine
    n = 3000
    edges = powerlaw_graph(n, 20000, seed=2)
    parts = build_partitions(edges, n, 8)
    app, o, i = make_pagerank_app(parts, n)
    pr = GraphEngine(o, i, app, degrees=(4, 2), device=device,
                     overlap=overlap)
    extras, p0 = pagerank_state(parts, n, pr.u_cap, pr.uin_cap,
                                device=device)
    req = [np.union1d(p.in_idx, p.out_idx).astype(np.uint32) for p in parts]
    b0 = fm_bitstrings(n, 8, 2, np.random.RandomState(3))
    hd, hx, h0 = make_hadi_engine(parts, req, (4, 2), 8, 2, b0,
                                  device=device)
    sym = np.concatenate([edges, edges[:, ::-1]], axis=0)
    sparts = build_partitions(sym, n, 8)
    for p in sparts:
        p.inv_outdeg = np.ones_like(p.inv_outdeg)
    sp, sx, s0 = make_spectral_engine(sparts, n, (4, 2), device=device)
    if overlap:
        hd.overlap = sp.overlap = True
    return [("pagerank", pr, p0, extras, 6), ("hadi", hd, h0, hx, 4),
            ("spectral", sp, s0, sx, 5)]


def _flat(out):
    """The tensors of a ``run`` result, in order."""
    final, last, traj = out
    parts = [final, last, traj]
    flat = []
    for p in parts:
        if isinstance(p, dict):
            flat.extend(p[k] for k in sorted(p))
        elif isinstance(p, list):
            for q in p:
                flat.extend(q[k] for k in sorted(q))
        elif p is not None:
            flat.append(p)
    return flat


@pytest.mark.gpu
@pytest.mark.parametrize("overlap", [False, True])
def test_graph_replay_equals_eager_loop_on_gpu(cuda, overlap):
    """PageRank, HADI and spectral on the card: ``run(k)`` replays one
    CUDA graph (one graph launch a run; one capture for ``"last"``, one a
    run for ``"trajectory"``, whose outputs are handed over) whose final
    state, last product and trajectory equal the eager loop's bit for
    bit, plain and rotated; a run's result survives the runs after it;
    the rotated schedule equals the plain one."""
    plain = {}
    for name, eng, state, extras, k in _graph_engines(cuda, overlap):
        for collect in ("last", "trajectory"):
            want = _flat(eng.eager_fn(k, collect)(state, extras))
            first = _flat(eng.run(k, state, extras, collect=collect))
            for _ in range(2):
                got = _flat(eng.run(k, state, extras, collect=collect))
                assert len(got) == len(want)
                assert all(torch.equal(a, b) for a, b in zip(got, want)), \
                    (name, collect)
            assert all(torch.equal(a, b) for a, b in zip(first, want)), \
                (name, collect, "overwritten")
            plain[(name, collect)] = want
        rep = eng.sync_report()
        assert rep["graph_launches"] == rep["dispatches"] == 6, rep
        assert rep["captures"] == 1 + 3 and rep["overlap"] == overlap, rep
    if overlap:
        for name, eng, state, extras, k in _graph_engines(cuda, False):
            for collect in ("last", "trajectory"):
                got = _flat(eng.run(k, state, extras, collect=collect))
                assert all(torch.equal(a, b) for a, b in
                           zip(got, plain[(name, collect)])), name


def _kernels_per_run(fn, reps=4, tries=5):
    """``{kernel name: launches}`` a call of ``fn`` runs on the device,
    from a ``torch.profiler`` trace of ``reps`` calls after a warm one;
    taken again (``tries`` in all) unless every kernel ran a whole number
    of times a call, as ``chip_smoke.profile_kernels`` does."""
    import re
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = {}
        for evt in prof.key_averages():
            if evt.device_type == DeviceType.CPU:
                continue
            key = evt.key.replace("(anonymous namespace)::", "")
            key = key[5:] if key.startswith("void ") else key
            name = re.split(r"[<(]", key)[0].split("::")[-1]
            total[name] = total.get(name, 0) + evt.count
        if total and all(n % reps == 0 for n in total.values()):
            return {name: n // reps for name, n in total.items()}
    raise AssertionError(f"no whole trace of {reps} calls: {total}")


@pytest.mark.gpu
def test_graph_replay_runs_its_captured_kernels_on_gpu(cuda):
    """A profiler trace of replays of a captured k-round PageRank graph
    holds, a replay, the k SpMV kernels its capture enqueued; no kernel
    wrapper is called and nothing is captured again; the transport's
    exchange count rises by 2 * depth * k a replay, as the eager loop's
    does."""
    (name, eng, state, extras, k), *_ = _graph_engines(cuda, False)
    eng.run(k, state, extras)                       # capture + 1 replay
    assert eng.run_fn(k).launches == {"spmv_csr": k}
    _build.reset_launches()
    calls, runs = eng.transport.calls, eng.report["dispatches"]
    ran = _kernels_per_run(lambda: eng.run(k, state, extras))
    assert ran.get("spmv_csr_kernel", 0) == k, ran
    assert not any(_build.LAUNCHES.values()), _build.LAUNCHES
    runs = eng.report["dispatches"] - runs
    assert eng.transport.calls - calls == runs * 2 * eng.planned.depth * k
    assert eng.sync_report()["captures"] == 1


def _reduced_step(device, mc, degrees, sync, **kw):
    """One reduced untied qwen step at ``mc`` from seed-0 weights: the
    loss, row 0 of every synced leaf and the parameters after, on the
    host."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.train import batch_stream
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.step import make_train_step
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                              tie_embeddings=False)
    step, _ = make_train_step(cfg, mc, sync=sync, dp_degrees=degrees,
                              sync_merge="fused",
                              sparse_tokens_hint=8 * 32 // mc.dp, **kw)
    params = T.init_params(cfg, mc.tp, seed=0, device=device)
    st = AdamW().init(params)
    cap = {}
    params, st, m = step(params, st, next(batch_stream(cfg, 8, 32, seed=0)),
                         capture=cap)
    return (float(m["loss"]),
            [t.cpu() for _, t in T.tree_leaves(cap["synced"])],
            [t.cpu() for _, t in T.tree_leaves(params)])


@pytest.mark.gpu
@pytest.mark.parametrize("sync", ["hier", "sparse"])
def test_pod_mesh_and_bucketed_sync_bit_for_bit_on_gpu(cuda, sync):
    """Reduced untied qwen on the card: the (pod, data, model) = (2, 2, 1)
    mesh with degrees {pod: (2,), data: (2,)} equals the flat (4, 1) mesh
    with {data: (2, 2)}, and (2, 2, 2) equals (4, 2); the bucketed sync
    (a 64 KiB budget) equals ``off``: the loss, every synced leaf and
    every parameter after the step, bit for bit."""
    from repro_torch.train.step import mesh_ctx
    pairs = [
        ((mesh_ctx(2, pod=2, device=cuda), {"pod": (2,), "data": (2,)}, {}),
         (mesh_ctx(4, device=cuda), {"data": (2, 2)}, {})),
        ((mesh_ctx(2, 2, pod=2, device=cuda), {"pod": (2,), "data": (2,)},
          {}), (mesh_ctx(4, 2, device=cuda), {"data": (2, 2)}, {})),
        ((mesh_ctx(4, device=cuda), {"data": (2, 2)},
          {"sync_overlap": "bucketed", "sync_bucket_bytes": 1 << 16}),
         (mesh_ctx(4, device=cuda), {"data": (2, 2)}, {}))]
    for (ma, da, ka), (mb, db, kb) in pairs:
        la, ga, pa = _reduced_step(cuda, ma, da, sync, **ka)
        lb, gb, pb = _reduced_step(cuda, mb, db, sync, **kb)
        assert la == lb, (la, lb)
        assert all(torch.equal(a, b) for a, b in zip(ga, gb))
        assert all(torch.equal(a, b) for a, b in zip(pa, pb))


@pytest.mark.gpu
def test_blocked_attention_at_8192_on_gpu(cuda):
    """One reduced qwen attention layer in bfloat16 at T = 8,192 on the
    card: the block forward takes the query-chunked attention, which is
    within bfloat16 rounding of ``attn_train`` (|a - b| <= 2^-7 x max|b|)
    and whose input gradient is finite; a second run bit-identical."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as T
    cfg = get_config("qwen1.5-0.5b").reduced()
    p = {k: v[0].to(cuda) for k, v in
         T.init_params(cfg, 1, seed=0, device="cpu")["blocks"]["b0"]
         ["attn"].items()}
    x = torch.randn(1, A.BLOCKED_ATTN_THRESHOLD, cfg.d_model,
                    generator=torch.Generator().manual_seed(4)
                    ).to(cfg.dtype).to(cuda)
    want = A.attn_train(p, x, cfg, 1, 0)
    xg = x.clone().requires_grad_(True)
    got = A.attn_train_any(p, xg, cfg, 1, 0)
    (gx,) = torch.autograd.grad(got.float().sum(), xg)
    got = got.detach()
    assert torch.equal(got, A.attn_train_blocked(p, x, cfg, 1, 0))
    gap = float((got.float() - want.float()).abs().max())
    assert gap <= 2.0 ** -7 * float(want.float().abs().max()), gap
    assert torch.isfinite(gx).all()


def _serve_case(arch, device, data, tp, slots, dispatch=None):
    """Reduced ``arch`` (seed-0 weights drawn on the CPU, copied over)
    served on ``device`` at (data, tp) with ``slots`` slots: the batched
    ids and the sequential oracle's of one Zipf stream."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serve import (ContinuousBatchingScheduler,
                                   DecodeService, zipf_request_stream)
    from repro_torch.serve.dispatch import SparseServeDispatch
    from repro_torch.serve.service import run_sequential_oracle
    from repro_torch.train.step import mesh_ctx
    cfg = get_config(arch).reduced()
    params = T.init_params(cfg, tp, seed=0, device="cpu")
    params = T.tree_from_leaves(params, [(p, t.to(device)) for p, t
                                         in T.tree_leaves(params)])
    mc = mesh_ctx(data, tp, device=device)

    def stream():
        return zipf_request_stream(7, cfg.vocab, prompt_lens=(8, 16),
                                   max_new=(1, 6), arrival_rate=0.7, seed=3)
    disp = None
    if dispatch is not None:
        disp = SparseServeDispatch(data, vocab=cfg.vocab, merge=dispatch[0],
                                   wire=dispatch[1], seed=5, device=device)
        disp.fit_hot_set(np.concatenate([r.prompt for r in stream()]),
                         head_size=8)
    sched = ContinuousBatchingScheduler(cfg, mc, params, slots=slots,
                                        max_seq=24, dispatch=disp)
    reqs = stream()
    report = DecodeService(sched).run(reqs)
    batched = [list(r.tokens) for r in sorted(report.completed,
                                              key=lambda r: r.rid)]
    sched.reset()
    sched.dispatch = None
    return cfg, batched, run_sequential_oracle(sched, stream()), disp


@pytest.mark.gpu
@pytest.mark.parametrize("arch,data,tp,slots", [
    ("qwen1.5-0.5b", 2, 1, 4), ("qwen1.5-0.5b", 2, 2, 8),
    ("granite-moe-3b-a800m", 2, 2, 4), ("xlstm-1.3b", 2, 1, 4),
    ("jamba-1.5-large-398b", 1, 1, 2)])
def test_continuous_batching_equals_oracle_on_gpu(cuda, arch, data, tp,
                                                  slots):
    """Reduced float32 models served on the card: continuous batching
    returns the sequential oracle's ids token for token (the decode rows
    independent of the other slots on the card too), every id below the
    vocab."""
    cfg, batched, oracle, _ = _serve_case(arch, cuda, data, tp, slots)
    assert batched == oracle
    assert all(0 <= t < cfg.vocab for ids in batched for t in ids)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "granite-moe-3b-a800m",
                                  "xlstm-1.3b", "jamba-1.5-large-398b",
                                  "whisper-base"])
def test_serving_steps_on_gpu_equal_cpu(cuda, arch):
    """The prefill and three decode steps of a reduced float32 model on
    the card against the same steps on the CPU: logits and every cache
    leaf within rtol 1e-4 + 1e-5 x max (float32 sums in another order),
    with an SSM block + 1e-4 x max (``tests/test_torch_serve.py``'s SSM
    bound: the stack amplifies the rounding; xlstm's logits part by 5.5e-5
    x max); a second card run bit-identical."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import _cross_cache
    from repro_torch.models import transformer as T
    from repro_torch.train.step import (make_decode_step, make_prefill_step,
                                        mesh_ctx)
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = get_config(arch).reduced()
    host = T.init_params(cfg, 1, seed=0, device="cpu")
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab, (2, 19)).astype(np.int32)
    batch = {"tokens": toks[:, :16]}
    if cfg.enc_layers:
        batch["enc_frames"] = rng.randn(2, cfg.enc_seq,
                                        cfg.d_model).astype(np.float32)
    runs = []
    for dev in ("cpu", cuda, cuda):
        params = T.tree_from_leaves(host, [(p, t.to(dev)) for p, t
                                           in T.tree_leaves(host)])
        mc = mesh_ctx(2, device=dev)
        pre, _ = make_prefill_step(cfg, mc, 24)
        dec, _ = make_decode_step(cfg, mc)
        cross = () if not cfg.enc_layers else (
            _cross_cache(cfg, mc, params, batch["enc_frames"]),)
        logits, cache = pre(params, batch)
        # copies: the decode steps write the cache in place
        out = [logits.cpu()] + [t.to("cpu", copy=True)
                                for _, t in T.cache_leaves(cache)]
        for i in range(3):
            logits, cache = dec(params, toks[:, 16 + i], np.full(2, 16 + i),
                                cache, *cross)
            out.append(logits.cpu())
        runs.append(out)
    want, got, again = runs
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    atol = 1e-4 if any(b != "attn" for b in cfg.pattern) else 1e-5
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=atol * float(b.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("merge,wire", [("fused", "raw"), ("banded", "raw"),
                                        ("fused", "delta+int8ef"),
                                        ("banded", "delta+int8ef")])
def test_serve_dispatch_kernels_on_gpu(cuda, merge, wire):
    """The sparse dispatch over 2 data positions on the card: its tail
    unions launch the merge-rank and scatter kernels of ``merge`` /
    ``wire``, the ids equal the run without dispatch, and each step's
    head + tail counts equal the bincount of the shards' ids."""
    from repro_torch.kernels import _build
    _build.reset_launches()
    cfg, batched, oracle, disp = _serve_case("qwen1.5-0.5b", cuda, 2, 1, 4,
                                             (merge, wire))
    assert batched == oracle and disp.steps > 0
    rank = "rank_counts" if merge == "fused" else "rank_counts_banded"
    scatter = ("onehot_scatter_add" if merge == "fused"
               else "banded_onehot_scatter_add") \
        + ("_scaled" if wire == "delta+int8ef" else "")
    assert _build.LAUNCHES[rank] >= disp.steps
    assert _build.LAUNCHES[scatter] >= disp.steps
    ex = disp.last
    assert ex.overflow == 0 and float(ex.head_counts.sum()
                                      + ex.tail_counts.sum()) > 0


@pytest.mark.gpu
def test_serve_launcher_takes_the_card_by_default(cuda, tmp_path,
                                                  monkeypatch):
    """``python -m repro_torch.launch.serve`` without ``--device`` serves
    on the current CUDA device (reduced qwen with the dispatch, and
    whisper's fixed batch)."""
    from repro_torch.launch import serve as launch_serve
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path / "plans"))
    gen = launch_serve.main(["--arch", "qwen1.5-0.5b", "--reduced",
                             "--requests", "4", "--prompt-len", "8",
                             "--gen", "4", "--sparse-dispatch",
                             "--data-axis", "2"])
    assert gen.shape == (4, 4) and int(gen.max()) < 512
    gen = launch_serve.main(["--arch", "whisper-base", "--reduced",
                             "--gen", "4"])
    assert gen.shape == (4, 4)


def _decode_runs(cfg, dev, steps_of, toks, positions):
    """Logits of each step of ``steps_of(dev)``'s decode steps on
    ``dev``, each from a copy of the cache of a 6-token prefill of 4 rows
    (32 slots, on a one-position mesh; every layout holds the same
    global cache): ``{name: [logits a step]}``."""
    from repro_torch.models import transformer as T
    from repro_torch.train.step import make_prefill_step, mesh_ctx
    host = T.init_params(cfg, 2, seed=0, device="cpu")
    params = T.tree_from_leaves(host, [(p, t.to(dev)) for p, t
                                       in T.tree_leaves(host)])
    prompt = np.random.RandomState(3).randint(0, cfg.vocab, (4, 6))
    _, cache0 = make_prefill_step(cfg, mesh_ctx(1, 1, device=dev), 32)[0](
        params, {"tokens": prompt})
    out = {}
    for name, step in steps_of(dev).items():
        cache = {k: {kk: t.clone() for kk, t in v.items()}
                 for k, v in cache0.items()}
        out[name] = []
        for p in positions:
            logits, cache = step(params, toks, np.full(len(toks), p), cache)
            out[name].append(logits.cpu())
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("arch,kw", [("command-r-plus-104b", {"fsdp": True}),
                                     ("arctic-480b", {"fsdp": True}),
                                     ("jamba-1.5-large-398b", {"fsdp": True}),
                                     ("qwen1.5-0.5b", {})])
def test_decode_layouts_on_gpu(cuda, arch, kw):
    """On the card, reduced float32, from a 6-token prefill: the split-KV
    decode (4 data positions of 8 of the 32 slots; steps at 6 to 9 cross
    the shard boundary at 8) equals the batch-sharded decode of a
    one-position mesh, and serve2d at (2, 2) (FSDP configs) equals the
    gather decode of the same mesh, within rtol 1e-4 + 1e-5 x max (1e-4 x
    max with an SSM block, as the serving test); each layout equals its
    CPU run within the same bound."""
    from repro_torch.configs import get_config
    from repro_torch.train.step import make_decode_step, mesh_ctx
    cfg = get_config(arch).reduced(**kw)
    toks = np.random.RandomState(2).randint(0, cfg.vocab, 4)

    def steps(dev):
        seq, one = mesh_ctx(4, 1, device=dev), mesh_ctx(1, 1, device=dev)
        out = {"splitkv": make_decode_step(cfg, seq, seq_sharded=True)[0],
               "gather1": make_decode_step(cfg, one)[0]}
        if cfg.fsdp:
            m22 = mesh_ctx(2, 2, device=dev)
            out["serve2d"] = make_decode_step(cfg, m22, serve2d=True)[0]
            out["gather22"] = make_decode_step(cfg, m22)[0]
        return out
    runs = {dev: _decode_runs(cfg, dev, steps, toks, (6, 7, 8, 9))
            for dev in ("cpu", cuda)}
    atol = 1e-4 if any(b != "attn" for b in cfg.pattern) else 1e-5

    def close(a, b):
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=1e-4,
                                       atol=atol * float(y.abs().max()))
    card = runs[cuda]
    close(card["splitkv"], card["gather1"])
    if cfg.fsdp:
        close(card["serve2d"], card["gather22"])
    for name in card:
        close(card[name], runs["cpu"][name])


@pytest.mark.gpu
def test_audits_on_gpu(cuda):
    """The audit sweep on the card: every report clean, each engine run
    one CUDA graph replay (``graph_launches`` + 1, the rounds read at
    capture), and the greedy prefill / decode steps make no host read and
    no device-to-host copy inside."""
    from repro_torch.analysis.cli import audit_sweep
    reports = audit_sweep(cuda)
    assert all(r.ok for r in reports), [r.to_dict() for r in reports
                                        if not r.ok]
    engines = [r for r in reports if r.target.startswith("GraphEngine")]
    assert len(engines) == 2
    for r in engines:
        assert r.check("one_scan_dispatch").actual == 1
        assert "read at capture" in r.check(
            "per_round_collectives_equal_plan_depth").detail
    serve = [r for r in reports if "greedy" in r.target]
    assert len(serve) == 2 and all(
        r.check("no_forbidden_primitives").actual == [] for r in serve)


@pytest.mark.gpu
def test_engine_capture_runs_without_cyclic_collection(cuda, monkeypatch):
    """The cyclic collector is off while an engine captures its graph and
    on again after: an engine dropped earlier is a cycle holding its CUDA
    graph, and a collection inside a capture would free that graph there,
    a CUDA call a capture forbids (the capture then fails)."""
    import gc
    from repro_torch.analysis.cli import pagerank_engine
    from repro_torch.core.transport import StackedTransport
    seen, orig = [], StackedTransport.all_to_all

    def probe(self, *args, **kwargs):
        if torch.cuda.is_current_stream_capturing():
            seen.append(gc.isenabled())
        return orig(self, *args, **kwargs)
    monkeypatch.setattr(StackedTransport, "all_to_all", probe)
    engine, extras, p0 = pagerank_engine(cuda)
    engine.run(3, p0, extras)
    assert engine.report["captures"] == 1
    assert seen and not any(seen) and gc.isenabled()


@pytest.mark.gpu
def test_engine_spans_under_the_profiler_on_gpu(cuda):
    """A PageRank engine captured and replayed while ``torch.profiler``
    records: the capture succeeds; each run (the first captures, each
    replays) is one ``engine.run`` span with positive device ms and no
    span inside; a span opened inside a graph capture records no event,
    and its graph replays."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import obs
    from repro_torch.analysis.cli import pagerank_engine
    engine, extras, p0 = pagerank_engine(cuda)
    want = engine.eager_fn(3)(p0, extras)[0]
    x = torch.arange(8.0, device=cuda)
    graph = torch.cuda.CUDAGraph()
    obs.reset()
    with profile(activities=[ProfilerActivity.CUDA]):
        outs = [engine.run(3, p0, extras)[0] for _ in range(3)]
        torch.cuda.synchronize()
        with torch.cuda.graph(graph):
            with obs.span("t.captured"):
                y = x * 2
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, 2 * x)
    assert all(torch.equal(o, want) for o in outs)
    assert engine.report["captures"] == 1
    tl = obs.timeline()
    (captured,) = [s for s in tl if s.name == "t.captured"]
    assert captured.events is None
    runs = [s for s in tl if s.name == "engine.run"]
    assert len(runs) == 3 and len(tl) == 4
    assert all(run.parent is None and run.device_ms() > 0 for run in runs)
    obs.reset()


@pytest.mark.gpu
def test_span_stamps_hold_their_launches_on_the_trace_clock_on_gpu(
        cuda, tmp_path):
    """The card's Chrome trace has the base ``obs.trace_base_ns`` gives,
    and at least 99 % of the ``cudaLaunchKernel`` calls of union reduces
    traced alone fall inside a ``union.reduce`` span once its host stamps
    are put on the trace's clock; the phases' device ms lie within the
    reduce's; each reduce's ``union.htod_copies`` (the two stages' edges:
    the inputs are on the card, the plan cached) is the trace's count of
    host-to-device copies a reduce."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import obs
    from repro_torch.core.api import SparseAllreduce
    rng = np.random.RandomState(5)
    m, cap = 16, 4096
    idx = np.stack([np.sort(rng.choice(10**6, cap, replace=False))
                    for _ in range(m)])
    idx = torch.as_tensor(idx.astype(np.int64), device=cuda)
    val = torch.as_tensor(rng.randint(-64, 64, (m, cap)) / 8.0,
                          dtype=torch.float32, device=cuda)
    ar = SparseAllreduce(m, (4, 4), backend="device", device=cuda,
                         merge="fused", plan_cache=False)
    ar.union_reduce(idx, val, m * cap)
    torch.cuda.synchronize()
    obs.reset()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            ar.union_reduce(idx, val, m * cap)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    reduces = [s for s in obs.timeline() if s.name == "union.reduce"]
    assert len(reduces) == 5
    assert int(trace["baseTimeNanoseconds"]) == \
        obs.trace_base_ns(reduces[0].start_ns)
    spans_us = [(obs.trace_us(s.start_ns), obs.trace_us(s.end_ns))
                for s in reduces]
    launches = [float(e["ts"]) for e in trace["traceEvents"]
                if e.get("ph") == "X" and e.get("cat") == "cuda_runtime"
                and str(e.get("name", "")).startswith("cudaLaunchKernel")]
    inside = sum(any(a <= t <= b for a, b in spans_us) for t in launches)
    print(f"launches inside union.reduce: {inside} of {len(launches)}")
    assert launches and inside >= 0.99 * len(launches)
    htod = [e for e in trace["traceEvents"] if e.get("ph") == "X"
            and e.get("cat") == "gpu_memcpy" and "HtoD" in str(e.get("name"))]
    print(f"host-to-device copies traced: {len(htod)}")
    assert [r.counts.get("union.htod_copies") for r in reduces] == [2] * 5
    assert len(htod) == 2 * 5
    for r in reduces:
        phases = [s.device_ms() for s in obs.timeline()
                  if s.root == r.id and s.name in (
                      "union.partition", "union.exchange", "union.merge",
                      "union.gather", "union.trim")]
        assert len(phases) == 3 * 2 + 2 + 1
        assert 0 < sum(phases) <= r.device_ms() * 1.01
    obs.reset()
