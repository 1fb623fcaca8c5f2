"""PyTorch port, kernel level: held to the Pallas kernels (interpret mode).

The same numpy inputs go through the reference's Pallas kernel, run in
interpret mode as the JAX package's own tests run it, and through the
port's wrapper, which on CPU tensors runs the kernel's plain version:

* ``rank_counts``: exact, strict and non-strict, with SENTINEL queries
  against SENTINEL-padded streams and lengths crossing the 512 tile;
* ``onehot_scatter_add``: exact on dyadic values, rtol 1e-6 otherwise,
  with -1 pads and the ``num_rows`` drop bin;
* ``spmv_ell``: rtol 1e-5 (float32 sums in another order).

The port's sparse-vector ops and the fused merge pipeline are held to the
reference's jnp / Pallas versions bit for bit on dyadic values.  The
CUDA kernels themselves are held to these plain versions on the card by
``tests/test_torch_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparse_vec as jsv
from repro.kernels import ops as jops
from repro.kernels.onehot_scatter import onehot_scatter_add as j_scatter
from repro.kernels.rank_merge import rank_counts as j_rank_counts
from repro.kernels.spmv_ell import spmv_ell as j_spmv

from repro_torch.core import sparse_vec as sv
from repro_torch.kernels import ops
from repro_torch.kernels.onehot_scatter import onehot_scatter_add
from repro_torch.kernels.rank_merge import merge_ranks, rank_counts
from repro_torch.kernels.spmv_ell import spmv_ell

SENT = 0xFFFFFFFF


def _sorted_stream(rng, n, real, hi=2**32 - 1):
    """Sorted uint32 stream of length n: ``real`` distinct values, then
    SENTINEL padding."""
    out = np.full(n, SENT, np.uint32)
    vals = np.unique(rng.randint(0, hi, 4 * real + 64, dtype=np.uint64))
    out[:real] = np.sort(rng.permutation(vals)[:real])
    return out


def _t(x):
    return torch.as_tensor(np.asarray(x).astype(np.int64))


# ---------------------------------------------------------------------------
# rank_counts / merge ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ca,cb,ra,rb", [(700, 513, 650, 500), (33, 1030, 33, 0),
                                         (512, 512, 100, 512), (1, 5, 0, 3)])
@pytest.mark.parametrize("strict", [True, False])
def test_rank_counts_matches_pallas(ca, cb, ra, rb, strict):
    rng = np.random.RandomState(ca * 7 + cb)
    a = _sorted_stream(rng, ca, ra, hi=5000)
    b = _sorted_stream(rng, cb, rb, hi=5000)
    want = np.asarray(j_rank_counts(jnp.asarray(a), jnp.asarray(b),
                                    strict=strict))
    got = rank_counts(_t(a), _t(b), strict=strict)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_rank_counts_batched_rows_are_independent():
    rng = np.random.RandomState(5)
    a = np.stack([_sorted_stream(rng, 40, 30) for _ in range(3)])
    b = np.stack([_sorted_stream(rng, 50, 45) for _ in range(3)])
    got = rank_counts(_t(a), _t(b), strict=False)
    for i in range(3):
        np.testing.assert_array_equal(
            got[i].numpy(), np.asarray(j_rank_counts(
                jnp.asarray(a[i]), jnp.asarray(b[i]), strict=False)))


def test_merge_ranks_is_the_stable_merge_permutation():
    """merge_ranks == i + sum of reference rank_counts with the stable
    tie-break strict=(s > r), and a bijection per group."""
    rng = np.random.RandomState(9)
    k, cap = 3, 40
    runs = np.stack([np.stack([_sorted_stream(rng, cap, rng.randint(0, cap),
                                              hi=60) for _ in range(k)])
                     for _ in range(2)])
    got = merge_ranks(_t(runs)).numpy()
    for g in range(2):
        for r in range(k):
            want = np.arange(cap)
            for s in range(k):
                if s != r:
                    want = want + np.asarray(j_rank_counts(
                        jnp.asarray(runs[g, r]), jnp.asarray(runs[g, s]),
                        strict=(s > r)))
            np.testing.assert_array_equal(got[g, r], want)
        assert sorted(got[g].reshape(-1)) == list(range(k * cap))


# ---------------------------------------------------------------------------
# onehot_scatter_add
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c,w,rows", [(100, 1, 50), (600, 3, 130), (64, 1, 1)])
@pytest.mark.parametrize("dyadic", [True, False])
def test_onehot_scatter_matches_pallas(c, w, rows, dyadic):
    rng = np.random.RandomState(c + w + rows)
    pos = rng.randint(-1, rows + 2, c).astype(np.int32)   # -1 and drop bins
    val = (rng.randint(-4096, 4096, (c, w)) / 1024.0 if dyadic
           else rng.randn(c, w)).astype(np.float32)
    want = np.asarray(j_scatter(jnp.asarray(pos), jnp.asarray(val), rows))
    got = onehot_scatter_add(torch.as_tensor(pos), torch.as_tensor(val), rows)
    if dyadic:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_onehot_scatter_batched_rows_are_independent():
    rng = np.random.RandomState(3)
    pos = rng.randint(-1, 12, (4, 30)).astype(np.int32)
    val = rng.randn(4, 30, 2).astype(np.float32)
    got = onehot_scatter_add(torch.as_tensor(pos), torch.as_tensor(val), 10)
    for i in range(4):
        np.testing.assert_allclose(
            got[i].numpy(), np.asarray(j_scatter(jnp.asarray(pos[i]),
                                                 jnp.asarray(val[i]), 10)),
            rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# spmv_ell
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r,k,n", [(300, 17, 120), (1, 1, 1), (257, 40, 9)])
def test_spmv_ell_matches_pallas(r, k, n):
    rng = np.random.RandomState(r + k)
    cols = rng.randint(-1, n, (r, k)).astype(np.int32)
    wts = rng.rand(r, k).astype(np.float32)
    x = rng.rand(n).astype(np.float32)
    want = np.asarray(j_spmv(jnp.asarray(cols), jnp.asarray(wts),
                             jnp.asarray(x)))
    got = spmv_ell(torch.as_tensor(cols), torch.as_tensor(wts),
                   torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)


def test_spmv_ell_batched_and_validation():
    rng = np.random.RandomState(1)
    cols = rng.randint(-1, 20, (3, 11, 6)).astype(np.int32)
    wts = rng.rand(3, 11, 6).astype(np.float32)
    x = rng.rand(3, 20).astype(np.float32)
    got = spmv_ell(torch.as_tensor(cols), torch.as_tensor(wts),
                   torch.as_tensor(x))
    for i in range(3):
        np.testing.assert_allclose(
            got[i].numpy(), np.asarray(j_spmv(jnp.asarray(cols[i]),
                                              jnp.asarray(wts[i]),
                                              jnp.asarray(x[i]))),
            rtol=1e-5, atol=1e-7)
    with pytest.raises(TypeError):
        spmv_ell(torch.as_tensor(cols).long(), torch.as_tensor(wts),
                 torch.as_tensor(x))
    with pytest.raises(ValueError):
        spmv_ell(torch.as_tensor(cols), torch.as_tensor(wts),
                 torch.as_tensor(x[:2]))


# ---------------------------------------------------------------------------
# sparse-vector ops and the fused merge pipeline, bit for bit on dyadic data
# ---------------------------------------------------------------------------

def _chunk(rng, cap, width, dup=True):
    """Sorted SENTINEL-padded chunk (duplicates allowed) with dyadic values."""
    n = rng.randint(1, cap + 1)
    idx = np.full(cap, SENT, np.uint32)
    raw = rng.randint(0, 3 * cap, n) if dup else rng.choice(4 * cap, n,
                                                           replace=False)
    idx[:n] = np.sort(raw)
    shape = (cap,) if width == 0 else (cap, width)
    val = np.zeros(shape, np.float32)
    val[:n] = rng.randint(-512, 512, (n,) + shape[1:]) / 256.0
    return idx, val


def _assert_chunk(got, want):
    np.testing.assert_array_equal(got.idx.numpy().astype(np.uint32),
                                  np.asarray(want.idx))
    np.testing.assert_array_equal(got.val.numpy(), np.asarray(want.val))


@pytest.mark.parametrize("cap,width,out_cap", [(40, 0, None), (33, 2, 20),
                                               (64, 0, 8)])
def test_sparse_vec_ops_match_reference(cap, width, out_cap):
    rng = np.random.RandomState(cap + width)
    (ia, va), (ib, vb) = _chunk(rng, cap, width), _chunk(rng, cap, width)
    ja = jsv.SparseChunk(idx=jnp.asarray(ia), val=jnp.asarray(va))
    jb = jsv.SparseChunk(idx=jnp.asarray(ib), val=jnp.asarray(vb))
    ta = sv.SparseChunk(idx=_t(ia), val=torch.as_tensor(va))
    tb = sv.SparseChunk(idx=_t(ib), val=torch.as_tensor(vb))
    _assert_chunk(sv.segment_compact(ta, out_cap), jsv.segment_compact(ja, out_cap))
    assert int(sv.compact_overflow(ta, 8)) == int(jsv.compact_overflow(ja, 8))
    _assert_chunk(sv.merge_add(ta, tb, out_cap), jsv.merge_add(ja, jb, out_cap))
    _assert_chunk(sv.tree_sum([ta, tb, ta], out_cap),
                  jsv.tree_sum([ja, jb, ja], out_cap))
    shuffled = np.random.RandomState(0).permutation(cap)
    _assert_chunk(sv.sort_chunk(_t(ia[shuffled]), torch.as_tensor(va[shuffled])),
                  jsv.sort_chunk(jnp.asarray(ia[shuffled]),
                                 jnp.asarray(va[shuffled])))
    q = np.concatenate([ia[:5], np.array([1, 7, SENT], np.uint32)])
    np.testing.assert_array_equal(
        sv.lookup(sv.segment_compact(ta), _t(q)).numpy(),
        np.asarray(jsv.lookup(jsv.segment_compact(ja), jnp.asarray(q))))


@pytest.mark.parametrize("k,cap,width", [(4, 16, 0), (2, 20, 3)])
def test_bucket_partition_and_concat_match_reference(k, cap, width):
    rng = np.random.RandomState(k * cap)
    idx, val = _chunk(rng, 4 * cap, width, dup=False)
    idx = np.where(idx == SENT, SENT, idx.astype(np.uint64) * 1000003
                   % (2**32 - 1)).astype(np.uint32)
    order = np.argsort(idx, kind="stable")
    idx, val = idx[order], val[order]
    edges = np.linspace(0, 2**32 - 1, k + 1).astype(np.uint32)
    jb, jo = jsv.bucket_partition(jsv.SparseChunk(jnp.asarray(idx),
                                                  jnp.asarray(val)),
                                  jnp.asarray(edges), k, cap)
    tb, to = sv.bucket_partition(sv.SparseChunk(_t(idx), torch.as_tensor(val)),
                                 _t(edges), k, cap)
    _assert_chunk(tb, jb)
    assert int(to) == int(jo)
    _assert_chunk(sv.concat_sorted_groups(tb.idx, tb.val),
                  jsv.concat_sorted_groups(jb.idx, jb.val))


@pytest.mark.parametrize("k,cap,width,out_cap", [(4, 24, 0, 96), (2, 33, 2, 40),
                                                 (3, 16, 0, 8)])
def test_merge_sorted_runs_matches_reference(k, cap, width, out_cap):
    """Fused merge == the reference's Pallas fused merge == the port's sort
    path, idx / overflow exact and values bit for bit (dyadic)."""
    rng = np.random.RandomState(k * 100 + cap)
    runs = [_chunk(rng, cap, width, dup=False) for _ in range(k)]
    idx = np.stack([r[0] for r in runs])
    val = np.stack([r[1] for r in runs])
    jc, jovf = jops.merge_sorted_runs(jnp.asarray(idx), jnp.asarray(val),
                                      out_cap)
    tc, tovf = ops.merge_sorted_runs(_t(idx), torch.as_tensor(val), out_cap)
    _assert_chunk(tc, jc)
    assert int(tovf) == int(jovf)
    cat = sv.concat_sorted_groups(_t(idx), torch.as_tensor(val))
    sc = sv.segment_compact(cat, out_cap)
    assert torch.equal(sc.idx, tc.idx) and torch.equal(sc.val, tc.val)
    assert int(sv.compact_overflow(cat, out_cap)) == int(tovf)


def test_kernel_merge_add_and_compact_match_reference():
    rng = np.random.RandomState(21)
    (ia, va), (ib, vb) = _chunk(rng, 30, 0), _chunk(rng, 30, 0)
    ja = jsv.SparseChunk(idx=jnp.asarray(ia), val=jnp.asarray(va))
    jb = jsv.SparseChunk(idx=jnp.asarray(ib), val=jnp.asarray(vb))
    ta = sv.SparseChunk(idx=_t(ia), val=torch.as_tensor(va))
    tb = sv.SparseChunk(idx=_t(ib), val=torch.as_tensor(vb))
    _assert_chunk(ops.merge_add(ta, tb), jops.merge_add(ja, jb))
    _assert_chunk(ops.segment_compact(ta, 20), jops.segment_compact(ja, 20))
    _assert_chunk(sv.merge_add(ta, tb, use_kernel=True), jsv.merge_add(ja, jb))
    _assert_chunk(sv.segment_compact(ta, 20, use_kernel=True),
                  jsv.segment_compact(ja, 20, use_kernel=True))
    # banded mode (unique indices per chunk: at most 2 sources per row)
    (ua, uva), (ub, uvb) = (_chunk(rng, 30, 0, dup=False) for _ in range(2))
    ju = [jsv.SparseChunk(idx=jnp.asarray(i), val=jnp.asarray(v))
          for i, v in ((ua, uva), (ub, uvb))]
    tu = [sv.SparseChunk(idx=_t(i), val=torch.as_tensor(v))
          for i, v in ((ua, uva), (ub, uvb))]
    _assert_chunk(ops.merge_add(*tu, mode="banded"),
                  jops.merge_add(*ju, mode="banded"))
    tc, tovf = ops.merge_sorted_runs(_t(np.stack([ua, ub])),
                                     torch.as_tensor(np.stack([uva, uvb])),
                                     40, mode="banded")
    jc, jovf = jops.merge_sorted_runs(jnp.asarray(np.stack([ua, ub])),
                                      jnp.asarray(np.stack([uva, uvb])), 40,
                                      mode="banded")
    _assert_chunk(tc, jc)
    assert int(tovf) == int(jovf)
    with pytest.raises(ValueError, match="mode"):
        ops.merge_add(*tu, mode="sorted")
