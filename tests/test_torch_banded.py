"""PyTorch port, banded merge kernels and wire-typed scatters: held to the
Pallas kernels in interpret mode, as the JAX package's own tests run them.

The port's wrappers run their plain versions on CPU tensors; the CUDA
kernels are held to those on the card by ``tests/test_torch_gpu.py``.

* ``rank_counts(banded=True)``: exact against the reference's banded
  kernel, strict and non-strict, tiles of 512 and 128, all-equal and
  SENTINEL-only streams; ``rank_tile_stats`` returns the reference's dict;
* ``onehot_scatter_add`` with bf16 values and with an int8 + scale
  payload, and ``banded_onehot_scatter_add`` unscaled and scaled (int8
  and bf16 values), including a C that is a block multiple: bit for bit
  on dyadic values and scales, rtol 1e-6 where a general scale is applied
  (the reference sums its one-hot products in another order);
* ``ops.merge_sorted_runs(mode="banded", row_scale=, out_dtype=)``,
  ``merge_add(mode="banded")`` and ``segment_compact(max_dup=)``: indices
  and overflow exact, values as above.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparse_vec as jsv
from repro.core.sparse_vec import HashPerm
from repro.kernels import ops as jops
from repro.kernels.onehot_scatter import band_inner_tiles as j_band_tiles
from repro.kernels.onehot_scatter import banded_onehot_scatter_add as j_banded
from repro.kernels.onehot_scatter import onehot_scatter_add as j_scatter
from repro.kernels.rank_merge import rank_counts as j_rank_counts
from repro.kernels.rank_merge import rank_tile_stats as j_tile_stats

from repro_torch.core import sparse_vec as sv
from repro_torch.kernels import ops
from repro_torch.kernels.onehot_scatter import (band_inner_tiles,
                                                banded_onehot_scatter_add,
                                                onehot_scatter_add)
from repro_torch.kernels.rank_merge import (merge_ranks, rank_counts,
                                            rank_tile_stats)

# one intra-op thread a test process: pytest-xdist runs several workers
# at once, and their OpenMP threads would oversubscribe the cores
torch.set_num_threads(1)

SENT = 0xFFFFFFFF


def _t(x):
    return torch.as_tensor(np.asarray(x).astype(np.int64))


def _sorted_stream(rng, n, real, hi=2**32 - 1):
    out = np.full(n, SENT, np.uint32)
    vals = np.unique(rng.randint(0, hi, 4 * real + 64, dtype=np.uint64))
    out[:real] = np.sort(rng.permutation(vals)[:real])
    return out


def _streams(kind, rng):
    if kind == "random":
        return (_sorted_stream(rng, 1100, 900, hi=20000),
                _sorted_stream(rng, 700, 650, hi=20000))
    if kind == "all_equal":
        return np.full(600, 77, np.uint32), np.full(530, 77, np.uint32)
    if kind == "sentinel_only":
        return np.full(300, SENT, np.uint32), np.full(520, SENT, np.uint32)
    # hash-unique interleaved streams, the butterfly's case
    perm = HashPerm.make(2)
    return (np.sort(perm.fwd_np(np.arange(1500, dtype=np.uint32))),
            np.sort(perm.fwd_np(np.arange(1500, 2700, dtype=np.uint32))))


# ---------------------------------------------------------------------------
# rank_counts(banded=True) and the tile report
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["random", "all_equal", "sentinel_only",
                                  "hashed"])
@pytest.mark.parametrize("tile", [512, 128])
@pytest.mark.parametrize("strict", [True, False])
def test_banded_rank_counts_match_pallas(kind, tile, strict):
    rng = np.random.RandomState(tile + len(kind))
    a, b = _streams(kind, rng)
    want = np.asarray(j_rank_counts(jnp.asarray(a), jnp.asarray(b),
                                    strict=strict, bm=tile, bn=tile,
                                    banded=True))
    got = rank_counts(_t(a), _t(b), strict=strict, banded=True, bm=tile,
                      bn=tile)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), rank_counts(_t(a), _t(b), strict=strict).numpy())
    assert rank_tile_stats(a, b, strict=strict, bm=tile, bn=tile) == \
        j_tile_stats(a, b, strict=strict, bm=tile, bn=tile)


def test_banded_merge_ranks_equal_dense():
    """One k-way launch form: the banded merge ranks are the dense ones,
    batched over groups, for query tiles that do and do not divide cap."""
    rng = np.random.RandomState(3)
    runs = np.stack([np.stack([_sorted_stream(rng, 300, rng.randint(0, 300),
                                              hi=3000) for _ in range(4)])
                     for _ in range(2)])
    dense = merge_ranks(_t(runs))
    for bm in (512, 128, 7):
        assert torch.equal(merge_ranks(_t(runs), banded=True, bm=bm), dense)
    with pytest.raises(ValueError, match="bm"):
        merge_ranks(_t(runs), banded=True, bm=2048)


# ---------------------------------------------------------------------------
# scatter-adds: wire-typed values and the banded kernel
# ---------------------------------------------------------------------------

def _payload(rng, c, w, dtype, dyadic_scale):
    """(torch val, jnp val, scale or None) for one wire dtype."""
    if dtype == "int8":
        q = rng.randint(-127, 128, (c, w)).astype(np.int8)
        scale = (2.0 ** rng.randint(-8, 0, c) if dyadic_scale
                 else rng.rand(c) + 0.01).astype(np.float32)
        return torch.as_tensor(q), jnp.asarray(q), scale
    v = (rng.randint(-512, 512, (c, w)) / 64.0).astype(np.float32)
    if dtype == "bf16":
        t = torch.as_tensor(v).to(torch.bfloat16)
        return t, jnp.asarray(v).astype(jnp.bfloat16), None
    return torch.as_tensor(v), jnp.asarray(v), None


def _assert_sum(got, want, exact):
    if exact:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("dtype,dyadic", [("bf16", True), ("int8", True),
                                          ("int8", False)])
def test_onehot_scatter_wire_types_match_pallas(dtype, dyadic):
    rng = np.random.RandomState(len(dtype) + dyadic)
    c, w, rows = 700, 2, 150
    pos = rng.randint(-1, rows + 2, c).astype(np.int32)
    tv, jv, scale = _payload(rng, c, w, dtype, dyadic)
    ts = None if scale is None else torch.as_tensor(scale)
    js = None if scale is None else jnp.asarray(scale)
    got = onehot_scatter_add(torch.as_tensor(pos), tv, rows, scale=ts)
    _assert_sum(got, j_scatter(jnp.asarray(pos), jv, rows, scale=js), dyadic)
    assert got.dtype == torch.float32


@pytest.mark.parametrize("dtype,scaled,dyadic", [
    ("f32", False, True), ("bf16", False, True), ("int8", True, True),
    ("int8", True, False), ("bf16", True, True)])
def test_banded_scatter_matches_pallas(dtype, scaled, dyadic):
    """Monotone pos with up to ``band`` sources per row, the drop bin and
    padding parked at the tail."""
    rng = np.random.RandomState(len(dtype) * 3 + scaled + dyadic)
    band, rows = 4, 300
    pos_np = np.repeat(np.arange(rows), rng.randint(0, band + 1, rows))
    pos_np = np.concatenate([pos_np, np.full(37, rows)]).astype(np.int32)
    c, w = len(pos_np), 3
    tv, jv, scale = _payload(rng, c, w, dtype, dyadic)
    if scaled and scale is None:
        scale = (2.0 ** rng.randint(-4, 0, c)).astype(np.float32)
    ts = torch.as_tensor(scale) if scaled else None
    js = jnp.asarray(scale) if scaled else None
    got = banded_onehot_scatter_add(torch.as_tensor(pos_np), tv, rows,
                                    band=band, scale=ts)
    _assert_sum(got, j_banded(jnp.asarray(pos_np), jv, rows, band=band,
                              scale=js), dyadic)
    assert torch.equal(got, onehot_scatter_add(torch.as_tensor(pos_np), tv,
                                               rows, scale=ts))


def test_banded_scatter_block_multiple_boundary():
    """C an exact multiple of the reference's bk with source-less output
    tiles past the last destination (the reference's start-block clamp)."""
    band, rows, bk = 8, 64, 512
    pos_np = np.repeat(np.arange(rows), band).astype(np.int32)   # c == bk
    val = np.arange(len(pos_np), dtype=np.float32)[:, None]
    for scale in (None, np.full(len(pos_np), 0.5, np.float32)):
        got = banded_onehot_scatter_add(
            torch.as_tensor(pos_np), torch.as_tensor(val), 1024, band=band,
            scale=None if scale is None else torch.as_tensor(scale))
        want = j_banded(jnp.asarray(pos_np), jnp.asarray(val), 1024,
                        band=band, bk=bk,
                        scale=None if scale is None else jnp.asarray(scale))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_scatter_guards_and_band_tiles():
    pos = torch.zeros(4, dtype=torch.int32)
    q = torch.zeros(4, 1, dtype=torch.int8)
    with pytest.raises(TypeError, match="scale"):
        onehot_scatter_add(pos, q, 2)
    with pytest.raises(TypeError, match="float32"):
        onehot_scatter_add(pos, torch.zeros(4, 1, dtype=torch.float64), 2)
    with pytest.raises(ValueError, match="scale"):
        onehot_scatter_add(pos, q, 2, scale=torch.ones(3))
    with pytest.raises(ValueError, match="band"):
        banded_onehot_scatter_add(pos, q.float(), 2, band=0)
    for band, bm, bk in ((4, 128, 512), (16, 128, 512), (1, 7, 3)):
        assert band_inner_tiles(band, bm, bk) == j_band_tiles(band, bm, bk)


# ---------------------------------------------------------------------------
# pipelines: banded merges with wire-typed values
# ---------------------------------------------------------------------------

def _runs(k, cap, width, seed):
    """k sorted SENTINEL-padded runs of hashed Zipf indices, unique per run
    (the butterfly invariant), with dyadic values."""
    rng = np.random.RandomState(seed)
    perm = HashPerm.make(seed + 1)
    idx = np.full((k, cap), SENT, np.uint32)
    vshape = (k, cap) if width == 0 else (k, cap, width)
    val = np.zeros(vshape, np.float32)
    for r in range(k):
        h = np.unique(perm.fwd_np((rng.zipf(1.6, cap * 2) % 5000)
                                  .astype(np.uint32)))
        n = min(len(h), rng.randint(1, cap + 1))
        idx[r, :n] = h[:n]
        val[r, :n] = rng.randint(-128, 129, (n,) + vshape[2:]) / 64.0
    return idx, val


def _assert_chunk(got, want, exact=True):
    np.testing.assert_array_equal(got.idx.numpy().astype(np.uint32),
                                  np.asarray(want.idx))
    _assert_sum(got.val, want.val, exact)


@pytest.mark.parametrize("k,cap,width,out_cap", [(4, 40, 0, 160), (8, 24, 2, 60),
                                                 (2, 50, 0, 16)])
def test_banded_merge_sorted_runs_match_pallas(k, cap, width, out_cap):
    idx, val = _runs(k, cap, width, seed=k * 10 + width)
    jc, jovf = jops.merge_sorted_runs(jnp.asarray(idx), jnp.asarray(val),
                                      out_cap, mode="banded")
    tc, tovf = ops.merge_sorted_runs(_t(idx), torch.as_tensor(val), out_cap,
                                     mode="banded")
    _assert_chunk(tc, jc)
    assert int(tovf) == int(jovf)
    fc, fovf = ops.merge_sorted_runs(_t(idx), torch.as_tensor(val), out_cap,
                                     mode="fused")
    assert torch.equal(fc.idx, tc.idx) and torch.equal(fc.val, tc.val)
    # int8 payload with a per-run scale, decoded inside the scatter
    for dyadic in (True, False):
        rng = np.random.RandomState(k + dyadic)
        q = rng.randint(-127, 128, val.shape).astype(np.int8)
        rs = (2.0 ** -rng.randint(1, 8, k) if dyadic
              else rng.rand(k) + 0.1).astype(np.float32)
        jc, _ = jops.merge_sorted_runs(jnp.asarray(idx), jnp.asarray(q),
                                       out_cap, mode="banded",
                                       row_scale=jnp.asarray(rs),
                                       out_dtype=jnp.float32)
        tc, _ = ops.merge_sorted_runs(_t(idx), torch.as_tensor(q), out_cap,
                                      mode="banded",
                                      row_scale=torch.as_tensor(rs),
                                      out_dtype=torch.float32)
        assert tc.val.dtype == torch.float32
        _assert_chunk(tc, jc, exact=dyadic)
    # bf16 payload, f32 output
    jc, _ = jops.merge_sorted_runs(jnp.asarray(idx),
                                   jnp.asarray(val).astype(jnp.bfloat16),
                                   out_cap, mode="banded",
                                   out_dtype=jnp.float32)
    tc, _ = ops.merge_sorted_runs(_t(idx), torch.as_tensor(val).bfloat16(),
                                  out_cap, mode="banded",
                                  out_dtype=torch.float32)
    _assert_chunk(tc, jc)


def test_banded_merge_add_and_segment_compact_match_pallas():
    (ia, va), (ib, vb) = (tuple(x[0] for x in _runs(1, 60, 0, seed=s))
                          for s in (5, 6))
    ja = jsv.SparseChunk(idx=jnp.asarray(ia), val=jnp.asarray(va))
    jb = jsv.SparseChunk(idx=jnp.asarray(ib), val=jnp.asarray(vb))
    ta = sv.SparseChunk(idx=_t(ia), val=torch.as_tensor(va))
    tb = sv.SparseChunk(idx=_t(ib), val=torch.as_tensor(vb))
    for cap in (None, 50):
        _assert_chunk(ops.merge_add(ta, tb, cap, mode="banded"),
                      jops.merge_add(ja, jb, cap, mode="banded"))
    # a sorted chunk with duplicates (at most 3 per index)
    rng = np.random.RandomState(8)
    idx = np.sort(np.repeat(rng.choice(1000, 40, replace=False),
                            rng.randint(1, 4, 40))).astype(np.uint32)
    idx = np.concatenate([idx, np.full(9, SENT, np.uint32)])
    val = (rng.randint(-64, 64, (len(idx), 2)) / 8.0).astype(np.float32)
    val[idx == SENT] = 0
    jc = jsv.SparseChunk(idx=jnp.asarray(idx), val=jnp.asarray(val))
    tc = sv.SparseChunk(idx=_t(idx), val=torch.as_tensor(val))
    for cap in (None, 20):
        want = jops.segment_compact(jc, cap, max_dup=3)
        _assert_chunk(ops.segment_compact(tc, cap, max_dup=3), want)
        _assert_chunk(sv.segment_compact(tc, cap), want)
