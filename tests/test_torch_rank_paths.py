"""PyTorch port, the two merge-rank kernels' arithmetic on the CPU.

The CUDA kernels run only on the card (``tests/test_torch_gpu.py``); what
they compute is mirrored here in plain PyTorch and held to ``searchsorted``
and to the JAX package's Pallas kernels in interpret mode:

* the dense kernel's merge path: co-ranks per diagonal
  (``ref.merge_path_coranks``) against ``searchsorted``, both tie rules,
  Ca != Cb, and the tile decomposition (each tile's co-ranks inside its own
  slices are the global ones less the tile's start);
* its merge tree over k runs (``ref.merge_tree_ranks_ref``) against
  ``merge_ranks_ref`` and against ranks composed from the JAX
  ``rank_counts``: k in {2, 3, 4, 5, 16}, caps that are no power of two,
  all-equal, SENTINEL-only, SENTINEL tails of different lengths, hashed
  interleaved runs;
* the banded kernel's tile triage (``ref.rank_counts_banded_ref``) against
  the JAX banded kernel with bm != bn, and ``merge_tile_stats`` against
  the JAX ``rank_tile_stats`` summed over the run pairs;
* the closed form the banded kernel gives SENTINEL queries: run r's
  SENTINEL entry i has merge rank i + (runs before r) * cap + the valid
  entries of the runs after r.

Ranks and counts are integers: every comparison is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sparse_vec import HashPerm
from repro.kernels.rank_merge import rank_counts as j_rank_counts
from repro.kernels.rank_merge import rank_tile_stats as j_tile_stats

from repro_torch.kernels import ref
from repro_torch.kernels.rank_merge import merge_ranks, merge_tile_stats

SENT = 0xFFFFFFFF


def _sorted(rng, n, real, hi):
    """Sorted uint32 stream of n entries: ``real`` draws below ``hi``
    (duplicates allowed), then SENTINEL."""
    out = np.full(n, SENT, np.uint32)
    out[:real] = np.sort(rng.randint(0, hi, real).astype(np.uint32))
    return out


def _runs(kind, g, k, cap, seed):
    """[g, k, cap] uint32 sorted runs of one kind."""
    rng = np.random.RandomState(seed)
    if kind == "all_equal":
        return np.full((g, k, cap), 77, np.uint32)
    if kind == "sentinel_only":
        return np.full((g, k, cap), SENT, np.uint32)
    if kind == "tails":        # duplicates and SENTINEL tails of any length
        return np.stack([np.stack([_sorted(rng, cap, rng.randint(0, cap + 1),
                                           3 * cap) for _ in range(k)])
                         for _ in range(g)])
    perm = HashPerm.make(seed)  # "hashed": distinct, interleaved runs
    base = rng.permutation(4 * k * cap).astype(np.uint32)
    out = np.full((g, k, cap), SENT, np.uint32)
    for i in range(g):
        for r in range(k):
            n = cap - (r % 3) * (cap // 4)
            raw = base[r * cap:r * cap + n] + np.uint32(i)
            out[i, r, :n] = np.sort(perm.fwd_np(raw))
    return out


def _t(x):
    return torch.as_tensor(np.asarray(x).astype(np.int64))


# ---------------------------------------------------------------------------
# the merge path: co-ranks and counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ca,cb,hi", [(300, 41, 50), (17, 900, 5000),
                                      (256, 256, 2**32 - 1), (1, 7, 3)])
@pytest.mark.parametrize("side", ["left", "right"])
def test_merge_path_coranks_give_searchsorted_counts(ca, cb, hi, side):
    """Co-ranks of every diagonal are monotone steps of 0 or 1; the steps
    that take a give each a entry its count d - i, which is
    ``searchsorted`` (strict: a first on ties, '<'; else b first, '<=')."""
    rng = np.random.RandomState(ca + cb)
    a = _t(np.stack([_sorted(rng, ca, rng.randint(0, ca + 1), hi)
                     for _ in range(3)]))
    b = _t(np.stack([_sorted(rng, cb, rng.randint(0, cb + 1), hi)
                     for _ in range(3)]))
    d = torch.arange(ca + cb + 1).expand(3, -1).contiguous()
    i = ref.merge_path_coranks(a, b, d, side == "left")
    step = i[:, 1:] - i[:, :-1]
    assert bool(((step == 0) | (step == 1)).all())
    assert torch.equal(i[:, -1], torch.full((3,), ca))
    want = torch.searchsorted(b, a, right=side == "right").to(torch.int32)
    assert torch.equal(ref.merge_path_counts_ref(a, b, side), want)


@pytest.mark.parametrize("tile", [64, 100])
def test_merge_path_tiles_compose(tile):
    """The kernel's two-level partition: a tile's co-ranks searched inside
    its own slices of a and b equal the global co-ranks less the tile's
    start, at every diagonal of the tile."""
    rng = np.random.RandomState(tile)
    a = _t(_sorted(rng, 500, 420, 300))
    b = _t(_sorted(rng, 333, 333, 300))
    n = 833
    glob = ref.merge_path_coranks(a, b, torch.arange(n + 1), True)
    for d0 in range(0, n, tile):
        d1 = min(d0 + tile, n)
        i0, i1 = int(glob[d0]), int(glob[d1])
        j0, j1 = d0 - i0, d1 - i1
        local = ref.merge_path_coranks(a[i0:i1], b[j0:j1],
                                       torch.arange(d1 - d0 + 1), True)
        assert torch.equal(local + i0, glob[d0:d1 + 1])


# ---------------------------------------------------------------------------
# the merge tree over k runs
# ---------------------------------------------------------------------------

def _jax_merge_ranks(runs):
    """Ranks composed from the JAX Pallas ``rank_counts`` (interpret mode)
    with the stable tie-break strict = (s > r)."""
    g, k, cap = runs.shape
    out = np.zeros(runs.shape, np.int64)
    for i in range(g):
        for r in range(k):
            want = np.arange(cap)
            for s in range(k):
                if s != r:
                    want = want + np.asarray(j_rank_counts(
                        jnp.asarray(runs[i, r]), jnp.asarray(runs[i, s]),
                        strict=s > r))
            out[i, r] = want
    return out


@pytest.mark.parametrize("kind,k,cap", [
    ("tails", 2, 37), ("tails", 3, 50), ("hashed", 4, 33),
    ("hashed", 5, 29), ("tails", 16, 13), ("all_equal", 5, 11),
    ("sentinel_only", 3, 21)])
def test_merge_tree_equals_merge_ranks_and_pallas(kind, k, cap):
    runs = _runs(kind, 2, k, cap, seed=k * cap)
    got = ref.merge_tree_ranks_ref(_t(runs))
    assert got.dtype == torch.int32
    assert torch.equal(got, ref.merge_ranks_ref(_t(runs)))
    assert torch.equal(got, merge_ranks(_t(runs)))
    np.testing.assert_array_equal(got.numpy(), _jax_merge_ranks(runs))
    for g in range(2):
        assert sorted(got[g].reshape(-1).tolist()) == list(range(k * cap))


# ---------------------------------------------------------------------------
# the banded kernel's tile triage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["tails", "hashed", "all_equal",
                                  "sentinel_only"])
@pytest.mark.parametrize("bm,bn", [(128, 64), (48, 200)])
@pytest.mark.parametrize("strict", [True, False])
def test_banded_triage_matches_pallas(kind, bm, bn, strict):
    runs = _runs(kind, 1, 2, 700, seed=bm + bn)
    a, b = runs[0, 0, :600], runs[0, 1]
    want = np.asarray(j_rank_counts(jnp.asarray(a), jnp.asarray(b),
                                    strict=strict, bm=bm, bn=bn, banded=True))
    got = ref.rank_counts_banded_ref(_t(a), _t(b),
                                     "left" if strict else "right", bm, bn)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind,k,cap,bm,bn", [
    ("hashed", 4, 300, 64, 48), ("tails", 5, 257, 100, 32),
    ("sentinel_only", 3, 100, 32, 64), ("all_equal", 3, 90, 40, 25)])
def test_merge_tile_stats_equal_pallas_sums(kind, k, cap, bm, bn):
    """``merge_tile_stats`` is the JAX ``rank_tile_stats`` summed over
    every ordered run pair (strict for s > r), and the banded merge ranks
    through the same tiles are the dense ones."""
    runs = _runs(kind, 2, k, cap, seed=cap)
    want = dict.fromkeys(("total_tiles", "full_below_tiles",
                          "skipped_tiles", "frontier_tiles"), 0)
    for g in range(2):
        for r in range(k):
            for s in range(k):
                if s != r:
                    st = j_tile_stats(runs[g, r], runs[g, s], strict=s > r,
                                      bm=bm, bn=bn)
                    for key in want:
                        want[key] += st[key]
    assert merge_tile_stats(_t(runs), bm=bm, bn=bn) == want
    assert torch.equal(merge_ranks(_t(runs), banded=True, bm=bm, bn=bn),
                       ref.merge_ranks_ref(_t(runs)))


@pytest.mark.parametrize("kind", ["tails", "hashed", "sentinel_only"])
def test_sentinel_entries_have_a_closed_form(kind):
    k, cap = 5, 40
    runs = _runs(kind, 2, k, cap, seed=7)
    ranks = ref.merge_ranks_ref(_t(runs)).numpy()
    valid = (runs != SENT).sum(-1)
    for g in range(2):
        for r in range(k):
            for i in np.flatnonzero(runs[g, r] == SENT):
                assert ranks[g, r, i] == i + r * cap + valid[g, r + 1:].sum()
    a, b = _t(runs[:, 0]), _t(runs[:, 1])
    sent = a == SENT
    left = ref.rank_counts_ref(a, b, "left")
    right = ref.rank_counts_ref(a, b, "right")
    vb = torch.as_tensor(valid[:, 1]).unsqueeze(1).expand(a.shape)
    assert torch.equal(left[sent], vb[sent].to(torch.int32))
    assert bool((right[sent] == cap).all())
