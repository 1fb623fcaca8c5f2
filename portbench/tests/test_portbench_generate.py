"""The traffic generators: equal seeds give equal inputs, large seeds
work, and the layouts are what the program expects."""
import numpy as np
import pytest
import torch

from portbench import generate, weights

SEEDS = (0, 2**31 + 11, 2**40 + 3)


def _gen(seed, stream=0):
    return generate.generator(seed, "cpu", stream)


@pytest.mark.parametrize("seed", SEEDS)
def test_powerlaw_edges_repeat_by_seed(seed):
    a = generate.powerlaw_edges(1000, 5000, 2.0, _gen(seed))
    b = generate.powerlaw_edges(1000, 5000, 2.0, _gen(seed))
    c = generate.powerlaw_edges(1000, 5000, 2.0, _gen(seed + 1))
    assert torch.equal(a, b) and not torch.equal(a[:100], c[:100])
    assert bool((a[:, 0] != a[:, 1]).all()) and int(a.max()) < 1000
    assert a.shape[0] > 4500


def test_edge_partition_index_sets_match_brute_force():
    edges = generate.powerlaw_edges(500, 4000, 2.0, _gen(5))
    g = generate.edge_partition(edges, 500, 8, _gen(6))
    src, dst = g["src"].numpy(), g["dst"].numpy()
    ec = np.cumsum(g["edge_counts"].numpy())[:-1]
    ic = np.cumsum(g["in_counts"].numpy())[:-1]
    oc = np.cumsum(g["out_counts"].numpy())[:-1]
    assert sorted(map(tuple, edges.tolist())) == \
        sorted(zip(src.tolist(), dst.tolist()))
    outdeg = np.bincount(edges[:, 0].numpy(), minlength=500).clip(min=1)
    for s, d, inn, out, sp, dp, w in zip(
            np.split(src, ec), np.split(dst, ec),
            np.split(g["in_idx"].numpy(), ic),
            np.split(g["out_idx"].numpy(), oc),
            np.split(g["src_pos"].numpy(), ec),
            np.split(g["dst_pos"].numpy(), ec),
            np.split(g["inv_outdeg"].numpy(), ec)):
        assert np.array_equal(inn, np.unique(s))
        assert np.array_equal(out, np.unique(d))
        assert np.array_equal(inn[sp], s) and np.array_equal(out[dp], d)
        assert np.allclose(w, 1.0 / outdeg[s])


def test_rank_cdf_is_the_chung_lu_law():
    """Rank k's mass is k ** (-1 / (alpha - 1)) over their sum; alpha 2
    gives Zipf(1)."""
    n = 1000
    cdf = generate.rank_cdf(n, 2.0, "cpu").numpy()
    w = 1.0 / np.arange(1, n + 1)
    assert np.abs(cdf - np.cumsum(w) / w.sum()).max() < 1e-12
    w = np.arange(1, n + 1) ** (-1.0 / 1.2)
    assert np.abs(generate.rank_cdf(n, 2.2, "cpu").numpy()
                  - np.cumsum(w) / w.sum()).max() < 1e-12


def test_hash_ids_is_the_affine_xor_bijection():
    mult, xor = generate.hash_keys(_gen(3))
    ids = torch.arange(0, 1 << 20, 7, dtype=torch.int64)
    got = generate.hash_ids(ids, mult, xor).numpy().astype(np.uint64)
    want = ((ids.numpy().astype(np.uint64) ^ np.uint64(xor))
            * np.uint64(mult)) % np.uint64(1 << 32)
    assert mult % 2 == 1 and np.array_equal(got, want)
    assert len(np.unique(got)) == len(got)


@pytest.mark.parametrize("seed", SEEDS)
def test_hashed_layout_is_sorted_coalesced_and_padded(seed):
    gen = _gen(seed)
    cdf = generate.rank_cdf(1 << 12, 2.0, "cpu")
    ranks = generate.draw_ranks(cdf, 4 * 1000, gen).reshape(4, 1000)
    vals = generate.dyadic_values((4, 1000), 8, -10, gen)
    mult, xor = generate.hash_keys(gen)
    idx, val = generate.hashed_layout(ranks, vals, 1024, mult, xor)
    h = generate.hash_ids(ranks, mult, xor)
    for n in range(4):
        want = {}
        for i, v in zip(h[n].tolist(), vals[n].tolist()):
            want[i] = want.get(i, 0.0) + v
        keys = sorted(want)
        row = idx[n].tolist()
        assert row[: len(keys)] == keys
        assert all(x == generate.SENTINEL for x in row[len(keys):])
        assert val[n, : len(keys)].tolist() == [want[k] for k in keys]
    with pytest.raises(ValueError):
        generate.hashed_layout(ranks, vals, 16, mult, xor)


@pytest.mark.parametrize("seed", SEEDS)
def test_tokens_values_and_weights_repeat_by_seed(seed):
    a = generate.zipf_tokens((3, 50), 100, 1.2, _gen(seed))
    assert torch.equal(a, generate.zipf_tokens((3, 50), 100, 1.2, _gen(seed)))
    assert int(a.min()) >= 0 and int(a.max()) < 100
    v = generate.dyadic_values((100,), 8, -10, _gen(seed))
    assert torch.equal(v * 1024, (v * 1024).round()) and float(v.abs().max()) <= 8 / 1024
    w1 = weights.leaf(("head",), (16, 32), torch.bfloat16, seed, "cpu")
    w2 = weights.leaf(("head",), (16, 32), torch.bfloat16, seed, "cpu")
    w3 = weights.leaf(("emb",), (16, 32), torch.bfloat16, seed, "cpu")
    assert torch.equal(w1, w2) and not torch.equal(w1, w3)
    assert not bool(weights.leaf(("final_ln",), (8,), torch.float32, seed,
                                 "cpu").any())
