"""PyTorch port, the overlapped schedules held to ``repro.train.step`` and the plain ones.

``plan_grad_buckets`` equals the reference's (imported in this process:
a pure function) on hypothesis-drawn leaf sizes and budgets, and keeps
its contract: an order-preserving exact cover whose buckets stay within
the byte budget unless a bucket is one oversized leaf.  The bucketed
hier sync (``sync_overlap="bucketed"``) against ``"off"`` on general
floats, at (data, model) = (4, 1) and on the (pod, data, model) = (2, 2,
1) mesh, ``hier`` and ``sparse``: every synced leaf bit for bit (each
element is summed over the same members in the same order), with ``2 *
depth`` exchanges a bucket, issued stage-major, and the same bits when a
leaf is cut into ``HIER_BLOCK`` windows.  ``GraphEngine(overlap=True)``
against the plain engine on a dyadic app and on PageRank, k in {1, 2, 3,
6}, ``collect="last"`` and ``"trajectory"``: final state, last product
and trajectory bit for bit, ``2 * depth`` exchanges a round.  The
launcher's ``--sync-overlap bucketed`` trains as ``off`` does; the
settings checks fire before any plan is built.
"""
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.train.step import plan_grad_buckets as ref_plan_grad_buckets

from repro_torch.configs import get_config
from repro_torch.core.allreduce import (dense_allreduce_hierarchical,
                                        dense_allreduce_hierarchical_bucketed,
                                        make_device_plan)
from repro_torch.core.transport import StackedTransport
from repro_torch.data.pipeline import powerlaw_graph
from repro_torch.graph.engine import EngineApp, GraphEngine
from repro_torch.graph.pagerank import (build_partitions, make_pagerank_app,
                                        pagerank_state)
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as T
from repro_torch.train import step as S

# one intra-op thread a test process: pytest-xdist runs several workers
# at once, and their OpenMP threads would oversubscribe the cores
torch.set_num_threads(1)

SIZES = st.lists(st.integers(min_value=0, max_value=5000), min_size=0,
                 max_size=40)


@given(SIZES, st.integers(min_value=1, max_value=4000))
@settings(max_examples=40, deadline=None)
def test_plan_grad_buckets_equals_reference(sizes, bucket_bytes):
    """The port's partition is the reference's, and an order-preserving
    exact cover within the byte budget (or one oversized leaf)."""
    got = S.plan_grad_buckets(sizes, bucket_bytes)
    assert got == [list(b) for b in ref_plan_grad_buckets(sizes,
                                                          bucket_bytes)]
    assert [i for b in got for i in b] == list(range(len(sizes)))
    for b in got:
        assert b and (sum(sizes[i] * 4 for i in b) <= bucket_bytes
                      or len(b) == 1)


def test_plan_grad_buckets_cases_and_validation():
    """The reference's own fixed cases, and its errors."""
    assert S.plan_grad_buckets([10, 10, 10], 80) == [[0, 1], [2]]
    assert S.plan_grad_buckets([10, 11], 80) == [[0], [1]]
    assert S.plan_grad_buckets([2, 100, 2], 16) == [[0], [1], [2]]
    assert S.plan_grad_buckets([0, 0, 4], 16) == [[0, 1, 2]]
    assert S.plan_grad_buckets([], 16) == []
    with pytest.raises(ValueError, match="bucket_bytes"):
        S.plan_grad_buckets([1], 0)
    with pytest.raises(ValueError, match="bytes_per_elem"):
        S.plan_grad_buckets([1], 64, bytes_per_elem=0)
    with pytest.raises(ValueError, match="leaf size"):
        S.plan_grad_buckets([4, -1], 64)


class _Log(StackedTransport):
    """A transport that logs each exchange: (kind, layer, width)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.log = []

    def reduce_scatter(self, layer, x):
        self.log.append(("rs", layer, x.shape[1]))
        return super().reduce_scatter(layer, x)

    def all_gather(self, layer, *xs):
        self.log.append(("ag", layer, xs[0].shape[1]))
        return super().all_gather(layer, *xs)


def test_bucketed_butterfly_is_stage_major_and_equal():
    """Three buckets over degrees (2, 2): each equals its own
    ``dense_allreduce_hierarchical`` bit for bit; the exchanges run every
    bucket's stage-0 reduce-scatter, then every stage-1 one, then the
    all-gathers in reverse stage order, 2 * depth * 3 in all."""
    plan = make_device_plan([("data", 4)], {"data": (2, 2)}, 8, 8)
    tr = _Log(plan.logical, "cpu")
    gen = torch.Generator().manual_seed(3)
    xs = [torch.randn(4, n, generator=gen) for n in (8, 16, 4)]
    got = dense_allreduce_hierarchical_bucketed(xs, plan, tr)
    for x, g in zip(xs, got):
        assert torch.equal(g, dense_allreduce_hierarchical(
            x, plan, StackedTransport(plan.logical, "cpu")))
    assert [e[:2] for e in tr.log] == (
        [("rs", 0)] * 3 + [("rs", 1)] * 3 + [("ag", 1)] * 3
        + [("ag", 0)] * 3)
    assert tr.calls == 2 * 2 * 3
    with pytest.raises(ValueError, match="divisible"):
        dense_allreduce_hierarchical_bucketed([torch.zeros(4, 6)], plan, tr)


def _cfg():
    return dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                               tie_embeddings=False)


def _general_grads(cfg):
    gen = torch.Generator().manual_seed(9)
    like = T.init_params(cfg, 1, device="cpu")
    return T.tree_from_leaves(like, [
        (p, torch.randn(t.shape, generator=gen)
         * torch.exp(2 * torch.randn(t.shape, generator=gen)))
        for p, t in T.tree_leaves(like)])


@pytest.mark.parametrize("sync,pod", [("hier", 1), ("sparse", 2)])
def test_bucketed_sync_equals_off_on_general_floats(sync, pod):
    """``make_sync_fn`` with ``sync_overlap="bucketed"`` (a 16 KiB budget:
    several buckets of small leaves, the large ones alone) against
    ``"off"`` at (4, 1) and (2, 2, 1), on normal floats of a wide range:
    every synced leaf of every position bit for bit, the overflow too."""
    cfg = _cfg()
    mc = S.mesh_ctx(4 // pod, pod=pod, device="cpu")
    degrees = {"pod": (2,), "data": (2,)} if pod > 1 else {"data": (2, 2)}
    grads = _general_grads(cfg)
    tokens = np.random.RandomState(1).randint(0, cfg.vocab, (8, 32))
    out = []
    for overlap in ("off", "bucketed"):
        fn, _ = S.make_sync_fn(cfg, mc, sync=sync, dp_degrees=degrees,
                               sync_merge="fused", sync_overlap=overlap,
                               sync_bucket_bytes=16 << 10,
                               sparse_tokens_hint=64)
        out.append(fn(grads, tokens))
    (a, oa), (b, ob) = out
    assert torch.equal(oa, ob)
    for (path, x), (_, y) in zip(T.tree_leaves(a), T.tree_leaves(b)):
        assert torch.equal(x, y), path


@pytest.mark.parametrize("block", [None, 64, 8])
def test_bucketed_leaves_count_exchanges_and_keep_bits(monkeypatch, block):
    """``_bucketed_hier_leaves`` on bfloat16 leaves of mixed sizes (one
    not a multiple of M): the bits of each leaf's own blocked butterfly,
    row 0 in float32 for a captured leaf, ``2 * depth`` exchanges a
    bucket; with ``HIER_BLOCK`` small the windows and an oversized leaf's
    column blocks keep the bits (``2 * depth`` exchanges a block)."""
    m = 4
    if block is not None:
        monkeypatch.setattr(S, "HIER_BLOCK", block)
    plan = make_device_plan([("data", m)], {"data": (2, 2)}, 8, 8)
    gen = torch.Generator().manual_seed(5)
    shapes = [(m, 3), (m, 5, 4), (m, 2), (m, 37), (m, 1)]
    gs = [torch.randn(sh, generator=gen).to(torch.bfloat16) for sh in shapes]
    want = [S._hier_allreduce_leaf(g, plan, StackedTransport(plan.logical,
                                                             "cpu"))
            for g in gs]
    tr = StackedTransport(plan.logical, "cpu")
    caps = [None, {}, None, None, None]
    got = S._bucketed_hier_leaves(list(gs), plan, tr, 96, captures=caps)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    cap = {}
    S._hier_allreduce_leaf(gs[1], plan, StackedTransport(plan.logical,
                                                         "cpu"), capture=cap)
    assert torch.equal(caps[1]["f32"], cap["f32"])
    padded = [int(np.prod(sh[1:])) + (-int(np.prod(sh[1:]))) % m
              for sh in shapes]
    buckets = S.plan_grad_buckets(padded, 96)
    if block is None:
        assert tr.calls == 2 * 2 * len(buckets)
    row = S._bucketed_hier_leaves(list(gs), plan, tr, 96, row=0)
    assert all(torch.equal(a, b[0]) for a, b in zip(row, want))


def test_sync_overlap_settings_are_checked_first():
    """The reference's checks, before any mesh or plan work (``None``
    stands for the config and the mesh)."""
    with pytest.raises(ValueError, match="ring sync is a single psum"):
        S.make_train_step(None, None, sync="ring", sync_overlap="bucketed")
    with pytest.raises(ValueError, match="ring sync is a single psum"):
        S.make_sync_fn(None, None, sync="ring", sync_overlap="bucketed")
    with pytest.raises(ValueError, match="sync_overlap must be one of"):
        S.make_train_step(None, None, sync="hier", sync_overlap="eager")
    with pytest.raises(ValueError, match="overlap must be one of"):
        S.sync_grads({}, _cfg(), S.mesh_ctx(2, device="cpu"), "hier", None,
                     None, overlap="eager")


def _dyadic_engine(overlap):
    """A dyadic app over 8 nodes of 2 degrees: out = half each node's
    first u_cap state entries plus a base, update = a quarter of the
    reduced values plus half the state; every sum exact."""
    rng = np.random.RandomState(4)
    out_sets = [np.sort(rng.choice(200, 40, replace=False)).astype(np.uint32)
                for _ in range(8)]
    in_sets = [np.sort(rng.choice(200, 30, replace=False)).astype(np.uint32)
               for _ in range(8)]
    app = EngineApp(
        out_fn=lambda s, e: s[:, e["pick"]] * 0.5 + e["base"],
        update_fn=lambda s, i, e, tr: i * 0.25 + s * 0.5, name="dyadic")
    eng = GraphEngine(out_sets, in_sets, app, degrees=(4, 2), device="cpu",
                      overlap=overlap)
    pick = torch.as_tensor(rng.randint(0, eng.uin_cap, eng.u_cap))
    base = torch.as_tensor(rng.randint(-8, 9, (8, eng.u_cap)) / 8.0,
                           dtype=torch.float32)
    s0 = torch.as_tensor(rng.randint(-16, 17, (8, eng.uin_cap)) / 16.0,
                         dtype=torch.float32)
    return eng, s0, {"pick": pick, "base": base}


def _pagerank_engine(overlap):
    n = 1500
    parts = build_partitions(powerlaw_graph(n, 9000, seed=3), n, 8)
    app, o, i = make_pagerank_app(parts, n)
    eng = GraphEngine(o, i, app, degrees=(4, 2), device="cpu",
                      overlap=overlap)
    extras, p0 = pagerank_state(parts, n, eng.u_cap, eng.uin_cap,
                                device="cpu")
    return eng, p0, extras


@pytest.mark.parametrize("make", [_dyadic_engine, _pagerank_engine],
                         ids=["dyadic", "pagerank"])
def test_engine_overlap_equals_plain(make):
    """The rotated schedule against the plain one for k in {1, 2, 3, 6}
    and both collects: final state, last product and trajectory bit for
    bit, ``2 * depth`` exchanges a round; the report says which."""
    plain, s0, extras = make(False)
    rot, _, _ = make(True)
    for k in (1, 2, 3, 6):
        for collect in ("last", "trajectory"):
            want = plain.run(k, s0, extras, collect=collect)
            calls = rot.transport.calls
            got = rot.run(k, s0, extras, collect=collect)
            assert rot.transport.calls - calls == 2 * rot.planned.depth * k
            for a, b in zip(got, want):
                assert (a is None and b is None) or torch.equal(a, b), \
                    (k, collect)
            eager = rot.eager_fn(k, collect)(s0, extras)
            assert all((a is None and b is None) or torch.equal(a, b)
                       for a, b in zip(eager, want))
    rep = rot.sync_report()
    assert rep["overlap"] is True and plain.sync_report()["overlap"] is False
    assert rep["reduce_collectives_per_round"] == 2 * rot.planned.depth
    assert rep["graph_launches"] == 0 and rep["dispatches"] == 8
    assert rot.remesh(tuple(range(10, 18))).overlap is True


def test_launcher_trains_with_bucketed_sync(tmp_path, monkeypatch):
    """``--sync-overlap bucketed --sync-bucket-kb 16`` trains two steps of
    the reduced model with the loss of ``off``, bit for bit."""
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path / "plans"))
    base = ["--reduced", "--device", "cpu", "--steps", "2", "--batch", "4",
            "--seq", "16", "--untied", "--data-axis", "2", "--dp-degrees",
            "2", "--sync", "hier"]
    off = launch_train.main(base)
    on = launch_train.main(base + ["--sync-overlap", "bucketed",
                                   "--sync-bucket-kb", "16"])
    assert np.isfinite(off) and on == off
