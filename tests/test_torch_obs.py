"""PyTorch port: the span and counter recorder (``repro_torch.obs``) on the
CPU.

With the profiler off a span only adds to the totals: no timeline
record, no ``torch.cuda.Event``, no ``record_function``.  Under
``torch.profiler`` spans nest with their parents' ids and share their
outermost span's id, and their ``time.time_ns()`` stamps, put on the
Chrome trace's clock by ``obs.trace_us``, fall on the
``record_function`` ranges opened around them in the exported trace.
At the layer boundaries: a union reduce's phases in order and its
host-to-device copies counted exactly, call by call (none on the CPU
itself), a train step's union phases under ``train.sync.sparse``, and a
PageRank engine's ``config`` once.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import obs
from repro_torch.core.api import SparseAllreduce
from repro_torch.core.sparse_vec import HashPerm
from repro_torch.kernels import _build

torch.set_num_threads(1)

M, C = 8, 64
PHASES = ("union.partition", "union.exchange", "union.merge",
          "union.gather", "union.trim")


@pytest.fixture(autouse=True)
def fresh():
    obs.reset()
    yield
    obs.reset()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _spans_of(name):
    return [s for s in obs.timeline() if s.name == name]


def _union_inputs(seed=1):
    """Hashed, sorted, SENTINEL-padded chunks [M, C] with dyadic values."""
    rng = np.random.RandomState(seed)
    perm = HashPerm.make(7)
    idx = np.full((M, C), 0xFFFFFFFF, np.uint32)
    val = np.zeros((M, C), np.float32)
    for n in range(M):
        nn = rng.randint(10, C // 2)
        h = perm.fwd_np(rng.choice(4000, size=nn, replace=False)
                        .astype(np.uint32))
        order = np.argsort(h)
        idx[n, :nn] = h[order]
        val[n, :nn] = rng.randint(-2048, 2048, nn)[order] / 256.0
    return idx, val


@pytest.mark.parametrize("raises", [False, True])
def test_profiler_off_keeps_totals_only(monkeypatch, raises):
    """Off the profiler: calls, nanoseconds and counters add up (also
    through a decorator and a raising body), the timeline stays empty, and
    no CUDA event or ``record_function`` is made, even with CUDA
    pretended initialised."""
    def refuse(*a, **k):
        raise AssertionError("made while the profiler is off")
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)

    @obs.span("t.inner")
    def inner():
        obs.count("t.items", 3)
        if raises:
            raise KeyError("body")

    for _ in range(2):
        with obs.span("t.outer"):
            try:
                inner()
            except KeyError:
                pass
    obs.count("t.items")
    snap = obs.snapshot()
    assert snap["spans"]["t.outer"]["calls"] == 2
    assert snap["spans"]["t.inner"]["calls"] == 2
    assert snap["spans"]["t.outer"]["ns"] >= snap["spans"]["t.inner"]["ns"] > 0
    assert snap["counters"]["t.items"] == 7
    assert {f"launch.{k}": v for k, v in _build.LAUNCHES.items()}.items() \
        <= snap["counters"].items()
    assert obs.timeline() == []
    obs.reset()
    assert obs.snapshot()["spans"] == {} and obs.timeline() == []


def test_timeline_spans_nest_under_the_profiler():
    """Parents' ids, one root id under each outermost span, counter
    increments on every span open at the time, host stamps in order; on
    the CPU no span holds device events."""
    with _cpu_profile():
        for _ in range(2):
            with obs.span("t.unit"):
                obs.count("t.c")
                with obs.span("t.a"):
                    with obs.span("t.a.leaf"):
                        obs.count("t.c", 2)
                with obs.span("t.b"):
                    pass
    obs.count("t.c", 5)                        # after: on no span
    tl = obs.timeline()
    assert [s.name for s in tl] == ["t.unit", "t.a", "t.a.leaf", "t.b"] * 2
    by_id = {s.id: s for s in tl}
    for unit in (tl[0], tl[4]):
        kids = [s for s in tl if s.root == unit.id]
        assert [s.name for s in kids] == ["t.unit", "t.a", "t.a.leaf", "t.b"]
        assert unit.parent is None
        for s in kids[1:]:
            parent = by_id[s.parent]
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
        assert by_id[kids[2].parent].name == "t.a"
        assert by_id[kids[3].parent].name == "t.unit"
        assert unit.counts == {"t.c": 3} and kids[1].counts == {"t.c": 2}
        assert kids[3].counts == {}
        assert all(s.events is None and s.device_ms() is None for s in kids)
    assert tl[0].root != tl[4].root
    assert obs.snapshot()["counters"]["t.c"] == 11


def _spanned(name):
    """A ``record_function`` range and, inside it, the span ``name``."""
    rf = record_function(name)

    class _Both:
        def __enter__(self):
            rf.__enter__()
            self.span = obs.span(name)
            self.span.__enter__()

        def __exit__(self, *exc):
            self.span.__exit__(*exc)
            rf.__exit__(*exc)
    return _Both()


def _clock_offsets_us(path):
    """Spans, each inside a ``record_function`` range of its name, under a
    CPU profile, the trace exported to ``path``: the base check, then each
    compared span's largest distance (us) between its stamps on the
    trace's clock and the range's ends."""
    obs.reset()
    with _cpu_profile() as prof:
        with _spanned("t.first"):
            pass
        for i in range(3):
            with _spanned(f"t.clock{i}"):
                torch.ones(1000).cumsum(0)
                with _spanned(f"t.clock{i}.in"):
                    torch.ones(1000).sum()
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    ranges = {e["name"]: (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
              for e in trace["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"}
    tl = obs.timeline()
    assert [s.name for s in tl[:2]] == ["t.first", "t.clock0"]
    assert len(tl) == 7
    base = int(trace["baseTimeNanoseconds"])
    assert all(obs.trace_base_ns(s.start_ns) == base for s in tl)
    return {s.name: max(abs(obs.trace_us(s.start_ns) - ranges[s.name][0]),
                        abs(obs.trace_us(s.end_ns) - ranges[s.name][1]))
            for s in tl[1:]}


def test_trace_us_lands_on_the_record_function_range(tmp_path):
    """Each span's stamps, put on the trace's clock by ``trace_us``, lie
    within 100 us of the ``record_function`` range opened around it in
    the exported Chrome trace, whose ``baseTimeNanoseconds`` is
    ``trace_base_ns``.  A first span takes the session's one-time set-up
    of its first host record and is not compared; a session is taken
    again (three in all) when the host was preempted between a stamp and
    its record, as a clock offset would show in every session and a
    preemption in one."""
    tries = []
    for k in range(3):
        tries.append(_clock_offsets_us(tmp_path / f"trace{k}.json"))
        if max(tries[-1].values()) < 100:
            break
    assert max(tries[-1].values()) < 100, tries


@pytest.mark.parametrize("host,replication,card", [
    (True, 1, True), (False, 1, True), (True, 2, True), (True, 1, False)])
def test_union_reduce_phases_and_copies(monkeypatch, host, replication,
                                        card):
    """Two layers (degrees (4, 2)) or three (r = 2 adds the replica
    stage): partition / exchange / merge per layer down, gather per layer
    up, then trim, all under ``union.reduce``.  ``union.htod_copies``
    counts, call by call, the host arrays the path makes into tensors
    (the plan-cache miss's transport tables too) and the inputs given as
    CPU tensors.  With ``card`` the CPU is counted as a device would be;
    as itself it counts no copy."""
    if card:
        monkeypatch.setattr(obs, "HOST_DEVICE_TYPES", ())
    idx, val = _union_inputs()
    if not host:
        idx = torch.as_tensor(idx.astype(np.int64))
        val = torch.as_tensor(val)
    made = []
    as_tensor = torch.as_tensor

    def counting(data, *a, **k):
        if not isinstance(data, torch.Tensor):
            made.append(type(data))
        return as_tensor(data, *a, **k)
    monkeypatch.setattr(torch, "as_tensor", counting)
    ar = SparseAllreduce(M, (4, 2), backend="device", device="cpu",
                         merge="fused", replication=replication,
                         dead={1} if replication > 1 else None,
                         plan_cache=False)
    layers = 2 + (replication > 1)
    per_call = []
    with _cpu_profile():
        for _ in range(2):
            made.clear()
            ar.union_reduce(idx, val, M * C)
            per_call.append(len(made))
    # idx and val from the host, the edges, the weights and first alive
    # replicas of r = 2; the miss adds the transport's three tables a layer
    assert per_call[1] == 2 * host + layers + 2 * (replication > 1)
    assert per_call[0] == per_call[1] + 3 * layers
    roots = _spans_of("union.reduce")
    assert len(roots) == 2
    copies = [n + 2 * (not host) for n in per_call]
    for root, n in zip(roots, copies):
        kids = [s.name for s in obs.timeline()
                if s.root == root.id and s is not root]
        assert kids == list(PHASES[:3]) * layers + \
            ["union.gather"] * layers + ["union.trim"]
        assert root.counts.get("union.htod_copies", 0) == n * card
    snap = obs.snapshot()
    assert snap["counters"].get("union.htod_copies", 0) == sum(copies) * card
    assert snap["spans"]["union.reduce"]["calls"] == 2
    assert snap["spans"]["union.trim"]["calls"] == 2
    assert ar.union_plan_stats == {"hits": 1, "misses": 1}


def test_train_step_nests_the_union_spans_under_the_sparse_sync():
    """A reduced untied qwen step with the sparse sync: ``train.step``,
    open at each ``mark`` hook, holds ``train.sync.sparse``, and the
    union phases lie under it."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train import step as S
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                              tie_embeddings=False)
    mc = S.mesh_ctx(4, device="cpu")
    step, _ = S.make_train_step(cfg, mc, sync="sparse",
                                dp_degrees={"data": (2, 2)},
                                sync_merge="fused", sparse_tokens_hint=32)
    params = T.init_params(cfg, 1, seed=3, device="cpu")
    st = AdamW().init(params)
    marks = []

    def mark(stage):
        (open_step,) = _spans_of("train.step")
        marks.append((stage, open_step.end_ns is None))
    with _cpu_profile():
        step(params, st, next(launch_train.batch_stream(cfg, 4, 16, seed=2)),
             mark=mark)
    assert marks == [("fwd_bwd", True), ("sync", True), ("update", True)]
    tl = obs.timeline()
    by_id = {s.id: s for s in tl}
    (root,) = _spans_of("train.step")
    (sparse,) = _spans_of("train.sync.sparse")
    assert sparse.parent == root.id and sparse.root == root.id
    phases = [s for s in tl if s.name in PHASES]
    assert [s.name for s in phases] == list(PHASES[:3]) * 2 + \
        ["union.gather"] * 2 + ["union.trim"]
    for s in phases:
        assert by_id[s.parent] is sparse and s.root == root.id
    assert len(tl) == 2 + len(phases)


def test_engine_set_up_records_config_once():
    """``make_pagerank_engine`` once: one ``engine.config``; each ``run``
    one ``engine.run``."""
    from repro_torch.data.pipeline import powerlaw_graph
    from repro_torch.graph.pagerank import (build_partitions,
                                            make_pagerank_engine)
    n = 400
    parts = build_partitions(powerlaw_graph(n, 2000, seed=2), n, M)
    engine, extras, p0 = make_pagerank_engine(parts, n, degrees=(4, 2),
                                              device="cpu", plan_cache=False)
    for _ in range(2):
        engine.run(3, p0, extras)
    spans = obs.snapshot()["spans"]
    assert spans["engine.config"]["calls"] == 1
    assert spans["engine.run"]["calls"] == 2
    assert set(spans) == {"engine.config", "engine.run"}
    assert obs.timeline() == []
