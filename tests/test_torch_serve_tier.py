"""PyTorch port, the serving tier (``repro_torch.serve``) on the CPU.

The claim under test, as the reference's ``tests/test_serve_tier.py``
states it: continuous-batched decode returns token for token what each
request gets served alone, the oracle being the same scheduler run one
request at a time (``run_sequential_oracle``: the same slot geometry,
so equality isolates request isolation -- slot writes, position
tracking, join / evict bookkeeping -- from the batch-size dependence of
a matmul's summation order).

* decode after a prefill of S tokens against the prefill of S + 1 for
  the five decoder families, within the bounds of the reference's
  ``tests/test_serve_consistency.py`` (the split-KV and 2D decode
  layouts are held to the reference in ``test_torch_decode_layouts.py``);
* the consistency sweep on reduced qwen at (slots, data positions) =
  (1, 1), (2, 2) and (8, 2), seeded Zipf streams with mixed prompt
  lengths, staggered arrivals and ``max_new`` down to 1; reduced
  granite-moe at (data, model) = (2, 2) with slots 4 (the MoE decode
  drops nothing: ``scheduler.moe_decode_drops_nothing``); EOS eviction;
  the scheduler's validation errors and slot bookkeeping;
* greedy ids never reach the padded vocab columns, even when those
  columns' logits are the largest;
* the sparse dispatch over 2 shards (sort, fused, banded merges; raw and
  ``delta+int8ef`` wires) only observes: the same ids with it on and
  off, and every step's head + tail counts equal a numpy bincount of the
  shards' ids; ``expert_load`` equals the predictor's bincount;
* the admission controller equals the reference's
  (``repro.serve.queue``, imported in-process: it needs no device)
  offer by offer, and the contracts of ``tests/test_admission.py``
  (hypothesis) hold on the port's copy;
* ``python -m repro_torch.launch.serve --device cpu`` serves a reduced
  decoder-only config with the dispatch and whisper on the fixed-batch
  path; without ``--device`` and without a card it raises.
"""
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer as T
from repro_torch.serve import (AdmissionController, ContinuousBatchingScheduler,
                               DecodeService, zipf_request_stream)
from repro_torch.serve import queue as Q
from repro_torch.serve.dispatch import (SparseServeDispatch, first_moe_router,
                                        make_expert_predictor)
from repro_torch.serve.scheduler import moe_decode_drops_nothing
from repro_torch.serve.service import run_sequential_oracle
from repro_torch.train import step as S

# one intra-op thread a test process: pytest-xdist runs several workers
# at once, and their OpenMP threads would oversubscribe the cores
torch.set_num_threads(1)

MAX_SEQ = 24


@pytest.fixture(scope="module")
def qwen():
    cfg = get_config("qwen1.5-0.5b").reduced()
    return cfg, T.init_params(cfg, 1, seed=0, device="cpu")


def _stream(cfg, n, seed, eos_id=None):
    """Mixed prompt lengths, staggered arrivals, max_new down to 1 (a
    request that completes at join)."""
    return zipf_request_stream(
        n, cfg.vocab, prompt_lens=(4, 8, 6), max_new=(1, 7),
        arrival_rate=0.6, eos_id=eos_id, seed=seed)


def _serve_and_compare(cfg, mc, params, slots, reqs, dispatch=None):
    sched = ContinuousBatchingScheduler(cfg, mc, params, slots=slots,
                                        max_seq=MAX_SEQ, dispatch=dispatch)
    report = DecodeService(sched).run(reqs)
    assert len(report.completed) == len(reqs)
    batched = {r.rid: list(r.tokens) for r in report.completed}
    sched.reset()
    if dispatch is not None:
        sched.dispatch = None
    oracle = run_sequential_oracle(sched, reqs)
    for i, req in enumerate(reqs):
        assert batched[req.rid] == oracle[i], \
            f"rid {req.rid} (slots={slots}): {batched[req.rid]} != {oracle[i]}"
    return batched, report


@pytest.mark.parametrize("slots,dp", [(1, 1), (2, 2), (8, 2)])
def test_continuous_batching_matches_sequential_oracle(qwen, slots, dp):
    cfg, params = qwen
    reqs = _stream(cfg, n=7, seed=100 + slots)
    batched, report = _serve_and_compare(
        cfg, S.mesh_ctx(dp, device="cpu"), params, slots, reqs)
    for req in reqs:
        assert 1 <= len(batched[req.rid]) <= req.max_new
    assert report.tokens_out == sum(len(t) for t in batched.values())


def test_moe_continuous_batching_at_tp2_matches_oracle():
    """Reduced granite-moe at (data, model) = (2, 2), slots 4: the decode
    drops no copy (free slots' garbage rows route too), so batched =
    oracle token for token."""
    cfg = get_config("granite-moe-3b-a800m").reduced()
    params = T.init_params(cfg, 2, seed=0, device="cpu")
    assert moe_decode_drops_nothing(cfg, 2, 2)
    reqs = zipf_request_stream(6, cfg.vocab, prompt_lens=(4, 6),
                               max_new=(1, 5), arrival_rate=0.8, seed=4)
    _serve_and_compare(cfg, S.mesh_ctx(2, 2, device="cpu"), params, 4, reqs)


def test_eos_evicts_early_and_stays_consistent(qwen):
    """A token the model emits mid-request, declared EOS: the request
    stops at it (strictly early), and batched still equals the oracle."""
    cfg, params = qwen
    mc = S.mesh_ctx(2, device="cpu")
    probe = _stream(cfg, n=5, seed=7)
    sched = ContinuousBatchingScheduler(cfg, mc, params, slots=2,
                                        max_seq=MAX_SEQ)
    DecodeService(sched).run(probe)
    eos = next((r.tokens[1] for r in probe if len(r.tokens) >= 3), None)
    assert eos is not None, "probe stream produced no 3-token request"
    reqs = _stream(cfg, n=5, seed=7, eos_id=int(eos))
    sched.reset()
    report = DecodeService(sched).run(reqs)
    batched = {r.rid: list(r.tokens) for r in report.completed}
    sched.reset()
    oracle = run_sequential_oracle(sched, reqs)
    stopped_early = 0
    for i, req in enumerate(reqs):
        assert batched[req.rid] == oracle[i]
        if len(batched[req.rid]) < req.max_new:
            assert batched[req.rid][-1] == eos
            stopped_early += 1
    assert stopped_early >= 1, "EOS never fired"


def test_scheduler_validation_and_slot_bookkeeping(qwen):
    cfg, params = qwen
    mc1 = S.mesh_ctx(1, device="cpu")
    with pytest.raises(ValueError, match="decoder-only"):
        ContinuousBatchingScheduler(get_config("whisper-base").reduced(),
                                    mc1, params, slots=2, max_seq=MAX_SEQ)
    with pytest.raises(ValueError, match="multiple"):
        ContinuousBatchingScheduler(cfg, mc1, params, slots=0,
                                    max_seq=MAX_SEQ)
    with pytest.raises(ValueError, match="multiple"):
        ContinuousBatchingScheduler(cfg, S.mesh_ctx(2, device="cpu"), params,
                                    slots=3, max_seq=MAX_SEQ)
    # the published granite (40 experts, top-8): cap_e is 8 up to 9 rows
    moe = get_config("granite-moe-3b-a800m")
    assert moe_decode_drops_nothing(moe, 8, 1)
    assert not moe_decode_drops_nothing(moe, 9, 1)
    assert moe_decode_drops_nothing(moe, 4, 2)
    with pytest.raises(ValueError, match="drop"):
        ContinuousBatchingScheduler(moe, mc1, None, slots=9, max_seq=MAX_SEQ)
    with pytest.raises(ValueError, match="shards"):
        ContinuousBatchingScheduler(
            cfg, mc1, params, slots=2, max_seq=MAX_SEQ,
            dispatch=SparseServeDispatch(2, vocab=cfg.vocab, seed=5,
                                         device="cpu"))
    sched = ContinuousBatchingScheduler(cfg, mc1, params, slots=2,
                                        max_seq=MAX_SEQ)
    with pytest.raises(ValueError, match="exceeds max_seq"):
        sched.join(zipf_request_stream(1, cfg.vocab, prompt_lens=(MAX_SEQ,),
                                       max_new=(4, 4), seed=0)[0])
    reqs = zipf_request_stream(3, cfg.vocab, prompt_lens=(4,),
                               max_new=(3, 3), seed=1)
    assert sched.join(reqs[0]) == 0 and sched.join(reqs[1]) == 1
    assert sched.free_slots() == [] and sched.active == 2
    with pytest.raises(RuntimeError, match="no free slot"):
        sched.join(reqs[2])
    while sched.active:
        sched.step()
    done = sched.pop_completed()
    assert sorted(r.rid for r in done) == [0, 1]
    assert sched.free_slots() == [0, 1]
    assert sched.metrics.joins == 2 and sched.metrics.evictions == 2


def test_greedy_never_picks_padded_vocab_columns():
    """Tied, vocab 500 padded to 512: the padded embedding rows are set to
    a large multiple of a real row, so for some rows the padded columns
    hold the largest logits; the greedy steps still return ids below the
    vocab (and ``_greedy_ids`` masks exactly the padded columns)."""
    cfg = get_config("qwen1.5-0.5b").reduced(vocab=500)
    assert T.padded_vocab(cfg, 1) == 512
    params = T.init_params(cfg, 1, seed=0, device="cpu")
    params["emb"][cfg.vocab:] = 50.0 * params["emb"][:1]
    mc = S.mesh_ctx(2, device="cpu")
    prefill, _ = S.make_prefill_step(cfg, mc, MAX_SEQ)
    toks = np.random.RandomState(0).randint(0, cfg.vocab, (2, 6))
    logits, _ = prefill(params, {"tokens": toks})
    assert bool((logits.argmax(-1) >= cfg.vocab).any())
    reqs = _stream(cfg, n=5, seed=33)
    sched = ContinuousBatchingScheduler(cfg, mc, params, slots=2,
                                        max_seq=MAX_SEQ)
    report = DecodeService(sched).run(reqs)
    for r in report.completed:
        assert all(0 <= t < cfg.vocab for t in r.tokens), r.tokens
    logits = torch.zeros((3, 512))
    logits[:, 500:] = 1.0
    logits[0, 7] = -1.0
    logits[1, 499] = 0.5
    ids = S._greedy_ids(logits, 500)
    assert ids.dtype == torch.int32 and ids.tolist() == [0, 499, 0]


@pytest.mark.parametrize("tied", [True, False])
def test_serving_steps_share_one_float32_head(tied):
    """bf16 weights: every step serving one parameter set reads one float32
    head (``T.head_f32``), cast again only after the head is modified in
    place, and dropped with the head tensor; the launcher's cross-cache
    tree casts none."""
    import gc
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                              dtype=torch.bfloat16, tie_embeddings=tied)
    params = T.init_params(cfg, 1, seed=0, device="cpu")
    src = params["emb"] if tied else params["head"]
    assert src.dtype == torch.bfloat16
    mc = S.mesh_ctx(2, device="cpu")
    before = len(T._HEAD32)
    S.serving_tree(params, cfg, mc)
    assert len(T._HEAD32) == before
    head32 = S._serving_params(cfg, mc)(params)[1]
    assert head32.dtype == torch.float32 and len(T._HEAD32) == before + 1
    assert S._serving_params(cfg, mc)(params)[1] is head32
    assert T.head_f32(params, cfg) is head32
    torch.testing.assert_close(
        head32, (src.T if tied else src).to(torch.float32), rtol=0, atol=0)
    with torch.no_grad():
        src.mul_(2.0)
    again = T.head_f32(params, cfg)
    assert again is not head32 and len(T._HEAD32) == before + 1
    torch.testing.assert_close(again, 2.0 * head32, rtol=0, atol=0)
    del params, src, again, head32
    gc.collect()
    assert len(T._HEAD32) == before


# the bounds of tests/test_serve_consistency.py: the softmax's max abs
# difference; argmax equal where the bound is tight
CONSISTENCY = [("qwen1.5-0.5b", 2e-3), ("gemma3-12b", 2e-3),
               ("xlstm-1.3b", 5e-2), ("granite-moe-3b-a800m", 5e-2),
               ("jamba-1.5-large-398b", 5e-2)]


@pytest.mark.parametrize("arch,tol", CONSISTENCY)
def test_decode_matches_longer_prefill(arch, tol):
    """decode(prefill(t[:S]), t[S]) against prefill(t[:S + 1]) for the
    five decoder families (cache layout, positions, rope, window, state
    handoff) on a (2, 1) mesh, S = 24, max_seq 32."""
    cfg = get_config(arch).reduced()
    params = T.init_params(cfg, 1, seed=0, device="cpu")
    mc = S.mesh_ctx(2, device="cpu")
    toks = np.random.RandomState(0).randint(0, cfg.vocab, (2, 25))
    prefill, _ = S.make_prefill_step(cfg, mc, 32)
    decode, _ = S.make_decode_step(cfg, mc)
    _, cache = prefill(params, {"tokens": toks[:, :24]})
    a, _ = decode(params, toks[:, 24], np.full(2, 24), cache)
    b, _ = prefill(params, {"tokens": toks})
    a, b = a[:, :cfg.vocab], b[:, :cfg.vocab]
    err = float((torch.softmax(a, -1) - torch.softmax(b, -1)).abs().max())
    assert err < tol, (arch, err)
    if tol < 1e-2:
        assert torch.equal(a.argmax(-1), b.argmax(-1))


class _RecordingDispatch:
    """Wraps a SparseServeDispatch to capture (input shards, exchange)."""

    def __init__(self, inner):
        self._inner = inner
        self.trace = []

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def on_step(self, tok_shards):
        ex = self._inner.on_step(tok_shards)
        self.trace.append(([np.array(s) for s in tok_shards], ex))
        return ex


@pytest.mark.parametrize("merge,wire", [("sort", "raw"), ("fused", "raw"),
                                        ("banded", "delta+int8ef")])
def test_dispatch_observes_without_perturbing_and_matches_bincount(
        qwen, merge, wire):
    """Two shards: the same ids with the dispatch on as off, and each
    step's head + tail counts equal a numpy bincount of the shards' ids
    (no overflow); the union path's plan cache warms after its first
    step."""
    cfg, params = qwen
    mc = S.mesh_ctx(2, device="cpu")
    reqs = _stream(cfg, n=6, seed=21)
    base, _ = _serve_and_compare(cfg, mc, params, 4, reqs)
    disp = SparseServeDispatch(2, vocab=cfg.vocab, seed=5, merge=merge,
                               wire=wire, device="cpu")
    disp.fit_hot_set(np.concatenate([r.prompt for r in reqs]), head_size=8)
    rec = _RecordingDispatch(disp)
    reqs2 = _stream(cfg, n=6, seed=21)
    sched = ContinuousBatchingScheduler(cfg, mc, params, slots=4,
                                        max_seq=MAX_SEQ, dispatch=rec)
    report = DecodeService(sched).run(reqs2)
    assert {r.rid: list(r.tokens) for r in report.completed} == base
    assert rec.trace, "dispatch never invoked"
    for shards, ex in rec.trace:
        toks = np.concatenate(shards).astype(np.int64)
        want = np.bincount(toks, minlength=cfg.vocab)
        got = np.zeros(cfg.vocab, np.int64)
        got[ex.head_ids.astype(np.int64)] += ex.head_counts.astype(np.int64)
        if len(ex.tail_ids):
            got[ex.tail_ids.astype(np.int64)] += \
                ex.tail_counts.astype(np.int64)
        assert ex.overflow == 0
        assert np.array_equal(got, want), "exchange != dense bincount"
        for t in toks[:4]:
            assert ex.count_of(int(t)) == want[t]
    assert report.plan_hit_rate is not None and report.plan_hit_rate >= 0.5


def test_expert_load_matches_predictor_bincount():
    """``expert_load`` of two shards' predicted experts (the shadow router
    on the first MoE block's router) equals their bincount; the frozen
    plan never replans."""
    cfg = get_config("granite-moe-3b-a800m").reduced()
    params = T.init_params(cfg, 1, seed=0, device="cpu")
    router = first_moe_router(params)
    assert router is not None and first_moe_router(
        T.init_params(get_config("qwen1.5-0.5b").reduced(), 1,
                      device="cpu")) is None
    pred = make_expert_predictor(cfg)
    rng = np.random.RandomState(3)
    eks = [pred(params["emb"], router, rng.randint(0, cfg.vocab, (10,)))
           for _ in range(2)]
    assert eks[0].shape == (10, cfg.top_k)
    disp = SparseServeDispatch(2, vocab=cfg.vocab, n_experts=cfg.n_experts,
                               seed=9, device="cpu")
    load = disp.expert_load(eks)
    want = sum(np.bincount(e.numpy().reshape(-1), minlength=cfg.n_experts)
               for e in eks).astype(np.float32)
    assert np.array_equal(load, want) and load.sum() == 20 * cfg.top_k
    assert disp.plan_hit_rate == 1.0
    with pytest.raises(RuntimeError, match="fit_hot_set"):
        disp.on_step([np.zeros(1, np.int32)] * 2)
    with pytest.raises(ValueError, match="shard token lists"):
        disp.fit_hot_set(np.arange(16), head_size=8)
        disp.on_step([np.zeros(1, np.int32)])
    with pytest.raises(RuntimeError, match="n_experts"):
        SparseServeDispatch(1, vocab=cfg.vocab, device="cpu").expert_load(
            [np.zeros(2, np.int64)])


# ---------------------------------------------------------------------------
# Admission control: the port's copy against the reference, then the
# reference's hypothesis contracts on the port's copy
# ---------------------------------------------------------------------------

def _req(rid: int):
    return Q.Request(rid=rid, prompt=np.zeros(2, np.int32), max_new=2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_admission_controller_equals_reference(seed):
    """Both controllers through the same seeded offer / next / complete
    sequence (times, latencies, breaker trips and probes included): the
    same outcome of every call, the same order out, the same stats."""
    from repro.serve import queue as RQ
    rng = np.random.RandomState(seed)
    kw = dict(rate=1.0, burst=2.0, queue_cap=3, slo=6.0, breach_window=2,
              cooldown=5.0, probes=2)
    port, ref = AdmissionController(**kw), RQ.AdmissionController(**kw)
    t, rid = 0.0, 0
    waiting = []
    for _ in range(300):
        t += float(rng.exponential(0.5))
        op = rng.choice(3, p=[0.5, 0.2, 0.3])
        if op == 0:
            a = port.offer(_req(rid), t)
            b = ref.offer(RQ.Request(rid=rid, prompt=np.zeros(2, np.int32),
                                     max_new=2), t)
            assert a == b
            rid += 1
        elif op == 1:
            a, b = port.next_request(), ref.next_request()
            assert (a is None) == (b is None)
            if a is not None:
                assert a.rid == b.rid
                waiting.append((a, b))
        elif waiting:
            a, b = waiting.pop(int(rng.randint(len(waiting))))
            a.arrival = b.arrival = t - float(rng.exponential(6.0))
            port.complete(a, t)
            ref.complete(b, t)
            assert a.finished_at == b.finished_at
        assert dataclasses.asdict(port.stats) == dataclasses.asdict(ref.stats)
        assert port.breaker.state == ref.breaker.state
        assert port.pending() == ref.pending()
    assert port.breaker.trips == ref.breaker.trips > 0
    assert port.stats.shed_rate and port.stats.shed_queue \
        and port.stats.shed_breaker


@given(st.floats(min_value=0.05, max_value=8.0),
       st.floats(min_value=1.0, max_value=10.0),
       st.lists(st.floats(min_value=0.0, max_value=3.0),
                min_size=1, max_size=60))
@settings(max_examples=60)
def test_token_bucket_window_bound(rate, burst, gaps):
    """Admits inside any window (t0, t1] never exceed burst + rate * dt."""
    tb = Q.TokenBucket(rate, burst)
    times = np.cumsum(np.asarray(gaps, np.float64))
    admitted = [t for t in times if tb.admit(float(t))]
    for i, t0 in enumerate(times):
        for t1 in times[i:]:
            n = sum(1 for t in admitted if t0 < t <= t1)
            assert n <= burst + rate * (t1 - t0) + 1e-6


@given(st.floats(min_value=0.1, max_value=4.0),
       st.floats(min_value=1.0, max_value=6.0))
def test_token_bucket_burst_then_starve_then_refill(rate, burst):
    tb = Q.TokenBucket(rate, burst)
    first = sum(tb.admit(0.0) for _ in range(int(burst) + 5))
    assert first == int(burst + 1e-9)
    later = sum(tb.admit(2.0 / rate) for _ in range(10))
    frac = burst - int(burst + 1e-9)
    assert later == int(min(burst, frac + 2.0) + 1e-9)


@given(st.integers(min_value=1, max_value=8),
       st.lists(st.booleans(), min_size=1, max_size=80))
@settings(max_examples=60)
def test_bounded_queue_fifo_and_accounting(cap, ops):
    q = Q.BoundedQueue(cap)
    seq = 0
    accepted, popped = [], []
    for is_offer in ops:
        if is_offer:
            if q.offer(seq):
                accepted.append(seq)
            seq += 1
        else:
            item = q.pop()
            if item is not None:
                popped.append(item)
        assert len(q) <= cap
        assert q.admitted + q.shed == q.offered == seq
    assert popped == accepted[:len(popped)]
    assert len(accepted) - len(popped) == len(q)


@given(st.integers(min_value=1, max_value=6),
       st.lists(st.integers(min_value=0, max_value=1),
                min_size=1, max_size=60))
@settings(max_examples=60)
def test_breaker_trips_only_on_consecutive_breaches(window, pattern):
    br = Q.CircuitBreaker(slo=10.0, breach_window=window, cooldown=5.0)
    streak, should_trip = 0, False
    for i, breach in enumerate(pattern):
        br.record(float(i), 20.0 if breach else 1.0)
        streak = streak + 1 if breach else 0
        if streak >= window:
            should_trip = True
            break
    assert (br.state == Q.CircuitBreaker.OPEN) == should_trip
    assert br.trips == int(should_trip)


@given(st.floats(min_value=0.5, max_value=20.0))
def test_breaker_always_half_opens_after_cooldown(cooldown):
    br = Q.CircuitBreaker(slo=1.0, breach_window=1, cooldown=cooldown)
    br.record(0.0, 2.0)
    assert br.state == Q.CircuitBreaker.OPEN
    assert not br.allow(cooldown * 0.5)
    assert br.allow(cooldown + 1e-6)
    assert br.state == Q.CircuitBreaker.HALF_OPEN


@given(st.lists(st.tuples(st.integers(min_value=0, max_value=2),
                          st.floats(min_value=0.0, max_value=4.0),
                          st.floats(min_value=0.0, max_value=30.0)),
                min_size=0, max_size=60))
@settings(max_examples=60)
def test_breaker_never_deadlocks_closed(ops):
    cooldown = 6.0
    br = Q.CircuitBreaker(slo=5.0, breach_window=2, cooldown=cooldown,
                          probes=2)
    t = 0.0
    for kind, dt, lat in ops:
        t += dt
        if kind == 0:
            br.allow(t)
        else:
            br.record(t, lat)
    t1 = t + cooldown + 1e-3
    assert br.allow(t1) or br.allow(t1 + cooldown + 1e-3), br.state


@given(st.lists(st.floats(min_value=0.0, max_value=2.0),
                min_size=1, max_size=80))
@settings(max_examples=40)
def test_controller_accounting_is_total(gaps):
    adm = AdmissionController(rate=0.7, burst=2.0, queue_cap=3, slo=8.0)
    t = 0.0
    for i, dt in enumerate(gaps):
        t += dt
        assert adm.offer(_req(i), t) in ("admitted", "shed_rate",
                                         "shed_queue", "shed_breaker")
    s = adm.stats
    assert s.offered == len(gaps) and s.admitted + s.shed == s.offered
    assert adm.pending() <= 3


@pytest.mark.parametrize("case", ["validates", "clock", "probes",
                                  "breaker_first", "full_queue"])
def test_admission_fixed_contracts(case):
    """The reference's fixed-trace admission tests on the port's copy."""
    if case == "validates":
        for args in ((0.0, 4.0), (1.0, 0.5)):
            with pytest.raises(ValueError):
                Q.TokenBucket(*args)
    elif case == "clock":
        tb = Q.TokenBucket(1.0, 1.0)
        assert tb.admit(10.0) and not tb.admit(5.0) and tb.admit(11.0)
    elif case == "probes":
        br = Q.CircuitBreaker(slo=1.0, breach_window=1, cooldown=4.0,
                              probes=2)
        br.record(0.0, 2.0)
        assert br.allow(5.0) and br.allow(5.0) and not br.allow(5.0)
        br.record(6.0, 0.5)
        br.record(6.0, 0.5)
        assert br.state == Q.CircuitBreaker.CLOSED
        br2 = Q.CircuitBreaker(slo=1.0, breach_window=1, cooldown=4.0,
                               probes=2)
        br2.record(0.0, 2.0)
        assert br2.allow(5.0)
        br2.record(6.0, 3.0)
        assert br2.state == Q.CircuitBreaker.OPEN and br2.trips == 2
    elif case == "breaker_first":
        adm = AdmissionController(rate=0.001, burst=2.0, queue_cap=8,
                                  slo=1.0, breach_window=1, cooldown=10.0)
        adm.breaker.record(0.0, 5.0)
        for i in range(4):
            assert adm.offer(_req(i), 1.0) == "shed_breaker"
        assert adm.offer(_req(10), 11.0) == "admitted"
        assert adm.offer(_req(11), 11.0) == "admitted"
        assert adm.stats.shed_rate == 0
    else:
        adm = AdmissionController(rate=100.0, burst=100.0, queue_cap=2,
                                  slo=8.0)
        assert [adm.offer(_req(i), 0.0) for i in range(3)] == \
            ["admitted", "admitted", "shed_queue"]
        assert adm.next_request().rid == 0
        assert adm.offer(_req(3), 0.0) == "admitted"


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def test_launcher_serves_decoder_only_with_dispatch(tmp_path, monkeypatch,
                                                    capsys):
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path / "plans"))
    gen = launch_serve.main(
        ["--arch", "qwen1.5-0.5b", "--reduced", "--device", "cpu",
         "--requests", "4", "--prompt-len", "8", "--gen", "4",
         "--sparse-dispatch"])
    assert gen.shape == (4, 4) and gen.dtype == np.int32
    assert int(gen.max()) < 512
    out = capsys.readouterr().out
    assert "served 4/4 requests" in out and "plan hit rate" in out


def test_launcher_serves_whisper_fixed_batch_and_admission(tmp_path,
                                                           monkeypatch):
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path / "plans"))
    gen = launch_serve.main(["--arch", "whisper-base", "--reduced",
                             "--device", "cpu", "--gen", "4"])
    assert gen.shape == (4, 4) and int(gen.max()) < 512
    gen = launch_serve.main(
        ["--arch", "qwen1.5-0.5b", "--reduced", "--device", "cpu",
         "--requests", "6", "--prompt-len", "4", "--gen", "3", "--rate",
         "0.5", "--burst", "1", "--queue-cap", "2", "--data-axis", "2"])
    assert 1 <= len(gen) < 6


def test_launcher_takes_the_card_by_default():
    """Without ``--device`` the launcher binds the current CUDA device,
    and without one it raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default binds it")
    with pytest.raises(RuntimeError):
        launch_serve.main(["--arch", "qwen1.5-0.5b", "--reduced"])
