"""The readers of the program's spans and counters on a hand-built
timeline and trace, without the program's recorder (an earlier commit),
and through a traced CPU run of the cells."""
import types

import pytest

from portbench import harness, spans

PHASES = ("partition", "exchange", "merge", "gather", "trim")


class _Ev:
    """A CUDA event stand-in: ``elapsed_time`` is the difference of two
    made-up device times (ms)."""

    def __init__(self, t):
        self.t = t

    def elapsed_time(self, end):
        return end.t - self.t


class _Span:
    def __init__(self, id, parent, name, t0=0.0, t1=0.0, counts=None,
                 events=True, start_ns=0, end_ns=0, root=None):
        self.id, self.parent, self.name = id, parent, name
        self.root = id if parent is None else root
        self.events = (_Ev(t0), _Ev(t1)) if events else None
        self.counts = counts or {}
        self.start_ns, self.end_ns = start_ns, end_ns

    def device_ms(self):
        return None if self.events is None else \
            self.events[0].elapsed_time(self.events[1])


def _reduce(first_id, base_ms, copies):
    """One ``union.reduce`` with two layers: partition / exchange / merge
    twice, gather twice, trim; phase p of layer l lasts (p + 1) + 10 * l
    ms from ``base_ms`` on."""
    root = _Span(first_id, None, "union.reduce",
                 counts={"union.htod_copies": copies})
    out, i, t = [root], first_id + 1, base_ms
    for layer in range(2):
        for p, ph in enumerate(PHASES[:3]):
            d = (p + 1) + 10 * layer
            out.append(_Span(i, first_id, f"union.{ph}", t, t + d,
                             root=first_id))
            i, t = i + 1, t + d
    for layer in range(2):
        out.append(_Span(i, first_id, "union.gather", t, t + 4 + 10 * layer,
                         root=first_id))
        i, t = i + 1, t + 4 + 10 * layer
    trim = _Span(i, first_id, "union.trim", t, t + 5, root=first_id)
    # a span below a phase belongs to the same reduce
    out += [trim, _Span(i + 1, i, "union.inner", t, t + 1, root=first_id)]
    return out


def _fake_obs(monkeypatch, tl, totals=None):
    obs = types.SimpleNamespace(
        timeline=lambda: list(tl),
        snapshot=lambda: {"spans": totals or {}, "counters": {}},
        trace_us=lambda ns: ns / 1000.0)
    monkeypatch.setattr(spans, "recorder", lambda: obs)
    return obs


def test_phase_sums_and_copies_a_reduce(monkeypatch):
    """Each phase summed over its layers within a reduce, the median over
    the reduces; the copies are the root's increments."""
    tl = _reduce(1, 0.0, 4) + _reduce(100, 500.0, 2) + _reduce(200, 900.0, 2)
    tl.append(_Span(300, None, "union.partition", 0, 99))   # outside any
    _fake_obs(monkeypatch, tl)
    want = {"partition": 1 + 11, "exchange": 2 + 12, "merge": 3 + 13,
            "gather": 4 + 14, "trim": 5}
    for ph, ms in want.items():
        got = harness.reader(f"union.{ph}_ms")({})
        assert got == pytest.approx(ms), ph
    assert harness.reader("union.htod_copies")({}) == 2
    assert spans.count_per_unit(tl, "union.reduce", "union.htod_copies") \
        == [4, 2, 2]


def test_units_without_events_are_left_out(monkeypatch):
    """On the CPU no span holds events: the phase metrics read nothing;
    a train step's sparse sync is summed a step."""
    tl = [_Span(1, None, "union.reduce", events=False),
          _Span(2, 1, "union.merge", events=False)]
    _fake_obs(monkeypatch, tl)
    assert harness.reader("union.merge_ms")({}) is None
    steps = []
    for k, ms in enumerate((30.0, 10.0, 20.0)):
        base = 10 * k
        steps += [_Span(base + 1, None, "train.step"),
                  _Span(base + 3, base + 1, "train.sync.sparse", 0.0, ms,
                        root=base + 1),
                  _Span(base + 4, base + 3, "union.merge", 0.0, 1.0,
                        root=base + 1)]
    _fake_obs(monkeypatch, steps)
    assert harness.reader("train.sparse_sync_ms")({}) == pytest.approx(20.0)


def test_config_seconds_from_the_totals(monkeypatch):
    _fake_obs(monkeypatch, [], {"engine.config": {"calls": 2,
                                                  "ns": 3_000_000_000}})
    assert harness.reader("engine.config_s")({}) == pytest.approx(1.5)
    _fake_obs(monkeypatch, [], {})
    assert harness.reader("engine.config_s")({}) is None


def test_idle_in_program_on_known_intervals(monkeypatch):
    """Device busy [0, 10], [20, 30], [50, 60], [61, 70] us: idle 10 + 20 +
    1 = 31 us between the first and the last activity.  Spans (host ns,
    the fake clock dividing by 1,000): a unit over [5, 25] with a phase
    over [8, 12] and a leaf in it over [9, 11], a unit over [40, 45] with
    a phase over [41, 43].  The innermost span owns each idle instant:
    the leaf 1 us (10-11), the phases 1 (11-12) and 2 (41-43), the units
    8 (12-20) and 1 + 2, and the host outside every span 10 + 5 + 1 (the
    gap at 60-61 included); the phases' share is (1 + 1 + 2) / 31."""
    device = [("k", 0.0, 10.0), ("k", 20.0, 10.0), ("c", 50.0, 10.0),
              ("k", 61.0, 9.0), ("k", 2.0, 3.0)]
    tl = [_Span(1, None, "union.reduce", start_ns=5000, end_ns=25000),
          _Span(2, 1, "union.merge", start_ns=8000, end_ns=12000, root=1),
          _Span(3, 2, "union.inner", start_ns=9000, end_ns=11000, root=1),
          _Span(4, None, "union.reduce", start_ns=40000, end_ns=45000),
          _Span(5, 4, "union.trim", start_ns=41000, end_ns=43000, root=4)]
    _fake_obs(monkeypatch, tl)
    owners = spans.idle_owners(device, [(s.id, s.start_ns / 1000.0,
                                         s.end_ns / 1000.0) for s in tl])
    assert owners == pytest.approx({1: 8.0, 2: 1.0, 3: 1.0, 4: 3.0, 5: 2.0,
                                    None: 16.0})
    read = harness.reader("idle_in_program.minibatch")
    assert read({"trace": {"device": device}}) == \
        pytest.approx(100.0 * 4 / 31)
    assert spans.idle_owners(device, []) == {None: 31.0}
    assert spans.idle_owners(device[:1], [(1, 0.0, 5.0)]) is None
    assert read({"trace": {"device": []}}) is None


def test_without_the_recorder_every_reader_reads_nothing(monkeypatch):
    monkeypatch.setattr(spans, "recorder", lambda: None)
    ctx = {"trace": {"device": [("k", 0.0, 1.0), ("k", 5.0, 1.0)]}}
    for name in [f"union.{p}_ms" for p in PHASES] + [
            "union.htod_copies", "engine.config_s", "train.sparse_sync_ms",
            "idle_in_program.minibatch"]:
        assert harness.reader(name)(ctx) is None, name


@pytest.mark.parametrize("cell,want", [
    ("minibatch.m64-16x4", {"union.htod_copies": 0.0}),
    ("pagerank.m64-16x4", {}),
])
def test_a_traced_cpu_run_reports_what_the_host_can_read(cell, want, small):
    """On the CPU the counter and the set-up's totals are read (the
    counter 0: no copy crosses to a device); no span holds device events
    and the trace holds no device activity, so the device metrics are
    left out."""
    from repro_torch import obs
    obs.reset()
    line = harness.run_cell(cell, 2**31 + 7, 0.2, True, device="cpu",
                            overrides=small(cell))
    assert line["correct"], line
    got = line["metrics"]
    for name, value in want.items():
        assert got[name]["value"] == value
    assert not any(n.startswith("idle_in_program") or n.endswith("_ms")
                   and n.startswith("union.") and n != "union.kernels_ms"
                   for n in got), got
    if cell.startswith("pagerank"):
        assert 0 < got["engine.config_s"]["value"] < 60
