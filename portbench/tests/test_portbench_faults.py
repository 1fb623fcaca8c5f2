"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run of a cell on the CPU at a small size, with one fault planted in the
program: a step that returns its state unchanged, half of the batch left
out (the mean taken over the rest), the exchange between the stacked
nodes left out, an answer altered where it is produced.  The sound run
of the same size comes out correct.
"""
import dataclasses

import pytest
import torch

from portbench import harness

CELLS = ("pagerank.m64-16x4", "minibatch.m64-16x4", "train.granite-moe-3b")
FAULTS = ("state_unchanged", "half_batch", "no_exchange", "answer_altered")


def _halve(t: torch.Tensor) -> torch.Tensor:
    """The first half of the stacked rows doubled, the rest zero: the mean
    over half the positions."""
    t = t.clone()
    m = t.shape[0]
    t[m // 2:] = 0
    t[: m // 2] *= 2
    return t


def _no_exchange(monkeypatch):
    """Every stacked exchange keeps each node's own data."""
    from repro_torch.core.transport import StackedTransport

    def all_to_all(self, layer, *xs):
        return xs

    def all_gather(self, layer, *xs):
        k = self.plan.degrees[layer]
        return tuple(torch.cat([x] * k, dim=1) for x in xs)

    def reduce_scatter(self, layer, x):
        k = self.plan.degrees[layer]
        c = x.shape[1] // k
        j = self._position[layer]
        return torch.stack([x[n, int(j[n]) * c:(int(j[n]) + 1) * c]
                            for n in range(x.shape[0])])

    monkeypatch.setattr(StackedTransport, "all_to_all", all_to_all)
    monkeypatch.setattr(StackedTransport, "all_gather", all_gather)
    monkeypatch.setattr(StackedTransport, "reduce_scatter", reduce_scatter)
    monkeypatch.setattr(StackedTransport, "psum",
                        lambda self, x, axes=None: x)


def _pagerank_app(monkeypatch, out=None, update=None):
    import repro_torch.graph.pagerank as pr
    orig = pr.make_pagerank_app

    def make(*a, **k):
        app, o, i = orig(*a, **k)
        fields = {}
        if out is not None:
            fields["out_fn"] = lambda s, e, f=app.out_fn: out(f(s, e))
        if update is not None:
            fields["update_fn"] = update
        return dataclasses.replace(app, **fields), o, i
    monkeypatch.setattr(pr, "make_pagerank_app", make)


def _bump(t: torch.Tensor) -> torch.Tensor:
    t = t.clone()
    t.view(-1)[0] += 1.0
    return t


def _union(monkeypatch, before=None, after=None, instead=None):
    from repro_torch.core.api import SparseAllreduce
    orig = SparseAllreduce.union_reduce

    def reduce(self, idx, val, out_capacity):
        if instead is not None:
            return instead(idx, val, out_capacity)
        if before is not None:
            val = before(val)
        oi, ov, of = orig(self, idx, val, out_capacity)
        if after is not None:
            ov = after(ov)
        return oi, ov, of
    monkeypatch.setattr(SparseAllreduce, "union_reduce", reduce)


def _own_input(idx, val, out_capacity):
    from portbench.generate import SENTINEL
    m, c = idx.shape
    oi = torch.full((m, out_capacity), SENTINEL, dtype=torch.int64)
    ov = torch.zeros((m, out_capacity), dtype=val.dtype)
    oi[:, :c], ov[:, :c] = idx, val
    return oi, ov, torch.zeros(m, dtype=torch.int64)


def _train(monkeypatch, fault):
    import repro_torch.train.step as ts
    from repro_torch.optim.adamw import AdamW, AdamWState
    if fault == "state_unchanged":
        monkeypatch.setattr(
            AdamW, "update", lambda self, grads, state, params, gnorm=None,
            donate=False: (params, AdamWState(state.step + 1, state.m,
                                              state.v), gnorm))
    elif fault == "half_batch":
        orig = ts.sync_grads

        def sync(grads, *a, **k):
            def halve(tree):
                return {key: halve(v) if isinstance(v, dict) else _halve(v)
                        for key, v in tree.items()}
            return orig(halve(grads), *a, **k)
        monkeypatch.setattr(ts, "sync_grads", sync)
    elif fault == "answer_altered":
        orig_make = ts.make_train_step

        def make(*a, **k):
            step, specs = orig_make(*a, **k)

            def altered(*sa, **sk):
                params, st, mets = step(*sa, **sk)
                params["final_ln"] = _bump(params["final_ln"])
                return params, st, mets
            return altered, specs
        monkeypatch.setattr(ts, "make_train_step", make)


def plant(monkeypatch, cell: str, fault: str) -> None:
    if fault == "no_exchange":
        _no_exchange(monkeypatch)
    elif cell.startswith("pagerank"):
        if fault == "state_unchanged":
            _pagerank_app(monkeypatch, update=lambda s, i, e, tr: s)
        elif fault == "half_batch":
            _pagerank_app(monkeypatch, out=_halve)
        else:
            _pagerank_app(monkeypatch, out=_bump)
    elif cell.startswith("minibatch"):
        if fault == "state_unchanged":
            _union(monkeypatch, instead=_own_input)
        elif fault == "half_batch":
            _union(monkeypatch, before=_halve)
        else:
            _union(monkeypatch, after=_bump)
    else:
        _train(monkeypatch, fault)


@pytest.mark.parametrize("cell", CELLS)
def test_the_sound_run_is_correct(cell, small):
    line = harness.run_cell(cell, 2**31 + 101, 0.2, False, device="cpu",
                            overrides=small(cell))
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_not_correct(cell, fault, small, monkeypatch):
    plant(monkeypatch, cell, fault)
    line = harness.run_cell(cell, 2**31 + 101, 0.2, False, device="cpu",
                            overrides=small(cell))
    assert not line["correct"], line["checks"]
