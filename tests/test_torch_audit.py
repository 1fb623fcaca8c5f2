"""PyTorch port, the dispatch audits (``repro_torch.analysis``) held to ``repro.analysis.auditor``'s (ROADMAP Queue 1 item 15).

One subprocess on eight forced host devices runs the reference's
``audit_reduce`` over the sweep's index sets (``repro.analysis.cli``:
degrees (4,) and (2, 2), replication 1 and 2); the port's
``audit_reduce`` on the same index sets must count the same exchanges,
``2 * planned.depth``.  On the CPU: an injected second reduce fails
``all_to_all_count`` (4 * depth) and an injected ``.item()`` fails
``no_forbidden_primitives``; the PageRank engine audit (plain and
``overlap=True``, 5 rounds) and the bucketed sync audit pass, and an
injected extra psum in the overlapped schedule fails
``same_total_collectives``; ``audit_serve_decode`` passes the greedy
prefill and decode steps of reduced qwen1.5-0.5b and refuses the raw
decode step on both of its checks, as ``tests/test_serve_tier.py``
holds the reference's; the command line exits 0 on a clean sweep and 2
on a usage error.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.analysis import (audit_callable, audit_engine,
                                  audit_overlap_sync, audit_reduce,
                                  audit_serve_decode)
from repro_torch.analysis import cli
from repro_torch.core.topology import ButterflyPlan
from repro_torch.core.transport import StackedTransport

# one intra-op thread a test process: pytest-xdist runs several workers
# at once, and their OpenMP threads would oversubscribe the cores
torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
CASES = [((4,), 1), ((4,), 2), ((2, 2), 1), ((2, 2), 2)]

REFERENCE_CODE = r"""
import sys
import numpy as np, jax
from repro.analysis.auditor import audit_reduce
from repro.core.api import SparseAllreduce

out = {}
for degs, r in %(cases)r:
    m = int(np.prod(degs))
    rng = np.random.RandomState(m)
    out_idx = [rng.choice(4096, rng.randint(5, 16), replace=False)
               .astype(np.uint32) for _ in range(m)]
    in_idx = [rng.choice(4096, rng.randint(5, 16), replace=False)
              .astype(np.uint32) for _ in range(m)]
    ar = SparseAllreduce(m, degs, backend="device", replication=r,
                         mesh=jax.make_mesh((m * r,), ("d",)), seed=m)
    ar.config(out_idx, in_idx)
    rep = audit_reduce(ar)
    c = {x.check_id: x for x in rep.checks}["collectives_equal_plan_depth"]
    assert rep.ok, rep.to_dict()
    out[f"{degs}/{r}"] = np.asarray([c.expected, c.actual])
np.savez(sys.argv[1], **out)
print("REFERENCE_OK")
""" % {"cases": CASES}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's audit counts (one 8-device subprocess)."""
    out = tmp_path_factory.mktemp("audit") / "ref.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", REFERENCE_CODE, str(out)],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "REFERENCE_OK" in r.stdout, r.stderr[-4000:]
    with np.load(out) as f:
        return dict(f)


@pytest.fixture(autouse=True)
def _plan_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path / "plans"))


@pytest.mark.parametrize("degs,r", CASES)
def test_audit_reduce_counts_equal_reference(ref, degs, r):
    """The port's reduce issues ``2 * depth`` exchanges, the reference's
    traced ``all_to_all`` count for the same index sets."""
    rep = audit_reduce(cli.configured(degs, r, "cpu"))
    assert rep.ok, rep.to_dict()
    c = rep.check("collectives_equal_plan_depth")
    want_depth = len(degs) + (1 if r > 1 else 0)
    assert c.expected == c.actual == 2 * want_depth
    assert [c.expected, c.actual] == ref[f"{degs}/{r}"].tolist()


def test_audit_catches_injected_exchange_and_host_read():
    """A second reduce doubles the exchanges; an ``.item()`` inside the
    call is a host read."""
    ar = cli.configured((2, 2), 1, "cpu")
    planned, _ = ar.planned_parts()
    meta = ar.staging_metadata()
    f = ar.reduce_fn
    x = torch.zeros((meta["num_physical"], meta["u_cap"]))

    rep = audit_callable("doubled-reduce", lambda v: f(v) + f(v * 2.0), x,
                         expected_all_to_all=2 * planned.depth)
    bad = rep.check("all_to_all_count")
    assert not bad.ok and bad.actual == 4 * planned.depth, bad

    def leaky(v):
        out = f(v)
        float(out[0, 0].item())
        return out
    rep = audit_callable("leaky-reduce", leaky, x)
    forb = rep.check("no_forbidden_primitives")
    assert not forb.ok and "aten::_local_scalar_dense" in forb.actual, forb
    assert audit_callable("reduce", f, x).ok


@pytest.mark.parametrize("overlap", [False, True], ids=["plain", "overlap"])
def test_audit_engine_passes(overlap):
    """The PageRank engine's run: one dispatch, 2 * depth exchanges a
    round, the rotated schedule's split around its round loop."""
    engine, extras, p0 = cli.pagerank_engine("cpu", overlap)
    for k in (1, 5):
        rep = audit_engine(engine, k, p0, extras)
        assert rep.ok, rep.to_dict()
        per = rep.check("per_round_collectives_equal_plan_depth")
        assert per.actual == [2 * engine.planned.depth] * k
    split = [c.check_id for c in audit_engine(engine, 5, p0, extras).checks]
    assert ("prologue_epilogue_split" in split) == overlap
    assert ("no_collectives_outside_scan" in split) != overlap


def test_audit_overlap_sync_passes_and_catches_extra_psum():
    """The bucketed stage-major sync is a pure reordering of its
    bucket-major twin; a hidden extra whole-mesh sum is caught."""
    ov, sq, args, depth = cli.bucketed_sync_pair("cpu")
    rep = audit_overlap_sync("bucketed", ov, sq, *args, depth=depth,
                             n_buckets=len(args))
    assert rep.ok, rep.to_dict()

    whole = StackedTransport(ButterflyPlan(8, (8,)), "cpu")

    def smuggled(*xs):
        outs = ov(*xs)
        whole.psum(outs[0])
        return outs
    bad = audit_overlap_sync("smuggled", smuggled, sq, *args, depth=depth,
                             n_buckets=len(args))
    assert not bad.check("same_total_collectives").ok
    assert bad.check("stage_major_interleaving").ok


def test_audit_serve_decode_passes_greedy_refuses_raw():
    """Greedy prefill / decode steps return int32 ids and no vocab-sized
    float output; the raw decode step fails both output checks."""
    cfg, params, pf, dg, dr, batch, ids, pos, cache = cli.serve_steps("cpu")
    rep = audit_serve_decode("prefill", pf, params, batch, vocab=cfg.vocab)
    assert rep.ok, rep.to_dict()
    rep = audit_serve_decode("decode", dg, params, ids, pos, cache,
                             vocab=cfg.vocab)
    assert rep.ok, rep.to_dict()
    raw = audit_serve_decode("raw", dr, params, ids, pos, cache,
                             vocab=cfg.vocab)
    assert not raw.check("no_vocab_sized_float_output").ok
    assert not raw.check("token_ids_output_is_integer").ok
    assert raw.check("no_forbidden_primitives").ok


def test_cli_exit_codes(capsys):
    """``--audit --device cpu`` is clean (0); no action is a usage error
    (2), as is an unknown flag."""
    assert cli.main(["--audit", "--device", "cpu"]) == 0
    assert "-> clean" in capsys.readouterr().out
    assert cli.main([]) == 2
    assert cli.main(["--bogus"]) == 2
