"""PyTorch port, the split-KV and 2D weight-stationary decode layouts held to ``repro.train.step``'s (ROADMAP Queue 1 item 15).

One subprocess on four forced host devices runs the reference's own
serve2d test inputs (``tests/test_device_allreduce.py``'s
``SERVE2D_CODE``): reduced float32 command-r-plus-104b,
arctic-480b and jamba-1.5-large-398b, all with ``fsdp=True``, at (data, model) =
(2, 2), B = 4 rows, a prompt of 12 tokens, 16 cache slots; the prefill
cache and the greedy token go to the gather decode and the serve2d
decode.  The split-KV cases run on command-r's cache of 2 rows and 16
slots, each leaf filled with ``0.1 * randn`` (seed 1), at (2, 2) with 2
sequence shards, with and without serve2d: pos 5; pos 7 then 8, the
second step crossing the shard boundary at slot 8 on the cache the first
returned; and a window of 4 slots at pos 9, which straddles the boundary
(slots 6-9).  The port runs its own steps on the same weights
(``params_from_jax``'s copy) and the reference's caches.

Held: every port logit and every updated cache leaf equals the
reference's within rtol = atol = 1e-4 (float32).  Measured: at most
2.2e-5 on the logits (jamba's serve2d; its gather decode differs by
1.7e-5 already, the mamba blocks' own accumulation orders), 3e-6 on the
other logits, and at most 6.2e-6 of a leaf's max |value| on the caches.
At (data, model) = (2, 1) the data-axis exchange census of one decode
step of each layout (the port's ``ExchangeCensus``) equals the
reference's jaxpr census: its collectives over ``data`` inside the
period scan times n_periods, plus those outside.  Reduced arctic in
bf16, as arctic is published, is held to the port's own gather decode
on the rows both paths route alike (``BF16_REL``).
"""
import dataclasses
import os
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch.analysis.auditor import ExchangeCensus
from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.train import step as S

# one intra-op thread a test process: pytest-xdist runs several workers
# at once, and their OpenMP threads would oversubscribe the cores
torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
B, PROMPT, MAX = 4, 12, 16
SEQ_B = 2
TOL = 1e-4
ARCHS = (("commandr", "command-r-plus-104b", {"fsdp": True}),
         ("arctic", "arctic-480b", {"fsdp": True}),
         ("jamba", "jamba-1.5-large-398b", {"fsdp": True}))
# (name, window override, positions of consecutive steps)
SEQ_CASES = (("pos5", 0, (5,)), ("boundary", 0, (7, 8)),
             ("window", 4, (9,)))
# (name, arch, config kw, decode-step kw) of the census at (2, 1)
CENSUS = (("splitkv", "command-r-plus-104b", {},
           {"seq_sharded": True}),
          ("serve2d", "command-r-plus-104b", {"fsdp": True},
           {"serve2d": True}),
          ("splitkv_2d", "command-r-plus-104b", {"fsdp": True},
           {"seq_sharded": True, "serve2d": True}),
          ("serve2d_moe", "arctic-480b", {"fsdp": True}, {"serve2d": True}),
          ("serve2d_hybrid", "jamba-1.5-large-398b", {"fsdp": True},
           {"serve2d": True}))

REFERENCE_CODE = r"""
import dataclasses, sys
from collections import Counter
import numpy as np, jax, jax.numpy as jnp
from repro.analysis.auditor import iter_eqns
from repro.configs import get_config
from repro.models import transformer as T
from repro.train.step import (init_cache_global, make_decode_step,
                              make_prefill_step, mesh_ctx)

B, S, MAX, SEQ_B = %(b)d, %(s)d, %(max)d, %(seq_b)d
ARCHS, SEQ_CASES, CENSUS = %(archs)r, %(seq_cases)r, %(census)r

def leaves(tree, prefix=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], prefix + (k,))]
    if isinstance(tree, tuple):
        return [x for i, t in enumerate(tree) for x in leaves(t, prefix + (str(i),))]
    return [(prefix, tree)]

def dump(out, key, tree):
    for p, v in leaves(tree):
        out[key + "/" + "/".join(p)] = np.asarray(v)

out = {}
mesh = jax.make_mesh((2, 2), ("data", "model"))
rng = np.random.RandomState(0)
toks = rng.randint(0, 512, (B, S)).astype(np.int32)
out["tokens"] = toks
pos = jnp.full((B,), S, jnp.int32)
for name, arch, kw in ARCHS:
    cfg = get_config(arch).reduced(**kw)
    params = T.init_params(cfg, tp=2, seed=0)
    dump(out, f"{name}/init", params)
    prefill, _ = make_prefill_step(cfg, mesh, max_seq=MAX)
    lg, cache = prefill(params, {"tokens": jnp.asarray(toks)})
    dump(out, f"{name}/cache", cache)
    tok = jnp.asarray(np.argmax(np.asarray(lg), -1), jnp.int32)
    out[f"{name}/tok"] = np.asarray(tok)
    for mode, s2d in (("gather", False), ("serve2d", True)):
        lgd, new = make_decode_step(cfg, mesh, serve2d=s2d)[0](
            params, tok, pos, cache)
        out[f"{name}/{mode}"] = np.asarray(lgd)
        dump(out, f"{name}/{mode}_cache", new)

for wname, window, positions in SEQ_CASES:
    cfg = get_config("command-r-plus-104b").reduced(fsdp=True)
    if window:
        cfg = dataclasses.replace(cfg, window=window,
                                  window_pattern=(window,) * len(cfg.pattern))
    params = T.init_params(cfg, tp=2, seed=0)
    cache0 = init_cache_global(cfg, mesh_ctx(mesh), SEQ_B, MAX)
    cache0 = jax.tree.map(
        lambda x: jnp.asarray(np.random.RandomState(1).randn(*x.shape),
                              x.dtype) * 0.1, cache0)
    if wname == "pos5":
        dump(out, "seqcache", cache0)
    tok2 = jnp.asarray(np.random.RandomState(2).randint(0, cfg.vocab, (SEQ_B,)),
                       jnp.int32)
    out["seqtok"] = np.asarray(tok2)
    for mode, s2d in (("splitkv", False), ("splitkv_2d", True)):
        step = make_decode_step(cfg, mesh, seq_sharded=True, seq_shards=2,
                                serve2d=s2d)[0]
        cache = cache0
        for i, p in enumerate(positions):
            lg, cache = step(params, tok2, jnp.full((SEQ_B,), p, jnp.int32),
                             cache)
            out[f"{wname}/{mode}/{i}"] = np.asarray(lg)
        dump(out, f"{wname}/{mode}/cache", cache)

mesh21 = jax.make_mesh((2, 1), ("data", "model"))
def data_axis(eqn):
    p = eqn.params
    names = p.get("axes", p.get("axis_name", ()))
    names = names if isinstance(names, (tuple, list)) else (names,)
    return "data" in names
COLL = {"psum": "psum", "psum2": "psum", "psum_invariant": "psum",
        "pmax": "pmax", "all_gather": "all_gather",
        "all_to_all": "all_to_all", "reduce_scatter": "reduce_scatter"}
for name, arch, ckw, skw in CENSUS:
    cfg = get_config(arch).reduced(**ckw)
    params = T.init_params(cfg, tp=1, seed=0)
    seq = skw.get("seq_sharded", False)
    b = SEQ_B if seq else 2
    cache = init_cache_global(cfg, mesh_ctx(mesh21), b, MAX)
    step = make_decode_step(cfg, mesh21, seq_shards=2 if seq else 1,
                            **skw)[0]
    jaxpr = jax.make_jaxpr(step)(params, jnp.zeros((b,), jnp.int32),
                                 jnp.full((b,), 5, jnp.int32), cache).jaxpr
    c = Counter()
    for eqn, in_scan in iter_eqns(jaxpr):
        kind = COLL.get(eqn.primitive.name)
        if kind and data_axis(eqn):
            c[kind] += cfg.n_periods if in_scan else 1
    for k, v in c.items():
        out[f"census/{name}/{k}"] = np.asarray(v)
np.savez(sys.argv[1], **out)
print("REFERENCE_OK")
""" % {"b": B, "s": PROMPT, "max": MAX, "seq_b": SEQ_B, "archs": ARCHS,
       "seq_cases": SEQ_CASES, "census": CENSUS}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's arrays (one 4-device subprocess for the file)."""
    out = tmp_path_factory.mktemp("layouts") / "ref.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", REFERENCE_CODE, str(out)],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "REFERENCE_OK" in r.stdout, r.stderr[-4000:]
    with np.load(out) as f:
        return dict(f)


def _params(ref, name, cfg, tp):
    like = T.init_params(cfg, tp, seed=0, device="cpu")
    return T.params_from_jax(
        T.tree_from_leaves(like, [(p, ref[f"{name}/init/" + "/".join(p)])
                                  for p, _ in T.tree_leaves(like)]),
        cfg, device="cpu")


def _cache(ref, key, like):
    """The port's cache tree ``like`` filled from the reference's leaves."""
    for path, leaf in T.cache_leaves(like):
        leaf.copy_(torch.as_tensor(ref[f"{key}/" + "/".join(path)]))
    return like


def _close(got, want, what):
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL,
                               err_msg=what)


@pytest.mark.parametrize("arch", ARCHS, ids=[a[0] for a in ARCHS])
def test_serve2d_matches_reference(ref, arch):
    """The gather and serve2d decode logits (and updated caches) of reduced
    command-r, arctic and jamba at (2, 2) equal the reference's."""
    name, full, kw = arch
    cfg = get_config(full).reduced(**kw)
    params = _params(ref, name, cfg, 2)
    mc = S.mesh_ctx(2, 2, device="cpu")
    pos = np.full(B, PROMPT)
    for mode, s2d in (("gather", False), ("serve2d", True)):
        cache = _cache(ref, f"{name}/cache",
                       S.init_cache_global(cfg, mc, B, MAX))
        step, _ = S.make_decode_step(cfg, mc, serve2d=s2d)
        logits, cache = step(params, ref[f"{name}/tok"], pos, cache)
        _close(logits, ref[f"{name}/{mode}"], f"{name} {mode}")
        for path, leaf in T.cache_leaves(cache):
            _close(leaf, ref[f"{name}/{mode}_cache/" + "/".join(path)],
                   f"{name} {mode} cache {path}")
        if s2d and cfg.n_experts:
            assert all(float(d.max()) == 0.0
                       for d in step.capture["moe_dropped"])


@pytest.mark.parametrize("case", SEQ_CASES, ids=[c[0] for c in SEQ_CASES])
@pytest.mark.parametrize("serve2d", [False, True], ids=["splitkv", "2d"])
def test_splitkv_matches_reference(ref, case, serve2d):
    """Split-KV decode, with and without serve2d, at (2, 2) over 2
    sequence shards: every step's logits and the final cache equal the
    reference's (pos 5; pos 7 then 8 across the shard boundary; a
    4-slot window straddling it)."""
    wname, window, positions = case
    cfg = get_config("command-r-plus-104b").reduced(fsdp=True)
    if window:
        cfg = dataclasses.replace(cfg, window=window,
                                  window_pattern=(window,) * len(cfg.pattern))
    params = _params(ref, "commandr", cfg, 2)
    mc = S.mesh_ctx(2, 2, device="cpu")
    mode = "splitkv_2d" if serve2d else "splitkv"
    cache = _cache(ref, "seqcache",
                   S.init_cache_global(cfg, mc, SEQ_B, MAX, seq_sharded=True))
    step, _ = S.make_decode_step(cfg, mc, seq_sharded=True, serve2d=serve2d)
    for i, p in enumerate(positions):
        logits, cache = step(params, ref["seqtok"], np.full(SEQ_B, p), cache)
        _close(logits, ref[f"{wname}/{mode}/{i}"], f"{wname} {mode} {i}")
    for path, leaf in T.cache_leaves(cache):
        _close(leaf, ref[f"{wname}/{mode}/cache/" + "/".join(path)],
               f"{wname} {mode} cache {path}")


@pytest.mark.parametrize("case", CENSUS, ids=[c[0] for c in CENSUS])
def test_data_axis_census_matches_reference(ref, case):
    """One decode step's exchanges over the data axis, by kind, at (2, 1):
    the reference's jaxpr census (inside the scan x n_periods, plus
    outside) equals the port's exchange census."""
    name, arch, ckw, skw = case
    cfg = get_config(arch).reduced(**ckw)
    mc = S.mesh_ctx(2, 1, device="cpu")
    seq = skw.get("seq_sharded", False)
    b = SEQ_B if seq else 2
    params = T.init_params(cfg, 1, seed=0, device="cpu")
    cache = S.init_cache_global(cfg, mc, b, MAX, seq_sharded=seq)
    step, _ = S.make_decode_step(cfg, mc, **skw)
    with ExchangeCensus() as ex:
        step(params, np.zeros(b), np.full(b, 5), cache)
    want = Counter({k.rsplit("/", 1)[1]: int(v) for k, v in ref.items()
                    if k.startswith(f"census/{name}/")})
    assert sum(want.values()) > 0
    assert ex.counts("data") == want, (name, dict(ex.counts("data")), want)


def test_splitkv_cache_and_layout_preconditions():
    """The split-KV cache is the global tensor; ``max_seq`` must split
    over the data positions; serve2d takes FSDP configs of attention /
    mamba blocks only, as the reference asserts."""
    cfg = get_config("qwen1.5-0.5b").reduced()
    mc = S.mesh_ctx(2, device="cpu")
    c = S.init_cache_global(cfg, mc, 2, 16, seq_sharded=True)
    assert c["b0"]["k"].shape == (cfg.n_periods, 2, 16, cfg.n_kv, cfg.hd)
    with pytest.raises(ValueError, match="split"):
        S.init_cache_global(cfg, mc, 2, 15, seq_sharded=True)
    with pytest.raises(ValueError, match="fsdp archs only"):
        S.make_decode_step(cfg, mc, serve2d=True)
    xl = get_config("xlstm-1.3b").reduced(fsdp=True)
    with pytest.raises(ValueError, match="attn/mamba"):
        S.make_decode_greedy_step(xl, mc, serve2d=True)


# bf16 serve2d against the gather decode: max |logit difference| over max
# |logit| on the rows both route alike.  bf16 keeps 8 mantissa bits (a
# rounding of 2^-9 relative); the two paths round the d-wide products at
# different points (M partial sums against one), which a few layers
# amplify to about 1.4e-2 here, so 3e-2 holds with room and a wrong block
# (of order 1) does not pass.
BF16_REL = 3e-2


def test_serve2d_bf16_moe_matches_gather_decode(monkeypatch):
    """Reduced arctic-480b with ``fsdp=True`` in bf16, as arctic is
    published: eight greedy serve2d decode steps at (2, 2) against the
    gather decode of a one-position mesh on the same prefill cache.  The
    routing of every row is recorded from ``moe.router_topk`` on both
    paths; on the rows routed alike (at least 3 in 4, as the smoke asks
    at full width) the logits agree within BF16_REL x max |logit|, and
    an empty cache reads outside it."""
    from repro_torch.models import moe as MOE
    cfg = dataclasses.replace(get_config("arctic-480b").reduced(fsdp=True),
                              dtype=torch.bfloat16)
    mc, one = S.mesh_ctx(2, 2, device="cpu"), S.mesh_ctx(1, 1, device="cpu")
    params = T.init_params(cfg, 2, seed=0, device="cpu")
    toks = np.random.RandomState(3).randint(0, cfg.vocab, (B, 8))
    tok, cache = S.make_prefill_greedy_step(cfg, one, MAX * 2)[0](
        params, {"tokens": toks})
    layout = S.make_decode_step(cfg, mc, serve2d=True)[0]
    twin = S.make_decode_step(cfg, one)[0]
    orig, seen = MOE.router_topk, []

    def record(logits, c):
        out = orig(logits, c)
        seen.append(out[2].reshape(-1, B, c.top_k)[0].sort(-1).values)
        return out
    monkeypatch.setattr(MOE, "router_topk", record)
    pos, alike, worst = np.full(B, 8), 0, 0.0
    for i in range(8):
        seen.clear()
        la, cache = layout(params, tok, pos + i, cache)
        lb, cache = twin(params, tok, pos + i, cache)
        half = len(seen) // 2
        same = torch.stack([(a == b).all(-1) for a, b in
                            zip(seen[:half], seen[half:])]).all(0)
        la, lb = la[:, :cfg.vocab].float(), lb[:, :cfg.vocab].float()
        alike += int(same.sum())
        if same.any():
            worst = max(worst, float((la - lb).abs().amax(-1)[same].max()
                                     / lb.abs().max()))
        tok = la.argmax(-1)
    assert alike >= 0.75 * 8 * B, alike
    assert worst <= BF16_REL, worst
    empty = {k: {n: torch.zeros_like(t) for n, t in v.items()}
             for k, v in cache.items()}
    le, _ = twin(params, tok, pos + 8, empty)
    ll, _ = layout(params, tok, pos + 8, cache)
    assert float((ll - le).abs().max() / le.abs().max()) > BF16_REL
