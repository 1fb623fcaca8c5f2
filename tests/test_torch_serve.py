"""PyTorch port, the serving steps held to ``repro.train.step``'s (ROADMAP Queue 1 item 14).

One subprocess on two forced host devices runs the reference's
``make_prefill_step``, ``make_decode_step``, ``make_prefill_greedy_step``
and ``make_decode_greedy_step`` (and, for whisper, ``build_cross_cache``
under ``shard_map``) on reduced float32 configs from one seed, B = 2
rows, a prompt of ``S`` = 8 tokens (a VLM's 8 image tokens before it),
``MAX`` = 24 cache slots, then three teacher-forced decode steps: at
(data, model) = (2, 1) qwen1.5-0.5b (dense, QKV bias, tied), gemma3-12b
(sliding window), granite-moe-3b-a800m (MoE), xlstm-1.3b (mLSTM and
sLSTM), jamba-1.5-large-398b (mamba, attention, dense and MoE FFNs),
whisper-base (cross cache) and internvl2-26b (image prefix, FSDP), and
qwen at (1, 2) (tp = 2).  The port runs its own steps on the same
weights (``params_from_jax``'s copy) at the same (data, model).

Held, each relative to the reference array's max |value|: the prefill
logits [B, V_pad], every cache leaf after the prefill (attention k / v,
mamba ``h`` / ``conv``, mLSTM ``S`` / ``N`` / ``m``, the sLSTM tuple),
whisper's cross cache, and the logits of each decode step, within rtol
1e-5 + 1e-5 x max for the attention and MoE families (the models test's
loss bound; measured at most 2e-6 x max) and within rtol 1e-4 + 1e-4 x
max for the families with an SSM block, whose stack the SSM test bounds
at 1e-3 x max (its gradients); measured at most 6e-5 x max, the sLSTM
state, and 1.6e-5 x max, jamba's logits; the greedy ids of the prefill and
of the first decode step equal the reference's wherever its top-two
logit margin exceeds twice that bound, are int32 and below the vocab.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer as T
from repro_torch.train import step as S

# one intra-op thread a test process: pytest-xdist runs several workers
# at once, and their OpenMP threads would oversubscribe the cores
torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
PROMPT, MAX, B, STEPS = 8, 24, 2, 3
CASES = (("qwen", "qwen1.5-0.5b", {}, 2, 1),
         ("gemma", "gemma3-12b", {}, 2, 1),
         ("granite", "granite-moe-3b-a800m", {}, 2, 1),
         ("xlstm", "xlstm-1.3b", {}, 2, 1),
         ("jamba", "jamba-1.5-large-398b", {}, 2, 1),
         ("whisper", "whisper-base", {}, 2, 1),
         ("internvl", "internvl2-26b", {"fsdp": True}, 2, 1),
         ("qwen_tp2", "qwen1.5-0.5b", {}, 1, 2))
# (rtol, atol as a multiple of the reference array's max |value|)
DENSE_TOL, SSM_TOL = (1e-5, 1e-5), (1e-4, 1e-4)

REFERENCE_CODE = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.configs import get_config
from repro.models import transformer as T
from repro.models.sharding import full_model_pspec
from repro.train import step as RS

S, MAX, B, STEPS = %(s)d, %(max)d, %(b)d, %(steps)d
CASES = %(cases)r

def leaves(tree, prefix=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], prefix + (k,))]
    if isinstance(tree, tuple):
        return [x for i, t in enumerate(tree) for x in leaves(t, prefix + (str(i),))]
    return [(prefix, tree)]

out = {}
for name, arch, kw, dp, tp in CASES:
    cfg = get_config(arch).reduced(**kw)
    mesh = jax.make_mesh((dp, tp), ("data", "model"))
    params = T.init_params(cfg, tp, seed=0)
    for p, v in leaves(params):
        out[f"{name}/init/" + "/".join(p)] = np.asarray(v)
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab, (B, S + STEPS)).astype(np.int32)
    out[f"{name}/tokens"] = toks
    batch = {"tokens": jnp.asarray(toks[:, :S])}
    if cfg.img_tokens:
        img = rng.randn(B, cfg.img_tokens, cfg.d_model).astype(np.float32)
        out[f"{name}/img_embeds"] = img
        batch["img_embeds"] = jnp.asarray(img)
    if cfg.enc_layers:
        fr = rng.randn(B, cfg.enc_seq, cfg.d_model).astype(np.float32)
        out[f"{name}/enc_frames"] = fr
        batch["enc_frames"] = jnp.asarray(fr)
    prefill, _ = RS.make_prefill_step(cfg, mesh, MAX)
    decode, _ = RS.make_decode_step(cfg, mesh)
    gprefill, _ = RS.make_prefill_greedy_step(cfg, mesh, MAX)
    gdecode, _ = RS.make_decode_greedy_step(cfg, mesh)
    extra = ()
    if cfg.enc_layers:
        mc = RS.mesh_ctx(mesh)
        ax = mc.axis_ctx(cfg)
        ccfn = jax.jit(shard_map(
            lambda p, f: T.build_cross_cache(p, f, cfg, ax), mesh=mesh,
            in_specs=(full_model_pspec(cfg, mc.tp, mc.dp_axes), P("data")),
            out_specs=(P(None, "data", None, "model", None),
                       P(None, "data", None, "model", None)),
            check_vma=False))
        extra = (ccfn(params, batch["enc_frames"]),)
        for i, c in enumerate(extra[0]):
            out[f"{name}/cross/{i}"] = np.asarray(c)
    logits, cache = prefill(params, batch)
    out[f"{name}/prefill"] = np.asarray(logits)
    for p, v in leaves(cache):
        out[f"{name}/cache/" + "/".join(p)] = np.asarray(v)
    ids, gcache = gprefill(params, batch)
    out[f"{name}/greedy_prefill"] = np.asarray(ids)
    pos0 = S + cfg.img_tokens
    gids, _ = gdecode(params, jnp.asarray(toks[:, S]),
                      jnp.full((B,), pos0, jnp.int32), gcache, *extra)
    out[f"{name}/greedy_decode"] = np.asarray(gids)
    for i in range(STEPS):
        lg, cache = decode(params, jnp.asarray(toks[:, S + i]),
                           jnp.full((B,), pos0 + i, jnp.int32), cache, *extra)
        out[f"{name}/decode{i}"] = np.asarray(lg)
np.savez(sys.argv[1], **out)
print("REFERENCE_OK")
""" % {"s": PROMPT, "max": MAX, "b": B, "steps": STEPS,
       "cases": CASES}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's arrays (one 2-device subprocess for the file)."""
    out = tmp_path_factory.mktemp("serve") / "ref.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", REFERENCE_CODE, str(out)],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "REFERENCE_OK" in r.stdout, r.stderr[-4000:]
    with np.load(out) as f:
        return dict(f)


def _tol(cfg):
    return SSM_TOL if any(b != "attn" for b in cfg.pattern) else DENSE_TOL


def _close(got, want, tol, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=tol[0],
                               atol=tol[1] * float(np.abs(want).max()),
                               err_msg=what)


def _greedy_equal(ids, logits, want, cfg, tol):
    """ids [B] int32 below the vocab, equal to ``want`` wherever the
    reference's top-two margin exceeds twice the logits' bound."""
    assert ids.dtype == torch.int32 and ids.shape == (B,)
    assert int(ids.max()) < cfg.vocab and int(ids.min()) >= 0
    real = logits[:, :cfg.vocab]
    top2 = np.sort(real, axis=-1)[:, -2:]
    bound = 2 * (tol[1] * float(np.abs(logits).max())
                 + tol[0] * np.abs(top2[:, 1]))
    sure = top2[:, 1] - top2[:, 0] > bound
    assert sure.any()
    assert np.array_equal(ids.numpy()[sure], want[sure])


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_serving_steps_match_reference(ref, case):
    """Prefill logits and cache, whisper's cross cache, three decode
    steps' logits and the greedy ids against the reference's (the module
    docstring's bounds)."""
    name, arch, kw, dp, tp = case
    cfg = get_config(arch).reduced(**kw)
    tol = _tol(cfg)
    like = T.init_params(cfg, tp, seed=0, device="cpu")
    params = T.params_from_jax(
        T.tree_from_leaves(like, [(p, ref[f"{name}/init/" + "/".join(p)])
                                  for p, _ in T.tree_leaves(like)]),
        cfg, device="cpu")
    mc = S.mesh_ctx(dp, tp, device="cpu")
    toks = ref[f"{name}/tokens"]
    batch = {"tokens": toks[:, :PROMPT]}
    for k in ("img_embeds", "enc_frames"):
        if f"{name}/{k}" in ref:
            batch[k] = ref[f"{name}/{k}"]
    extra = ()
    if cfg.enc_layers:
        cross = launch_serve._cross_cache(cfg, mc, params, batch["enc_frames"])
        for i, c in enumerate(cross):
            _close(c, ref[f"{name}/cross/{i}"], tol, f"{name} cross {i}")
        extra = (cross,)
    prefill, _ = S.make_prefill_step(cfg, mc, MAX)
    decode, _ = S.make_decode_step(cfg, mc)
    logits, cache = prefill(params, batch)
    _close(logits, ref[f"{name}/prefill"], tol, f"{name} prefill")
    for path, leaf in T.cache_leaves(cache):
        want = ref[f"{name}/cache/" + "/".join(path)]
        assert leaf.shape == want.shape and leaf.dtype == cfg.dtype \
            or leaf.dtype == torch.float32, (path, leaf.shape, leaf.dtype)
        _close(leaf, want, tol, f"{name} cache {path}")
    pos0 = PROMPT + cfg.img_tokens
    for i in range(STEPS):
        logits, cache = decode(params, toks[:, PROMPT + i],
                               np.full(B, pos0 + i, np.int32), cache, *extra)
        _close(logits, ref[f"{name}/decode{i}"], tol, f"{name} decode {i}")

    gprefill, _ = S.make_prefill_greedy_step(cfg, mc, MAX)
    gdecode, _ = S.make_decode_greedy_step(cfg, mc)
    ids, gcache = gprefill(params, batch)
    _greedy_equal(ids, ref[f"{name}/prefill"], ref[f"{name}/greedy_prefill"],
                  cfg, tol)
    ids, _ = gdecode(params, toks[:, PROMPT], np.full(B, pos0, np.int32),
                     gcache, *extra)
    _greedy_equal(ids, ref[f"{name}/decode0"], ref[f"{name}/greedy_decode"],
                  cfg, tol)
