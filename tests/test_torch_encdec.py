"""PyTorch port, the encoder-decoder and VLM stubs held to ``repro.models``.

The reference runs in this process on one CPU device (a 1 x 1 ``data`` x
``model`` mesh under ``shard_map``), and once in a subprocess on 4
forced host devices for three train steps of each model.  Both packages
get the same weights (``params_from_jax``) and the same numpy inputs
from a seed.  On reduced (float32) whisper-base (one encoder and one
decoder layer, 32 stub frames) and internvl2-26b (8 stub image tokens):
``cross_attn``, ``encode_kv`` and ``encoder_fwd`` within rtol 1e-5 +
1e-6 x max|value|; ``forward_loss`` with the frames, with the image
embeddings and with text alone within rtol 1e-5, every gradient leaf
within rtol 1e-5 + 1e-5 x max|leaf| (float32 sums in another order).
The VLM loss mask is 0 over the image positions and their labels 0.
The position-stacked forward equals each position's own.  Three
``make_train_step`` steps of reduced untied whisper-base and of reduced
untied internvl2 with ``fsdp=True`` (sparse sync, fused merge, M = 4,
degrees (2, 2)) track the reference's 4-device run: losses within rtol
1e-4, overflow equal (0).  The launcher runs both reduced models end to
end on the CPU.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as P

from repro.compat import shard_map
from repro.configs import get_config as jget_config
from repro.models import attention as JA
from repro.models import transformer as JT

from repro_torch.configs import get_config
from repro_torch.launch import train as launch_train
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamW
from repro_torch.train import step as S

# one intra-op thread a test process: pytest-xdist runs several workers
# at once, and their OpenMP threads would oversubscribe the cores
torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
B, SEQ = 2, 16
M, BATCH, STEPS, TRAIN_SEQ = 4, 8, 3, 32
DEGREES = {"data": (2, 2)}
TRAIN_ARCHS = {"whisper-base": False, "internvl2-26b": True}   # fsdp

REFERENCE_CODE = r"""
import dataclasses, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config
from repro.launch.train import batch_stream
from repro.models import transformer as T
from repro.optim.adamw import AdamW
from repro.train.step import make_train_step

def leaves(tree, prefix=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], prefix + (k,))]
    return [(prefix, tree)]

mesh = jax.make_mesh((%(m)d, 1), ("data", "model"))
out = {}
for arch, fsdp in %(archs)r.items():
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              tie_embeddings=False, fsdp=fsdp)
    params = T.init_params(cfg, 1, seed=0)
    out.update({arch + "/init/" + "/".join(p): np.asarray(v)
                for p, v in leaves(params)})
    step, _ = make_train_step(cfg, mesh, sync="sparse",
                              dp_degrees=%(degrees)r, sync_merge="fused",
                              sparse_tokens_hint=%(hint)d, donate=False)
    p, st = params, AdamW().init(params)
    stream = batch_stream(cfg, %(batch)d, %(seq)d, seed=0)
    losses, ovf = [], []
    for i in range(%(steps)d):
        b = {k: jnp.asarray(v) for k, v in next(stream).items()}
        p, st, m = step(p, st, b)
        losses.append(float(m["loss"]))
        ovf.append(int(m["sync_overflow"]))
    out[arch + "/losses"] = np.asarray(losses)
    out[arch + "/ovf"] = np.asarray(ovf)
np.savez(sys.argv[1], **out)
print("REFERENCE_OK")
""" % {"m": M, "archs": TRAIN_ARCHS, "degrees": DEGREES,
       "hint": BATCH * TRAIN_SEQ // M, "batch": BATCH, "seq": TRAIN_SEQ,
       "steps": STEPS}


def _mesh_fn(fn):
    """``fn`` run inside shard_map on a 1 x 1 (data, model) mesh, every
    argument replicated."""
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    return shard_map(fn, mesh=mesh, in_specs=P(), out_specs=P(),
                     check_vma=False)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(got, want, rel=1e-6, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=rel * float(np.abs(want).max()),
                               err_msg=what)


def _inputs(cfg, seed=0, b=B):
    """Tokens, labels and the frontend stub's inputs of ``cfg``."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab, (b, SEQ)).astype(np.int32)
    labels = rng.randint(0, cfg.vocab, (b, SEQ)).astype(np.int32)
    extra = {}
    if cfg.img_tokens:
        extra["extra_embeds"] = rng.randn(b, cfg.img_tokens,
                                          cfg.d_model).astype(np.float32)
    if cfg.enc_layers:
        extra["enc_frames"] = rng.randn(b, cfg.enc_seq,
                                        cfg.d_model).astype(np.float32)
    return toks, labels, extra


@pytest.fixture(scope="module")
def whisper():
    """Reduced whisper's reference weights (numpy) and config pair."""
    jcfg = jget_config("whisper-base").reduced()
    return jcfg, get_config("whisper-base").reduced(), \
        _np(JT.init_params(jcfg, 1, seed=0))


def test_cross_attn_and_encode_kv_match_reference(whisper):
    jcfg, cfg, params = whisper
    cp = jax.tree.map(lambda a: a[0], params["cross"])
    rng = np.random.RandomState(3)
    x = rng.randn(B, SEQ, cfg.d_model).astype(np.float32)
    enc = rng.randn(B, cfg.enc_seq, cfg.d_model).astype(np.float32)

    def ref(cp, x, enc):
        k, v = JA.encode_kv(cp, enc, jcfg, 1)
        return JA.cross_attn(cp, x, k, v, jcfg, "model", 1), k, v
    want = jax.jit(_mesh_fn(ref))(cp, x, enc)
    tcp = {k: _t(v) for k, v in cp.items()}
    k, v = A.encode_kv(tcp, _t(enc), cfg)
    assert k.shape == (B, cfg.enc_seq, cfg.kv_local(1), cfg.hd)
    got = A.cross_attn(tcp, _t(x), k, v, cfg)
    for g, w, what in zip((got, k, v), want, ("cross_attn", "k", "v")):
        _close(g.numpy(), w, what=what)


def test_encoder_fwd_matches_reference(whisper):
    jcfg, cfg, params = whisper
    frames = np.random.RandomState(4).randn(
        B, cfg.enc_seq, cfg.d_model).astype(np.float32)
    want = jax.jit(_mesh_fn(lambda p, f: JT.encoder_fwd(
        p, f, jcfg, JT.AxisCtx())))(params, frames)
    got = T.encoder_fwd(T.params_from_jax(params, cfg, device="cpu"),
                        _t(frames), cfg)
    _close(got.numpy(), want, what="encoder_fwd")


@pytest.mark.parametrize("arch,frontend", [("whisper-base", True),
                                           ("internvl2-26b", True),
                                           ("internvl2-26b", False)])
def test_forward_loss_and_gradients_match_reference(arch, frontend):
    """The loss with the frames / image embeddings (and internvl2 on its
    text alone) within rtol 1e-5, every gradient leaf within rtol 1e-5 +
    1e-5 x max|leaf|."""
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jp = JT.init_params(jcfg, 1, seed=0)
    toks, labels, extra = _inputs(cfg)
    if not frontend:
        extra = {}

    def loss_fn(p, t, l, ex):
        return JT.forward_loss(p, t, l, jcfg, JT.AxisCtx(), **ex)[0]
    jl, jg = jax.jit(jax.value_and_grad(_mesh_fn(loss_fn)))(
        jp, toks, labels, extra)
    tp = T.params_from_jax(_np(jp), cfg, device="cpu")
    leaves = T.tree_leaves(tp)
    ps = [p.requires_grad_(True) for _, p in leaves]
    loss, _ = T.forward_loss(tp, _t(toks).long(), _t(labels).long(), cfg,
                             **{k: _t(v) for k, v in extra.items()})
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    want = dict(T.tree_leaves(_np(jg)))
    assert sorted(want) == sorted(p for p, _ in leaves)
    for (path, _), g in zip(leaves, torch.autograd.grad(loss, ps)):
        _close(g.numpy(), want[path], rel=1e-5, what=str(path))


def test_params_copy_and_port_init_shapes(whisper):
    """The new leaves (``enc_blocks``, ``enc_ln``, ``cross``,
    ``ln_cross``) copy both ways exactly, and the port's own init has the
    reference's shapes and dtypes."""
    _, cfg, params = whisper
    tp = T.params_from_jax(params, cfg, device="cpu")
    for (p, a), (q, b) in zip(T.tree_leaves(params),
                              T.tree_leaves(T.params_to_numpy(tp))):
        assert p == q and a.dtype == b.dtype and np.array_equal(a, b)
    own = T.init_params(cfg, 1, seed=0, device="cpu")
    assert [(p, tuple(t.shape), str(t.dtype)) for p, t in T.tree_leaves(own)]\
        == [(p, a.shape, "torch." + str(a.dtype))
            for p, a in T.tree_leaves(params)]
    assert own["enc_blocks"]["b0"]["attn"]["wq"].shape[0] == cfg.enc_layers
    assert own["cross"]["wq"].shape[0] == cfg.n_periods


def test_vlm_loss_mask_zeroes_image_positions(monkeypatch):
    """The head sees labels 0 and mask 0 over the Ti image positions and
    the text's labels and mask (ones, or the caller's) after them."""
    cfg = get_config("internvl2-26b").reduced()
    params = T.init_params(cfg, 1, seed=1, device="cpu")
    toks, labels, extra = _inputs(cfg, seed=2)
    seen = []
    head_loss = T.lm_head_loss

    def spy(x, head, lbl, mask):
        seen.append((x.shape, lbl, mask))
        return head_loss(x, head, lbl, mask)
    monkeypatch.setattr(T, "lm_head_loss", spy)
    text_mask = torch.as_tensor(
        np.random.RandomState(5).randint(0, 2, toks.shape)).float()
    ti = cfg.img_tokens
    for mask in (None, text_mask):
        T.forward_loss(params, _t(toks).long(), _t(labels).long(), cfg,
                       extra_embeds=_t(extra["extra_embeds"]),
                       loss_mask=mask)
        shape, lbl, m = seen.pop()
        assert shape == (B, ti + SEQ, cfg.d_model)
        assert torch.equal(lbl[:, :ti], torch.zeros(B, ti, dtype=lbl.dtype))
        assert torch.equal(lbl[:, ti:], _t(labels).long())
        assert torch.equal(m[:, :ti], torch.zeros(B, ti))
        assert torch.equal(m[:, ti:], torch.ones(B, SEQ) if mask is None
                           else text_mask)


@pytest.mark.parametrize("arch", ["whisper-base", "internvl2-26b"])
def test_position_stacked_forward_is_each_positions_own(arch):
    """Parameters broadcast over M = 3 positions with different tokens and
    frontend inputs: losses and gradients equal each position's own."""
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              tie_embeddings=False)
    params = T.init_params(cfg, 1, seed=4, device="cpu")
    toks, labels, extra = _inputs(cfg, seed=8, b=6)
    toks, labels = (_t(a).long().reshape(3, 2, SEQ) for a in (toks, labels))
    extra = {k: _t(v).reshape((3, 2) + v.shape[1:]) for k, v in extra.items()}
    leaves = T.tree_leaves(params)
    ps = [p.unsqueeze(0).expand((3,) + tuple(p.shape)).requires_grad_(True)
          for _, p in leaves]
    loss, _ = T.forward_loss(T.tree_from_leaves(params, [
        (path, p) for (path, _), p in zip(leaves, ps)]), toks, labels, cfg,
        **extra)
    assert loss.shape == (3,)
    gs = torch.autograd.grad(loss.sum(), ps)
    for i in range(3):
        one = [p.clone().requires_grad_(True) for _, p in leaves]
        l1, _ = T.forward_loss(T.tree_from_leaves(params, [
            (path, p) for (path, _), p in zip(leaves, one)]), toks[i],
            labels[i], cfg, **{k: v[i] for k, v in extra.items()})
        torch.testing.assert_close(loss[i], l1, rtol=1e-6, atol=0)
        for (path, _), g, g1 in zip(leaves, gs, torch.autograd.grad(l1, one)):
            torch.testing.assert_close(g[i], g1, rtol=1e-5, atol=1e-7,
                                       msg=str(path))


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """The reference's three 4-device train steps of both models."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = tmp_path_factory.mktemp("encdec") / "ref.npz"
    r = subprocess.run([sys.executable, "-c", REFERENCE_CODE, str(out)],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "REFERENCE_OK" in r.stdout, r.stderr[-4000:]
    with np.load(out) as f:
        return dict(f)


@pytest.mark.parametrize("arch", sorted(TRAIN_ARCHS))
def test_three_train_steps_track_reference_4_devices(reference_runs, arch):
    """Reduced untied whisper-base, and internvl2 with ``fsdp=True``,
    sparse sync with the fused merge over M = 4 (degrees (2, 2)) on the
    launcher's batch stream (its frames / image embeddings included):
    the three losses within rtol 1e-4 of the reference's 4-device run
    from the same weights, overflow equal (0)."""
    ref = reference_runs
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              tie_embeddings=False, fsdp=TRAIN_ARCHS[arch])
    like = T.init_params(cfg, 1, device="cpu")
    params = T.tree_from_leaves(like, [
        (p, torch.as_tensor(ref[arch + "/init/" + "/".join(p)]))
        for p, _ in T.tree_leaves(like)])
    step, _ = S.make_train_step(cfg, S.mesh_ctx(M, device="cpu"),
                                sync="sparse", dp_degrees=DEGREES,
                                sync_merge="fused",
                                sparse_tokens_hint=BATCH * TRAIN_SEQ // M)
    st = AdamW().init(params)
    stream = launch_train.batch_stream(cfg, BATCH, TRAIN_SEQ, seed=0)
    losses, ovf = [], []
    for _ in range(STEPS):
        params, st, m = step(params, st, next(stream))
        losses.append(float(m["loss"]))
        ovf.append(int(m["sync_overflow"]))
    np.testing.assert_allclose(losses, ref[arch + "/losses"], rtol=1e-4)
    assert ovf == list(ref[arch + "/ovf"]) == [0] * STEPS


@pytest.mark.parametrize("arch", ["whisper-base", "internvl2-26b"])
def test_launcher_runs_reduced_frontends_on_cpu(arch, capsys, monkeypatch,
                                                tmp_path):
    """``--arch ... --reduced --device cpu`` trains end to end: the batch
    stream's frames / image embeddings reach the step."""
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path))
    loss = launch_train.main([
        "--arch", arch, "--reduced", "--device", "cpu", "--untied",
        "--sync", "sparse", "--merge", "fused", "--steps", "2", "--seq",
        "16", "--data-axis", "4", "--dp-degrees", "2,2"])
    assert np.isfinite(loss)
    assert "step     1" in capsys.readouterr().out
