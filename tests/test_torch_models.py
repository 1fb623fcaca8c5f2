"""PyTorch port, the dense model family held to ``repro.models``.

The reference runs in this process on one CPU device (a 1 x 1 ``data`` x
``model`` mesh under ``shard_map``, where its vocab collectives are
identities, as the port's are at tp = 1).  Both packages get the same
weights: the reference's ``init_params`` copied over with
``params_from_jax``.  For the reduced (float32) ``qwen1.5-0.5b`` (QKV
bias, silu), ``starcoder2-15b`` (GQA, gelu) and ``gemma3-12b`` (a 5:1
sliding-window pattern): ``forward_loss`` within rtol 1e-5 and every
gradient leaf within rtol 1e-4, atol 1e-6.  On their own: ``rope``,
``rmsnorm``, the GQA attention with causal and window masks, the
embedding and head loss; ``zipf_tokens`` and ``Batcher`` byte for byte;
``AdamW.update`` within rtol 1e-6; the weight copy both ways.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from repro.compat import shard_map
from repro.configs import get_config as jget_config
from repro.data.pipeline import Batcher as JBatcher, zipf_tokens as jzipf
from repro.models import attention as JA
from repro.models import common as JC
from repro.models import transformer as JT
from repro.optim.adamw import AdamW as JAdamW

from repro_torch.configs import ARCHS, get_config
from repro_torch.data.pipeline import Batcher, zipf_tokens
from repro_torch.models import attention as A
from repro_torch.models import common as C
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamW

# one intra-op thread a test process: pytest-xdist runs several workers
# at once, and their OpenMP threads would oversubscribe the cores
torch.set_num_threads(1)

ARCH_NAMES = ["qwen1.5-0.5b", "starcoder2-15b", "gemma3-12b"]
B, S = 2, 32


def _mesh_fn(fn):
    """``fn`` run inside shard_map on a 1 x 1 (data, model) mesh, every
    argument replicated."""
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    return shard_map(fn, mesh=mesh, in_specs=P(), out_specs=P(),
                     check_vma=False)


def _batch(vocab, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, vocab, (B, S)).astype(np.int32),
            rng.randint(0, vocab, (B, S)).astype(np.int32))


@pytest.fixture(scope="module", params=ARCH_NAMES)
def arch_case(request):
    """The reference's reduced config, weights, loss and gradients."""
    arch = request.param
    jcfg = jget_config(arch).reduced()
    jp = JT.init_params(jcfg, 1, seed=0)
    toks, labels = _batch(jcfg.vocab)
    ax = JT.AxisCtx()

    def loss_fn(p, t, l):
        return JT.forward_loss(p, t, l, jcfg, ax)[0]
    f = _mesh_fn(loss_fn)
    jl, jg = jax.jit(jax.value_and_grad(f))(jp, toks, labels)
    return dict(arch=arch, params=jax.tree.map(np.asarray, jp),
                loss=float(jl), grads=jax.tree.map(np.asarray, jg),
                toks=toks, labels=labels)


def test_forward_loss_and_gradients_match_reference(arch_case):
    cfg = get_config(arch_case["arch"]).reduced()
    tp = T.params_from_jax(arch_case["params"], cfg, device="cpu")
    leaves = T.tree_leaves(tp)
    ps = [p.requires_grad_(True) for _, p in leaves]
    loss, aux = T.forward_loss(tp, torch.as_tensor(arch_case["toks"]).long(),
                               torch.as_tensor(arch_case["labels"]).long(),
                               cfg)
    assert float(aux) == 0.0
    np.testing.assert_allclose(float(loss.detach()), arch_case["loss"],
                               rtol=1e-5)
    gs = torch.autograd.grad(loss, ps)
    want = dict(T.tree_leaves(arch_case["grads"]))
    assert sorted(want) == sorted(p for p, _ in leaves)
    for (path, _), g in zip(leaves, gs):
        np.testing.assert_allclose(g.numpy(), want[path], rtol=1e-4,
                                   atol=1e-6, err_msg=str(path))


def test_params_copy_both_ways_and_port_init_shapes(arch_case):
    cfg = get_config(arch_case["arch"]).reduced()
    tp = T.params_from_jax(arch_case["params"], cfg, device="cpu")
    back = T.params_to_numpy(tp)
    for (p, a), (q, b) in zip(T.tree_leaves(arch_case["params"]),
                              T.tree_leaves(back)):
        assert p == q and a.dtype == b.dtype and np.array_equal(a, b)
    own = T.init_params(cfg, 1, seed=0, device="cpu")
    assert [(p, tuple(t.shape)) for p, t in T.tree_leaves(own)] == \
        [(p, a.shape) for p, a in T.tree_leaves(arch_case["params"])]
    again = T.init_params(cfg, 1, seed=0, device="cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b)
               in zip(T.tree_leaves(own), T.tree_leaves(again)))


def test_bfloat16_weights_copy_bit_for_bit():
    cfg = get_config("qwen1.5-0.5b").reduced(dtype=torch.bfloat16)
    jcfg = jget_config("qwen1.5-0.5b").reduced(dtype=jnp.bfloat16)
    jp = jax.tree.map(np.asarray, JT.init_params(jcfg, 1, seed=1))
    tp = T.params_from_jax(jp, cfg, device="cpu")
    assert tp["blocks"]["b0"]["attn"]["wq"].dtype == torch.bfloat16
    for (_, a), (_, b) in zip(T.tree_leaves(jp),
                              T.tree_leaves(T.params_to_numpy(tp))):
        assert a.dtype == b.dtype and \
            np.array_equal(a.view(np.uint16) if a.dtype.itemsize == 2 else a,
                           b.view(np.uint16) if b.dtype.itemsize == 2 else b)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_and_rmsnorm_match(theta):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 12, 3, 16).astype(np.float32)
    pos = np.tile(np.arange(12, dtype=np.int32), (2, 1))
    want = np.asarray(JC.rope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = C.rope(torch.as_tensor(x), torch.as_tensor(pos).long(), theta)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    g = rng.randn(16).astype(np.float32)
    want = np.asarray(JC.rmsnorm(jnp.asarray(x), jnp.asarray(g), 1e-6))
    got = C.rmsnorm(torch.as_tensor(x), torch.as_tensor(g), 1e-6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    for kind in ("silu", "gelu"):
        want = np.asarray(JC.act_fn(jnp.asarray(x), kind))
        np.testing.assert_allclose(C.act_fn(torch.as_tensor(x), kind).numpy(),
                                   want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("window,causal", [(0, True), (5, True), (0, False)])
def test_gqa_attention_and_masks_match(window, causal):
    jcfg = jget_config("starcoder2-15b").reduced()      # 4 heads over 2 kv
    cfg = get_config("starcoder2-15b").reduced()
    jp = JA.attn_params(jax.random.PRNGKey(3), jcfg, 1, jnp.float32)
    x = np.random.RandomState(2).randn(2, 20, cfg.d_model).astype(np.float32)

    def fn(p, x):
        return JA.attn_train(p, x, jcfg, "model", 1, window, causal=causal)
    want = np.asarray(_mesh_fn(fn)(jp, jnp.asarray(x)))
    tp = {k: torch.as_tensor(np.array(v)) for k, v in jp.items()}
    got = A.attn_train(tp, torch.as_tensor(x), cfg, 1, window, causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    mask = A.attn_mask(20, window, causal)
    rel = np.arange(20)[:, None] - np.arange(20)[None, :]
    ref = (rel >= 0) & (rel < (window or 21)) if causal else np.ones_like(rel, bool)
    assert np.array_equal(mask.numpy(), ref)


def test_embedding_and_head_loss_match():
    rng = np.random.RandomState(5)
    emb = rng.randn(64, 8).astype(np.float32)
    head = rng.randn(8, 64).astype(np.float32)
    ids = rng.randint(0, 64, (2, 6)).astype(np.int32)
    x = rng.randn(2, 6, 8).astype(np.float32)
    mask = (rng.rand(2, 6) > 0.3).astype(np.float32)
    want = np.asarray(_mesh_fn(lambda e, i: JC.embed(e, i, "model"))(emb, ids))
    got = C.embed(torch.as_tensor(emb), torch.as_tensor(ids).long())
    assert np.array_equal(got.numpy(), want)
    for m in (None, mask):
        def fn(x, h, l, m=m):
            return JC.lm_head_loss(x, h, l, "model",
                                   None if m is None else jnp.asarray(m))
        want = float(_mesh_fn(fn)(x, head, ids))
        got = C.lm_head_loss(torch.as_tensor(x), torch.as_tensor(head),
                             torch.as_tensor(ids).long(),
                             None if m is None else torch.as_tensor(m))
        np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_zipf_tokens_and_batcher_byte_identical():
    for seed, alpha in ((0, 1.2), (3, 1.05)):
        a = jzipf(np.random.RandomState(seed), (4, 33), 1000, alpha)
        b = zipf_tokens(np.random.RandomState(seed), (4, 33), 1000, alpha)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    ja = iter(JBatcher(vocab=500, batch=3, seq=16, seed=7))
    pa = iter(Batcher(vocab=500, batch=3, seq=16, seed=7))
    for _ in range(3):
        (t1, l1), (t2, l2) = next(ja), next(pa)
        assert t1.tobytes() == t2.tobytes() and l1.tobytes() == l2.tobytes()


def test_adamw_update_matches():
    rng = np.random.RandomState(9)
    params = {"a": rng.randn(4, 6).astype(np.float32),
              "b": {"c": rng.randn(6).astype(np.float32),
                    "d": rng.randn(2, 3, 4).astype(np.float32)}}
    grads = jax.tree.map(lambda p: rng.randn(*p.shape).astype(np.float32),
                         params)
    jopt, opt = JAdamW(lr=1e-2, grad_clip=0.5), AdamW(lr=1e-2, grad_clip=0.5)
    jst = jopt.init(jax.tree.map(jnp.asarray, params))
    tp = jax.tree.map(torch.as_tensor, params)
    st = opt.init(tp)
    jpar = jax.tree.map(jnp.asarray, params)
    for k in range(3):
        g = jax.tree.map(lambda x: x * (k + 1), grads)
        jpar, jst, jn = jopt.update(jax.tree.map(jnp.asarray, g), jst, jpar)
        tp, st, n = opt.update(jax.tree.map(torch.as_tensor, g), st, tp)
        np.testing.assert_allclose(float(n), float(jn), rtol=1e-6)
    assert int(st.step) == 3
    for (p, a), (_, b) in zip(T.tree_leaves(jax.tree.map(np.asarray, jpar)),
                              T.tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-6, atol=1e-7,
                                   err_msg=str(p))
    for (_, a), (_, b) in zip(T.tree_leaves(jax.tree.map(np.asarray, jst.v)),
                              T.tree_leaves(st.v)):
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-6)


def test_configs_copied_as_data():
    from repro.configs import ARCHS as JARCHS, LONG_CTX as JLONG, \
        SHAPES as JSHAPES, pair_plan as jpair
    from repro_torch.configs import LONG_CTX, SHAPES, pair_plan
    assert list(ARCHS) == list(JARCHS) and LONG_CTX == JLONG
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JSHAPES.items()}
    for name in ARCHS:
        a, b = dataclasses.asdict(ARCHS[name]), dataclasses.asdict(JARCHS[name])
        assert a.pop("dtype") == torch.bfloat16
        assert jnp.dtype(b.pop("dtype")) == jnp.bfloat16
        assert a == b, name
        assert ARCHS[name].param_count() == JARCHS[name].param_count()
        for shape in SHAPES:
            assert pair_plan(name, shape) == jpair(name, shape)
    for variant in ("untied", "swa"):
        a = dataclasses.asdict(get_config("qwen1.5-0.5b", variant))
        b = dataclasses.asdict(jget_config("qwen1.5-0.5b", variant))
        a.pop("dtype"), b.pop("dtype")
        assert a == b
    with pytest.raises(ValueError, match="variant"):
        get_config("qwen1.5-0.5b", "nope")


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "gemma3-12b"])
def test_position_stacked_forward_is_each_positions_own(arch):
    """Parameters broadcast over M positions run as one batched program:
    its losses and the gradients of their sum with respect to the
    broadcast copies equal each position's own forward and backward."""
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              tie_embeddings=arch == "gemma3-12b")
    params = T.init_params(cfg, 1, seed=4, device="cpu")
    rng = np.random.RandomState(8)
    toks = torch.as_tensor(rng.randint(0, cfg.vocab, (3, 2, 16)))
    labels = torch.as_tensor(rng.randint(0, cfg.vocab, (3, 2, 16)))
    leaves = T.tree_leaves(params)
    ps = [p.unsqueeze(0).expand((3,) + tuple(p.shape)).requires_grad_(True)
          for _, p in leaves]
    tree = T.tree_from_leaves(params, [(path, p) for (path, _), p
                                       in zip(leaves, ps)])
    loss, aux = T.forward_loss(tree, toks, labels, cfg)
    assert loss.shape == aux.shape == (3,)
    gs = torch.autograd.grad(loss.sum(), ps)
    for i in range(3):
        one = [p.clone().requires_grad_(True) for _, p in leaves]
        l1, _ = T.forward_loss(T.tree_from_leaves(params, [
            (path, p) for (path, _), p in zip(leaves, one)]), toks[i],
            labels[i], cfg)
        torch.testing.assert_close(loss[i], l1, rtol=1e-6, atol=0)
        for (path, _), g, g1 in zip(leaves, gs, torch.autograd.grad(l1, one)):
            torch.testing.assert_close(g[i], g1, rtol=1e-5, atol=1e-7,
                                       msg=str(path))


def test_stacked_head_loss_casts_one_position_at_a_time(monkeypatch):
    """``lm_head_loss`` with a position-stacked bfloat16 head broadcast
    over M = 3 (stride 0) equals the plain ``bmm`` of the float32 cast
    head (which materializes M float32 copies): losses, and the gradients
    of x and of the head (in bfloat16, the cast's backward), within rtol
    1e-6."""
    gen = torch.Generator().manual_seed(11)
    head = (torch.randn(16, 40, generator=gen) / 4).to(torch.bfloat16)
    x = torch.randn(3, 2, 5, 16, generator=gen)
    labels = torch.randint(0, 40, (3, 2, 5), generator=gen)
    mask = (torch.rand(3, 2, 5, generator=gen) > 0.3).float()
    outs = []
    for stacked in (True, False):
        h = head.unsqueeze(0).expand(3, 16, 40).requires_grad_(True)
        xx = x.clone().requires_grad_(True)
        if not stacked:
            monkeypatch.setattr(C._StackedHeadLogits, "apply",
                                lambda x32, hd: torch.bmm(
                                    x32, hd.to(torch.float32)))
        loss = C.lm_head_loss(xx, h, labels, mask)
        gx, gh = torch.autograd.grad(loss.sum(), (xx, h))
        assert loss.shape == (3,) and gh.dtype == torch.bfloat16
        outs.append((loss.detach(), gx, gh.float()))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
