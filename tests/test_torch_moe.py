"""PyTorch port, the MoE block held to ``repro.models.moe``.

The reference runs in this process on one CPU device (a 1 x 1 ``data`` x
``model`` mesh under ``shard_map``, where its two expert ``all_to_all``s
are over one device, as the port's dispatch is at tp = 1), and once in a
subprocess on 4 forced host devices for three train steps.  Both packages
get the same weights (``params_from_jax``).  Exact: the routing
(``router_topk``: weights, experts, ties to the lower expert), the
group-by (``_group_by``: slots and keep masks) and the dropped fraction.
Within rtol 1e-5 (+ 1e-5 x max|y|): ``moe_ffn`` on reduced granite-moe
(4 experts, top-2), at the default capacity and at ``moe_capacity=0.5``
(copies dropped); within rtol 1e-5 the loss of reduced granite-moe (``moe``) and arctic
(``moe+dense``); every gradient leaf within rtol 1e-4, atol 1e-6.  The
position-stacked MoE forward equals each position's own; three
``make_train_step`` steps of reduced untied granite-moe with sparse /
fused sync over M = 4 track the reference's 4-device run within rtol
1e-4.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from repro.compat import shard_map
from repro.configs import get_config as jget_config
from repro.models import moe as JMOE
from repro.models import transformer as JT

from repro_torch.configs import get_config
from repro_torch.launch import train as launch_train
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamW
from repro_torch.train import step as S

# one intra-op thread a test process: pytest-xdist runs several workers
# at once, and their OpenMP threads would oversubscribe the cores
torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
B, SEQ = 2, 32
M, BATCH, STEPS = 4, 8, 3
DEGREES = {"data": (2, 2)}

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

cfg = dataclasses.replace(get_config("granite-moe-3b-a800m").reduced(),
                          tie_embeddings=False)
mesh = jax.make_mesh((%(m)d, 1), ("data", "model"))
params = T.init_params(cfg, 1, seed=0)
out = {"init/" + "/".join(p): np.asarray(v) for p, v in leaves(params)}
step, _ = make_train_step(cfg, mesh, sync="sparse", dp_degrees=%(degrees)r,
                          sync_merge="fused", sparse_tokens_hint=%(hint)d,
                          donate=False)
p, st = params, AdamW().init(params)
stream = batch_stream(cfg, %(batch)d, %(seq)d, seed=0)
losses, auxes, ovf = [], [], []
for i in range(%(steps)d):
    b = {k: jnp.asarray(v) for k, v in next(stream).items()}
    p, st, m = step(p, st, b)
    losses.append(float(m["loss"]))
    auxes.append(float(m["aux"]))
    ovf.append(int(m["sync_overflow"]))
out["losses"], out["auxes"], out["ovf"] = (np.asarray(losses),
                                           np.asarray(auxes), np.asarray(ovf))
np.savez(sys.argv[1], **out)
print("REFERENCE_OK")
""" % {"m": M, "degrees": DEGREES, "hint": BATCH * SEQ // M, "batch": BATCH,
       "seq": SEQ, "steps": STEPS}


def _mesh_fn(fn):
    """``fn`` run inside shard_map on a 1 x 1 (data, model) mesh, every
    argument replicated."""
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    return shard_map(fn, mesh=mesh, in_specs=P(), out_specs=P(),
                     check_vma=False)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(tree):
    return {k: torch.as_tensor(np.array(v)) for k, v in tree.items()}


def test_router_topk_equals_reference_with_ties():
    """Softmax, top-k and renormalised weights on shared logits; rows with
    equal logits keep the lower expert first, as ``lax.top_k`` does."""
    jcfg = jget_config("granite-moe-3b-a800m")
    cfg = get_config("granite-moe-3b-a800m")
    rng = np.random.RandomState(0)
    logits = rng.randn(64, 48).astype(np.float32)        # 40 real, 8 padded
    logits[0, :] = 0.5                                   # every expert tied
    logits[1, 3] = logits[1, 7] = logits[1, 30] = 4.0    # a tie in the top
    logits[2, :40] = np.repeat(rng.randn(20), 2)         # pairs of equals
    probs, wk, ek = JMOE.router_topk(jnp.asarray(logits), jcfg)
    gp, gw, ge = MOE.router_topk(torch.as_tensor(logits), cfg)
    assert np.array_equal(ge.numpy(), np.asarray(ek))
    assert list(ge[0].numpy()) == list(range(8))
    assert list(ge[1, :3].numpy()) == [3, 7, 30]
    np.testing.assert_allclose(gp.numpy(), np.asarray(probs), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(gw.numpy(), np.asarray(wk), rtol=1e-6)
    assert float(gp[:, 40:].abs().max()) == 0.0


@pytest.mark.parametrize("groups,cap", [(1, 8), (4, 3), (6, 40)])
def test_group_by_equals_reference(groups, cap):
    """Slots and keep masks exactly: stable ranks, earlier entries win
    capacity, overflow parked at groups * cap."""
    rng = np.random.RandomState(groups)
    dest = rng.randint(0, groups, 97).astype(np.int32)
    slot, keep = JMOE._group_by(jnp.asarray(dest), groups, cap)
    gs, gk = MOE._group_by(torch.as_tensor(dest).long(), groups, cap)
    assert np.array_equal(gs.numpy(), np.asarray(slot))
    assert np.array_equal(gk.numpy(), np.asarray(keep))


@pytest.mark.parametrize("capacity", [2.0, 0.5])
def test_moe_ffn_equals_reference(capacity):
    """Reduced granite-moe: 4 experts, top-2, 64 tokens; at capacity 0.5
    a quarter of the copies find no slot, and the port drops the same
    fraction."""
    jcfg = jget_config("granite-moe-3b-a800m").reduced()
    cfg = get_config("granite-moe-3b-a800m").reduced()
    jp = JMOE.moe_params(jax.random.PRNGKey(1), jcfg, 1, jnp.float32)
    x = np.random.RandomState(2).randn(B, SEQ, cfg.d_model).astype(np.float32)

    def fn(p, x):
        return JMOE.moe_ffn(p, x, jcfg, "model", 1, capacity_factor=capacity)
    y, aux, dropped = _mesh_fn(fn)(jp, jnp.asarray(x))
    gy, gaux, gdrop = MOE.moe_ffn(_torch(_np(jp)), torch.as_tensor(x), cfg,
                                  capacity_factor=capacity)
    # rtol 1e-5, and atol 1e-5 x max|y|: float32 sums over d = 256 and
    # d_ff = 128 taken in another order leave ~1e-6 x max on entries that
    # cancel to near 0
    np.testing.assert_allclose(gy.numpy(), np.asarray(y), rtol=1e-5,
                               atol=1e-5 * float(np.abs(y).max()))
    np.testing.assert_allclose(float(gaux), float(aux), rtol=1e-5)
    assert float(gdrop) == float(dropped)
    assert (float(gdrop) > 0.1) == (capacity < 1)
    assert MOE.capacities(cfg, B * SEQ, 1, capacity)[0] == \
        int(max(8, B * SEQ * cfg.top_k * capacity))


@pytest.fixture(scope="module", params=["granite-moe-3b-a800m", "arctic-480b"])
def arch_case(request):
    """The reference's reduced config, weights, loss, aux and gradients of
    ``loss + 0.01 aux``."""
    arch = request.param
    jcfg = jget_config(arch).reduced()
    jp = JT.init_params(jcfg, 1, seed=0)
    rng = np.random.RandomState(0)
    toks = rng.randint(0, jcfg.vocab, (B, SEQ)).astype(np.int32)
    labels = rng.randint(0, jcfg.vocab, (B, SEQ)).astype(np.int32)

    def loss_fn(p, t, l):
        loss, aux = JT.forward_loss(p, t, l, jcfg, JT.AxisCtx())
        return loss + 0.01 * aux, (loss, aux)
    f = _mesh_fn(loss_fn)
    (_, (jl, ja)), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jp, toks, labels)
    return dict(arch=arch, params=_np(jp), loss=float(jl), aux=float(ja),
                grads=_np(jg), toks=toks, labels=labels)


def test_forward_loss_and_gradients_match_reference(arch_case):
    cfg = get_config(arch_case["arch"]).reduced()
    assert cfg.ffn_pattern[0] == ("moe" if "granite" in cfg.name
                                  else "moe+dense")
    tp = T.params_from_jax(arch_case["params"], cfg, device="cpu")
    assert tp["blocks"]["b0"]["moe"]["router"].dtype == torch.float32
    leaves = T.tree_leaves(tp)
    ps = [p.requires_grad_(True) for _, p in leaves]
    loss, aux = T.forward_loss(tp, torch.as_tensor(arch_case["toks"]).long(),
                               torch.as_tensor(arch_case["labels"]).long(),
                               cfg)
    np.testing.assert_allclose(float(loss.detach()), arch_case["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux.detach()), arch_case["aux"],
                               rtol=1e-5)
    gs = torch.autograd.grad(loss + 0.01 * aux, ps)
    want = dict(T.tree_leaves(arch_case["grads"]))
    assert sorted(want) == sorted(p for p, _ in leaves)
    for (path, _), g in zip(leaves, gs):
        np.testing.assert_allclose(g.numpy(), want[path], rtol=1e-4,
                                   atol=1e-6, err_msg=str(path))


def test_params_copy_and_port_init_shapes(arch_case):
    cfg = get_config(arch_case["arch"]).reduced()
    tp = T.params_from_jax(arch_case["params"], cfg, device="cpu")
    for (p, a), (q, b) in zip(T.tree_leaves(arch_case["params"]),
                              T.tree_leaves(T.params_to_numpy(tp))):
        assert p == q and a.dtype == b.dtype and np.array_equal(a, b)
    own = T.init_params(cfg, 1, seed=0, device="cpu")
    assert [(p, tuple(t.shape), str(t.dtype)) for p, t in T.tree_leaves(own)]\
        == [(p, a.shape, "torch." + str(a.dtype))
            for p, a in T.tree_leaves(arch_case["params"])]


def test_position_stacked_moe_is_each_positions_own():
    """Broadcast parameters over M = 3 positions with different tokens:
    losses, aux, dropped fractions and gradients equal each position's
    own run (capacity 0.5, so drops happen per position)."""
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m").reduced(),
                              tie_embeddings=False, moe_capacity=0.5)
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
    gs = torch.autograd.grad((loss + 0.01 * aux).sum(), ps)
    moe_p = {k: v.unsqueeze(0).expand((3,) + tuple(v.shape))
             for k, v in params["blocks"]["b0"]["moe"].items()}
    moe_p = {k: v[:, 0] for k, v in moe_p.items()}      # period 0
    x = torch.randn(3, 2, 16, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    _, _, dropped = MOE.moe_ffn(moe_p, x, cfg, capacity_factor=0.5)
    for i in range(3):
        one = [p.clone().requires_grad_(True) for _, p in leaves]
        l1, a1 = T.forward_loss(T.tree_from_leaves(params, [
            (path, p) for (path, _), p in zip(leaves, one)]), toks[i],
            labels[i], cfg)
        torch.testing.assert_close(loss[i], l1, rtol=1e-6, atol=0)
        torch.testing.assert_close(aux[i], a1, rtol=1e-6, atol=0)
        _, _, d1 = MOE.moe_ffn({k: v[i] for k, v in moe_p.items()}, x[i],
                               cfg, capacity_factor=0.5)
        assert float(dropped[i]) == float(d1) and float(d1) > 0
        for (path, _), g, g1 in zip(leaves, gs, torch.autograd.grad(
                l1 + 0.01 * a1, one)):
            torch.testing.assert_close(g[i], g1, rtol=1e-5, atol=1e-7,
                                       msg=str(path))


def test_three_train_steps_track_reference_4_devices(tmp_path):
    """Reduced untied granite-moe, sparse sync with the fused merge over M
    = 4 (degrees (2, 2)): the port's three losses and aux values within
    rtol 1e-4 of the reference's 4-device run from the same weights on
    the launcher's batch stream, overflow equal (0)."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = tmp_path / "ref.npz"
    r = subprocess.run([sys.executable, "-c", REFERENCE_CODE, str(out)],
                       env=env, capture_output=True, text=True, timeout=400)
    assert r.returncode == 0 and "REFERENCE_OK" in r.stdout, r.stderr[-4000:]
    with np.load(out) as f:
        ref = dict(f)
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m").reduced(),
                              tie_embeddings=False)
    like = T.init_params(cfg, 1, device="cpu")
    params = T.tree_from_leaves(like, [
        (p, torch.as_tensor(ref["init/" + "/".join(p)]))
        for p, _ in T.tree_leaves(like)])
    step, _ = S.make_train_step(cfg, S.mesh_ctx(M, device="cpu"),
                                sync="sparse", dp_degrees=DEGREES,
                                sync_merge="fused",
                                sparse_tokens_hint=BATCH * SEQ // M)
    st = AdamW().init(params)
    stream = launch_train.batch_stream(cfg, BATCH, SEQ, seed=0)
    losses, auxes, ovf = [], [], []
    for _ in range(STEPS):
        params, st, m = step(params, st, next(stream))
        losses.append(float(m["loss"]))
        auxes.append(float(m["aux"]))
        ovf.append(int(m["sync_overflow"]))
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-4)
    np.testing.assert_allclose(auxes, ref["auxes"], rtol=1e-4)
    assert ovf == list(ref["ovf"]) == [0] * STEPS
