"""PyTorch port, FSDP on the stacked data mesh held to ``repro.train.step``.

The reference shards every ``"fsdp"`` dim of the block leaves over the
data axes and all_gathers it per period; the gather's transpose, a
reduce-scatter, is those leaves' gradient sync, and ``sync_grads`` only
divides them by dp.  The port holds such a leaf once
(``sharding.FsdpGather``): the gather is a broadcast view and its
backward a tiled reduce-scatter over one stage of degree M.  Checked
here: the backward equals the sum over the positions bit for bit on
dyadic values, in one exchange; an FSDP leaf's synced gradient is
exactly ``g / dp``; FSDP with replication > 1 raises ``ValueError`` (in
the step and the launcher), and so does an encoder with FSDP; three
steps of reduced qwen1.5-0.5b with ``fsdp=True`` (2 layers, ``hier``
sync over M = 4, degrees (2, 2)) track the reference's 4-device run,
losses and grad norms within rtol 1e-4; and in bfloat16 the port's FSDP
and non-FSDP steps from the same weights give bit-equal step-1 losses
(the same forward) and synced gradients within ``chip_smoke.
FSDP_PAIR_LIMITS``, the bound the card's ``train_vlm`` pair is held to
(the FSDP sum adds the positions in bfloat16, the butterfly in float32).
"""
import dataclasses
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.topology import ButterflyPlan
from repro_torch.core.transport import StackedTransport
from repro_torch.launch import train as launch_train
from repro_torch.models import sharding as SH
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamW
from repro_torch.train import step as S

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
M, BATCH, SEQ, STEPS, LAYERS = 4, 8, 32, 3, 2
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

cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                          n_layers=%(layers)d, fsdp=True)
mesh = jax.make_mesh((%(m)d, 1), ("data", "model"))
params = T.init_params(cfg, 1, seed=0)
out = {"init/" + "/".join(p): np.asarray(v) for p, v in leaves(params)}
step, _ = make_train_step(cfg, mesh, sync="hier", dp_degrees=%(degrees)r,
                          donate=False)
p, st = params, AdamW().init(params)
stream = batch_stream(cfg, %(batch)d, %(seq)d, seed=0)
losses, gnorms = [], []
for i in range(%(steps)d):
    b = {k: jnp.asarray(v) for k, v in next(stream).items()}
    p, st, m = step(p, st, b)
    losses.append(float(m["loss"]))
    gnorms.append(float(m["gnorm"]))
out["losses"], out["gnorms"] = np.asarray(losses), np.asarray(gnorms)
np.savez(sys.argv[1], **out)
print("REFERENCE_OK")
""" % {"m": M, "layers": LAYERS, "degrees": DEGREES, "batch": BATCH,
       "seq": SEQ, "steps": STEPS}


def _smoke():
    """``chip_smoke.py`` as a module (it imports nothing of the port or
    of torch at import)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _dyadic(rng, shape):
    return torch.as_tensor(rng.randint(-64, 65, shape) / 16.0,
                           dtype=torch.float32)


@pytest.mark.parametrize("dim", [0, 1])
def test_gather_backward_is_the_sum_over_positions(dim):
    """Forward: a stride-0 view of the held-once leaf, no copy.
    Backward: the stacked cotangent summed over the M positions, bit for
    bit on dyadic values, in one exchange of the transport."""
    rng = np.random.RandomState(dim)
    x = _dyadic(rng, (8, 12)).requires_grad_(True)
    tr = StackedTransport(ButterflyPlan(M, (M,)), "cpu")
    y = SH.FsdpGather.apply(x, dim, tr)
    assert y.shape == (M, 8, 12) and y.stride(0) == 0
    assert y.data_ptr() == x.data_ptr()
    assert torch.equal(y[2], x)
    g = _dyadic(rng, (M, 8, 12))
    (gx,) = torch.autograd.grad(y, x, g)
    assert tr.calls == 1
    assert torch.equal(gx, g[0] + g[1] + g[2] + g[3])
    with pytest.raises(ValueError, match="does not split"):
        z = torch.zeros(6, 6, requires_grad=True)
        torch.autograd.grad(SH.FsdpGather.apply(z, 0, tr), z,
                            torch.ones(M, 6, 6))


def test_fsdp_gather_picks_the_fsdp_dims():
    """``fsdp_gather`` of a period: the FSDP leaves gathered along their
    spec's dim, the norms untouched."""
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                              fsdp=True)
    spec = SH.period_spec(cfg, 1)
    assert SH.fsdp_dim(spec["b0"]["attn"]["wo"]) == 1
    assert SH.fsdp_dim(spec["b0"]["ffn"]["w1"]) == 0
    params = T.init_params(cfg, 1, seed=0, device="cpu")
    pp = T.tree_from_leaves(params["blocks"], [
        (p, t[0]) for p, t in T.tree_leaves(params["blocks"])])
    tr = StackedTransport(ButterflyPlan(M, (M,)), "cpu")
    out = SH.fsdp_gather(pp, spec, tr)
    assert out["b0"]["ffn"]["w1"].shape == (M,) + pp["b0"]["ffn"]["w1"].shape
    assert out["b0"]["ln1"] is pp["b0"]["ln1"]
    assert out["b0"]["attn"]["bq"] is pp["b0"]["attn"]["bq"]


def test_fsdp_leaf_synced_gradient_is_g_over_dp():
    """``sync_grads`` gives an FSDP leaf (held once, summed by its
    gather's backward) ``g / dp`` with no exchange; the other leaves still
    go through the butterfly."""
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                              fsdp=True)
    mc = S.mesh_ctx(M, device="cpu")
    plans = S._build_sync_plans(cfg, mc, "hier", DEGREES, None, False)
    params = T.init_params(cfg, 1, seed=3, device="cpu")
    paths = SH.fsdp_block_paths(cfg)
    held = lambda path: path[0] == "blocks" and path[1:] in paths
    gen = torch.Generator().manual_seed(0)
    grads = T.tree_from_leaves(params, [
        (p, torch.randn(t.shape if held(p) else (M,) + tuple(t.shape),
                        generator=gen)) for p, t in T.tree_leaves(params)])
    want = {p: g.clone() for p, g in T.tree_leaves(grads)}
    synced, _, _ = S.sync_grads(grads, cfg, mc, "hier", plans, None)
    n_held = 0
    for path, g in T.tree_leaves(synced):
        if held(path):
            n_held += 1
            assert torch.equal(g, want[path] / M), path
        else:
            torch.testing.assert_close(g[0], want[path].sum(0) / M,
                                       rtol=1e-5, atol=1e-6)
    assert n_held == 7          # wq, wk, wv, wo, w1, w2, w3
    assert plans.hier.calls == 4 * (len(want) - n_held)


def test_fsdp_with_replication_and_encoder_raise(monkeypatch, tmp_path):
    """FSDP with replication > 1 raises ``ValueError`` as the reference's
    step does, from ``make_train_step`` and from the launcher (before any
    weights are drawn); an encoder-decoder with FSDP raises
    ``ValueError`` naming the pair."""
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                              fsdp=True)
    mc = S.mesh_ctx(M, device="cpu")
    with pytest.raises(ValueError, match="replication>1 is unsupported"):
        S.make_train_step(cfg, mc, sync="hier", replication=2)
    S.make_train_step(cfg, mc, sync="hier", replication=1)
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path))
    with pytest.raises(ValueError, match="replication>1 is unsupported"):
        launch_train.main(["--arch", "internvl2-26b", "--device", "cpu",
                           "--replication", "2", "--data-axis", "4",
                           "--dp-degrees", "2,2", "--sync", "hier"])
    enc = dataclasses.replace(get_config("whisper-base").reduced(),
                              fsdp=True)
    with pytest.raises(ValueError, match="enc_layers with fsdp"):
        T.init_params(enc, 1, device="cpu")


def test_reduced_qwen_fsdp_tracks_reference_4_devices(tmp_path):
    """Reduced qwen1.5-0.5b with ``fsdp=True`` and 2 layers, ``hier`` sync
    over M = 4 (degrees (2, 2)): three losses and grad norms within rtol
    1e-4 of the reference's 4-device run from the same weights."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = tmp_path / "ref.npz"
    r = subprocess.run([sys.executable, "-c", REFERENCE_CODE, str(out)],
                       env=env, capture_output=True, text=True, timeout=400)
    assert r.returncode == 0 and "REFERENCE_OK" in r.stdout, r.stderr[-4000:]
    with np.load(out) as f:
        ref = dict(f)
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                              n_layers=LAYERS, fsdp=True)
    like = T.init_params(cfg, 1, device="cpu")
    params = T.tree_from_leaves(like, [
        (p, torch.as_tensor(ref["init/" + "/".join(p)]))
        for p, _ in T.tree_leaves(like)])
    step, _ = S.make_train_step(cfg, S.mesh_ctx(M, device="cpu"),
                                sync="hier", dp_degrees=DEGREES)
    st = AdamW().init(params)
    stream = launch_train.batch_stream(cfg, BATCH, SEQ, seed=0)
    losses, gnorms = [], []
    for _ in range(STEPS):
        params, st, m = step(params, st, next(stream))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-4)
    np.testing.assert_allclose(gnorms, ref["gnorms"], rtol=1e-4)


def _bf16_step(fsdp, params):
    """One bfloat16 ``hier`` step of reduced untied qwen (2 layers) over M
    = 4 from copies of ``params``: (loss, synced row-0 leaves)."""
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                              n_layers=LAYERS, dtype=torch.bfloat16,
                              tie_embeddings=False, fsdp=fsdp)
    step, _ = S.make_train_step(cfg, S.mesh_ctx(M, device="cpu"),
                                sync="hier", dp_degrees=DEGREES)
    p = T.tree_from_leaves(params, [(k, t.clone())
                                    for k, t in T.tree_leaves(params)])
    capture = {}
    batch = next(launch_train.batch_stream(cfg, BATCH, SEQ, seed=0))
    _, _, m = step(p, AdamW().init(p), batch, capture=capture)
    return float(m["loss"]), dict(T.tree_leaves(capture["synced"]))


def test_fsdp_and_plain_steps_agree_within_the_card_bound():
    """The same bfloat16 weights and batch with ``fsdp=True`` and
    ``False``: step-1 losses bit-equal, each synced leaf within
    ``FSDP_PAIR_LIMITS`` (max |a - b| / max |b| and the relative L2
    error), the non-FSDP leaves bit-equal."""
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                              n_layers=LAYERS, dtype=torch.bfloat16,
                              tie_embeddings=False)
    params = T.init_params(cfg, 1, seed=7, device="cpu")
    la, ga = _bf16_step(True, params)
    lb, gb = _bf16_step(False, params)
    assert la == lb
    smoke = _smoke()
    limits = smoke.FSDP_PAIR_LIMITS
    paths = SH.fsdp_block_paths(dataclasses.replace(cfg, fsdp=True))
    for path, b in gb.items():
        a = ga[path]
        if path[1:] not in paths:
            assert torch.equal(a, b), path
            continue
        err = smoke.pair_error(a, b)
        assert err["max_rel"] <= limits["max_rel"], (path, err)
        assert err["l2_rel"] <= limits["l2_rel"], (path, err)
