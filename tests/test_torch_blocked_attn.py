"""PyTorch port, the query-chunked attention held to ``repro.models.attention``.

One JAX subprocess (2 forced host devices) runs the reference's
``attn_train_blocked`` at T = 2,048 on one reduced ``qwen1.5-0.5b``
attention block (float32, seed-0 weights): causal, with a 300-token
window, and at tp = 2 on a 1 x 2 (data, model) mesh.  The port's
``attn_train_blocked`` on the same weights and input is held to it
within rtol 1e-5 + 1e-6 x max (float32 sums in another order).  Port
only: ``attn_train_blocked``'s forward equals the port's ``attn_train``
bit for bit on the CPU, in float32 with a window and at tp = 2, and in
bfloat16 with gemma3's 16-token window (each chunk's products have the reduction lengths of the whole
sequence's); the input gradient differs only in the order the chunks'
key and value gradients are summed: within rtol 1e-5 + 1e-6 x max in
float32 (2.5e-7 x max measured), 2^-7 x max in bfloat16 (one unit
roundoff of the max is 2^-8; 0.0046 measured); a one-layer model at T =
8,192 takes the blocked path through the block forward and builds no
mask of more than ``Q_CHUNK`` rows; T not a multiple of ``Q_CHUNK``
raises ``ValueError``.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import attention as A
from repro_torch.models import transformer as T

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SEQ, WINDOW = 2048, 300
CASES = {"causal": (1, 0), "window": (1, WINDOW), "tp2": (2, 0)}

REFERENCE_CODE = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
from repro.configs import get_config
from repro.models import attention as A
from repro.models import transformer as T
from repro.models.sharding import full_model_pspec

cfg = get_config("qwen1.5-0.5b").reduced()
x = np.random.RandomState(7).randn(1, %(seq)d, cfg.d_model).astype(np.float32)
out = {"x": x}
for tp in (1, 2):
    names = [n for n, (t, _) in %(cases)r.items() if t == tp]
    mesh = Mesh(np.array(jax.devices()[:tp]).reshape(1, tp),
                ("data", "model"))
    attn = T.init_params(cfg, tp, seed=0)["blocks"]["b0"]["attn"]
    for name in names:
        for k, v in attn.items():
            out[f"{name}/p/{k}"] = np.asarray(v[0])
    spec = full_model_pspec(cfg, tp, ("data",))["blocks"]["b0"]["attn"]

    def body(p, x, tp=tp, names=names):
        p = {k: v[0] for k, v in p.items()}
        return tuple(A.attn_train_blocked(p, x, cfg, "model", tp,
                                          %(cases)r[n][1]) for n in names)
    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec, P()),
                           out_specs=tuple(P() for _ in names),
                           check_vma=False))
    for name, y in zip(names, fn(attn, jnp.asarray(x))):
        out[f"{name}/y"] = np.asarray(y)
np.savez(sys.argv[1], **out)
print("REFERENCE_OK")
""" % {"seq": SEQ, "cases": CASES}


def _cfg(arch="qwen1.5-0.5b", **kw):
    return dataclasses.replace(get_config(arch).reduced(), **kw)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's outputs (one 2-device subprocess for the file)."""
    out = tmp_path_factory.mktemp("blocked") / "ref.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", REFERENCE_CODE, str(out)],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "REFERENCE_OK" in r.stdout, r.stderr[-4000:]
    with np.load(out) as f:
        return dict(f)


def _stacked(p, x, tp):
    """At tp > 1 the port's attention is position-stacked: one data
    position, [1, ...] leaves and input."""
    if tp == 1:
        return p, x
    return {k: v.unsqueeze(0) for k, v in p.items()}, x.unsqueeze(0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_blocked_attention_matches_reference(ref, name):
    """The port's ``attn_train_blocked`` on the reference's weights and
    input: within rtol 1e-5 + 1e-6 x max of the reference's."""
    tp, window = CASES[name]
    cfg = _cfg()
    p = {k[len(name) + 3:]: torch.as_tensor(v) for k, v in ref.items()
         if k.startswith(f"{name}/p/")}
    p, x = _stacked(p, torch.as_tensor(ref["x"]), tp)
    got = A.attn_train_blocked(p, x, cfg, tp, window)
    want = ref[f"{name}/y"]
    np.testing.assert_allclose(got.reshape(want.shape).numpy(), want,
                               rtol=1e-5, atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("arch,tp,window,dtype", [
    ("qwen1.5-0.5b", 1, WINDOW, torch.float32),
    ("qwen1.5-0.5b", 2, 0, torch.float32),
    ("gemma3-12b", 1, 16, torch.bfloat16)])
def test_blocked_forward_equals_attn_train_bit_for_bit(arch, tp, window, dtype):
    """``attn_train_blocked`` against ``attn_train`` at T = 2,048 on the
    CPU: outputs bit for bit, input gradients within the module
    docstring's bound."""
    cfg = _cfg(arch, dtype=dtype)
    p = {k: v[0] for k, v in
         T.init_params(cfg, tp, seed=0, device="cpu")["blocks"]["b0"]
         ["attn"].items()}
    x = torch.randn(2, SEQ, cfg.d_model,
                    generator=torch.Generator().manual_seed(1)).to(dtype)
    p, x = _stacked(p, x, tp)
    outs = []
    for fn in (A.attn_train, A.attn_train_blocked):
        xg = x.clone().requires_grad_(True)
        y = fn(p, xg, cfg, tp, window)
        ct = torch.ones_like(y).cumsum(-1) / y.shape[-1]
        (gx,) = torch.autograd.grad(y, xg, ct)
        outs.append((y.detach(), gx))
    assert torch.equal(outs[0][0], outs[1][0])
    want, got = outs[0][1].float(), outs[1][1].float()
    top = float(want.abs().max())
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * top)
    else:
        assert float((got - want).abs().max()) <= 2.0 ** -7 * top


def test_long_sequence_dispatches_to_the_chunks(monkeypatch):
    """A one-layer reduced model at T = 8,192 takes the query-chunked path
    through the block forward, builds no mask of more than ``Q_CHUNK``
    rows, and its loss is finite; ``attn_train_blocked`` is taken at
    ``BLOCKED_ATTN_THRESHOLD`` and not below it."""
    cfg = _cfg()
    rows, calls = [], []
    mask, blocked = A.attn_mask, A.attn_train_blocked

    def rec_mask(t, *a, **kw):
        out = mask(t, *a, **kw)
        rows.append(out.shape[0])
        return out

    def rec_blocked(*a, **kw):
        calls.append(a[1].shape[-2])
        return blocked(*a, **kw)
    monkeypatch.setattr(A, "attn_mask", rec_mask)
    monkeypatch.setattr(A, "attn_train_blocked", rec_blocked)
    params = T.init_params(cfg, 1, seed=0, device="cpu")
    t = A.BLOCKED_ATTN_THRESHOLD
    toks = torch.as_tensor(np.random.RandomState(2).randint(
        0, cfg.vocab, (1, t)))
    with torch.no_grad():
        loss, _ = T.forward_loss(params, toks, toks, cfg)
    assert np.isfinite(float(loss))
    assert calls == [t] * cfg.n_layers
    assert rows and max(rows) == A.Q_CHUNK
    x = torch.zeros(1, t - A.Q_CHUNK, cfg.d_model)
    p = {k: v[0] for k, v in params["blocks"]["b0"]["attn"].items()}
    A.attn_train_any(p, x, cfg, 1, 0)
    assert calls == [t] * cfg.n_layers


def test_blocked_attention_needs_whole_chunks():
    """T not a multiple of ``Q_CHUNK`` raises ``ValueError``, called
    directly and through the dispatch above the threshold."""
    cfg = _cfg()
    p = {k: v[0] for k, v in T.init_params(cfg, 1, seed=0, device="cpu")
         ["blocks"]["b0"]["attn"].items()}
    with pytest.raises(ValueError, match="not a multiple of Q_CHUNK"):
        A.attn_train_blocked(p, torch.zeros(1, 1000, cfg.d_model), cfg, 1, 0)
    with pytest.raises(ValueError, match="not a multiple of Q_CHUNK"):
        A.attn_train_any(p, torch.zeros(
            1, A.BLOCKED_ATTN_THRESHOLD + 512, cfg.d_model), cfg, 1, 0)
