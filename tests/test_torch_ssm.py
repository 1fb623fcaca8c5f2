"""PyTorch port, the SSM blocks held to ``repro.models.ssm``.

The reference runs in this process on one CPU device (a 1 x 1 ``data`` x
``model`` mesh under ``shard_map``; at tp = 1 its ``psum`` over the model
axis is an identity, as the port's is), with the same weights in both
packages.  Blocks, float32, reduced configs (d 256, 4 heads):

* ``mamba_train`` at T = 64 (one scan chunk) and T = 512 (two chunks of
  ``SCAN_CHUNK`` = 256, the state carried across): within rtol 1e-4 and
  atol 1e-5 x max|y|.  The reference's prefix over a chunk is
  ``lax.associative_scan``, the port's a Hillis-Steele scan: the same
  combine with the products in another order.
* ``mlstm_train`` at T = 256 (two chunks of ``CHUNK`` = 128) and
  ``slstm_train`` (a 32-step recurrence): within rtol 1e-4 and atol 1e-5
  x max|y|.  The masked gates take no NaN in the backward: the input
  gradient is finite and within rtol 1e-3 + 1e-4 x max.

Models: ``forward_loss`` of reduced xlstm (7 mLSTM + 1 sLSTM) and reduced
jamba (7 mamba + 1 attention, dense and MoE FFNs alternating) within rtol
1e-5, every gradient leaf within rtol 1e-4 and atol 1e-3 x max|leaf|.
These stacks amplify rounding in the backward: the reference's own
gradients move by up to 3e-5 x max (the embedding leaf of reduced xlstm)
when its embedding is scaled by 1 + 2^-22, and the port's differ from
them by up to 1.1e-4 x max, in the layers farthest from the loss.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from repro.compat import shard_map
from repro.configs import get_config as jget_config
from repro.models import ssm as JSSM
from repro.models import transformer as JT

from repro_torch.configs import get_config
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T

# one intra-op thread a test process: pytest-xdist runs several workers
# at once, and their OpenMP threads would oversubscribe the cores
torch.set_num_threads(1)

B = 2


def _mesh_fn(fn):
    """``fn`` run inside shard_map on a 1 x 1 (data, model) mesh, every
    argument replicated."""
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    return shard_map(fn, mesh=mesh, in_specs=P(), out_specs=P(),
                     check_vma=False)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


BLOCKS = {"mamba": ("jamba-1.5-large-398b", JSSM.mamba_params,
                    JSSM.mamba_train, SSM.mamba_train),
          "mlstm": ("xlstm-1.3b", JSSM.mlstm_params, JSSM.mlstm_train,
                    SSM.mlstm_train),
          "slstm": ("xlstm-1.3b", JSSM.slstm_params, JSSM.slstm_train,
                    SSM.slstm_train)}


@pytest.mark.parametrize("kind,t", [("mamba", 64), ("mamba", 512),
                                    ("mlstm", 256), ("slstm", 32)])
def test_block_forward_and_input_gradient_match(kind, t):
    arch, jparams, jtrain, train = BLOCKS[kind]
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jp = jparams(jax.random.PRNGKey(7), jcfg, 1, jnp.float32)
    rng = np.random.RandomState(3)
    x = rng.randn(B, t, cfg.d_model).astype(np.float32)
    ct = rng.randn(B, t, cfg.d_model).astype(np.float32)

    def fn(p, x):
        return jtrain(p, x, jcfg, "model", 1)

    def vjp(p, x):
        y, pull = jax.vjp(lambda x: fn(p, x), x)
        return y, pull(jnp.asarray(ct))[0]
    y, gx = jax.jit(_mesh_fn(vjp))(jp, jnp.asarray(x))
    tp = {k: torch.as_tensor(np.array(v)) for k, v in _np(jp).items()}
    xt = torch.as_tensor(x).requires_grad_(True)
    got = train(tp, xt, cfg)
    (ggx,) = torch.autograd.grad(got, xt, torch.as_tensor(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y), rtol=1e-4,
                               atol=1e-5 * float(np.abs(y).max()))
    assert torch.isfinite(ggx).all()
    np.testing.assert_allclose(ggx.numpy(), np.asarray(gx), rtol=1e-3,
                               atol=1e-4 * float(np.abs(gx).max()))


def test_prefix_scan_is_the_linear_recurrence():
    """The Hillis-Steele prefix of the combine gives h_t = a_t h_{t-1} +
    b_t (float64, against the sequential loop)."""
    rng = np.random.RandomState(0)
    for t in (1, 5, 16, 37):
        a = torch.as_tensor(rng.rand(3, t, 4), dtype=torch.float64)
        b = torch.as_tensor(rng.randn(3, t, 4), dtype=torch.float64)
        acum, h = SSM._prefix_scan(a, b, dim=1)
        state = torch.zeros(3, 4, dtype=torch.float64)
        prod = torch.ones(3, 4, dtype=torch.float64)
        for i in range(t):
            state = a[:, i] * state + b[:, i]
            prod = prod * a[:, i]
            torch.testing.assert_close(h[:, i], state, rtol=1e-12, atol=0)
            torch.testing.assert_close(acum[:, i], prod, rtol=1e-12, atol=0)


@pytest.fixture(scope="module", params=["xlstm-1.3b", "jamba-1.5-large-398b"])
def arch_case(request):
    """The reference's reduced config, weights, loss, aux and gradients of
    ``loss + 0.01 aux``."""
    arch = request.param
    jcfg = jget_config(arch).reduced()
    jp = JT.init_params(jcfg, 1, seed=0)
    rng = np.random.RandomState(0)
    toks = rng.randint(0, jcfg.vocab, (B, 32)).astype(np.int32)
    labels = rng.randint(0, jcfg.vocab, (B, 32)).astype(np.int32)

    def loss_fn(p, t, l):
        loss, aux = JT.forward_loss(p, t, l, jcfg, JT.AxisCtx())
        return loss + 0.01 * aux, (loss, aux)
    (_, (jl, ja)), jg = jax.jit(jax.value_and_grad(
        _mesh_fn(loss_fn), has_aux=True))(jp, toks, labels)
    return dict(arch=arch, params=_np(jp), loss=float(jl), aux=float(ja),
                grads=_np(jg), toks=toks, labels=labels)


def test_forward_loss_and_gradients_match_reference(arch_case):
    cfg = get_config(arch_case["arch"]).reduced()
    tp = T.params_from_jax(arch_case["params"], cfg, device="cpu")
    leaves = T.tree_leaves(tp)
    ps = [p.requires_grad_(True) for _, p in leaves]
    loss, aux = T.forward_loss(tp, torch.as_tensor(arch_case["toks"]).long(),
                               torch.as_tensor(arch_case["labels"]).long(),
                               cfg)
    np.testing.assert_allclose(float(loss.detach()), arch_case["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux.detach()), arch_case["aux"],
                               rtol=1e-5, atol=1e-7)
    gs = torch.autograd.grad(loss + 0.01 * aux, ps)
    want = dict(T.tree_leaves(arch_case["grads"]))
    assert sorted(want) == sorted(p for p, _ in leaves)
    for (path, _), g in zip(leaves, gs):
        w = want[path]
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-3 * float(np.abs(w).max()),
                                   err_msg=str(path))


def test_params_copy_and_port_init_shapes(arch_case):
    """The new leaves (float32 ``A_log``, ``D``, ``wi``, ``wf``,
    ``bias``) copy exactly both ways; the port's own init has the
    reference's shapes and dtypes, ``D`` at 1."""
    cfg = get_config(arch_case["arch"]).reduced()
    tp = T.params_from_jax(arch_case["params"], cfg, device="cpu")
    for (p, a), (q, b) in zip(T.tree_leaves(arch_case["params"]),
                              T.tree_leaves(T.params_to_numpy(tp))):
        assert p == q and a.dtype == b.dtype and np.array_equal(a, b)
    own = T.init_params(cfg, 1, seed=0, device="cpu")
    assert [(p, tuple(t.shape), str(t.dtype)) for p, t in T.tree_leaves(own)]\
        == [(p, a.shape, "torch." + str(a.dtype))
            for p, a in T.tree_leaves(arch_case["params"])]
    for path, t in T.tree_leaves(own):
        if path[-1] == "D":
            assert torch.equal(t, torch.ones_like(t))
