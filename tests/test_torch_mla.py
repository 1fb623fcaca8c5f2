"""PyTorch port, the DeepSeek-V3 decoder (Moonlight) held to the plain
float32 reference ``portbench/reference/moonlight.py``.

The reference package has no such model, so the port is held to the
benchmark's plain reference (torch and nothing else, float32 autograd)
on seeded random weights at a small size (``DeepSeekV3Config.reduced``:
the leading dense layer and two MoE layers, 8 experts top-2 or top-3,
float32), with a drawn correction bias and an expert share.  The
tolerances: float32 against float32 in another order of operations, so
rtol 1e-5 on the loss and the aux (a few ulps of sums over hundreds of
terms), 1e-5 x max|y| on a block's output, rtol 1e-4 / atol 1e-6 on
every gradient leaf and 1e-6 on AdamW's step (the repository's
tolerances for the other families).  The same port in bfloat16 misses
the loss's by two orders of magnitude (:func:`test_bfloat16_fails_the_loss_tolerance`).
Beside them: the shares of a layer add up to the uncut layer, the spans
open once a block, serving refuses the model, and every other
configuration's fields and parameter tree are those of the reference
package.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax

from repro.models import common as JC
from repro.models import transformer as JT
from repro.configs import ARCHS as JARCHS

from repro_torch import obs
from repro_torch.configs import ARCHS, PORT_ARCHS, get_config
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.models.common import DeepSeekV3Config, ModelConfig, rmsnorm
from repro_torch.optim.adamw import AdamW

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.reference import granite as RG  # noqa: E402
from portbench.reference import moonlight as R  # noqa: E402

torch.set_num_threads(1)

B, S = 2, 16
LOSS_RTOL = 1e-5


def _config(**kw) -> DeepSeekV3Config:
    """Reduced Moonlight with a drawn correction bias."""
    cfg = get_config("moonlight-16b-a3b").reduced(**kw)
    gen = torch.Generator().manual_seed(11)
    bias = torch.randn((cfg.n_periods, cfg.n_experts), generator=gen) * 0.05
    return dataclasses.replace(cfg, router_bias=tuple(bias.reshape(-1)
                                                      .tolist()))


def _ref_cfg(cfg: DeepSeekV3Config) -> dict:
    """The reference's configuration keys of a port configuration."""
    return {"hidden_size": cfg.d_model, "num_attention_heads": cfg.n_heads,
            "qk_nope_head_dim": cfg.q_nope_dim,
            "qk_rope_head_dim": cfg.q_rope_dim, "kv_lora_rank": cfg.kv_rank,
            "v_head_dim": cfg.v_dim, "first_k_dense_replace": cfg.lead_dense,
            "num_hidden_layers": cfg.n_layers,
            "published_n_routed_experts": cfg.n_experts,
            "n_routed_experts": cfg.held,
            "held_experts_first": cfg.expert_first,
            "num_experts_per_tok": cfg.top_k,
            "routed_scaling_factor": cfg.router_scale,
            "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.norm_eps,
            "seq_aux_alpha": cfg.aux_alpha,
            "moe_capacity_factor": cfg.moe_capacity,
            "expert_capacity_slack": 1.25}


def _bias(cfg):
    return torch.tensor(cfg.router_bias, dtype=torch.float32).reshape(
        cfg.n_periods, cfg.n_experts)


def _params(cfg, seed=0):
    """Seeded weights, the norm gains drawn away from 0 too."""
    p = T.init_params(cfg, 1, seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    flat = {}
    for path, t in T.tree_leaves(p):
        if path[-1] in ("ln1", "ln2", "final_ln", "kv_ln"):
            t = (torch.randn(t.shape, generator=gen) * 0.1).to(t.dtype)
        flat[path] = t
    return T.tree_from_leaves(p, flat), flat


def _batch(vocab, seed=0, shape=(B, S)):
    rng = np.random.RandomState(seed)
    return (torch.as_tensor(rng.randint(0, vocab, shape)),
            torch.as_tensor(rng.randint(0, vocab, shape)))


def _close(got, want, rtol=1e-4, atol=1e-6):
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


def test_mla_block_matches_reference():
    """The latent attention block's output, within 1e-5 x max|y|."""
    cfg = _config()
    _, flat = _params(cfg)
    x = torch.randn(B, S, cfg.d_model, generator=torch.Generator()
                    .manual_seed(3))
    leaves = [flat[("blocks", "b0", "mla", n)][0] for n in R.MLA]
    got = MLA.mla_train(dict(zip(R.MLA, leaves)), x, cfg)
    want = R.Model(_ref_cfg(cfg)).mla(x, *leaves)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("first,held", [(0, 8), (2, 4), (6, 2)])
def test_moe_share_layer_matches_reference(first, held):
    """The sigmoid / bias / shared-expert MoE sub-block of one expert
    share (the router whole, experts [first, first + held) held), and its
    aux, against the reference's."""
    cfg = _config(top_k=3, expert_first=first, experts_held=held)
    _, flat = _params(cfg)
    b = ("blocks", "b0")
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(B, S, cfg.d_model, generator=gen)
    h = rmsnorm(x, flat[b + ("ln2",)][0], cfg.norm_eps)
    moe = {n: flat[b + ("moe", n)][0] for n in R.MOE}
    moe["bias"] = _bias(cfg)[0]
    ffn = {n: flat[b + ("ffn", n)][0] for n in R.FFN}
    ym, aux, dropped = MOE.moe_ffn(moe, h, cfg)
    got = x + ym + T.ffn_fwd(ffn, h, cfg)
    ref = R.Model(_ref_cfg(cfg))
    yr, aux_r = ref.moe(h, moe["router"], moe["bias"], moe["w1"], moe["w3"],
                        moe["w2"])
    want = x + yr + ref.ffn(h, *ffn.values())
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    _close(aux, aux_r, rtol=LOSS_RTOL, atol=0)
    assert float(dropped) == 0.0


@pytest.mark.parametrize("first,held", [(0, 8), (2, 4)])
def test_moe_share_drops_as_reference_below_capacity(first, held):
    """At a capacity factor of 0.5 half the copies find no dispatch slot
    (the dispatch granite's MoE runs, its first ``cap_dev`` copies kept),
    and the kept ones are held to the reference's capacity rule."""
    cfg = _config(top_k=3, expert_first=first, experts_held=held,
                  moe_capacity=0.5)
    _, flat = _params(cfg)
    b = ("blocks", "b0")
    x = torch.randn(B, S, cfg.d_model, generator=torch.Generator()
                    .manual_seed(6))
    h = rmsnorm(x, flat[b + ("ln2",)][0], cfg.norm_eps)
    moe = {n: flat[b + ("moe", n)][0] for n in R.MOE}
    moe["bias"] = _bias(cfg)[0]
    ym, _, dropped = MOE.moe_ffn(moe, h, cfg, capacity_factor=0.5)
    yr, _ = R.Model(_ref_cfg(cfg)).moe(h, moe["router"], moe["bias"],
                                       moe["w1"], moe["w3"], moe["w2"])
    assert (ym - yr).abs().max() <= 1e-5 * yr.abs().max()
    assert float(dropped) == 0.5


def test_shares_add_up_to_the_uncut_layer():
    """The routed parts of four shares of two experts each, with the
    shared experts counted once, equal the uncut reference layer (all
    eight experts held); the capacity is the router's, whichever share."""
    cfg = _config(top_k=3)
    _, flat = _params(cfg)
    b = ("blocks", "b0")
    h = torch.randn(B, S, cfg.d_model, generator=torch.Generator()
                    .manual_seed(9))
    moe = {n: flat[b + ("moe", n)][0] for n in R.MOE}
    ffn = {n: flat[b + ("ffn", n)][0] for n in R.FFN}
    bias = _bias(cfg)[0]
    total = T.ffn_fwd(ffn, h, cfg)
    for first in range(0, cfg.n_experts, 2):
        share = dataclasses.replace(cfg, expert_first=first, experts_held=2)
        leaves = dict(moe, bias=bias, **{
            k: moe[k][first:first + 2] for k in ("w1", "w3", "w2")})
        total = total + MOE.moe_ffn(leaves, h, share)[0]
    ref = R.Model(_ref_cfg(cfg))
    whole = ref.moe(h, moe["router"], bias, moe["w1"], moe["w3"],
                    moe["w2"])[0] + ref.ffn(h, *ffn.values())
    assert (total - whole).abs().max() <= 1e-5 * whole.abs().max()


def test_forward_loss_gradients_and_adamw_step_match_reference():
    """``forward_loss`` (loss and aux), every gradient leaf and one AdamW
    step of the reduced model (experts 2-5 of 8 held) against the
    reference's objective, autograd and AdamW."""
    cfg = _config(top_k=3, expert_first=2, experts_held=4)
    params, flat = _params(cfg)
    toks, labels = _batch(cfg.vocab)
    leaves = T.tree_leaves(params)
    ps = [t.detach().requires_grad_(True) for _, t in leaves]
    tree = T.tree_from_leaves(params, [(p, t) for (p, _), t in
                                       zip(leaves, ps)])
    loss, aux = T.forward_loss(tree, toks, labels, cfg)
    grads = torch.autograd.grad(loss + cfg.aux_alpha * aux, ps)
    ref = R.Model(_ref_cfg(cfg), _bias(cfg))
    rp = {p: t.detach().clone().requires_grad_(True) for p, t in flat.items()}
    rloss, raux = ref.objective(rp, toks, labels)
    (rloss + ref.aux_weight * raux).backward()
    _close(loss, rloss, rtol=LOSS_RTOL, atol=0)
    _close(aux, raux, rtol=LOSS_RTOL, atol=0)
    for (path, _), g in zip(leaves, grads):
        _close(g, rp[path].grad)
    # one AdamW step each, from the same gradients
    synced = T.tree_from_leaves(params, [(p, g) for (p, _), g in
                                         zip(leaves, grads)])
    opt = AdamW()
    new, _, _ = opt.update(synced, opt.init(params), params)
    radam = RG.AdamW(dataclasses.asdict(opt))
    rparams = {p: t.detach().clone() for p, t in flat.items()}
    radam.update(rparams, {p: g for (p, _), g in zip(leaves, grads)},
                 {p: t.dtype for p, t in flat.items()})
    for path, t in T.tree_leaves(new):
        _close(t, rparams[path], rtol=1e-6, atol=1e-7)


def test_bfloat16_fails_the_loss_tolerance():
    """The same model in bfloat16 (weights rounded, activations and
    matmuls bfloat16, as the benchmark runs it) misses ``LOSS_RTOL``."""
    cfg = _config()
    params, flat = _params(cfg)
    toks, labels = _batch(cfg.vocab)
    want = R.Model(_ref_cfg(cfg), _bias(cfg)).objective(flat, toks,
                                                        labels)[0]
    low = dataclasses.replace(cfg, dtype=torch.bfloat16)
    lp = T.tree_from_leaves(params, [
        (p, t if t.ndim < 2 or p[-1] == "router" else t.to(torch.bfloat16))
        for p, t in T.tree_leaves(params)])
    got = T.forward_loss(lp, toks, labels, low)[0]
    assert abs(float(got) - float(want)) > 10 * LOSS_RTOL * abs(float(want))


def test_train_step_runs_the_sparse_embedding_sync():
    """``make_train_step`` over 2 stacked positions with the sparse sync
    of the untied embedding: finite losses that fall, no overflow."""
    from repro_torch.train.step import make_train_step, mesh_ctx
    cfg = _config()
    params, _ = _params(cfg)
    step, specs = make_train_step(cfg, mesh_ctx(2, device="cpu"),
                                  sync="sparse", opt=AdamW(lr=1e-3),
                                  aux_weight=cfg.aux_alpha,
                                  sparse_tokens_hint=B * S,
                                  sync_merge="fused",
                                  dp_degrees={"data": (2,)})
    assert "lead" in specs["params"]
    st = AdamW(lr=1e-3).init(params)
    toks, labels = _batch(cfg.vocab, shape=(2 * B, S))
    losses = []
    for _ in range(3):
        params, st, m = step(params, st, {"tokens": toks, "labels": labels})
        losses.append(float(m["loss"]))
        assert int(m["sync_overflow"]) == 0
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_spans_open_once_a_block_a_forward():
    """``model.mla`` once for every layer and ``model.moe`` once for
    every MoE layer of one forward (no backward: no recompute)."""
    cfg = _config()
    params, _ = _params(cfg)
    toks, labels = _batch(cfg.vocab)
    obs.RECORDER.reset()
    with torch.no_grad():
        T.forward_loss(params, toks, labels, cfg)
    spans = obs.snapshot()["spans"]
    assert spans["model.mla"]["calls"] == cfg.n_layers
    assert spans["model.moe"]["calls"] == cfg.n_periods
    # the granite family's MoE blocks open the span too
    gcfg = get_config("granite-moe-3b-a800m").reduced()
    gp = T.init_params(gcfg, 1, seed=0, device="cpu")
    obs.RECORDER.reset()
    with torch.no_grad():
        T.forward_loss(gp, toks % gcfg.vocab, labels % gcfg.vocab, gcfg)
    assert obs.snapshot()["spans"]["model.moe"]["calls"] == gcfg.n_periods


def test_serving_and_other_tp_refuse_the_model():
    cfg = _config()
    params, _ = _params(cfg)
    tok = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="serving"):
        T.forward_prefill(params, tok, cfg, max_seq=8,
                          head32=params["head"])
    with pytest.raises(ValueError, match="serving"):
        T.forward_decode(params, tok[:, 0], tok[:, 0], {}, cfg,
                         head32=params["head"])
    from repro_torch.launch import serve
    with pytest.raises(ValueError, match="serving"):
        serve.main(["--arch", "moonlight-16b-a3b", "--device", "cpu"])
    with pytest.raises(ValueError, match="tp = 1"):
        T.init_params(cfg, 2, device="meta")


def test_launch_train_takes_the_arch():
    from repro_torch.launch import train as launch_train
    loss = launch_train.main([
        "--arch", "moonlight-16b-a3b", "--reduced", "--device", "cpu",
        "--steps", "2", "--batch", "4", "--seq", "16", "--data-axis", "2",
        "--sync", "sparse", "--merge", "fused", "--dp-degrees", "2",
        "--experts-held", "4"])
    assert np.isfinite(loss)


def test_published_config_and_parameter_count():
    """The registry's Moonlight is the published model (27 layers, 64
    experts top-6, all held); 8 held give the reckoned 3.36 B."""
    cfg = PORT_ARCHS["moonlight-16b-a3b"]
    assert "moonlight-16b-a3b" not in ARCHS
    assert (cfg.n_layers, cfg.n_periods, cfg.n_experts, cfg.top_k,
            cfg.held) == (27, 26, 64, 6, 64)
    share = dataclasses.replace(cfg, experts_held=8)
    assert round(share.param_count() / 1e9, 2) == 3.36
    assert sum(t.numel() for _, t in T.tree_leaves(
        T.init_params(share, 1, device="meta"))) == share.param_count()


def test_other_configs_keep_their_fields_and_trees():
    """``ModelConfig`` has the reference's fields and nothing else, and
    every other configuration's parameter tree (paths, shapes, dtypes)
    is the reference package's, at its reduced size and, for the
    benchmark's granite, at full size."""
    assert [f.name for f in dataclasses.fields(ModelConfig)] == \
        [f.name for f in dataclasses.fields(JC.ModelConfig)]
    cases = [(n, ARCHS[n].reduced(), JARCHS[n].reduced()) for n in ARCHS]
    cases.append(("granite-moe-3b-a800m", ARCHS["granite-moe-3b-a800m"],
                  JARCHS["granite-moe-3b-a800m"]))
    for name, cfg, jcfg in cases:
        assert not isinstance(cfg, DeepSeekV3Config)
        own = {p: (tuple(t.shape), str(t.dtype).split(".")[-1])
               for p, t in T.tree_leaves(T.init_params(cfg, 1,
                                                       device="meta"))}
        shapes = jax.eval_shape(lambda c=jcfg: JT.init_params(c, 1, seed=0))
        theirs = {p: (tuple(a.shape), str(a.dtype))
                  for p, a in T.tree_leaves(shapes)}
        assert own == theirs, name
