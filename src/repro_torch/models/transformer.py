"""Model assembly, the training forward (reference: ``repro.models.transformer``).

Parameters are the reference's global-shape tree at tp = 1: ``emb``
[V_pad, d], ``final_ln``, ``head`` [d, V_pad] when untied, and
``blocks`` whose leaves carry a leading period dim (the reference scans
over it; the port loops, viewing each period through one ``unbind`` per
leaf, whose backward stacks the periods' gradients once).  A period's
blocks follow the config's ``pattern`` (attention, mamba, mLSTM, sLSTM
mixers) and ``ffn_pattern`` (dense, MoE, both, or none); the MoE aux
losses are summed over the blocks.  Each block is recomputed in the
backward under ``remat_policy="full"`` (``torch.utils.checkpoint``, the
reference's per-block ``jax.checkpoint``); ``"dots"`` keeps the
activations, which gives the same values.  An encoder, image tokens,
FSDP and tp > 1 raise, naming their ROADMAP items.
:func:`params_from_jax` and :func:`params_to_numpy` copy weights between
the two packages exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from . import attention as A
from . import moe as MOE
from . import ssm as SSM
from .common import (ModelConfig, act_fn, dense_init, embed, linear,
                     lm_head_loss, rmsnorm)
from .sharding import check_ported

Params = Dict[str, Any]


def padded_vocab(cfg: ModelConfig, tp: int) -> int:
    """Vocab rounded up to a multiple of 16 * tp."""
    return -(-cfg.vocab // (tp * 16)) * (tp * 16)


@dataclasses.dataclass(frozen=True)
class AxisCtx:
    """The reference's axis context; the port runs tp = 1 only."""
    tp_axis: str = "model"
    tp: int = 1
    dp_axes: Tuple[str, ...] = ("data",)
    fsdp_axes: Optional[Tuple[str, ...]] = None


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _block_builders(cfg: ModelConfig, tp: int, draw, zeros):
    """The reference's per-kind leaf builders, each drawing its weights
    with ``draw(shape, scale_axis, dtype)`` and its zero / one leaves
    with ``zeros(*shape, dtype)``: ``(mixers, ffn, moe)``."""
    d, ff, hd, h = cfg.d_model, cfg.d_ff, cfg.hd, cfg.n_heads
    dt, f32 = cfg.dtype, torch.float32

    def attn():
        hq, kvw = cfg.n_heads_padded(tp) * hd, cfg.n_kv * hd
        p = {"wq": draw((d, hq)), "wk": draw((d, kvw)),
             "wv": draw((d, kvw)), "wo": draw((hq, d))}
        if cfg.qkv_bias:
            p.update(bq=zeros(hq, dtype=dt), bk=zeros(kvw, dtype=dt),
                     bv=zeros(kvw, dtype=dt))
        return p

    def mamba():
        di, n = 2 * d, cfg.ssm_state
        p = {"in_x": draw((d, di)), "in_z": draw((d, di)),
             "conv": draw((cfg.ssm_conv, di)), "w_dt": draw((d, di)),
             "w_B": draw((d, n)), "w_C": draw((d, n)),
             "A_log": zeros(di, n), "D": zeros(di) + 1.0}
        p["out"] = draw((di, d))
        return p

    def mlstm():
        return {"wq": draw((d, d)), "wk": draw((d, d)), "wv": draw((d, d)),
                "wi": draw((d, h), dtype=f32), "wf": draw((d, h), dtype=f32),
                "out": draw((d, d))}

    def slstm():
        dh = d // h
        return {"wx": draw((d, 4 * d)),
                "wr": draw((h, dh, 4 * dh), scale_axis=1),
                "out": draw((d, d)), "bias": zeros(4 * d)}

    def ffn():
        return {"w1": draw((d, ff)), "w3": draw((d, ff)),
                "w2": draw((ff, d))}

    def moe():
        ep, eff = cfg.n_experts_padded(tp), cfg.expert_d_ff
        return {"router": draw((d, ep), dtype=f32),
                "w1": draw((ep, d, eff), scale_axis=1),
                "w3": draw((ep, d, eff), scale_axis=1),
                "w2": draw((ep, eff, d), scale_axis=1)}

    return ({"attn": attn, "mamba": mamba, "mlstm": mlstm, "slstm": slstm},
            ffn, moe)


def init_params(cfg: ModelConfig, tp: int = 1, seed: int = 0,
                device=None) -> Params:
    """Global-shape parameter tree drawn from a ``torch.Generator`` seeded
    with ``seed`` on ``device`` (default: the current CUDA device), block
    by block in pattern order; norms, biases and ``A_log`` start at 0 and
    mamba's ``D`` at 1, as in the reference.  The router and the mLSTM
    gates are float32."""
    from repro_torch.core.transport import resolve_device
    check_ported(cfg, tp)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    d, n = cfg.d_model, cfg.n_periods
    dt = cfg.dtype
    vp = padded_vocab(cfg, tp)

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros((n,) + shape, dtype=dtype, device=device)

    def draw(shape, scale_axis=0, dtype=dt):
        return dense_init(gen, (n,) + tuple(shape),
                          scale_axis=1 + scale_axis, dtype=dtype)

    mixers, ffn_params, moe_params = _block_builders(cfg, tp, draw, zeros)
    blocks = {}
    for j, (blk, ffn) in enumerate(zip(cfg.pattern, cfg.ffn_pattern)):
        e = {"ln1": zeros(d), blk: mixers[blk]()}
        if ffn != "none":
            e["ln2"] = zeros(d)
        if ffn in ("dense", "moe+dense"):
            e["ffn"] = ffn_params()
        if ffn in ("moe", "moe+dense"):
            e["moe"] = moe_params()
        blocks[f"b{j}"] = e
    p: Params = {"emb": dense_init(gen, (vp, d), scale_axis=1, dtype=dt),
                 "final_ln": torch.zeros(d, dtype=torch.float32,
                                         device=device),
                 "blocks": blocks}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, (d, vp), dtype=dt)
    return p


def tree_leaves(tree, prefix=()):
    """``[(path, leaf)]`` of a dict tree, keys sorted at every level (the
    reference's flatten order)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_leaves(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)]


def _rebuild(like, leaves, prefix=()):
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves, prefix + (k,)) for k, v in like.items()}
    return leaves[prefix]


def tree_from_leaves(like, items):
    """The dict tree of ``like`` with leaves from ``items`` ({path: leaf}
    or [(path, leaf)]).  (A module-level recursion: a recursive closure
    would be a reference cycle that kept the leaves, e.g. a model's
    parameters, alive until the cyclic collector ran.)"""
    return _rebuild(like, dict(items))


def params_from_jax(tree, cfg: ModelConfig, device=None) -> Params:
    """A reference parameter tree (numpy arrays, e.g. ``jax.tree.map(
    np.asarray, params)``) as the port's tensors on ``device`` (default:
    the current CUDA device), value for value and dtype for dtype
    (bfloat16 arrays are reinterpreted bit for bit)."""
    from repro_torch.core.transport import resolve_device
    check_ported(cfg)
    device = resolve_device(device)

    def conv(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a.copy())
        return t.to(device)
    return tree_from_leaves(tree, [(p, conv(a)) for p, a in tree_leaves(tree)])


def params_to_numpy(params: Params):
    """The inverse of :func:`params_from_jax`: numpy arrays, bfloat16
    leaves as ``ml_dtypes.bfloat16`` (the reference's array type)."""
    def conv(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()
    return tree_from_leaves(params, [(p, conv(t))
                                     for p, t in tree_leaves(params)])


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def ffn_fwd(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Gated FFN: act(x w1) * (x w3), then w2."""
    h = act_fn(linear(x, p["w1"]), cfg.act) * linear(x, p["w3"])
    return linear(h, p["w2"])


def _remat(cfg: ModelConfig):
    """Per-block wrapper: recompute in the backward (``"full"``) or keep
    the activations (``"dots"``; the same values)."""
    if cfg.remat_policy == "dots":
        return lambda fn, *args: fn(*args)
    return lambda fn, *args: checkpoint(fn, *args, use_reentrant=False)


def _period_fwd(pp: Params, x: torch.Tensor, cfg: ModelConfig, ax: AxisCtx,
                positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One period of blocks, full sequence: ``(x, aux_loss)``, the MoE
    blocks' aux losses summed ([M] for position-stacked x)."""
    ckpt = _remat(cfg)
    aux = torch.zeros(x.shape[:1] if pp["b0"]["ln1"].ndim == 2 else (),
                      dtype=torch.float32, device=x.device)
    for j, (blk, ffn) in enumerate(zip(cfg.pattern, cfg.ffn_pattern)):
        e = pp[f"b{j}"]
        w = cfg.window_pattern[j] if cfg.window_pattern else cfg.window

        def mixer(pm, ln1, x, blk=blk, w=w):
            h = rmsnorm(x, ln1, cfg.norm_eps)
            if blk == "attn":
                return x + A.attn_train(pm, h, cfg, ax.tp, w,
                                        positions=positions)
            if blk == "mamba":
                return x + SSM.mamba_train(pm, h, cfg, ax.tp)
            if blk == "mlstm":
                return x + SSM.mlstm_train(pm, h, cfg, ax.tp)
            if blk == "slstm":
                return x + SSM.slstm_train(pm, h, cfg, ax.tp)
            raise ValueError(f"unknown block kind {blk!r}")

        def ffnblk(pf, pmoe, ln2, x, ffn=ffn):
            h2 = rmsnorm(x, ln2, cfg.norm_eps)
            y2 = ffn_fwd(pf, h2, cfg) if pf is not None else None
            if pmoe is None:
                return x + y2, None
            ym, a, _ = MOE.moe_ffn(pmoe, h2, cfg, ax.tp,
                                   capacity_factor=cfg.moe_capacity)
            return x + (ym if y2 is None else y2 + ym), a

        x = ckpt(mixer, e[blk], e["ln1"], x)
        if ffn == "none":
            continue
        x, a = ckpt(ffnblk, e.get("ffn"), e.get("moe"), e["ln2"], x)
        if a is not None:
            aux = aux + a
    return x, aux


def _period_views(blocks: Params, n: int, dim: int = 0):
    """The period-stacked block tree (period axis ``dim``) as ``n``
    per-period trees of views."""
    paths = tree_leaves(blocks)
    per = [t.unbind(dim) for _, t in paths]
    return [tree_from_leaves(blocks, [(p, u[i]) for (p, _), u
                                      in zip(paths, per)])
            for i in range(n)]


def forward_loss(params: Params, tokens: torch.Tensor, labels: torch.Tensor,
                 cfg: ModelConfig, ax: Optional[AxisCtx] = None,
                 extra_embeds=None, enc_frames=None,
                 loss_mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward of tokens / labels [B, T]: ``(loss, aux)``.

    Position-stacked parameters (every leaf with a leading [M] axis, e.g.
    ``emb`` [M, V, d]) take tokens / labels [M, B, T] and give the M
    positions' losses and aux, each [M]: one batched program, whose
    gradient of ``loss.sum()`` is each position's own gradient."""
    ax = ax or AxisCtx()
    check_ported(cfg, ax.tp)
    if extra_embeds is not None or enc_frames is not None:
        raise NotImplementedError(
            "encoder-decoder and VLM stubs are not ported yet (ROADMAP "
            "Queue 1 item 18)")
    stacked = params["emb"].ndim == 3
    x = embed(params["emb"], tokens).to(cfg.dtype)
    positions = torch.arange(x.shape[-2], dtype=torch.int64, device=x.device)
    aux = torch.zeros(x.shape[:1] if stacked else (), dtype=torch.float32,
                      device=x.device)
    for pp in _period_views(params["blocks"], cfg.n_periods,
                            dim=1 if stacked else 0):
        x, a = _period_fwd(pp, x, cfg, ax, positions)
        aux = aux + a
    x = rmsnorm(x, params["final_ln"], cfg.norm_eps)
    head = params["emb"].transpose(-1, -2) if cfg.tie_embeddings \
        else params["head"]
    loss = lm_head_loss(x, head.to(torch.float32), labels, loss_mask)
    return loss, aux
