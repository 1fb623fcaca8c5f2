"""Model assembly for the dense attention family (reference: ``repro.models.transformer``).

Parameters are the reference's global-shape tree at tp = 1: ``emb``
[V_pad, d], ``final_ln``, ``head`` [d, V_pad] when untied, and
``blocks`` whose leaves carry a leading period dim (the reference scans
over it; the port loops, viewing each period through one ``unbind`` per
leaf, whose backward stacks the periods' gradients once).  Each block is
recomputed in the backward under ``remat_policy="full"``
(``torch.utils.checkpoint``, the reference's per-block ``jax.checkpoint``);
``"dots"`` keeps the activations, which gives the same values.  Patterns
other than attention blocks with dense FFNs, an encoder, image tokens
and FSDP raise, naming their ROADMAP items.  :func:`params_from_jax` and
:func:`params_to_numpy` copy weights between the two packages exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from . import attention as A
from .common import (ModelConfig, act_fn, dense_init, embed, linear,
                     lm_head_loss, rmsnorm)
from .sharding import check_dense_family

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

def init_params(cfg: ModelConfig, tp: int = 1, seed: int = 0,
                device=None) -> Params:
    """Global-shape parameter tree drawn from a ``torch.Generator`` seeded
    with ``seed`` on ``device`` (default: the current CUDA device); norms
    and biases start at 0 as in the reference."""
    from repro_torch.core.transport import resolve_device
    check_dense_family(cfg)
    if tp != 1:
        raise NotImplementedError(
            "the model axis (tp > 1) is not ported yet (ROADMAP Queue 1 "
            "item 20)")
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    d, ff, hd, n = cfg.d_model, cfg.d_ff, cfg.hd, cfg.n_periods
    dt = cfg.dtype
    hq, kvw = cfg.n_heads_padded(tp) * hd, cfg.n_kv * hd
    vp = padded_vocab(cfg, tp)

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    def draw(shape, scale_axis=0):
        return dense_init(gen, (n,) + tuple(shape),
                          scale_axis=1 + scale_axis, dtype=dt)

    blocks = {}
    for j in range(len(cfg.pattern)):
        attn = {"wq": draw((d, hq)), "wk": draw((d, kvw)),
                "wv": draw((d, kvw)), "wo": draw((hq, d))}
        if cfg.qkv_bias:
            attn.update(bq=zeros(n, hq, dtype=dt), bk=zeros(n, kvw, dtype=dt),
                        bv=zeros(n, kvw, dtype=dt))
        blocks[f"b{j}"] = {
            "ln1": zeros(n, d), "attn": attn, "ln2": zeros(n, d),
            "ffn": {"w1": draw((d, ff)), "w3": draw((d, ff)),
                    "w2": draw((ff, d))}}
    p: Params = {"emb": dense_init(gen, (vp, d), scale_axis=1, dtype=dt),
                 "final_ln": zeros(d), "blocks": blocks}
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


def tree_from_leaves(like, items):
    """The dict tree of ``like`` with leaves from ``items`` ({path: leaf}
    or [(path, leaf)])."""
    d = dict(items)

    def rb(t, prefix=()):
        if isinstance(t, dict):
            return {k: rb(v, prefix + (k,)) for k, v in t.items()}
        return d[prefix]
    return rb(like)


def params_from_jax(tree, cfg: ModelConfig, device=None) -> Params:
    """A reference parameter tree (numpy arrays, e.g. ``jax.tree.map(
    np.asarray, params)``) as the port's tensors on ``device`` (default:
    the current CUDA device), value for value and dtype for dtype
    (bfloat16 arrays are reinterpreted bit for bit)."""
    from repro_torch.core.transport import resolve_device
    check_dense_family(cfg)
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
    """One period of blocks, full sequence: ``(x, aux_loss)``."""
    ckpt = _remat(cfg)
    for j in range(len(cfg.pattern)):
        e = pp[f"b{j}"]
        w = cfg.window_pattern[j] if cfg.window_pattern else cfg.window

        def mixer(pa, ln1, x, w=w):
            h = rmsnorm(x, ln1, cfg.norm_eps)
            return x + A.attn_train(pa, h, cfg, ax.tp, w, positions=positions)

        def ffnblk(pf, ln2, x):
            h2 = rmsnorm(x, ln2, cfg.norm_eps)
            return x + ffn_fwd(pf, h2, cfg)

        x = ckpt(mixer, e["attn"], e["ln1"], x)
        x = ckpt(ffnblk, e["ffn"], e["ln2"], x)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


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
    check_dense_family(cfg)
    if ax.tp != 1:
        raise NotImplementedError(
            "the model axis (tp > 1) is not ported yet (ROADMAP Queue 1 "
            "item 20)")
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
