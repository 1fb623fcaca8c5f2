"""Model assembly, the training forward (reference: ``repro.models.transformer``).

Parameters are the reference's global-shape tree at the mesh's tp:
``emb`` [V_pad, d] (V padded to a multiple of 16 * tp), ``final_ln``,
``head`` [d, V_pad] when untied, and ``blocks`` (query heads padded to
``n_heads_padded(tp)``, experts to ``n_experts_padded(tp)``) whose
leaves carry a leading period dim (the reference scans
over it; the port loops, viewing each period through one ``unbind`` per
leaf, whose backward stacks the periods' gradients once).  A period's
blocks follow the config's ``pattern`` (attention, mamba, mLSTM, sLSTM
mixers) and ``ffn_pattern`` (dense, MoE, both, or none); the MoE aux
losses are summed over the blocks.  Each block is recomputed in the
backward under ``remat_policy="full"`` (``torch.utils.checkpoint``, the
reference's per-block ``jax.checkpoint``); ``"dots"`` keeps the
activations, which gives the same values.

The frontend stubs: an encoder-decoder (whisper) adds ``enc_blocks``
(stacked over ``enc_layers``), ``enc_ln``, ``cross`` (stacked over the
periods) and ``ln_cross``; :func:`encoder_fwd` runs the frame embeddings
through the encoder stack unmasked, and each decoder attention block is
followed by a cross-attention block against that period's encoder keys
and values.  A VLM (internvl2) prepends its patch embeddings to the
token embeddings, and the loss skips them.  FSDP (``cfg.fsdp`` on a mesh
whose axis context carries the gather's transport): each period's FSDP
leaves, held once, are gathered into the M positions' views
(``sharding.FsdpGather``), whose backward is their gradient sync.

The model axis (tp > 1, position-stacked, ``AxisCtx.model`` the
:class:`repro_torch.core.transport.ModelAxis`): the leaves are held
whole and every product whose function tp does not change runs once per
data row, as at tp = 1 (``models.common`` says why); attention takes
each model position's heads, and the MoE dispatches over the model axis
(each block's module describes how).  The MoE aux losses are each model
position's own, on its token slice (as the reference's), so at tp > 1
the aux is [M, tp]; the train objective of a data row is its loss plus
the aux weight times their mean over the model positions
(``train.step``).  :func:`params_from_jax` and
:func:`params_to_numpy` copy weights between the two packages exactly,
at any tp.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint
from torch.utils.weak import WeakIdKeyDictionary

from . import attention as A
from . import moe as MOE
from . import ssm as SSM
from .common import (ModelConfig, act_fn, dense_init, embed, linear,
                     lm_head_loss, rmsnorm)
from .sharding import (check_ported, fsdp_block_paths, fsdp_gather,
                       period_spec)

Params = Dict[str, Any]


def padded_vocab(cfg: ModelConfig, tp: int) -> int:
    """Vocab rounded up to a multiple of 16 * tp."""
    return -(-cfg.vocab // (tp * 16)) * (tp * 16)


@dataclasses.dataclass(frozen=True)
class AxisCtx:
    """The reference's axis context.  With ``fsdp_axes``,
    ``fsdp_transport`` is the stacked transport of one stage over the
    data positions that FSDP's gather reduces over; at tp > 1 ``model``
    is the mesh's model axis (``train.step.MeshCtx.axis_ctx`` gives it),
    which the MoE's exchanges go through."""
    tp_axis: str = "model"
    tp: int = 1
    dp_axes: Tuple[str, ...] = ("data",)
    fsdp_axes: Optional[Tuple[str, ...]] = None
    fsdp_transport: Any = None
    model: Any = None


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _block_builders(cfg: ModelConfig, tp: int, draw, zeros):
    """The reference's per-kind leaf builders, each drawing its weights
    with ``draw(shape, scale_axis, dtype)`` and its zero / one leaves
    with ``zeros(*shape, dtype)``: ``(mixers, ffn, moe)``."""
    d, ff, h = cfg.d_model, cfg.d_ff, cfg.n_heads
    f32 = torch.float32

    def attn():
        return A.attn_params(cfg, tp, draw, zeros)

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
    by block in pattern order, then the embedding, the head, and an
    encoder-decoder's encoder blocks and cross attention; norms, biases
    and ``A_log`` start at 0 and mamba's ``D`` at 1, as in the
    reference.  The router and the mLSTM gates are float32."""
    from repro_torch.core.transport import resolve_device
    check_ported(cfg, tp)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    d = cfg.d_model
    dt = cfg.dtype
    vp = padded_vocab(cfg, tp)

    def stacked(n):
        """``(draw, zeros)`` of leaves stacked over ``n``."""
        def zeros(*shape, dtype=torch.float32):
            return torch.zeros((n,) + shape, dtype=dtype, device=device)

        def draw(shape, scale_axis=0, dtype=dt):
            return dense_init(gen, (n,) + tuple(shape),
                              scale_axis=1 + scale_axis, dtype=dtype)
        return draw, zeros

    draw, zeros = stacked(cfg.n_periods)
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
    if cfg.enc_layers:
        edraw, ezeros = stacked(cfg.enc_layers)
        _, enc_ffn, _ = _block_builders(cfg, tp, edraw, ezeros)
        p["enc_blocks"] = {"b0": {
            "ln1": ezeros(d), "attn": A.attn_params(cfg, tp, edraw, ezeros),
            "ln2": ezeros(d), "ffn": enc_ffn()}}
        p["enc_ln"] = torch.zeros(d, dtype=torch.float32, device=device)
        p["cross"] = A.cross_attn_params(cfg, tp, draw, zeros)
        p["ln_cross"] = torch.zeros(d, dtype=torch.float32, device=device)
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
                positions: torch.Tensor, cross_kv=None, cross_p=None,
                ln_cross=None, causal: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One period of blocks, full sequence: ``(x, aux_loss)``, the MoE
    blocks' aux losses summed ([M] for position-stacked x, [M, tp] at tp >
    1: each model position's).  With
    ``cross_kv`` (the encoder's keys and values), each attention block is
    followed by a cross-attention block (``cross_p``, ``ln_cross``);
    ``causal=False`` is the encoder's unmasked attention."""
    ckpt = _remat(cfg)
    tp, model = ax.tp, ax.model
    lead = x.shape[:1] if pp["b0"]["ln1"].ndim == 2 else ()
    aux = torch.zeros(lead + ((tp,) if tp > 1 else ()), dtype=torch.float32,
                      device=x.device)
    for j, (blk, ffn) in enumerate(zip(cfg.pattern, cfg.ffn_pattern)):
        e = pp[f"b{j}"]
        w = cfg.window_pattern[j] if cfg.window_pattern else cfg.window

        def mixer(pm, ln1, x, blk=blk, w=w):
            h = rmsnorm(x, ln1, cfg.norm_eps)
            if blk == "attn":
                return x + A.attn_train_any(pm, h, cfg, tp, w,
                                            positions=positions,
                                            causal=causal)
            if blk == "mamba":
                return x + SSM.mamba_train(pm, h, cfg, tp)
            if blk == "mlstm":
                return x + SSM.mlstm_train(pm, h, cfg, tp)
            if blk == "slstm":
                return x + SSM.slstm_train(pm, h, cfg, tp)
            raise ValueError(f"unknown block kind {blk!r}")

        def ffnblk(pf, pmoe, ln2, x, ffn=ffn):
            h2 = rmsnorm(x, ln2, cfg.norm_eps)
            y2 = ffn_fwd(pf, h2, cfg) if pf is not None else None
            if pmoe is None:
                return x + y2, None
            ym, a, _ = MOE.moe_ffn(pmoe, h2, cfg, tp,
                                   capacity_factor=cfg.moe_capacity,
                                   model=model)
            return x + (ym if y2 is None else y2 + ym), a

        x = ckpt(mixer, e[blk], e["ln1"], x)
        if cross_kv is not None and blk == "attn":
            x = ckpt(_cross_block, cross_p, ln_cross, cross_kv[0],
                     cross_kv[1], x, cfg, tp)
        if ffn == "none":
            continue
        x, a = ckpt(ffnblk, e.get("ffn"), e.get("moe"), e["ln2"], x)
        if a is not None:
            aux = aux + a
    return x, aux


def _cross_block(cp, ln_cross, ck, cv, x, cfg, tp):
    """x plus the cross attention of its norm against the encoder."""
    hc = rmsnorm(x, ln_cross, cfg.norm_eps)
    return x + A.cross_attn(cp, hc, ck, cv, cfg, tp)


def _period_views(blocks: Params, n: int, dim=0):
    """The period-stacked block tree as ``n`` per-period trees of views:
    the period axis is ``dim``, or ``dim(path)`` per leaf."""
    paths = tree_leaves(blocks)
    per = [t.unbind(dim(p) if callable(dim) else dim) for p, t in paths]
    return [tree_from_leaves(blocks, [(p, u[i]) for (p, _), u
                                      in zip(paths, per)])
            for i in range(n)]


def _decoder_periods(params: Params, cfg: ModelConfig, ax: AxisCtx):
    """``(blocks, cross)``: each decoder period's block tree (under FSDP
    its FSDP leaves gathered, :func:`fsdp_gather`) and its cross
    attention leaves (``None`` without an encoder), as per-period views
    of the period-stacked leaves (position-stacked or not)."""
    stacked = params["emb"].ndim == 3
    held = fsdp_block_paths(cfg, ax.tp) if ax.fsdp_axes else frozenset()
    period_dim = (lambda path: 0 if path in held else 1) if stacked else 0
    views = _period_views(params["blocks"], cfg.n_periods, dim=period_dim)
    if ax.fsdp_axes:
        spec = period_spec(cfg, ax.tp)
        views = [fsdp_gather(pp, spec, ax.fsdp_transport) for pp in views]
    cross = [None] * cfg.n_periods
    if cfg.enc_layers:
        cross = _period_views(params["cross"], cfg.n_periods,
                              dim=1 if stacked else 0)
    return views, cross


def encoder_fwd(params: Params, frames: torch.Tensor, cfg: ModelConfig,
                ax: Optional[AxisCtx] = None) -> torch.Tensor:
    """The encoder over stub frame embeddings [B, S, d] (position-stacked:
    [M, B, S, d]): the period stack over ``enc_blocks``, unmasked, then
    ``enc_ln``."""
    ax = ax or AxisCtx()
    stacked = params["emb"].ndim == 3
    x = frames
    positions = torch.arange(x.shape[-2], dtype=torch.int64, device=x.device)
    for pp in _period_views(params["enc_blocks"], cfg.enc_layers,
                            dim=1 if stacked else 0):
        x, _ = _period_fwd(pp, x, cfg, ax, positions, causal=False)
    return rmsnorm(x, params["enc_ln"], cfg.norm_eps)


def forward_loss(params: Params, tokens: torch.Tensor, labels: torch.Tensor,
                 cfg: ModelConfig, ax: Optional[AxisCtx] = None,
                 extra_embeds=None, enc_frames=None,
                 loss_mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward of tokens / labels [B, T]: ``(loss, aux)``.

    Position-stacked parameters (every leaf with a leading [M] axis, e.g.
    ``emb`` [M, V, d]) take tokens / labels [M, B, T] and give the M
    positions' losses and aux, each [M]: one batched program, whose
    gradient of ``loss.sum()`` is each position's own gradient.  Under
    FSDP (``ax.fsdp_axes``) the FSDP block leaves are held once and
    gathered per period.

    ``extra_embeds`` [B, Ti, d] (VLM): cast to the model dtype and put
    before the token embeddings; their labels are 0 and their loss mask
    0, and positions run over the whole Ti + T.  ``enc_frames`` [B, S, d]
    (encoder-decoder): run through :func:`encoder_fwd`, and each decoder
    period's cross attention reads keys and values projected from its
    output by that period's ``cross`` leaves.

    At tp = ``ax.tp`` > 1 the parameters are the global leaves at that tp
    (``init_params(cfg, tp)``) and each data row runs the model axis as
    the module describes (the parameters position-stacked); aux is each
    model position's, [M, tp]."""
    ax = ax or AxisCtx()
    check_ported(cfg, ax.tp)
    stacked = params["emb"].ndim == 3
    if ax.tp > 1 and (ax.model is None or not stacked):
        raise ValueError("tp > 1 takes position-stacked parameters ([M, "
                         "*global] leaves) and the mesh's model axis "
                         "(AxisCtx.model, from train.step.mesh_ctx)")
    x = embed(params["emb"], tokens).to(cfg.dtype)
    mask = loss_mask
    if extra_embeds is not None:
        lead, ti = x.shape[:-2], extra_embeds.shape[-2]
        x = torch.cat([extra_embeds.to(cfg.dtype), x], dim=-2)
        labels = torch.cat([torch.zeros(lead + (ti,), dtype=labels.dtype,
                                        device=labels.device), labels], -1)
        m0 = torch.ones(tokens.shape, dtype=torch.float32,
                        device=x.device) if mask is None else mask
        mask = torch.cat([torch.zeros(lead + (ti,), dtype=torch.float32,
                                      device=x.device),
                          m0.to(torch.float32)], -1)
    positions = torch.arange(x.shape[-2], dtype=torch.int64, device=x.device)
    aux = torch.zeros((x.shape[:1] if stacked else ())
                      + ((ax.tp,) if ax.tp > 1 else ()), dtype=torch.float32,
                      device=x.device)
    views, cross = _decoder_periods(params, cfg, ax)
    if cfg.enc_layers:
        enc_out = encoder_fwd(params, enc_frames.to(cfg.dtype), cfg, ax)
    for pp, cp in zip(views, cross):
        if cp is None:
            x, a = _period_fwd(pp, x, cfg, ax, positions)
        else:
            x, a = _period_fwd(pp, x, cfg, ax, positions,
                               cross_kv=A.encode_kv(cp, enc_out, cfg, ax.tp),
                               cross_p=cp, ln_cross=params["ln_cross"])
        aux = aux + a
    x = rmsnorm(x, params["final_ln"], cfg.norm_eps)
    head = params["emb"].transpose(-1, -2) if cfg.tie_embeddings \
        else params["head"]
    loss = lm_head_loss(x, head, labels, mask)
    return loss, aux


# ---------------------------------------------------------------------------
# Serving: prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, b: int, max_seq: int, tp: int = 1,
               device=None) -> Params:
    """The zero decode cache of ``b`` batch rows, every leaf stacked over
    the periods ([n_periods, b, ...]), at the reference's global shapes
    for ``tp`` (its ``init_cache_global``): attention ``{"k", "v"}``
    [n_periods, b, max_seq, kv_local(tp) * tp, hd] in the model dtype,
    and each SSM block's state (``models.ssm``)."""
    from repro_torch.core.transport import resolve_device
    device = resolve_device(device)
    npd, kvg = cfg.n_periods, cfg.kv_local(tp) * tp
    lead = (npd, b)
    per = {}
    for j, blk in enumerate(cfg.pattern):
        if blk == "attn":
            shape = lead + (max_seq, kvg, cfg.hd)
            per[f"b{j}"] = {
                "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
        elif blk == "mamba":
            per[f"b{j}"] = SSM.mamba_init_state(lead, cfg, tp, cfg.dtype,
                                                device)
        elif blk == "mlstm":
            per[f"b{j}"] = SSM.mlstm_init_state(lead, cfg, tp, device)
        elif blk == "slstm":
            per[f"b{j}"] = SSM.slstm_init_state(lead, cfg, device)
    return per


def cache_leaves(cache):
    """``[(path, leaf)]`` of a cache tree (the sLSTM state a tuple)."""
    out = []
    for key in sorted(cache):
        c = cache[key]
        if isinstance(c, tuple):
            out.extend(((key, str(i)), t) for i, t in enumerate(c))
        else:
            out.extend(((key, k), c[k]) for k in sorted(c))
    return out


def _period_slot(leaf: torch.Tensor, i: int, lead) -> torch.Tensor:
    """Period ``i`` of a cache leaf [n_periods, B, ...] as a view with
    the batch dim split as ``lead`` ([B] or [M, B / M])."""
    return leaf[i].view(tuple(lead) + tuple(leaf.shape[2:]))


def head_f32(params: Params, cfg: ModelConfig) -> torch.Tensor:
    """The float32 head [d, V_pad] of held-once parameters (tied:
    ``emb.T``), for :func:`forward_prefill` / :func:`forward_decode`'s
    ``head32``.  The cast is kept per head tensor and redone only when the
    tensor is modified in place, so every step serving one parameter set
    shares one copy; it goes when the head tensor does (a float32 head is
    used as it is)."""
    src = params["emb"] if cfg.tie_embeddings else params["head"]
    head = src.transpose(0, 1) if cfg.tie_embeddings else src
    if head.dtype == torch.float32:
        return head
    hit = _HEAD32.get(src)
    if hit is None or hit[0] != src._version:
        with torch.no_grad():
            hit = (src._version, head.to(torch.float32))
        _HEAD32[src] = hit
    return hit[1]


# head tensor -> (its version when cast, float32 head)
_HEAD32 = WeakIdKeyDictionary()


def _ffn_out(e: Params, x: torch.Tensor, cfg: ModelConfig,
             ax: AxisCtx) -> torch.Tensor:
    """The FFN sub-block's residual add (dense, MoE or both)."""
    h2 = rmsnorm(x, e["ln2"], cfg.norm_eps)
    y2 = ffn_fwd(e["ffn"], h2, cfg) if "ffn" in e else None
    if "moe" in e:
        ym, _, _ = MOE.moe_ffn(e["moe"], h2, cfg, ax.tp,
                               capacity_factor=cfg.moe_capacity,
                               model=ax.model)
        y2 = ym if y2 is None else y2 + ym
    return x + y2


@torch.no_grad()
def forward_prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                    ax: Optional[AxisCtx] = None, max_seq: int = 0,
                    enc_frames=None, extra_embeds=None, *,
                    head32: torch.Tensor):
    """The prompt forward (the reference's ``forward_prefill``): tokens
    [B, T] (position-stacked: [M, B / M, T] with stacked parameters, as
    :func:`forward_loss` takes them) -> ``(logits, cache)``: the last
    position's float32 logits [..., V_pad] and the cache of the B rows
    (:func:`init_cache` at ``max_seq``, the prompt's keys and values in
    slots [0, T), each SSM block's final state).  ``extra_embeds`` (VLM)
    come before the tokens, so T counts them; ``enc_frames``
    (encoder-decoder) feed each period's cross attention; ``head32`` is
    the float32 head (:func:`head_f32`).  No gradient is kept."""
    ax = ax or AxisCtx()
    check_ported(cfg, ax.tp)
    x = embed(params["emb"], tokens).to(cfg.dtype)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(cfg.dtype), x], dim=-2)
    lead, t = x.shape[:-2], x.shape[-2]
    if max_seq < t:
        raise ValueError(f"max_seq {max_seq} < prompt length {t}")
    positions = torch.arange(t, dtype=torch.int64, device=x.device)
    cache = init_cache(cfg, math.prod(lead), max_seq, ax.tp, x.device)
    views, cross = _decoder_periods(params, cfg, ax)
    if cfg.enc_layers:
        enc_out = encoder_fwd(params, enc_frames.to(cfg.dtype), cfg, ax)
    for i, (pp, cp) in enumerate(zip(views, cross)):
        for j, (blk, ffn) in enumerate(zip(cfg.pattern, cfg.ffn_pattern)):
            e, c = pp[f"b{j}"], cache[f"b{j}"]
            h = rmsnorm(x, e["ln1"], cfg.norm_eps)
            w = cfg.window_pattern[j] if cfg.window_pattern else cfg.window
            if blk == "attn":
                y, (k, v) = A.attn_train_any(e[blk], h, cfg, ax.tp, w,
                                             positions=positions,
                                             return_kv=True)
                _period_slot(c["k"], i, lead)[..., :t, :, :] = k
                _period_slot(c["v"], i, lead)[..., :t, :, :] = v
            else:
                y, st = getattr(SSM, f"{blk}_train")(e[blk], h, cfg, ax.tp,
                                                     return_state=True)
                items = zip(c, st) if blk == "slstm" else \
                    ((c[k], st[k]) for k in c)
                for leaf, val in items:
                    _period_slot(leaf, i, lead).copy_(val)
            x = x + y
            if cp is not None and blk == "attn":
                ck, cv = A.encode_kv(cp, enc_out, cfg, ax.tp)
                x = _cross_block(cp, params["ln_cross"], ck, cv, x, cfg,
                                 ax.tp)
            if ffn != "none":
                x = _ffn_out(e, x, cfg, ax)
    x = rmsnorm(x[..., -1, :], params["final_ln"], cfg.norm_eps)
    return torch.matmul(x.to(torch.float32), head32), cache


@torch.no_grad()
def forward_decode(params: Params, token: torch.Tensor, pos: torch.Tensor,
                   cache: Params, cfg: ModelConfig,
                   ax: Optional[AxisCtx] = None, cross_cache=None, *,
                   head32: torch.Tensor):
    """One decode step (the reference's ``forward_decode`` with a
    batch-sharded cache): token ids and positions [B] (position-stacked:
    [M, B / M]) -> ``(logits [..., V_pad] float32, cache)``.  The cache
    is updated in place (each attention block's k / v written at ``pos``,
    each SSM state replaced) and returned.  ``cross_cache`` (the
    encoder-decoder's ``(k, v)``, :func:`build_cross_cache`) feeds the
    cross attention; ``head32`` is the float32 head (:func:`head_f32`).
    Under FSDP each period's leaves are gathered as in training.  No
    gradient is kept."""
    ax = ax or AxisCtx()
    check_ported(cfg, ax.tp)
    x = embed(params["emb"], token.unsqueeze(-1)).to(cfg.dtype)
    lead = x.shape[:-2]
    views, cross = _decoder_periods(params, cfg, ax)
    for i, (pp, cp) in enumerate(zip(views, cross)):
        for j, (blk, ffn) in enumerate(zip(cfg.pattern, cfg.ffn_pattern)):
            e, c = pp[f"b{j}"], cache[f"b{j}"]
            h = rmsnorm(x, e["ln1"], cfg.norm_eps)
            w = cfg.window_pattern[j] if cfg.window_pattern else cfg.window
            if blk == "attn":
                y = A.attn_decode(e[blk], h, _period_slot(c["k"], i, lead),
                                  _period_slot(c["v"], i, lead), pos, cfg,
                                  ax.tp, w)
            elif blk == "slstm":
                y, st = SSM.slstm_decode(
                    e[blk], h, tuple(_period_slot(leaf, i, lead)
                                     for leaf in c), cfg, ax.tp)
                for leaf, val in zip(c, st):
                    _period_slot(leaf, i, lead).copy_(val)
            else:
                views_i = {k: _period_slot(c[k], i, lead) for k in c}
                y, st = getattr(SSM, f"{blk}_decode")(e[blk], h, views_i,
                                                      cfg, ax.tp)
                for k in c:
                    views_i[k].copy_(st[k])
            x = x + y
            if cp is not None and blk == "attn":
                ck, cv = (_period_slot(t, i, lead) for t in cross_cache)
                if ax.tp > 1:
                    ck, cv = A._heads_tp(ck, ax.tp), A._heads_tp(cv, ax.tp)
                x = _cross_block(cp, params["ln_cross"], ck, cv, x, cfg,
                                 ax.tp)
            if ffn != "none":
                x = _ffn_out(e, x, cfg, ax)
    x = rmsnorm(x[..., 0, :], params["final_ln"], cfg.norm_eps)
    return torch.matmul(x.to(torch.float32), head32), cache


@torch.no_grad()
def build_cross_cache(params: Params, enc_frames: torch.Tensor,
                      cfg: ModelConfig, ax: Optional[AxisCtx] = None):
    """The encoder-decoder's cross cache: the encoder forward of the
    frames [B, S, d] (position-stacked [M, B / M, S, d]), then each
    period's cross-attention keys and values, ``(k, v)`` each
    [n_periods, B, S, kv_local(tp) * tp, hd] (the cache's head layout)."""
    ax = ax or AxisCtx()
    enc_out = encoder_fwd(params, enc_frames.to(cfg.dtype), cfg, ax)
    _, cross = _decoder_periods(params, cfg, ax)
    ks, vs = [], []
    for cp in cross:
        k, v = A.encode_kv(cp, enc_out, cfg, 1)
        ks.append(A.kv_global(k, cfg, ax.tp))
        vs.append(A.kv_global(v, cfg, ax.tp))
    b = math.prod(enc_out.shape[:-2])
    return tuple(torch.stack(t).reshape((cfg.n_periods, b)
                                        + tuple(t[0].shape[-3:]))
                 for t in (ks, vs))
