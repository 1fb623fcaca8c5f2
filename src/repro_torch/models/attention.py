"""GQA attention, the training path (reference: ``repro.models.attention``).

``attn_train`` is the reference's full-sequence attention at one
tensor-parallel shard: project q/k/v (with the optional QKV bias), rotate
q and k, score every query against every key in the activation dtype,
mask (causal, and a sliding window when ``window > 0``) with ``NEG``,
softmax in float32 and cast the weights back to the activation dtype,
then the weighted values and the output projection.  ``cross_attn`` is
the decoder's cross attention (whisper): unrotated queries against the
encoder's keys and values (``encode_kv``, computed once per period),
every key visible.  Plain torch ops in the reference's order; there is
no TPU kernel here.

At tp > 1 (position-stacked) the reference's local heads are
reproduced: query heads padded to ``n_heads_padded(tp)`` and split into
tp groups of ``heads_local``; kv heads split the same way when ``n_kv >=
tp``, else replicated and sliced, position m taking kv head ``(m *
n_kv) // tp`` (``_localize_attn``).  q, k and v come from one product
each with the held leaves; the scores run over the [M, tp] positions as
one batch; the output projection, the positions' partial products
summed over the model axis in the reference (its ``psum``), is one
product of their heads side by side with the held ``wo``.

``attn_train_blocked`` is the reference's query-chunked attention,
which the block forward takes for sequences of ``BLOCKED_ATTN_THRESHOLD``
tokens and more: the same projections and rotation, then each chunk of
``Q_CHUNK`` queries scored against the whole key sequence under its rows
of the mask, built from the positions (never a [T, T] mask), with a full
softmax row per chunk.  A chunk's float32 scores, not the sequence's,
are alive at a time in the forward; the function is ``attn_train``'s.
Decode is not ported yet (ROADMAP Queue 1 item 14).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .common import ModelConfig, linear, rope, vec

NEG = -1e30
BLOCKED_ATTN_THRESHOLD = 8192
Q_CHUNK = 1024


def attn_params(cfg: ModelConfig, tp: int, draw, zeros):
    """One attention block's leaves: ``wq`` [d, Hp * hd], ``wk`` / ``wv``
    [d, KV * hd], ``wo`` [Hp * hd, d], drawn with ``draw(shape)``, and the
    zero QKV biases (``zeros(n, dtype=)``) when ``cfg.qkv_bias``."""
    d, hd = cfg.d_model, cfg.hd
    hq, kvw = cfg.n_heads_padded(tp) * hd, cfg.n_kv * hd
    p = {"wq": draw((d, hq)), "wk": draw((d, kvw)),
         "wv": draw((d, kvw)), "wo": draw((hq, d))}
    if cfg.qkv_bias:
        p.update(bq=zeros(hq, dtype=cfg.dtype), bk=zeros(kvw, dtype=cfg.dtype),
                 bv=zeros(kvw, dtype=cfg.dtype))
    return p


def cross_attn_params(cfg: ModelConfig, tp: int, draw, zeros):
    """A cross-attention block's leaves: an attention block's."""
    return attn_params(cfg, tp, draw, zeros)


def _project_qkv(p, x: torch.Tensor, cfg: ModelConfig):
    """q [..., T, H, hd], k and v [..., T, KV, hd] in x's dtype, with as
    many heads as the leaves hold (at tp > 1 every position's)."""
    lead, hd = x.shape[:-1], cfg.hd
    q = linear(x, p["wq"])
    k = linear(x, p["wk"])
    v = linear(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + vec(p["bq"], q), k + vec(p["bk"], k), v + vec(p["bv"], v)
    return (q.reshape(lead + (-1, hd)), k.reshape(lead + (-1, hd)),
            v.reshape(lead + (-1, hd)))


def _heads_tp(q: torch.Tensor, tp: int) -> torch.Tensor:
    """Heads [M, ..., T, H, hd] split over the model axis: [M, tp, ...,
    T, H / tp, hd], position m's heads being the m-th block."""
    return q.unflatten(-2, (tp, q.shape[-2] // tp)).movedim(-3, 1)


def _kv_tp(k: torch.Tensor, cfg: ModelConfig, tp: int) -> torch.Tensor:
    """kv heads [M, ..., S, KV, hd] as each position's [M, tp, ..., S,
    kv_local, hd]: split when ``n_kv >= tp``, else head ``(m * n_kv) //
    tp`` for position m (the reference's ``_localize_attn``)."""
    if cfg.n_kv >= tp:
        return _heads_tp(k, tp)
    idx = torch.tensor([(m * cfg.n_kv) // tp for m in range(tp)],
                       device=k.device)
    return k.index_select(-2, idx).unsqueeze(-2).movedim(-3, 1)


def _merge_pos(t: torch.Tensor) -> torch.Tensor:
    """[M, tp, B, T, h, hd] as one batch [M * tp * B, T, h, hd]."""
    return t.reshape((-1,) + tuple(t.shape[-3:]))


def _group_scores_to_out(q, k, v, mask, cfg: ModelConfig, tp: int):
    """q [B,T,Hl,hd], k/v [B,S,KVl,hd], mask [T,S] or [B,T,S] ->
    [B,T,Hl*hd]: each group of Hl/KVl query heads shares one kv head."""
    b, t, hl, hd = q.shape
    kvl = k.shape[2]
    g = hl // kvl if hl % kvl == 0 else 0
    scale = math.sqrt(float(hd))
    if g == 0:  # padded heads not divisible by kv: map head -> kv by ratio
        qk_map = (torch.arange(hl, device=q.device) * kvl) // hl
        k = k.index_select(2, qk_map)             # [B,S,Hl,hd]
        v = v.index_select(2, qk_map)
        scores = torch.einsum("bthd,bshd->bhts", q, k).to(torch.float32)
        scores = scores / scale
        m = mask[None, None] if mask.ndim == 2 else mask[:, None]
        scores = torch.where(m, scores, torch.full_like(scores, NEG))
        w = torch.softmax(scores, dim=-1).to(q.dtype)
        out = torch.einsum("bhts,bshd->bthd", w, v)
    else:
        qg = q.reshape(b, t, kvl, g, hd)
        scores = torch.einsum("btkgd,bskd->bkgts", qg, k).to(torch.float32)
        scores = scores / scale
        m = mask if mask.ndim == 3 else mask[None]
        scores = torch.where(m[:, None, None], scores,
                             torch.full_like(scores, NEG))
        w = torch.softmax(scores, dim=-1).to(q.dtype)
        out = torch.einsum("bkgts,bskd->btkgd", w, v).reshape(b, t, hl, hd)
    return out.reshape(b, t, hl * hd)


def attn_mask(t: int, window: int, causal: bool = True,
              device=None, rows: Optional[range] = None) -> torch.Tensor:
    """bool [T, T]: causal (key <= query), within ``window`` positions
    when ``window > 0``; all true when not causal.  ``rows``: only those
    query rows, [len(rows), T]."""
    rows = rows if rows is not None else range(t)
    ti = torch.arange(rows.start, rows.stop, dtype=torch.int64,
                      device=device)
    si = torch.arange(t, dtype=torch.int64, device=device)
    rel = ti[:, None] - si[None, :]
    if not causal:
        return torch.ones((len(rows), t), dtype=torch.bool, device=device)
    w_eff = window if window > 0 else t + 1
    return (rel >= 0) & (rel < w_eff)


def _heads_out(q, k, v, mask, cfg: ModelConfig, tp: int) -> torch.Tensor:
    """The attended heads of q [..., T, H, hd] against k / v [..., S, KV,
    hd] under ``mask`` [T, S], before the output projection: [..., T,
    H * hd].  At tp > 1 (position-stacked; k / v may be per position
    already, [M, tp, ..., S, kv_local, hd]) each model position's heads,
    laid side by side."""
    if tp > 1:
        qt = _heads_tp(q, tp)
        if k.ndim == q.ndim:
            k, v = _kv_tp(k, cfg, tp), _kv_tp(v, cfg, tp)
        out = _group_scores_to_out(_merge_pos(qt), _merge_pos(k),
                                   _merge_pos(v), mask, cfg, tp)
        out = out.reshape(qt.shape[:-2] + (out.shape[-1],))  # [M, tp, ..., hl*hd]
        return out.movedim(1, -2).flatten(-2)
    out = _group_scores_to_out(q.reshape((-1,) + tuple(q.shape[-3:])),
                               k.reshape((-1,) + tuple(k.shape[-3:])),
                               v.reshape((-1,) + tuple(v.shape[-3:])),
                               mask, cfg, tp)
    return out.reshape(q.shape[:-2] + (out.shape[-1],))


def _rotated_qkv(p, x: torch.Tensor, cfg: ModelConfig,
                 positions: Optional[torch.Tensor]):
    """q, k, v of x projected, q and k rotated at ``positions`` (default
    0..T-1)."""
    q, k, v = _project_qkv(p, x, cfg)
    if positions is None:
        positions = torch.arange(x.shape[-2], dtype=torch.int64,
                                 device=x.device)
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def attn_train(p, x: torch.Tensor, cfg: ModelConfig, tp: int, window: int,
               positions: Optional[torch.Tensor] = None,
               causal: bool = True) -> torch.Tensor:
    """Full-sequence attention of x [B, T, d] (position-stacked: [M, B, T,
    d] with stacked weights); ``window`` 0 = full; ``positions`` [T] or
    broadcastable to the leading dims + [T].  At tp > 1 (position-stacked)
    each model position's heads."""
    t = x.shape[-2]
    q, k, v = _rotated_qkv(p, x, cfg, positions)
    mask = attn_mask(t, int(window), causal, device=x.device)
    return linear(_heads_out(q, k, v, mask, cfg, tp), p["wo"])


def attn_train_blocked(p, x: torch.Tensor, cfg: ModelConfig, tp: int,
                       window: int, positions: Optional[torch.Tensor] = None,
                       causal: bool = True) -> torch.Tensor:
    """:func:`attn_train` in chunks of ``Q_CHUNK`` queries (the reference's
    query-chunked attention for long sequences): project and rotate as
    ``attn_train``, then score each chunk against the whole key sequence,
    ``[..., heads, Q_CHUNK, T]``, under the chunk's rows of the causal and
    window mask (built from the positions), softmax each full row, attend,
    and lay the chunks end to end for one ``wo`` product.  T must be a
    multiple of ``Q_CHUNK``.  At tp > 1 each chunk takes each model
    position's heads."""
    t = x.shape[-2]
    if t % Q_CHUNK:
        raise ValueError(f"attn_train_blocked: sequence length {t} is not a "
                         f"multiple of Q_CHUNK={Q_CHUNK}")
    q, k, v = _rotated_qkv(p, x, cfg, positions)
    if tp > 1:
        k, v = _kv_tp(k, cfg, tp), _kv_tp(v, cfg, tp)
    outs = []
    for lo in range(0, t, Q_CHUNK):
        rows = range(lo, lo + Q_CHUNK)
        mask = attn_mask(t, int(window), causal, device=x.device, rows=rows)
        outs.append(_heads_out(q[..., lo:lo + Q_CHUNK, :, :], k, v, mask,
                               cfg, tp))
    return linear(torch.cat(outs, dim=-2), p["wo"])


def attn_train_any(p, x: torch.Tensor, cfg: ModelConfig, tp: int,
                   window: int, positions: Optional[torch.Tensor] = None,
                   causal: bool = True) -> torch.Tensor:
    """The block forward's dispatch (the reference's ``_attn_any``):
    :func:`attn_train_blocked` for sequences of ``BLOCKED_ATTN_THRESHOLD``
    tokens and more, else :func:`attn_train`."""
    fn = attn_train_blocked if x.shape[-2] >= BLOCKED_ATTN_THRESHOLD \
        else attn_train
    return fn(p, x, cfg, tp, window, positions=positions, causal=causal)


def cross_attn(p, x: torch.Tensor, enc_k: torch.Tensor, enc_v: torch.Tensor,
               cfg: ModelConfig, tp: int = 1) -> torch.Tensor:
    """Decoder cross attention of x [B, T, d] against the encoder's keys
    and values [B, S, KVl, hd] (``encode_kv``): no bias, no rotation,
    every key visible.  Position-stacked: x [M, B, T, d], k/v [M, B, S,
    KVl, hd], stacked weights; at tp > 1 the keys and values are each
    position's, [M, tp, B, S, kv_local, hd]."""
    t, hd = x.shape[-2], cfg.hd
    q = linear(x, p["wq"])
    q = q.reshape(q.shape[:-1] + (-1, hd))
    s = enc_k.shape[-3]
    mask = torch.ones((t, s), dtype=torch.bool, device=x.device)
    return linear(_heads_out(q, enc_k.to(q.dtype), enc_v.to(q.dtype), mask,
                             cfg, tp), p["wo"])


def encode_kv(p, enc_out: torch.Tensor, cfg: ModelConfig, tp: int = 1):
    """Cross attention's keys and values [..., S, KVl, hd] from the
    encoder output [..., S, d] (no bias); at tp > 1 (position-stacked)
    each position's, [M, tp, ..., S, kv_local, hd]."""
    hd = cfg.hd
    k = linear(enc_out, p["wk"])
    v = linear(enc_out, p["wv"])
    k = k.reshape(k.shape[:-1] + (-1, hd))
    v = v.reshape(v.shape[:-1] + (-1, hd))
    if tp > 1:
        return _kv_tp(k, cfg, tp), _kv_tp(v, cfg, tp)
    return k, v
