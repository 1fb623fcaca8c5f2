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

Serving: the prefill's ``return_kv=True`` returns the rotated keys and
values in the cache's head layout (:func:`kv_global`), and
``attn_decode`` is the reference's one-token step against a [..., S,
KVg, hd] cache: rotate q and k at ``pos``, write k / v at ``pos`` (in
place), score the query against every cache slot in the activation
dtype under the mask ``slot <= pos`` (and the window), softmax in
float32, then the weighted values and ``wo``.  The cache holds the
reference's global kv heads at the mesh's tp: ``kv_local(tp) * tp`` of
them, model position m's being block m (when ``n_kv < tp``, kv head ``(m
* n_kv) // tp`` repeated per position, as the reference's
``_localize_attn`` takes it).

Two more decode layouts.  ``attn_decode_splitkv`` is flash-decoding
over a cache whose sequence axis is split over the M data positions:
the batch is replicated, the cache is the same global tensor viewed as
M slot blocks, and each block's softmax statistics (float32 maximum,
sum of exponentials, weighted values) combine through the stacked
transport's ``pmax`` and ``psum``.  ``attn_decode_2d`` / ``ffn_2d`` are
the 2D weight-stationary decode: the held-once FSDP leaves are used in
place, each data position multiplying its row (or column) block of a
leaf, a view, and the partial products are summed (or laid end to end)
by the transport; the rows are gathered around each product instead of
the weights.  Every exchange goes through the transport, so its
``calls`` / ``sums`` / ``maxes`` are the reference's collective census.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from .common import ModelConfig, act_fn, linear, rope, vec

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
    return _heads_tp(kv_global(k, cfg, tp), tp)


def _merge_pos(t: torch.Tensor) -> torch.Tensor:
    """[M, tp, B, T, h, hd] as one batch [M * tp * B, T, h, hd]."""
    return t.reshape((-1,) + tuple(t.shape[-3:]))


def _group_scores_to_out(q, k, v, mask, cfg: ModelConfig, tp: int):
    """q [B,T,Hl,hd], k [B,S,KVl,hd], v [B,S,KVl,vd], mask [T,S] or
    [B,T,S] -> [B,T,Hl*vd]: each group of Hl/KVl query heads shares one kv
    head (vd = hd but for latent attention's values)."""
    b, t, hl, hd = q.shape
    kvl, vd = k.shape[2], v.shape[-1]
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
        out = torch.einsum("bkgts,bskd->btkgd", w, v).reshape(b, t, hl, vd)
    return out.reshape(b, t, hl * vd)


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


def kv_global(k: torch.Tensor, cfg: ModelConfig, tp: int) -> torch.Tensor:
    """kv heads [..., S, KV, hd] in the cache's layout [..., S,
    kv_local(tp) * tp, hd]: as they are when ``n_kv >= tp`` (the model
    positions' blocks in order), else position m's head ``(m * n_kv) //
    tp`` for each m."""
    if cfg.n_kv >= tp:
        return k
    idx = torch.tensor([(m * cfg.n_kv) // tp for m in range(tp)],
                       device=k.device)
    return k.index_select(-2, idx)


def _with_kv(y, k, v, cfg: ModelConfig, tp: int, return_kv: bool):
    """``y``, or ``(y, (k, v))`` in the cache's layout."""
    if not return_kv:
        return y
    return y, (kv_global(k, cfg, tp), kv_global(v, cfg, tp))


def attn_train(p, x: torch.Tensor, cfg: ModelConfig, tp: int, window: int,
               positions: Optional[torch.Tensor] = None,
               causal: bool = True, return_kv: bool = False):
    """Full-sequence attention of x [B, T, d] (position-stacked: [M, B, T,
    d] with stacked weights); ``window`` 0 = full; ``positions`` [T] or
    broadcastable to the leading dims + [T].  At tp > 1 (position-stacked)
    each model position's heads.  ``return_kv``: also the rotated keys
    and values, [..., T, KVg, hd] (:func:`kv_global`)."""
    t = x.shape[-2]
    q, k, v = _rotated_qkv(p, x, cfg, positions)
    mask = attn_mask(t, int(window), causal, device=x.device)
    return _with_kv(linear(_heads_out(q, k, v, mask, cfg, tp), p["wo"]),
                    k, v, cfg, tp, return_kv)


def attn_train_blocked(p, x: torch.Tensor, cfg: ModelConfig, tp: int,
                       window: int, positions: Optional[torch.Tensor] = None,
                       causal: bool = True, return_kv: bool = False):
    """:func:`attn_train` in chunks of ``Q_CHUNK`` queries (the reference's
    query-chunked attention for long sequences): project and rotate as
    ``attn_train``, then score each chunk against the whole key sequence,
    ``[..., heads, Q_CHUNK, T]``, under the chunk's rows of the causal and
    window mask (built from the positions), softmax each full row, attend,
    and lay the chunks end to end for one ``wo`` product.  T must be a
    multiple of ``Q_CHUNK``.  At tp > 1 each chunk takes each model
    position's heads.  ``return_kv`` as :func:`attn_train`'s."""
    t = x.shape[-2]
    if t % Q_CHUNK:
        raise ValueError(f"attn_train_blocked: sequence length {t} is not a "
                         f"multiple of Q_CHUNK={Q_CHUNK}")
    q, k0, v0 = _rotated_qkv(p, x, cfg, positions)
    k, v = (_kv_tp(k0, cfg, tp), _kv_tp(v0, cfg, tp)) if tp > 1 else (k0, v0)
    outs = []
    for lo in range(0, t, Q_CHUNK):
        rows = range(lo, lo + Q_CHUNK)
        mask = attn_mask(t, int(window), causal, device=x.device, rows=rows)
        outs.append(_heads_out(q[..., lo:lo + Q_CHUNK, :, :], k, v, mask,
                               cfg, tp))
    return _with_kv(linear(torch.cat(outs, dim=-2), p["wo"]), k0, v0, cfg,
                    tp, return_kv)


def attn_train_any(p, x: torch.Tensor, cfg: ModelConfig, tp: int,
                   window: int, positions: Optional[torch.Tensor] = None,
                   causal: bool = True, return_kv: bool = False):
    """The block forward's dispatch (the reference's ``_attn_any``):
    :func:`attn_train_blocked` for sequences of ``BLOCKED_ATTN_THRESHOLD``
    tokens and more, else :func:`attn_train`."""
    fn = attn_train_blocked if x.shape[-2] >= BLOCKED_ATTN_THRESHOLD \
        else attn_train
    return fn(p, x, cfg, tp, window, positions=positions, causal=causal,
              return_kv=return_kv)


def _decode_write(cache_k: torch.Tensor, cache_v: torch.Tensor,
                  k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor,
                  cfg: ModelConfig, tp: int) -> None:
    """Write one token's rotated k / v [..., 1, KV, hd] into the cache
    [..., S, KVg, hd] at ``pos`` [...] in place (one slot a row, an
    ``index_put_`` of distinct rows), in the cache's head layout."""
    s, kvg, hd = cache_k.shape[-3:]
    rows = torch.arange(pos.numel(), device=pos.device)
    flat = pos.reshape(-1)
    ck, cv = cache_k.view(-1, s, kvg, hd), cache_v.view(-1, s, kvg, hd)
    ck[rows, flat] = kv_global(k, cfg, tp).reshape(-1, kvg, hd).to(ck.dtype)
    cv[rows, flat] = kv_global(v, cfg, tp).reshape(-1, kvg, hd).to(cv.dtype)


def _decode_heads(q: torch.Tensor, cache_k: torch.Tensor,
                  cache_v: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig,
                  tp: int, window: int) -> torch.Tensor:
    """The attended heads [..., 1, H * hd] of one rotated query [..., 1,
    H, hd] against every cache slot ``<= pos`` (within ``window`` when it
    is > 0), before the output projection."""
    s = cache_k.shape[-3]
    si = torch.arange(s, device=q.device)
    w_eff = int(window) if window > 0 else s + 1
    rel = pos.unsqueeze(-1) - si                       # [..., S]
    mask = ((rel >= 0) & (rel < w_eff)).unsqueeze(-2)  # [..., 1, S]
    kk, vv = cache_k.to(q.dtype), cache_v.to(q.dtype)
    if tp > 1:
        kk, vv = _heads_tp(kk, tp), _heads_tp(vv, tp)
        mask = mask.unsqueeze(1).expand((mask.shape[0], tp)
                                        + tuple(mask.shape[1:]))
    mask = mask.reshape((-1,) + tuple(mask.shape[-2:]))
    return _heads_out(q, kk, vv, mask, cfg, tp)


def attn_decode(p, x: torch.Tensor, cache_k: torch.Tensor,
                cache_v: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig,
                tp: int, window: int) -> torch.Tensor:
    """One new token x [..., 1, d] against the cache [..., S, KVg, hd]
    (``pos`` [...]: the token's position, the length written so far):
    its rotated k / v are written at ``pos`` in place (one slot a row, an
    ``index_put_`` of distinct rows), then the query attends to the slots
    ``<= pos`` (within ``window`` when it is > 0).  Returns [..., 1, d].
    At tp > 1 (position-stacked) each model position's heads against its
    block of the cache's heads, then one ``wo`` product."""
    q, k, v = _rotated_qkv(p, x, cfg, pos.unsqueeze(-1))
    _decode_write(cache_k, cache_v, k, v, pos, cfg, tp)
    return linear(_decode_heads(q, cache_k, cache_v, pos, cfg, tp, window),
                  p["wo"])


# ---------------------------------------------------------------------------
# Split-KV decode over a sequence-sharded cache
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _kv_head_map(cfg: ModelConfig, tp: int, hq: int, device: torch.device
                 ) -> Tuple[Optional[torch.Tensor], int]:
    """``(kmap, g)`` for ``hq`` global query heads against a cache of
    ``kv_local(tp) * tp`` heads: model position m's query head i reads its
    kv head ``(i * kv_local) // heads_local`` (the reference's ``qk_map``
    within each position).  Where that is query head h reading kv head h
    // g for every h, ``(None, g)``; else ``(kmap int64 [hq] on device,
    0)``.  Built once per (config, tp, heads, device)."""
    hl, kvl = hq // tp, cfg.kv_local(tp)
    kmap = [(h // hl) * kvl + ((h % hl) * kvl) // hl for h in range(hq)]
    kvg = kvl * tp
    if hq % kvg == 0 and kmap == [h // (hq // kvg) for h in range(hq)]:
        return None, hq // kvg
    return torch.tensor(kmap, dtype=torch.int64, device=device), 0


def _shard_scores(q: torch.Tensor, k: torch.Tensor,
                  kmap: Optional[torch.Tensor], g: int) -> torch.Tensor:
    """q [B, H, hd] against one shard's keys [B, S_loc, KVg, hd]: [B, H,
    S_loc] in q's dtype.  ``g`` > 0: query heads h of kv head h // g (the
    reference's ``take`` by ``qk_map`` then the same products, without
    copying the keys per query head); else by ``kmap``."""
    b, hq, hd = q.shape
    if g:
        return torch.einsum("bkgd,bskd->bkgs", q.reshape(b, -1, g, hd),
                            k).reshape(b, hq, -1)
    return torch.einsum("bhd,bshd->bhs", q, k.index_select(2, kmap))


def _shard_values(z: torch.Tensor, v: torch.Tensor,
                  kmap: Optional[torch.Tensor], g: int) -> torch.Tensor:
    """float32 weights z [B, H, S_loc] times one shard's values [B, S_loc,
    KVg, hd] (float32): [B, H, hd]."""
    b, hq, s = z.shape
    if g:
        return torch.einsum("bkgs,bskd->bkgd", z.reshape(b, -1, g, s),
                            v).reshape(b, hq, -1)
    return torch.einsum("bhs,bshd->bhd", z, v.index_select(2, kmap))


def _splitkv_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  cache_k: torch.Tensor, cache_v: torch.Tensor,
                  pos: torch.Tensor, cfg: ModelConfig, tp: int, window: int,
                  seq_axis) -> torch.Tensor:
    """The split-KV attention core (the reference's ``_splitkv_core``) on
    rotated q [B, 1, H, hd] and k / v [B, 1, KV, hd], all heads of every
    model position, against the global cache [B, S, KVg, hd]: data
    position d owns slots [d * S / M, (d + 1) * S / M) (``seq_axis``, the
    :class:`~repro_torch.core.transport.StackedTransport` of the M
    positions).  The owner writes the new token's k / v at ``pos`` (in
    place); each position scores its slots, masked to ``<= pos`` and the
    window, and its float32 maximum, sum of exponentials and weighted
    values combine over the positions by the transport's ``pmax`` and
    ``psum``.  Returns [B, H * hd] in q's dtype."""
    _decode_write(cache_k, cache_v, k, v, pos, cfg, tp)
    m = seq_axis.num_nodes
    b, s = cache_k.shape[:2]
    if s % m:
        raise ValueError(f"split-KV: {s} cache slots do not split over {m} "
                         f"data positions")
    s_loc, hq, hd = s // m, q.shape[-2], cfg.hd
    kmap, g = _kv_head_map(cfg, tp, hq, q.device)
    q1 = q[:, 0]                                           # [B, H, hd]
    scores = []
    for d in range(m):
        lo = d * s_loc
        sc = _shard_scores(q1, cache_k[:, lo:lo + s_loc].to(q.dtype), kmap,
                           g).to(torch.float32) / math.sqrt(float(hd))
        spos = lo + torch.arange(s_loc, device=q.device)
        rel = pos.unsqueeze(-1) - spos                     # [B, S_loc]
        mask = rel >= 0
        if window > 0:
            mask = mask & (rel < int(window))
        scores.append(torch.where(mask.unsqueeze(1), sc,
                                  torch.full_like(sc, NEG)))
    scores = torch.stack(scores)                           # [M, B, H, S_loc]
    mx = seq_axis.pmax(scores.amax(dim=-1))                # [M, B, H]
    z = torch.exp(scores - mx.unsqueeze(-1))
    l = seq_axis.psum(z.sum(dim=-1))
    o = torch.stack([_shard_values(
        z[d], cache_v[:, d * s_loc:(d + 1) * s_loc].to(q.dtype)
        .to(torch.float32), kmap, g) for d in range(m)])   # [M, B, H, hd]
    o = seq_axis.psum(o)
    out = (o[0] / torch.clamp(l[0], min=1e-30).unsqueeze(-1)).to(q.dtype)
    return out.reshape(b, hq * hd)


def attn_decode_splitkv(p, x: torch.Tensor, cache_k: torch.Tensor,
                        cache_v: torch.Tensor, pos: torch.Tensor,
                        cfg: ModelConfig, tp: int, window: int,
                        seq_axis) -> torch.Tensor:
    """Flash-decoding over a sequence-sharded cache (the reference's
    ``attn_decode_splitkv``): x [B, 1, d], the batch replicated over the
    data positions, so q / k / v are projected once (they do not depend
    on the shard); :func:`_splitkv_core` against the global cache [B, S,
    KVg, hd]; one ``wo`` product.  Returns [B, 1, d]."""
    q, k, v = _rotated_qkv(p, x, cfg, pos.unsqueeze(-1))
    out = _splitkv_core(q, k, v, cache_k, cache_v, pos, cfg, tp, window,
                        seq_axis)
    return linear(out, p["wo"]).unsqueeze(-2)


# ---------------------------------------------------------------------------
# 2D weight-stationary decode (serve2d)
# ---------------------------------------------------------------------------

def _own_block(x: torch.Tensor, m: int, dim: int) -> torch.Tensor:
    """Position d's d-th block of ``dim`` from a per-position [M, ...]
    tensor: [M, ..., n / M at dim, ...]."""
    xr = x.unflatten(dim, (m, x.shape[dim] // m)).movedim(dim, 1)
    idx = torch.arange(m, device=x.device)
    return xr[idx, idx]


def _col_matmul_2d(x_full: torch.Tensor, w: torch.Tensor, transport,
                   axes=None) -> torch.Tensor:
    """x_full [M, N, d] (each data position's copy) times the held-once
    leaf w [d, out] split by rows over the M positions: position d
    multiplies its column block of x by its row block of w (a view), and
    the partial products [M, N, out] are summed over the data axes
    (``transport.psum``, one sum an axis).  [M, N, out], every position
    the same."""
    m = transport.num_nodes
    part = torch.bmm(_own_block(x_full, m, 2),
                     w.unflatten(0, (m, w.shape[0] // m)))
    return transport.psum(part, axes)


def _row_matmul_2d(h: torch.Tensor, w: torch.Tensor,
                   transport) -> torch.Tensor:
    """h [M, N, in] (each position's copy) times the held-once leaf w [in,
    d] split by columns: position d takes its column block of w (a view),
    and the M column blocks [M, N, d / M] are laid end to end by the
    transport's tiled all_gather: [M, N, d].  (The reference's psum over
    the model axis is the whole product here: the leaf is held whole.)"""
    m = transport.num_nodes
    wv = w.unflatten(1, (m, w.shape[1] // m)).movedim(1, 0)   # [M, in, d/M]
    part = torch.bmm(h, wv)                                   # [M, N, d/M]
    (full,) = transport.all_gather(0, part.transpose(1, 2).contiguous())
    return full.transpose(1, 2)


def _batch_replicate(x: torch.Tensor, transport) -> torch.Tensor:
    """Per-position rows [M, b_loc, ...] -> every position holds all M *
    b_loc rows (the transport's tiled all_gather)."""
    return transport.all_gather(0, x)[0]


def _batch_slice(x: torch.Tensor, b_loc: int) -> torch.Tensor:
    """[M, B, ...] -> position d's rows [d * b_loc, (d + 1) * b_loc)."""
    return _own_block(x, x.shape[0], 1)


def _full_rows(x: torch.Tensor, transport, batch_replicated: bool):
    """The rows every position multiplies, [M, N, d]: the held-once batch
    x [B, 1, d] as each position's view when it is replicated, else the
    positions' rows x [M, b_loc, 1, d] gathered."""
    if batch_replicated:
        return x[:, 0].unsqueeze(0).expand((transport.num_nodes,)
                                           + tuple(x[:, 0].shape))
    return _batch_replicate(x[..., 0, :], transport)


def _own_rows(y: torch.Tensor, b_loc: int, batch_replicated: bool):
    """[M, N, ...] every position the same -> the batch held once [N,
    ...] (replicated) or each position's rows [M, b_loc, ...]."""
    return y[0] if batch_replicated else _batch_slice(y, b_loc)


def attn_decode_2d(p, x: torch.Tensor, cache_k: torch.Tensor,
                   cache_v: torch.Tensor, pos: torch.Tensor,
                   cfg: ModelConfig, tp: int, window: int, transport,
                   axes=None, seq_axis=None) -> torch.Tensor:
    """One decode token with the held-once FSDP attention leaves used in
    place (the reference's ``attn_decode_2d``): no per-period gather.

    ``transport``: the stacked transport of the M data positions (one
    stage of degree M, ``MeshCtx.axis_ctx``'s FSDP transport); ``axes``
    the data axes' sizes for its sums.  Batch-sharded cache
    (``seq_axis=None``): x [M, b_loc, 1, d], the cache [M, b_loc, S,
    KVg, hd]; the rows are gathered, q / k / v are
    :func:`_col_matmul_2d` products, each position attends its own rows,
    the heads are gathered again for :func:`_row_matmul_2d`, and each
    position keeps its rows: [M, b_loc, 1, d].  Sequence-sharded
    (``seq_axis`` the split-KV transport): x [B, 1, d] replicated, the
    global cache [B, S, KVg, hd], the core :func:`_splitkv_core`:
    [B, 1, d]."""
    replicated = seq_axis is not None
    b_loc = x.shape[-3]
    xf = _full_rows(x, transport, replicated)
    q = _col_matmul_2d(xf, p["wq"], transport, axes)
    k = _col_matmul_2d(xf, p["wk"], transport, axes)
    v = _col_matmul_2d(xf, p["wv"], transport, axes)
    if cfg.qkv_bias:
        q, k, v = q + vec(p["bq"], q), k + vec(p["bk"], k), v + vec(p["bv"], v)
    q, k, v = (_own_rows(t, b_loc, replicated).unsqueeze(-2)
               .unflatten(-1, (-1, cfg.hd)) for t in (q, k, v))
    q = rope(q, pos.unsqueeze(-1), cfg.rope_theta)
    k = rope(k, pos.unsqueeze(-1), cfg.rope_theta)
    if replicated:
        out = _splitkv_core(q, k, v, cache_k, cache_v, pos, cfg, tp, window,
                            seq_axis)                          # [B, H*hd]
        out_full = out.unsqueeze(0).expand((transport.num_nodes,)
                                           + tuple(out.shape))
    else:
        _decode_write(cache_k, cache_v, k, v, pos, cfg, tp)
        out = _decode_heads(q, cache_k, cache_v, pos, cfg, tp, window)
        out_full = _batch_replicate(out[..., 0, :], transport)  # [M, B, H*hd]
    y = _row_matmul_2d(out_full, p["wo"], transport)
    return _own_rows(y, b_loc, replicated).unsqueeze(-2)


def ffn_2d(p, x: torch.Tensor, cfg: ModelConfig, transport, axes=None,
           batch_replicated: bool = False) -> torch.Tensor:
    """The dense FFN with held-once FSDP leaves used in place (the
    reference's ``ffn_2d``): act(x w1) * (x w3) from
    :func:`_col_matmul_2d` products, then :func:`_row_matmul_2d` by w2.
    x [M, b_loc, 1, d] (or [B, 1, d] replicated) -> the same shape."""
    b_loc = x.shape[-3]
    xf = _full_rows(x, transport, batch_replicated)
    h = act_fn(_col_matmul_2d(xf, p["w1"], transport, axes), cfg.act) \
        * _col_matmul_2d(xf, p["w3"], transport, axes)
    y = _row_matmul_2d(h, p["w2"], transport)
    return _own_rows(y, b_loc, batch_replicated).unsqueeze(-2)


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
