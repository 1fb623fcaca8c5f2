"""Multi-head latent attention (MLA), the training block of a DeepSeek-V3
decoder (``models.common.DeepSeekV3Config``).  The port's own block: the
reference package has none.

Per token x [d]: ``q = x wq`` gives each of the H heads a query of
``q_nope_dim`` unrotated and ``q_rope_dim`` rotated columns; ``x wkv_a``
gives a ``kv_rank``-wide latent and one ``q_rope_dim``-wide rope key that
every head shares; the latent goes through an RMS norm (gain ``kv_ln``),
then ``wkv_b`` up-projects it to each head's ``q_nope_dim`` key columns
and ``v_dim`` value columns.  Keys are the up-projected columns beside the
shared rope key; scores over sqrt(q_nope_dim + q_rope_dim), causal;
softmax in float32 as ``attention``'s; the heads' values through ``wo``.
No ``q`` latent (``q_lora_rank`` null) and no rope scaling.

RoPE rotates the two halves of the rope columns (``common.rope``, the
port's layout).  The published modelling code rotates interleaved pairs;
the two differ by a fixed permutation of the rope columns of ``wq`` and
``wkv_a``, so a checkpoint maps onto this layout by permuting them.

Scores reuse ``attention._group_scores_to_out`` (one kv head a query
head), whose output takes the value heads' width; sequences of
``attention.BLOCKED_ATTN_THRESHOLD`` tokens and more are scored in
chunks of ``Q_CHUNK`` queries, as the GQA block's.  Each block's forward
is the span ``model.mla`` (:mod:`repro_torch.obs`), again in the
backward's recompute.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import obs

from . import attention as A
from .common import DeepSeekV3Config, linear, rmsnorm, rope


def mla_params(cfg: DeepSeekV3Config, draw, zeros):
    """One block's leaves: ``wq`` [d, H * (nope + rope)], ``wkv_a`` [d,
    kv_rank + rope], the latent's norm gain ``kv_ln`` [kv_rank] (float32,
    zero-centred), ``wkv_b`` [kv_rank, H * (nope + v)], ``wo`` [H * v,
    d]."""
    d, h = cfg.d_model, cfg.n_heads
    return {"wq": draw((d, h * (cfg.q_nope_dim + cfg.q_rope_dim))),
            "wkv_a": draw((d, cfg.kv_rank + cfg.q_rope_dim)),
            "kv_ln": zeros(cfg.kv_rank),
            "wkv_b": draw((cfg.kv_rank, h * (cfg.q_nope_dim + cfg.v_dim))),
            "wo": draw((h * cfg.v_dim, d))}


def _qkv(p, x: torch.Tensor, cfg: DeepSeekV3Config,
         positions: torch.Tensor):
    """Rotated q and k [..., T, H, nope + rope] and v [..., T, H, v_dim]
    in x's dtype."""
    lead, h = x.shape[:-1], cfg.n_heads
    nope, rp = cfg.q_nope_dim, cfg.q_rope_dim
    q = linear(x, p["wq"]).reshape(lead + (h, nope + rp))
    ckv = linear(x, p["wkv_a"])
    latent = rmsnorm(ckv[..., :cfg.kv_rank], p["kv_ln"], cfg.norm_eps)
    k_rope = rope(ckv[..., cfg.kv_rank:].unsqueeze(-2), positions,
                  cfg.rope_theta)                         # [..., T, 1, rp]
    kv = linear(latent, p["wkv_b"]).reshape(lead + (h, nope + cfg.v_dim))
    q = torch.cat([q[..., :nope], rope(q[..., nope:], positions,
                                       cfg.rope_theta)], dim=-1)
    k = torch.cat([kv[..., :nope], k_rope.expand(lead + (h, rp))], dim=-1)
    return q, k, kv[..., nope:]


def _heads(q, k, v, mask, cfg: DeepSeekV3Config) -> torch.Tensor:
    """Attended heads [..., T, H * v_dim] of q / k [..., T, H, qk] and v
    [..., S, H, v_dim] under ``mask``."""
    flat = [t.reshape((-1,) + tuple(t.shape[-3:])) for t in (q, k, v)]
    out = A._group_scores_to_out(*flat, mask, cfg, 1)
    return out.reshape(q.shape[:-2] + (out.shape[-1],))


@obs.span("model.mla")
def mla_train(p, x: torch.Tensor, cfg: DeepSeekV3Config,
              positions: Optional[torch.Tensor] = None,
              causal: bool = True) -> torch.Tensor:
    """Full-sequence latent attention of x [B, T, d] (position-stacked:
    [M, B, T, d] with stacked leaves) -> [..., T, d]."""
    t = x.shape[-2]
    if positions is None:
        positions = torch.arange(t, dtype=torch.int64, device=x.device)
    q, k, v = _qkv(p, x, cfg, positions)
    if t < A.BLOCKED_ATTN_THRESHOLD:
        out = _heads(q, k, v, A.attn_mask(t, 0, causal, device=x.device),
                     cfg)
    else:
        if t % A.Q_CHUNK:
            raise ValueError(f"mla_train: sequence length {t} is not a "
                             f"multiple of Q_CHUNK={A.Q_CHUNK}")
        out = torch.cat([
            _heads(q[..., lo:lo + A.Q_CHUNK, :, :], k, v,
                   A.attn_mask(t, 0, causal, device=x.device,
                               rows=range(lo, lo + A.Q_CHUNK)), cfg)
            for lo in range(0, t, A.Q_CHUNK)], dim=-2)
    return linear(out, p["wo"])
