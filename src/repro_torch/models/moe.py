"""Mixture-of-experts FFN, the training block (reference: ``repro.models.moe``).

The reference shards experts over the ``model`` axis and dispatches
tokens to the expert-owning device with two ``all_to_all``s: bucket the
token copies by destination, exchange fixed-capacity buckets, group the
received copies by local expert, run the gated expert FFN, and return
along the same route -- one layer of the paper's butterfly, with the
same static capacities and counted drops.

Position-stacked inputs (x [M, B, T, d] with parameters [M, ...], as
``models.common`` describes) route, group, fill capacities and count
drops per position: position m's destinations are offset by m times its
group count and one flat stable group-by runs over all of them, which
gives every position the ranks it would get alone.  At tp > 1 every
(data row, model position) pair is such a position, P = M * tp of them:
model position m takes its ``ceil(n / tp)`` token slice of its data row
(the reference's ``token_shard``, zero-padded), routes it, buckets its
copies by owning model position into ``cap_dev`` slots, and the
dispatch is the model axis's ``all_to_all`` of ``[M, tp_src, tp_dst,
cap_dev, d]`` buffers (``core.transport.ModelAxis``); each position runs
its ``experts_local`` experts on what it received (its shard of the
expert leaves is a view), the results return by the same
``all_to_all``, and the tiled ``all_gather`` lays the slices end to end
again.  At tp = 1 the same code runs with the exchanges left out
(identities) and so does the bucketing by model position: a position's
bucket is then its route order, the first ``cap_dev`` copies kept.
The aux loss and the dropped fraction are each
position's own, [M, tp]; the train objective takes the mean of the aux
over the model positions (``models.transformer``).  The group-by, the
dispatch scatters and the combine gathers are plain torch ops, as the
reference's are plain ``jnp``.  The two gathers back from the expert
slots are ``index_select``s, whose backward is an ``index_add_`` (atomic
on the card): every index that repeats there (the overflow slot, the
clamped slots of dropped copies) only ever receives a zero gradient, and
every other index one value, so the sums are exact in any order.
(Advanced indexing's sort-based backward took 284 of a granite-moe
step's 1,039 device ms on an H100, ``tools/train_step_profile.py``.)

A DeepSeek-V3 configuration (``common.DeepSeekV3Config``, tp = 1) runs
the same dispatch.  It routes by :func:`router_sigmoid` and computes its
expert share: the router keeps its ``n_experts`` outputs and top-k (the
capacities are those over them), the layer holds experts
``[expert_first, expert_first + held)``, and copies to the others join
the empty slots' group, so they add nothing (on one card the
expert-parallel layer without its exchange).  Its aux loss is the
sequence-wise balance (:func:`seq_balance`).  Every MoE block's forward
is the span
``model.moe`` (:mod:`repro_torch.obs`), again in the backward's
recompute.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import obs

from .common import DeepSeekV3Config, ModelConfig, act_fn, linear


def router_topk(logits: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mask padded experts, softmax in float32, top-k, renormalise.

    ``logits`` [..., E_pad] float32 -> ``(probs [..., E_pad], wk [..., K],
    ek [..., K])``.  The top-k is a stable descending sort, so equal
    probabilities keep the lower expert first, as ``lax.top_k`` does."""
    e_pad = logits.shape[-1]
    real = torch.arange(e_pad, device=logits.device) < cfg.n_experts
    logits = torch.where(real, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    wk = order.values[..., :cfg.top_k]
    ek = order.indices[..., :cfg.top_k]
    wk = wk / torch.clamp(torch.sum(wk, dim=-1, keepdim=True), min=1e-9)
    return probs, wk, ek


def _group_by(dest: torch.Tensor, num_groups: int, cap: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slot assignment of 1-D ``dest``: entry i -> (dest_i, rank of i
    within dest_i), ``(slot, keep)`` with slot a flat index into
    [num_groups * cap] and overflow parked at num_groups * cap.  Stable:
    earlier entries win capacity.  A dest >= num_groups ranks from the
    last group's start (the reference's clamped gather)."""
    n = dest.shape[0]
    order = torch.sort(dest, stable=True).indices
    sorted_dest = dest[order]
    first = torch.searchsorted(
        sorted_dest, torch.arange(num_groups, device=dest.device,
                                  dtype=sorted_dest.dtype))
    pos_sorted = torch.arange(n, device=dest.device) \
        - first[torch.clamp(sorted_dest, max=num_groups - 1)]
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    keep = pos < cap
    slot = torch.where(keep, dest * cap + pos,
                       torch.full_like(pos, num_groups * cap))
    return slot, keep


def capacities(cfg: ModelConfig, n: int, tp: int,
               capacity_factor: float) -> Tuple[int, int]:
    """``(cap_dev, cap_e)`` for n tokens a position, as the reference
    computes them (Python floats cast with ``int``)."""
    el = cfg.experts_local(tp)
    cap_dev = int(max(8, -(-n * cfg.top_k // tp) * capacity_factor))
    cap_e = int(min(max(8, -(-tp * cap_dev // el) * 1.25), tp * cap_dev))
    return cap_dev, cap_e


def _fill(slot: torch.Tensor, keep: torch.Tensor, vals: torch.Tensor,
          rows: int) -> torch.Tensor:
    """``zeros([rows + 1, ...]).at[slot].set(where(keep, vals, 0))[:-1]``:
    kept entries have distinct slots, every other one writes zeros to the
    overflow row ``rows``."""
    mask = keep.reshape(keep.shape + (1,) * (vals.ndim - 1))
    buf = torch.zeros((rows + 1,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                      device=vals.device)
    return buf.index_put((slot,), torch.where(mask, vals,
                                              torch.zeros_like(vals)))[:-1]


def router_sigmoid(logits: torch.Tensor, bias: Optional[torch.Tensor],
                   cfg: DeepSeekV3Config
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """DeepSeek-V3's ``noaux_tc`` routing (one group): ``logits`` [...,
    E] float32 -> ``(scores [..., E], wk [..., K], ek [..., K])``.
    Scores are the sigmoid of the logits; the top k of score plus
    ``bias`` (the correction bias, selection only, no gradient) by a
    stable descending sort choose the experts; their weights are the
    chosen scores over their sum (``+ 1e-20``) times
    ``cfg.router_scale``."""
    scores = torch.sigmoid(logits)
    choice = scores.detach() if bias is None else scores.detach() + bias
    ek = torch.sort(choice, dim=-1, descending=True,
                    stable=True).indices[..., :cfg.top_k]
    wk = torch.gather(scores, -1, ek)
    wk = wk / (torch.sum(wk, dim=-1, keepdim=True) + 1e-20) \
        * cfg.router_scale
    return scores, wk, ek


def seq_balance(scores: torch.Tensor, cfg: DeepSeekV3Config
                ) -> torch.Tensor:
    """DeepSeek-V3's sequence-wise balance term (arXiv:2412.19437
    §2.1.2) without its alpha, each row's ``sum_i f_i P_i`` averaged over
    the rows: ``scores`` [..., B, T, E] -> [...].  ``f_i`` is E / (K T)
    times the tokens whose top k by raw score hold expert i, ``P_i`` the
    row's mean of the scores normalised over the experts."""
    e, k = scores.shape[-1], cfg.top_k
    t = scores.shape[-2]
    top = torch.sort(scores.detach(), dim=-1, descending=True,
                     stable=True).indices[..., :k]
    lead = scores.shape[:-2]
    hits = torch.zeros(lead + (e,), dtype=torch.float32,
                       device=scores.device).scatter_add_(
        -1, top.reshape(lead + (t * k,)),
        torch.ones(lead + (t * k,), dtype=torch.float32,
                   device=scores.device))
    f = hits * (e / (k * t))
    pn = torch.mean(scores / torch.sum(scores, dim=-1, keepdim=True), dim=-2)
    return torch.mean(torch.sum(f * pn, dim=-1), dim=-1)


@obs.span("model.moe")
def moe_ffn(p: Dict, x: torch.Tensor, cfg: ModelConfig, tp: int = 1,
            capacity_factor: float = 2.0, model=None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B, T, d] -> ``(y [B, T, d], aux_loss, dropped_fraction)``.

    Position-stacked (x [M, B, T, d], parameters [M, ...]): y [M, B, T,
    d], aux and dropped [M], each position's own; at tp > 1 (``model``
    the model axis, :class:`repro_torch.core.transport.ModelAxis`) aux
    and dropped are [M, tp], each model position's on its token slice.
    The aux loss is the switch-style load balance ``sum(mean probs *
    top-1 share) * E`` (a DeepSeek-V3 configuration: :func:`seq_balance`);
    the dropped fraction counts the copies that found no dispatch slot."""
    stacked = p["router"].ndim == 3
    xs = x if stacked else x.unsqueeze(0)
    m, d = xs.shape[0], xs.shape[-1]
    n_full = math.prod(xs.shape[1:-1])
    el, e_pad, k_top = cfg.experts_local(tp), cfg.n_experts_padded(tp), \
        cfg.top_k
    deepseek = isinstance(cfg, DeepSeekV3Config)
    # the experts a position computes: its el, or a DeepSeek-V3 share
    first, held = (cfg.expert_first, cfg.held) if deepseek else (0, el)
    router = p["router"] if stacked else p["router"].unsqueeze(0)
    w1, w3, w2 = (p[k] if stacked else p[k].unsqueeze(0)
                  for k in ("w1", "w3", "w2"))
    dev = x.device
    if tp > 1 and (model is None or deepseek):
        raise ValueError("moe_ffn at tp > 1 exchanges over the mesh's model "
                         "axis: pass model= (train.step.mesh_ctx gives it); "
                         "a DeepSeek-V3 configuration runs at tp = 1")
    # model position j of data row i is position i * tp + j, P in all,
    # holding its ceil(n / tp) token slice (the whole row at tp = 1)
    n = -(-n_full // tp)
    npos = m * tp
    xp = xs.reshape(m, n_full, d)
    if n * tp != n_full:
        xp = F.pad(xp, (0, 0, 0, n * tp - n_full))
    xf = xp.reshape(npos, n, d)

    # ---- route (per token, each position's aux on its slice) --------------
    logits = linear(xp.to(torch.float32), router).reshape(npos, n, -1)
    if deepseek:
        scores, wk, ek = router_sigmoid(logits, p.get("bias"), cfg)
        aux = seq_balance(scores.reshape((npos,) + tuple(xs.shape[1:-1])
                                         + (cfg.n_experts,)), cfg)
    else:
        probs, wk, ek = router_topk(logits, cfg)
        me = torch.mean(probs, dim=1)                           # [P, E]
        top1 = F.one_hot(ek[..., 0], e_pad).to(torch.float32)
        ce = torch.mean(top1, dim=1)
        aux = torch.sum(me * ce, dim=-1) * cfg.n_experts        # [P]

    # ---- dispatch: bucket by owning model position ------------------------
    cap_dev, cap_e = capacities(cfg, n, tp, capacity_factor)
    flat_e = ek.reshape(npos, n * k_top)
    xk = torch.repeat_interleave(xf, k_top, dim=1).reshape(npos * n * k_top, d)
    if tp > 1:
        off = torch.arange(npos, device=dev)[:, None]
        slot, keep = _group_by((flat_e // el + off * tp).reshape(-1),
                               npos * tp, cap_dev)
        rows = tp * cap_dev                    # received slots a position
        rx = _fill(slot, keep, xk, npos * rows)          # [P * tp * cap, d]
        re = torch.full((npos * rows + 1,), -1, dtype=torch.int64, device=dev)
        re = re.index_put((slot,), torch.where(
            keep, (flat_e % el).reshape(-1), torch.full_like(slot, -1)))[:-1]
        # [M, tp_src, tp_dst, cap] -> received [M, tp_dst, tp_src]
        rx = model.all_to_all(rx.reshape(m, tp, tp, cap_dev, d)).reshape(
            npos * rows, d)
        re = model.all_to_all(re.reshape(m, tp, tp, cap_dev)).reshape(-1)
    else:
        # one position owns every expert: its bucket is the route order,
        # the first cap_dev copies kept; copies to experts outside the
        # held share get -1, as empty slots do
        rows = n * k_top
        keep = (torch.arange(rows, device=dev) < cap_dev).repeat(npos)
        local = flat_e.reshape(-1) - first
        rx, re = xk, torch.where(keep & (local >= 0) & (local < held), local,
                                 torch.full_like(local, -1))

    # ---- local expert compute: group received copies by local expert ------
    # each position's empty slots go to a group of their own (held), after
    # its experts, so they never take an expert's capacity
    g = held + 1
    rpos = torch.arange(npos * rows, device=dev) // rows
    edest = torch.where(re >= 0, re, held) + rpos * g
    eslot, ekeep = _group_by(edest, npos * g, cap_e)
    live = ekeep & (re >= 0)
    ex = _fill(eslot, live, rx, npos * g * cap_e).reshape(npos, g, cap_e, d)
    # position j's experts are its shard of the held [M, tp * held, ...]
    # leaves
    ex = ex[:, :held].reshape(m, tp * held, cap_e, d)
    h = act_fn(torch.matmul(ex, w1), cfg.act) * torch.matmul(ex, w3)
    ey = torch.matmul(h, w2)                              # [M, E, cap, d]
    # back to received-slot order; dropped and empty slots read their
    # position's last expert slot and are masked
    local = eslot - rpos * (g * cap_e)
    safe_es = torch.clamp(local, max=held * cap_e - 1) + rpos * (held * cap_e)
    y_slots = torch.index_select(ey.reshape(npos * held * cap_e, d), 0,
                                 safe_es) * live[:, None].to(ey.dtype)

    # ---- combine ----------------------------------------------------------
    if tp > 1:      # the return route: the same all_to_all
        y_slots = model.all_to_all(y_slots.reshape(m, tp, tp, cap_dev, d)) \
            .reshape(npos * rows, d)
        spos = torch.arange(npos * n * k_top, device=dev) // (n * k_top)
        safe_slot = torch.clamp(slot - spos * rows, max=rows - 1) \
            + spos * rows
        y_slots = torch.index_select(y_slots, 0, safe_slot) \
            * keep[:, None].to(y_slots.dtype)
    y = torch.sum(y_slots.reshape(npos, n, k_top, d)
                  * wk[..., None].to(x.dtype), dim=2)           # [P, n, d]
    dropped = 1.0 - torch.mean(keep.reshape(npos, -1).to(torch.float32),
                               dim=1)
    if tp > 1:      # the slices end to end again: [M, tp * n, d]
        y = model.all_gather(y.reshape(m, tp, n, d))[:, :n_full]
        aux, dropped = aux.reshape(m, tp), dropped.reshape(m, tp)
    y = y.reshape(xs.shape)
    if not stacked:
        return y[0], aux[0], dropped[0]
    return y, aux, dropped
