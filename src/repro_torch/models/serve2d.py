"""2D weight-stationary decode for the MoE and Mamba blocks (reference: ``repro.models.serve2d``).

The principle of ``attention.attn_decode_2d``: decode reads every weight
once a token, so the held-once FSDP leaves are used in place -- each data
position multiplies its row block of a leaf (a view) and the partial
products are summed over the data axes by the stacked transport --
instead of each position taking the whole leaf.

MoE: the float32 router logits are such a summed product, the same on
every position, so every position routes its tokens to the same top-k.
The dispatch carries each position's d / M column slice of its tokens
over the model axis (``ModelAxis.all_to_all``; at tp = 1 the exchanges
are identities, left out), each (data, model) position multiplies what
it received by its experts' row blocks (views of the held leaves, never
a copy: an arctic layer holds 26.8 GB of bf16 experts), the hidden
activations are summed over the data axes, and the outputs return by
the same route; the model axis's tiled all_gather and the transport's
lay the token slices and the column slices end to end again.  The
decode capacities are the reference's (``moe.capacities``); the dropped
fraction of each position is returned beside the output.

Mamba: the five input projections are summed products, the state
update is ``ssm.mamba_cell`` on each position's rows (or the replicated
batch), and the out projection is a column-block product gathered over
the data axes.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from . import moe as MOE
from . import ssm as SSM
from .attention import (_batch_replicate, _col_matmul_2d, _full_rows,
                        _own_block, _own_rows, _row_matmul_2d)
from .common import ModelConfig, act_fn


def moe_ffn_2d(p: Dict, x: torch.Tensor, cfg: ModelConfig, tp: int,
               transport, axes=None, model=None,
               batch_replicated: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE block of one decode token with held-once FSDP expert leaves
    (router [d, E_pad] float32, w1 / w3 [E_pad, d, eff], w2 [E_pad, eff,
    d]) used in place.  x [M, b_loc, 1, d] (or [B, 1, d] replicated) ->
    ``(y, dropped)``: y as x, ``dropped`` [M, tp] each position's
    fraction of token copies that found no dispatch slot."""
    if tp > 1 and model is None:
        raise ValueError("moe_ffn_2d at tp > 1 exchanges over the mesh's "
                         "model axis: pass model=")
    m = transport.num_nodes
    b_loc = x.shape[-3]
    xf = _full_rows(x, transport, batch_replicated)         # [M, N, d]
    n_full, d = xf.shape[1], xf.shape[2]
    dl = d // m
    el, k_top, dev = cfg.experts_local(tp), cfg.top_k, x.device

    # ---- route (summed logits: the same top-k on every position) ----------
    _, wk, ek = MOE.router_topk(_col_matmul_2d(
        xf.to(torch.float32), p["router"].to(torch.float32), transport,
        axes), cfg)                                         # [M, N, K]

    # ---- token slices over the model axis, d / M columns each ------------
    n = -(-n_full // tp)
    pad = n * tp - n_full
    npos = m * tp
    xs = F.pad(_own_block(xf, m, 2), (0, 0, 0, pad)).reshape(npos, n, dl)
    es = F.pad(ek, (0, 0, 0, pad)).reshape(npos, n * k_top)
    ws = F.pad(wk, (0, 0, 0, pad)).reshape(npos, n, k_top)
    cap, cap_e = MOE.capacities(cfg, n, tp, cfg.moe_capacity)
    off = torch.arange(npos, device=dev)[:, None]
    slot, keep = MOE._group_by((es // el + off * tp).reshape(-1),
                               npos * tp, cap)
    xk = torch.repeat_interleave(xs, k_top, dim=1).reshape(-1, dl)
    rows_dev = npos * tp * cap
    rx = MOE._fill(slot, keep, xk, rows_dev)                # [P*tp*cap, dl]
    re = torch.full((rows_dev + 1,), -1, dtype=torch.int64, device=dev)
    re = re.index_put((slot,), torch.where(
        keep, (es % el).reshape(-1), torch.full_like(slot, -1)))[:-1]
    if tp > 1:
        rx = model.all_to_all(rx.reshape(m, tp, tp, cap, dl)).reshape(
            rows_dev, dl)
        re = model.all_to_all(re.reshape(m, tp, tp, cap)).reshape(-1)

    # ---- expert products on d / M slices, summed over the data axes -------
    g = el + 1           # a position's empty slots group after its experts
    rpos = torch.arange(rows_dev, device=dev) // (tp * cap)
    eslot, ekeep = MOE._group_by(torch.where(re >= 0, re, el) + rpos * g,
                                 npos * g, cap_e)
    live = ekeep & (re >= 0)
    ex = MOE._fill(eslot, live, rx, npos * g * cap_e).reshape(
        m, tp, g, cap_e, dl)[:, :, :el]
    eff = p["w1"].shape[-1]
    h = ex.new_empty((m, tp, el, cap_e, eff))
    h3 = torch.empty_like(h)
    for di in range(m):
        for j in range(tp):
            rows = (slice(j * el, (j + 1) * el), slice(di * dl, (di + 1) * dl))
            torch.bmm(ex[di, j], p["w1"][rows], out=h[di, j])
            torch.bmm(ex[di, j], p["w3"][rows], out=h3[di, j])
    h = act_fn(transport.psum(h, axes), cfg.act) * transport.psum(h3, axes)
    ey = ex.new_empty((m, tp, el, cap_e, dl))
    for di in range(m):
        for j in range(tp):
            torch.bmm(h[di, j], p["w2"][j * el:(j + 1) * el, :,
                                        di * dl:(di + 1) * dl], out=ey[di, j])
    local = eslot - rpos * (g * cap_e)
    safe_es = torch.clamp(local, max=el * cap_e - 1) + rpos * (el * cap_e)
    y_slots = torch.index_select(ey.reshape(-1, dl), 0, safe_es) \
        * live[:, None].to(ey.dtype)
    if tp > 1:
        y_slots = model.all_to_all(y_slots.reshape(m, tp, tp, cap, dl)) \
            .reshape(rows_dev, dl)

    # ---- combine, then the slices end to end ------------------------------
    spos = torch.arange(npos * n * k_top, device=dev) // (n * k_top)
    safe_slot = torch.clamp(slot - spos * (tp * cap),
                            max=tp * cap - 1) + spos * (tp * cap)
    per_assign = torch.index_select(y_slots, 0, safe_slot) \
        * keep[:, None].to(y_slots.dtype)
    y = torch.sum(per_assign.reshape(npos, n, k_top, dl)
                  * ws[..., None].to(x.dtype), dim=2)       # [P, n, dl]
    dropped = 1.0 - torch.mean(keep.reshape(npos, -1).to(torch.float32),
                               dim=1)
    y = model.all_gather(y.reshape(m, tp, n, dl)) if tp > 1 \
        else y.reshape(m, n, dl)
    y = y[:, :n_full]
    (y,) = transport.all_gather(0, y.transpose(1, 2).contiguous())
    y = y.transpose(1, 2)                                   # [M, N, d]
    return (_own_rows(y, b_loc, batch_replicated).unsqueeze(-2),
            dropped.reshape(m, tp))


def mamba_decode_2d(p: Dict, x: torch.Tensor, state: Dict, cfg: ModelConfig,
                    tp: int, transport, axes=None,
                    batch_replicated: bool = False
                    ) -> Tuple[torch.Tensor, Dict]:
    """The Mamba decode with held-once FSDP leaves (in_x / in_z / w_dt /
    w_B / w_C [d, ...], out [dil, d]) used in place; conv, A_log and D
    are used as given.  x [M, b_loc, 1, d] with the state's rows [M,
    b_loc, ...] (or [B, 1, d] and [B, ...] replicated) -> ``(out as x,
    new state)``."""
    b_loc = x.shape[-3]
    xf = _full_rows(x, transport, batch_replicated)
    xi, z, dt, bm, cm = (
        _own_rows(_col_matmul_2d(xf, p[k], transport, axes), b_loc,
                  batch_replicated)
        for k in ("in_x", "in_z", "w_dt", "w_B", "w_C"))
    y, st = SSM.mamba_cell(p, xi, z, dt, bm, cm, state, x.dtype)
    yf = y.unsqueeze(0).expand((transport.num_nodes,) + tuple(y.shape)) \
        if batch_replicated else _batch_replicate(y, transport)
    out = _row_matmul_2d(yf, p["out"], transport)
    return _own_rows(out, b_loc, batch_replicated).unsqueeze(-2), st
