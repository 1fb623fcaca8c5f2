"""SSM blocks: Mamba (jamba) and xLSTM's mLSTM / sLSTM, training and serving (reference: ``repro.models.ssm``).

* Mamba's selective scan h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t runs
  in chunks of ``SCAN_CHUNK`` steps, as the reference's does: within a
  chunk a parallel prefix over time, across chunks a carried state.  The
  reference's prefix is ``lax.associative_scan``; torch has none, so the
  port's is a log-step (Hillis-Steele) scan of the same combine.  The
  products come in another order, so the two agree to rounding, not bits.
* mLSTM is the chunkwise linear-attention form: quadratic within chunks
  of ``CHUNK`` tokens, a [B, H, dk, dv] state carried across chunks.  The
  causal gate mask is ``-inf`` through ``torch.where`` (the reference's
  ``jnp.where``), so the masked entries take no gradient.
* sLSTM is a true recurrence (R h_{t-1} inside the gates): a Python loop
  over the T steps, one small matmul and a dozen elementwise launches a
  step.  Its input projection is one matmul over all steps, taken out of
  the loop.

Every block takes position-stacked parameters ([M, ...], activations
[M, B, T, d]) as ``models.common`` describes.  At tp > 1 the parameters
are the global leaves, held whole, so each block computes the tp = 1
function in one program: mamba's channels and the reference's ``psum``
after ``out`` are one product over every channel, and sLSTM is
replicated.  mLSTM computes the tp = 1 function too; the reference's
does not (it splits ``wv``'s columns contiguously while its heads take
``dk / tp`` each; ROADMAP Queue 3 lists it).

Serving: ``return_state=True`` on a ``*_train`` hands the prompt's final
state to the decode cache, and ``*_decode`` advances it one token; the
state leaves are batch-major, as the reference's cache holds them --
mamba ``{"h": [..., dil, n] float32, "conv": [..., K - 1, dil]}`` (the
last K - 1 pre-conv inputs, in the model dtype), mLSTM ``{"S": [..., H,
dk, dv], "N": [..., H, dk], "m": [..., H]}`` float32 (the prefill's
``m`` is zeros, the reference's), sLSTM the tuple ``(c, n, h, m)`` of
[..., H, dh] float32 -- where ``...`` is the activations' leading dims
([B] or [M, B]).  ``*_init_state`` gives the zero state.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .common import ModelConfig, linear, vec

CHUNK = 128
SCAN_CHUNK = 256


def _mat(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A matrix parameter [..., r, c] shaped to broadcast against
    activations ``x`` [(M,) ..., r, c]: position-stacked [M, r, c] gains
    singleton dims after M."""
    if w.ndim == 2:
        return w
    return w.reshape((w.shape[0],) + (1,) * (x.ndim - 3) + w.shape[1:])


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

def mamba_inner(cfg: ModelConfig, tp: int) -> int:
    """Inner channels per tensor-parallel shard."""
    return max(8, 2 * cfg.d_model // tp)


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv by shifted adds; x [..., T, C], w [K, C]
    (position-stacked [M, K, C] with x [M, ..., T, C])."""
    k = w.shape[-2]
    tap = (lambda i: w[i]) if w.ndim == 2 else (lambda i: vec(w[:, i], x))
    out = x * tap(k - 1)
    t = x.shape[-2]
    for i in range(1, k):
        shifted = F.pad(x, (0, 0, i, 0))[..., :t, :]
        out = out + shifted * tap(k - 1 - i)
    return out


def _scan_combine(l, r):
    """The scan's combine: (a_l a_r, b_l a_r + b_r), l before r."""
    return l[0] * r[0], l[1] * r[0] + r[1]


def _prefix_scan(a: torch.Tensor, b: torch.Tensor, dim: int):
    """Inclusive prefix of ``_scan_combine`` over ``dim`` (Hillis-Steele:
    ceil(log2 T) steps, each combining entry t with entry t - s)."""
    t = a.shape[dim]
    s = 1
    while s < t:
        lo_a, lo_b = a.narrow(dim, 0, t - s), b.narrow(dim, 0, t - s)
        hi_a, hi_b = a.narrow(dim, s, t - s), b.narrow(dim, s, t - s)
        na, nb = _scan_combine((lo_a, lo_b), (hi_a, hi_b))
        a = torch.cat([a.narrow(dim, 0, s), na], dim)
        b = torch.cat([b.narrow(dim, 0, s), nb], dim)
        s *= 2
    return a, b


def _chunked_selective_scan(dt: torch.Tensor, xi: torch.Tensor,
                            bm: torch.Tensor, cm: torch.Tensor,
                            a_mat: torch.Tensor):
    """y_t = C_t . h_t with h_t = exp(dt_t A) h_{t-1} + (dt_t xi_t) B_t.

    dt, xi [..., T, dil] float32; bm, cm [..., T, n]; ``a_mat`` [dil, n]
    or broadcastable to [..., dil, n] per leading index (position-stacked:
    [M, 1, dil, n]).  The [..., ck, dil, n] gates exist one chunk of
    ``SCAN_CHUNK`` steps at a time.  Returns (y [..., T, dil], final
    state [..., dil, n])."""
    t = dt.shape[-2]
    ck = min(SCAN_CHUNK, t)
    assert t % ck == 0, f"seq {t} % chunk {ck}"
    lead = dt.shape[:-2]
    a_mat = a_mat.unsqueeze(-3)                       # [..., 1, dil, n]
    carry = torch.zeros(lead + (dt.shape[-1], bm.shape[-1]),
                        dtype=torch.float32, device=dt.device)
    ys = []
    for c0 in range(0, t, ck):
        sl = slice(c0, c0 + ck)
        dt_c, xi_c = dt[..., sl, :], xi[..., sl, :]
        a_c = torch.exp(dt_c[..., None] * a_mat)      # [..., ck, dil, n]
        bt_c = (dt_c * xi_c)[..., None] * bm[..., sl, None, :]
        acum, hin = _prefix_scan(a_c, bt_c, dim=-3)
        h = hin + acum * carry.unsqueeze(-3)
        ys.append(torch.einsum("...kcn,...kn->...kc", h, cm[..., sl, :]))
        carry = h[..., -1, :, :]
    return torch.cat(ys, dim=-2), carry


def mamba_train(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                tp: int = 1, return_state: bool = False):
    """Mamba block of x [B, T, d] (position-stacked [M, B, T, d]); with
    ``return_state``, ``(out, state)``: the scan's final ``h`` and the
    last K - 1 pre-conv inputs as ``conv`` (the prefill's cache)."""
    xi_pre = linear(x, p["in_x"])                     # [..., T, dil]
    z = linear(x, p["in_z"])
    xi = F.silu(_causal_conv(xi_pre, p["conv"]))
    dt = F.softplus(linear(x, p["w_dt"]).to(torch.float32))
    bm = linear(x, p["w_B"]).to(torch.float32)
    cm = linear(x, p["w_C"]).to(torch.float32)
    a_mat = _mat(-torch.exp(p["A_log"]), x)
    ys, h_fin = _chunked_selective_scan(dt, xi.to(torch.float32), bm, cm,
                                        a_mat)
    y = ys.to(x.dtype) + xi * vec(p["D"], xi).to(x.dtype)
    y = y * F.silu(z)
    out = linear(y, p["out"])
    if not return_state:
        return out
    k = p["conv"].shape[-2]
    return out, {"h": h_fin, "conv": xi_pre[..., x.shape[-2] - (k - 1):, :]}


def mamba_decode(p: Dict, x: torch.Tensor, state: Dict, cfg: ModelConfig,
                 tp: int = 1) -> Tuple[torch.Tensor, Dict]:
    """One token x [..., 1, d] against ``state`` {"h": [..., dil, n],
    "conv": [..., K - 1, dil]}: ``(out [..., 1, d], new state)``.  The
    conv tap products are summed in float32 (the reference's einsum)."""
    xi = linear(x, p["in_x"])[..., 0, :]              # [..., dil]
    z = linear(x, p["in_z"])[..., 0, :]
    hist = torch.cat([state["conv"], xi.unsqueeze(-2).to(
        state["conv"].dtype)], dim=-2)                # [..., K, dil]
    w = _mat(p["conv"], hist)
    xi = F.silu(torch.sum(hist.to(torch.float32) * w.to(torch.float32),
                          dim=-2).to(x.dtype))
    dt = F.softplus(linear(x, p["w_dt"]).to(torch.float32))[..., 0, :]
    bm = linear(x, p["w_B"]).to(torch.float32)[..., 0, :]
    cm = linear(x, p["w_C"]).to(torch.float32)[..., 0, :]
    a_mat = _mat(-torch.exp(p["A_log"]), hist)        # [(M, 1,) dil, n]
    h = state["h"] * torch.exp(dt[..., None] * a_mat) \
        + (dt * xi.to(torch.float32))[..., None] * bm[..., None, :]
    y = torch.einsum("...cn,...n->...c", h, cm).to(x.dtype) \
        + xi * vec(p["D"], xi).to(x.dtype)
    y = y * F.silu(z)
    return linear(y.unsqueeze(-2), p["out"]), {"h": h, "conv": hist[..., 1:, :]}


def mamba_init_state(lead: Tuple[int, ...], cfg: ModelConfig, tp: int,
                     dtype, device=None) -> Dict:
    """The zero mamba state for leading dims ``lead`` ([B] or [M, B]) at
    the global width (``mamba_inner(cfg, tp) * tp`` channels)."""
    dil = mamba_inner(cfg, tp) * tp
    return {"h": torch.zeros(tuple(lead) + (dil, cfg.ssm_state),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros(tuple(lead) + (cfg.ssm_conv - 1, dil),
                                dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# mLSTM (chunkwise parallel linear attention with exponential gating)
# ---------------------------------------------------------------------------

def mlstm_dims(cfg: ModelConfig, tp: int) -> Tuple[int, int, int]:
    """(heads, key dim, value dim per shard)."""
    h = cfg.n_heads
    dk = cfg.d_model // h
    return h, dk, max(1, dk // tp)


def mlstm_train(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                tp: int = 1, return_state: bool = False):
    """mLSTM block of x [B, T, d] (position-stacked [M, B, T, d]): the tp
    = 1 function at any ``tp``; with ``return_state``, ``(out, state)``,
    the state after the last chunk with ``m`` zeros (the reference's)."""
    lead, t = x.shape[:-2], x.shape[-2]
    h, dk, dvl = mlstm_dims(cfg, 1)
    c = min(CHUNK, t)
    nc = t // c
    assert t % c == 0, f"seq {t} not divisible by chunk {c}"
    bsz = math.prod(lead)
    f32 = torch.float32
    x32 = x.to(f32)
    q = linear(x, p["wq"]).reshape(bsz, nc, c, h, dk)
    k = linear(x, p["wk"]).reshape(bsz, nc, c, h, dk) \
        / torch.sqrt(torch.tensor(float(dk), dtype=f32)).to(x.dtype)
    v = linear(x, p["wv"]).reshape(bsz, nc, c, h, dvl)
    lf = F.logsigmoid(linear(x32, p["wf"])).reshape(bsz, nc, c, h)
    li = linear(x32, p["wi"]).reshape(bsz, nc, c, h)
    clf = torch.cumsum(lf, dim=2)                             # within chunk
    total = clf[:, :, -1, :]                                  # [b, nc, h]

    # intra-chunk: D_ij = exp(clf_i - clf_j + li_j), j <= i (stabilised)
    gate = clf[:, :, :, None, :] - clf[:, :, None, :, :] \
        + li[:, :, None, :, :]                                # [b,nc,i,j,h]
    ti = torch.arange(c, device=x.device)
    causal = (ti[:, None] >= ti[None, :])[None, None, :, :, None]
    gate = torch.where(causal, gate, torch.full_like(gate, -math.inf))
    gmax = torch.amax(gate, dim=3)
    mstab = torch.maximum(gmax, torch.zeros_like(gmax))      # [b,nc,i,h]
    dmat = torch.exp(gate - mstab[:, :, :, None, :])
    qf, kf, vf = q.to(f32), k.to(f32), v.to(f32)
    scores = torch.einsum("bnihd,bnjhd->bnijh", qf, kf) * dmat
    intra = torch.einsum("bnijh,bnjhv->bnihv", scores, vf)
    n_intra = torch.einsum("bnijh,bnjhd->bnihd", scores, kf)

    # inter-chunk state S [b, h, dk, dvl] and normaliser N [b, h, dk]
    wgt = torch.exp(total[:, :, None, :] - clf + li)
    kv = torch.einsum("bnjhd,bnjhv,bnjh->bnhdv", kf, vf, wgt)
    ksum = torch.einsum("bnjhd,bnjh->bnhd", kf, wgt)
    s_st = torch.zeros((bsz, h, dk, dvl), dtype=f32, device=x.device)
    n_st = torch.zeros((bsz, h, dk), dtype=f32, device=x.device)
    s_hist, n_hist = [], []
    for j in range(nc):
        s_hist.append(s_st)
        n_hist.append(n_st)
        decay = torch.exp(total[:, j])
        s_st = s_st * decay[..., None, None] + kv[:, j]
        n_st = n_st * decay[..., None] + ksum[:, j]
    s_hist = torch.stack(s_hist, 1)                           # [b,nc,h,dk,dvl]
    n_hist = torch.stack(n_hist, 1)

    qs = qf * torch.exp(clf - mstab)[..., None]
    inter = torch.einsum("bnihd,bnhdv->bnihv", qs, s_hist)
    n_inter = torch.einsum("bnihd,bnhd->bnihd", qs, n_hist)

    num = intra + inter                                       # [b,nc,c,h,dvl]
    nq = torch.sum((n_intra + n_inter) * qf, dim=-1)          # [b,nc,c,h]
    denom = torch.maximum(torch.abs(nq), torch.exp(-mstab))[..., None]
    y = (num / denom).reshape(lead + (t, h * dvl)).to(x.dtype)
    out = linear(y, p["out"])
    if not return_state:
        return out
    return out, {"S": s_st.reshape(lead + s_st.shape[1:]),
                 "N": n_st.reshape(lead + n_st.shape[1:]),
                 "m": torch.zeros(lead + (h,), dtype=f32, device=x.device)}


def mlstm_decode(p: Dict, x: torch.Tensor, state: Dict, cfg: ModelConfig,
                 tp: int = 1) -> Tuple[torch.Tensor, Dict]:
    """One token x [..., 1, d] against ``state`` {"S", "N", "m"}: the
    exponential-gated recurrent step, ``(out [..., 1, d], new state)``;
    the tp = 1 function at any ``tp``."""
    lead = x.shape[:-2]
    h, dk, dv = mlstm_dims(cfg, 1)
    f32 = torch.float32
    q = linear(x, p["wq"])[..., 0, :].reshape(lead + (h, dk)).to(f32)
    k = (linear(x, p["wk"])[..., 0, :].reshape(lead + (h, dk))
         / torch.sqrt(torch.tensor(float(dk), dtype=f32)).to(x.dtype)
         ).to(f32)
    v = linear(x, p["wv"])[..., 0, :].reshape(lead + (h, dv)).to(f32)
    x32 = x.to(f32)
    lf = F.logsigmoid(linear(x32, p["wf"])[..., 0, :])       # [..., H]
    li = linear(x32, p["wi"])[..., 0, :]
    m_new = torch.maximum(state["m"] + lf, li)
    sc_old = torch.exp(state["m"] + lf - m_new)
    sc_in = torch.exp(li - m_new)
    s_new = state["S"] * sc_old[..., None, None] \
        + torch.einsum("...hd,...hv->...hdv", k, v) * sc_in[..., None, None]
    n_new = state["N"] * sc_old[..., None] + k * sc_in[..., None]
    num = torch.einsum("...hd,...hdv->...hv", q, s_new)
    nq = torch.sum(n_new * q, dim=-1)
    denom = torch.maximum(torch.abs(nq), torch.exp(-m_new))[..., None]
    y = (num / denom).reshape(lead + (h * dv,)).to(x.dtype)
    return (linear(y.unsqueeze(-2), p["out"]),
            {"S": s_new, "N": n_new, "m": m_new})


def mlstm_init_state(lead: Tuple[int, ...], cfg: ModelConfig, tp: int = 1,
                     device=None) -> Dict:
    """The zero mLSTM state for leading dims ``lead`` (the tp = 1 dims at
    any tp: the reference's global [H, dk, dvl * tp])."""
    h, dk, dv = mlstm_dims(cfg, 1)
    z = dict(dtype=torch.float32, device=device)
    lead = tuple(lead)
    return {"S": torch.zeros(lead + (h, dk, dv), **z),
            "N": torch.zeros(lead + (h, dk), **z),
            "m": torch.zeros(lead + (h,), **z)}


# ---------------------------------------------------------------------------
# sLSTM (sequential)
# ---------------------------------------------------------------------------

def _slstm_cell(zx_t: torch.Tensor, wr: torch.Tensor, state, dtype):
    """One step, head-major.  ``zx_t`` [P, H, b, 4 dh] float32 (the input
    projection of this step plus the bias), ``wr`` [P * H, dh, 4 dh]
    contiguous; state (c, n, h, m) each [P, H, b, dh] float32."""
    c, n, hprev, m = state
    pp, h_heads, b, dh = hprev.shape
    zr = torch.bmm(hprev.to(dtype).reshape(pp * h_heads, b, dh), wr)
    z = zx_t + zr.to(torch.float32).reshape(pp, h_heads, b, 4 * dh)
    zi, zf, zz, zo = torch.split(z, dh, dim=-1)
    fm = zf + m
    m_new = torch.maximum(fm, zi)                           # stabiliser
    i = torch.exp(zi - m_new)
    f = torch.exp(fm - m_new)
    c = f * c + i * torch.tanh(zz)
    n = f * n + i
    o = torch.sigmoid(zo)
    hnew = o * c / torch.clamp(torch.abs(n), min=1.0)
    return (c, n, hnew, m_new), hnew


def _slstm_inputs(p: Dict, x: torch.Tensor, cfg: ModelConfig):
    """``(stacked, xs, zx [T, P, H, b, 4 dh], wr [P * H, dh, 4 dh])``:
    the input projection of every step plus the bias, head-major, and one
    copy of the (broadcast) recurrent weights a call."""
    stacked = p["wr"].ndim == 4
    xs = x if stacked else x.unsqueeze(0)
    pp, t, d = xs.shape[0], xs.shape[-2], xs.shape[-1]
    h_heads = cfg.n_heads
    dh = d // h_heads
    xb = xs.reshape(pp, -1, t, d)
    b = xb.shape[1]
    wx = p["wx"] if stacked else p["wx"].unsqueeze(0)
    wr = (p["wr"] if stacked else p["wr"].unsqueeze(0)).contiguous() \
        .reshape(pp * h_heads, dh, 4 * dh)
    bias = (p["bias"] if stacked else p["bias"].unsqueeze(0)).reshape(
        pp, 1, 1, h_heads, 4 * dh)
    zx = linear(xb, wx).to(torch.float32).reshape(pp, b, t, h_heads, 4 * dh)
    zx = (zx + bias).permute(2, 0, 3, 1, 4).contiguous()    # [T,P,H,b,4dh]
    return stacked, xs, zx, wr


def _slstm_out(p: Dict, hs: torch.Tensor, xs: torch.Tensor, stacked: bool,
               dtype) -> torch.Tensor:
    """The output projection of the steps' h [P, H, b, T, dh]."""
    y = hs.permute(0, 2, 3, 1, 4).reshape(xs.shape).to(dtype)
    out = linear(y, p["out"] if stacked else p["out"].unsqueeze(0))
    return out if stacked else out[0]


def _state_to_heads(state, pp: int):
    """Batch-major (c, n, h, m), each [..., H, dh], as [P, H, b, dh]."""
    return tuple(s.reshape((pp, -1) + tuple(s.shape[-2:])).transpose(1, 2)
                 for s in state)


def _state_from_heads(state, lead):
    """[P, H, b, dh] states back to batch-major [*lead, H, dh]."""
    return tuple(s.transpose(1, 2).reshape(tuple(lead) + tuple(s.shape[1:2])
                                           + tuple(s.shape[-1:]))
                 for s in state)


def slstm_train(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                tp: int = 1, return_state: bool = False):
    """sLSTM block of x [B, T, d] (position-stacked [M, B, T, d]): a loop
    over the T steps, the state held head-major ([P, H, b, dh]) so a step
    needs no transposes.  The bias joins the input projection before the
    loop (the reference adds it after the recurrent term).  With
    ``return_state``, ``(out, (c, n, h, m))`` after the last step."""
    stacked, xs, zx, wr = _slstm_inputs(p, x, cfg)
    pp, b = zx.shape[1], zx.shape[3]
    zeros = torch.zeros((pp, cfg.n_heads, b, zx.shape[-1] // 4),
                        dtype=torch.float32, device=x.device)
    state = (zeros, zeros, zeros, zeros)
    hs = []
    for step in range(zx.shape[0]):
        state, hnew = _slstm_cell(zx[step], wr, state, x.dtype)
        hs.append(hnew)
    out = _slstm_out(p, torch.stack(hs, 3), xs, stacked, x.dtype)
    if not return_state:
        return out
    return out, _state_from_heads(state, x.shape[:-2])


def slstm_decode(p: Dict, x: torch.Tensor, state, cfg: ModelConfig,
                 tp: int = 1):
    """One token x [..., 1, d] against ``state`` (c, n, h, m), each [...,
    H, dh]: one cell step, ``(out [..., 1, d], new state)``."""
    stacked, xs, zx, wr = _slstm_inputs(p, x, cfg)
    new, hnew = _slstm_cell(zx[0], wr, _state_to_heads(state, zx.shape[1]),
                            x.dtype)
    return (_slstm_out(p, hnew.unsqueeze(3), xs, stacked, x.dtype),
            _state_from_heads(new, x.shape[:-2]))


def slstm_init_state(lead: Tuple[int, ...], cfg: ModelConfig, device=None):
    """The zero sLSTM state (c, n, h, m) for leading dims ``lead``."""
    dh = cfg.d_model // cfg.n_heads
    z = torch.zeros(tuple(lead) + (cfg.n_heads, dh), dtype=torch.float32,
                    device=device)
    return (z, z.clone(), z.clone(), z.clone())
