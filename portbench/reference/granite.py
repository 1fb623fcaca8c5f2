"""Plain training steps of the MoE decoder (granite-moe-3b-a800m) in
float32, with autograd and nothing else.

The model, as the configuration runs it (the published multipliers and
the tied embedding are not run: the configuration's ``assumed`` values):
token embedding (untied);
per layer a pre-norm causal attention block (RMS norm with a zero-centred
gain, rotary embedding of the two halves, grouped-query heads, scores
over sqrt(head size)) and a pre-norm mixture-of-experts block (float32
router, softmax over the experts, the top k by a stable descending sort,
their weights renormalised, each expert a SiLU-gated FFN; each expert
takes at most ``capacity`` copies, the earlier tokens first, the rest
dropped), each added to the residual; a final norm and a float32 head,
the mean cross-entropy over the padded vocabulary.  The objective of one
data position is its loss plus ``aux_weight`` times the switch load
balance ``E * sum_e(mean prob_e * top-1 share_e)``; the step's gradient
is the mean over the positions.  AdamW with global-norm clipping, bias
correction and decay on the leaves of two or more dims; each parameter is
kept in its configured dtype after an update.

Memory: the positions run one at a time (their gradients summed), each
layer is recomputed in the backward, and the experts run one at a time
on the copies routed to them.  ``lowp`` rounds every matmul operand to a
lower type with a per-tensor scale (the control); ``fault`` plants one
fault of a training step (the harness's fault tests).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Path = Tuple[str, ...]
FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


class _Round(torch.autograd.Function):
    """Forward: ``x`` rounded to ``dtype`` under a per-tensor scale;
    backward: the gradient rounded to ``grad_dtype`` the same way."""

    @staticmethod
    def forward(ctx, x, dtype, grad_dtype):
        ctx.grad_dtype = grad_dtype
        return _round(x, dtype)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.grad_dtype), None, None


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    if dtype is None:
        return x
    if dtype in FP8_MAX:
        amax = x.detach().abs().amax().clamp(min=1e-30)
        s = FP8_MAX[dtype] / amax
        return (x * s).to(dtype).to(x.dtype) / s
    return x.to(dtype).to(x.dtype)


class Model:
    """The forward and the objective (module docstring)."""

    def __init__(self, cfg: dict, lowp: Optional[Tuple] = None):
        self.d = int(cfg["hidden_size"])
        self.h = int(cfg["num_attention_heads"])
        self.kv = int(cfg["num_key_value_heads"])
        self.hd = self.d // self.h
        self.layers = int(cfg["num_hidden_layers"])
        self.e = int(cfg["num_local_experts"])
        self.k = int(cfg["num_experts_per_tok"])
        self.theta = float(cfg["rope_theta"])
        self.eps = float(cfg["rms_norm_eps"])
        self.aux_weight = float(cfg["router_aux_loss_coef"])
        self.cap_factor = float(cfg["moe_capacity_factor"])
        self.cap_slack = float(cfg["expert_capacity_slack"])
        self.lowp = lowp

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.lowp is not None:
            a = _Round.apply(a, *self.lowp)
            b = _Round.apply(b, *self.lowp)
        return torch.matmul(a, b)

    def capacity(self, n: int) -> int:
        """Copies one expert takes of ``n`` tokens: ``n * k`` slots times
        the capacity factor over the experts, times the slack, at least 8
        and at most all slots."""
        slots = int(max(8, n * self.k * self.cap_factor))
        return int(min(max(8, -(-slots // self.e) * self.cap_slack), slots))

    def norm(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        s = torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + self.eps)
        return x * s * (1.0 + g)

    def rope(self, x: torch.Tensor) -> torch.Tensor:
        t, half = x.shape[-3], self.hd // 2
        freqs = self.theta ** (-torch.arange(half, dtype=torch.float32,
                                             device=x.device) / half)
        ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] \
            * freqs
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)

    def attention(self, x, wq, wk, wv, wo):
        b, t, _ = x.shape
        q = self.rope(self.mm(x, wq).reshape(b, t, self.h, self.hd))
        k = self.rope(self.mm(x, wk).reshape(b, t, self.kv, self.hd))
        v = self.mm(x, wv).reshape(b, t, self.kv, self.hd)
        g = self.h // self.kv
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
        scores = self.mm(q.permute(0, 2, 1, 3), k.permute(0, 2, 3, 1)) \
            / math.sqrt(self.hd)
        causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        scores = scores.masked_fill(~causal, float("-inf"))
        out = self.mm(torch.softmax(scores, -1), v.permute(0, 2, 1, 3))
        return self.mm(out.permute(0, 2, 1, 3).reshape(b, t, -1), wo)

    def moe(self, x, router, w1, w3, w2):
        """``(y, aux)`` of the MoE block over x [B, T, d]."""
        shape = x.shape
        x = x.reshape(-1, self.d)
        n = x.shape[0]
        probs = torch.softmax(self.mm(x, router), -1)
        top = torch.sort(probs, dim=-1, descending=True, stable=True)
        wk = top.values[:, : self.k]
        ek = top.indices[:, : self.k]
        wk = wk / wk.sum(-1, keepdim=True)
        share = F.one_hot(ek[:, 0], self.e).to(torch.float32).mean(0)
        aux = self.e * torch.sum(probs.mean(0) * share)
        flat = ek.reshape(-1)                      # token-major copies
        order = torch.sort(flat, stable=True).indices
        first = torch.searchsorted(flat[order], torch.arange(
            self.e, device=x.device, dtype=flat.dtype))
        rank = torch.empty_like(order)
        rank[order] = torch.arange(flat.numel(), device=x.device) \
            - first[flat[order]]
        keep = rank < self.capacity(n)
        tok = torch.arange(n, device=x.device).repeat_interleave(self.k)
        weight = wk.reshape(-1)
        y = torch.zeros_like(x)
        for e in range(self.e):
            sel = torch.nonzero((flat == e) & keep).squeeze(1)
            if sel.numel() == 0:
                continue
            xe = x.index_select(0, tok[sel])
            he = F.silu(self.mm(xe, w1[e])) * self.mm(xe, w3[e])
            ye = self.mm(he, w2[e]) * weight[sel, None]
            y = y.index_add(0, tok[sel], ye)
        return y.reshape(shape), aux

    def layer(self, x, ln1, wq, wk, wv, wo, ln2, router, w1, w3, w2):
        x = x + self.attention(self.norm(x, ln1), wq, wk, wv, wo)
        y, aux = self.moe(self.norm(x, ln2), router, w1, w3, w2)
        return x + y, aux

    def objective(self, p: Dict[Path, torch.Tensor], tokens: torch.Tensor,
                  labels: torch.Tensor):
        """``(loss, aux)`` of one position's rows [B, T]."""
        b = ("blocks", "b0")
        names = [("ln1",), ("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
                 ("attn", "wo"), ("ln2",), ("moe", "router"), ("moe", "w1"),
                 ("moe", "w3"), ("moe", "w2")]
        # one unbind a stacked leaf: its backward stacks the layers once
        per_layer = list(zip(*(p[b + n].unbind(0) for n in names)))
        x = p[("emb",)][tokens]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for args in per_layer:
            x, a = checkpoint(self.layer, x, *args, use_reentrant=False)
            aux = aux + a
        x = self.norm(x, p[("final_ln",)])
        logits = self.mm(x.reshape(-1, self.d), p[("head",)])
        loss = F.cross_entropy(logits, labels.reshape(-1))
        return loss, aux


class AdamW:
    """The configuration's AdamW, leaf by leaf in float32."""

    def __init__(self, opt: dict):
        self.lr, self.b1, self.b2 = opt["lr"], opt["b1"], opt["b2"]
        self.eps, self.wd, self.clip = opt["eps"], opt["weight_decay"], \
            opt["grad_clip"]
        self.t = 0
        self.m: Dict[Path, torch.Tensor] = {}
        self.v: Dict[Path, torch.Tensor] = {}

    def update(self, params: Dict[Path, torch.Tensor],
               grads: Dict[Path, torch.Tensor],
               dtypes: Dict[Path, torch.dtype]) -> None:
        """In place: ``params[path]`` (float32 leaves holding values of
        their configured dtype) stepped by ``grads``, a slice of the
        leading dim at a time."""
        self.t += 1
        gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        scale = torch.clamp(self.clip / torch.clamp(gnorm, min=1e-9), max=1.0)
        b1c, b2c = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for path, grad in grads.items():
            p = params[path]
            if path not in self.m:
                self.m[path] = torch.zeros_like(p)
                self.v[path] = torch.zeros_like(p)
            m, v = self.m[path], self.v[path]
            for sl in (range(p.shape[0]) if p.ndim >= 3 else (slice(None),)):
                g = grad[sl] * scale
                m[sl].mul_(self.b1).add_(g, alpha=1 - self.b1)
                v[sl].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
                delta = (m[sl] / b1c) / (torch.sqrt(v[sl] / b2c) + self.eps)
                if p.ndim >= 2:
                    delta.add_(p[sl], alpha=self.wd)
                p[sl] = (p[sl] - self.lr * delta).to(dtypes[path]) \
                    .to(torch.float32)
                del g, delta


def steps(cfg: dict, opt: dict, draw: Callable[[Path], torch.Tensor],
          paths: List[Path], batches: List[Tuple[torch.Tensor, torch.Tensor]],
          lowp: Optional[Tuple] = None, fault: Optional[str] = None) -> dict:
    """``len(batches)`` training steps from the weights ``draw(path)``
    gives (each batch tokens / labels [M, B, T]): the mean loss of each
    step, each leaf's norm of the first gradient as the optimizer gets
    it (after clipping), and each leaf's norm of its change over all the
    steps.  ``fault``: ``"half_batch"`` (only the first half of the
    positions, their mean), ``"no_exchange"`` (each position's gradient
    alone: position 0's over M), or None."""
    model = Model(cfg, lowp)
    dtypes = {p: draw(p).dtype for p in paths}
    params = {p: draw(p).to(torch.float32) for p in paths}
    adam = AdamW(opt)
    losses, first_grad = [], {}
    for tokens, labels in batches:
        m = tokens.shape[0]
        use = list(range(m))
        if fault == "half_batch":
            use = use[: max(1, m // 2)]
        elif fault == "no_exchange":
            use = [0]
        div = m if fault == "no_exchange" else len(use)
        for t in params.values():
            t.requires_grad_(True)
        step_losses = []
        for i in use:
            loss, aux = model.objective(params, tokens[i], labels[i])
            step_losses.append(float(loss.detach()))
            ((loss + model.aux_weight * aux) / div).backward()
            del loss, aux
        losses.append(sum(step_losses) / len(step_losses))
        grads = {}
        for p in paths:
            grads[p] = params[p].grad
            params[p] = params[p].detach()
        with torch.no_grad():
            adam.update(params, grads, dtypes)
        if not first_grad:
            first_grad = {p: float(torch.linalg.vector_norm(
                adam.m[p] / (1 - adam.b1))) for p in paths}
        del grads
    change = {p: float(torch.linalg.vector_norm(
        params[p] - draw(p).to(torch.float32))) for p in paths}
    return {"losses": losses, "grad_norms": first_grad, "change_norms": change}


def worst_gap(got: Dict[Path, float], want: Dict[Path, float],
              kept: List[Path]) -> float:
    """Largest ``|got - want|`` over the kept leaves, each over the larger
    of its ``want`` and the median leaf's."""
    return max((g for g, _ in _gaps(got, want, kept)), default=0.0)


def worst_leaf(got: Dict[Path, float], want: Dict[Path, float],
               kept: List[Path]) -> Optional[Path]:
    """The kept leaf that sets :func:`worst_gap`."""
    return max(_gaps(got, want, kept), default=(0.0, None))[1]


def _gaps(got, want, kept):
    vals = sorted(want[p] for p in kept)
    med = vals[len(vals) // 2] if vals else 0.0
    return [(abs(got[p] - want[p]) / max(want[p], med, 1e-30), p)
            for p in kept]


def kept_leaves(grad_norms: Dict[Path, float], share: float) -> List[Path]:
    """Leaves whose reference gradient norm is at least ``share`` of the
    median leaf's (the others move under AdamW by round-off alone)."""
    vals = sorted(grad_norms.values())
    med = vals[len(vals) // 2]
    return sorted(p for p, v in grad_norms.items() if v >= share * med)
