"""Plain training steps of Moonlight-16B-A3B (a DeepSeek-V3 decoder) in
float32, with autograd and nothing else.

The model, as the configuration runs it (``configs/moonlight-16b-a3b.json``
with the HF ``config.json`` keys): token embedding (untied); layer 0 a
pre-norm latent attention block and a pre-norm SwiGLU of width
``intermediate_size``; each later layer a pre-norm latent attention block
and a pre-norm MoE block, each added to the residual; a final norm and a
float32 head, the mean cross-entropy over the vocabulary.

- Norms: RMS norm with a zero-centred gain (``x * rsqrt(mean x^2 + eps) *
  (1 + g)``, g drawn 0): the published gain ``w`` is ``1 + g``.
- Latent attention (no q latent): q = x wq, [H, nope + rope] a token;
  x wkv_a gives a ``kv_lora_rank`` latent and one rope key shared by the
  heads; the normed latent times wkv_b gives each head's nope key and
  value columns; RoPE on the rope columns, scores over sqrt(nope + rope),
  causal softmax, the heads' values through wo.  Departure: RoPE rotates
  the two halves of the rope columns, where the published code rotates
  interleaved pairs (a fixed permutation of the rope columns of wq and
  wkv_a).
- MoE: a float32 router, sigmoid scores over its
  ``published_n_routed_experts`` outputs; the top ``num_experts_per_tok``
  of score plus the held correction bias (``bias``, selection only) by a
  stable descending sort; weights the chosen scores over their sum
  (+ 1e-20) times ``routed_scaling_factor``.  This card's share: experts
  ``[held_experts_first, + n_routed_experts)``, each a SwiGLU of width
  ``moe_intermediate_size``; routes to other experts add nothing.
  Departure: the port's capacity rule, where the published model drops
  none: of the ``n * k`` copies in token order the first ``slots`` are
  dispatched (all of them at a factor of 1 or more), and each expert
  takes at most ``capacity`` of those (over the router's experts, the
  earlier tokens first).  The ``n_shared_experts`` shared experts
  are one SwiGLU of their summed width, added for every token.
- Aux: DeepSeek-V3's sequence-wise balance (arXiv:2412.19437 §2.1.2) of
  each MoE layer, ``sum_i f_i P_i`` per row averaged over the rows, ``f_i``
  E / (K T) times the tokens whose top K by raw score hold expert i,
  ``P_i`` the row's mean of the scores normalised over the experts; the
  objective is the loss plus ``seq_aux_alpha`` times the layers' sum.
  Departure: the bias is held (its update rule belongs to pre-training),
  and AdamW (``reference.granite.AdamW``) stands for Muon.

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

from portbench.reference.granite import AdamW, _Round

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

Path = Tuple[str, ...]
MLA = ("wq", "wkv_a", "kv_ln", "wkv_b", "wo")
FFN = ("w1", "w3", "w2")
MOE = ("router", "w1", "w3", "w2")


class Model:
    """The forward and the objective (module docstring)."""

    def __init__(self, cfg: dict, bias: Optional[torch.Tensor] = None,
                 lowp: Optional[Tuple] = None):
        self.d = int(cfg["hidden_size"])
        self.h = int(cfg["num_attention_heads"])
        self.nope = int(cfg["qk_nope_head_dim"])
        self.rp = int(cfg["qk_rope_head_dim"])
        self.rank = int(cfg["kv_lora_rank"])
        self.vd = int(cfg["v_head_dim"])
        self.lead = int(cfg["first_k_dense_replace"])
        self.layers = int(cfg["num_hidden_layers"])
        self.e = int(cfg["published_n_routed_experts"])
        self.held = int(cfg["n_routed_experts"])
        self.first = int(cfg.get("held_experts_first", 0))
        self.k = int(cfg["num_experts_per_tok"])
        self.scale = float(cfg["routed_scaling_factor"])
        self.theta = float(cfg["rope_theta"])
        self.eps = float(cfg["rms_norm_eps"])
        self.aux_weight = float(cfg["seq_aux_alpha"])
        self.cap_factor = float(cfg["moe_capacity_factor"])
        self.cap_slack = float(cfg["expert_capacity_slack"])
        self.bias = bias                       # [MoE layers, E] or None
        self.lowp = lowp

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.lowp is not None:
            a = _Round.apply(a, *self.lowp)
            b = _Round.apply(b, *self.lowp)
        return torch.matmul(a, b)

    def slots(self, n: int) -> int:
        """Copies dispatched of ``n`` tokens: ``n * k`` times the
        capacity factor, at least 8."""
        return int(max(8, n * self.k * self.cap_factor))

    def capacity(self, n: int) -> int:
        """Copies one expert takes of ``n`` tokens: the slots over the
        router's experts, times the slack, at least 8 and at most all
        slots."""
        slots = self.slots(n)
        return int(min(max(8, -(-slots // self.e) * self.cap_slack), slots))

    def norm(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        s = torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + self.eps)
        return x * s * (1.0 + g)

    def rope(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, T, heads, rp], the two halves rotated."""
        t, half = x.shape[-3], x.shape[-1] // 2
        freqs = self.theta ** (-torch.arange(half, dtype=torch.float32,
                                             device=x.device) / half)
        ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] \
            * freqs
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)

    def mla(self, x, wq, wkv_a, kv_ln, wkv_b, wo):
        b, t, _ = x.shape
        h, nope, rp = self.h, self.nope, self.rp
        q = self.mm(x, wq).reshape(b, t, h, nope + rp)
        ckv = self.mm(x, wkv_a)
        kv = self.mm(self.norm(ckv[..., : self.rank], kv_ln), wkv_b) \
            .reshape(b, t, h, nope + self.vd)
        k_rope = self.rope(ckv[..., self.rank:].reshape(b, t, 1, rp))
        q = torch.cat([q[..., :nope], self.rope(q[..., nope:])], -1)
        k = torch.cat([kv[..., :nope], k_rope.expand(b, t, h, rp)], -1)
        v = kv[..., nope:]
        scores = self.mm(q.permute(0, 2, 1, 3), k.permute(0, 2, 3, 1)) \
            / math.sqrt(nope + rp)
        causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        scores = scores.masked_fill(~causal, float("-inf"))
        out = self.mm(torch.softmax(scores, -1), v.permute(0, 2, 1, 3))
        return self.mm(out.permute(0, 2, 1, 3).reshape(b, t, -1), wo)

    def ffn(self, x, w1, w3, w2):
        return self.mm(F.silu(self.mm(x, w1)) * self.mm(x, w3), w2)

    def moe(self, x, router, bias, w1, w3, w2):
        """``(y, aux)`` of the routed experts held over x [B, T, d]."""
        shape = x.shape
        b, t = shape[0], shape[1]
        x = x.reshape(-1, self.d)
        n = x.shape[0]
        scores = torch.sigmoid(self.mm(x, router))
        choice = scores.detach() if bias is None else scores.detach() + bias
        ek = torch.sort(choice, dim=-1, descending=True,
                        stable=True).indices[:, : self.k]
        wk = torch.gather(scores, 1, ek)
        wk = wk / (wk.sum(-1, keepdim=True) + 1e-20) * self.scale
        # sequence-wise balance, each row's, averaged over the rows
        top = torch.sort(scores.detach(), dim=-1, descending=True,
                         stable=True).indices[:, : self.k].reshape(b, -1)
        f = F.one_hot(top, self.e).to(torch.float32).sum(1) \
            * (self.e / (self.k * t))
        pn = (scores / scores.sum(-1, keepdim=True)).reshape(b, t, -1).mean(1)
        aux = (f * pn).sum(-1).mean()
        flat = ek.reshape(-1)                      # token-major copies
        order = torch.sort(flat, stable=True).indices
        first = torch.searchsorted(flat[order], torch.arange(
            self.e, device=x.device, dtype=flat.dtype))
        rank = torch.empty_like(order)
        rank[order] = torch.arange(flat.numel(), device=x.device) \
            - first[flat[order]]
        keep = (rank < self.capacity(n)) \
            & (torch.arange(flat.numel(), device=x.device) < self.slots(n))
        tok = torch.arange(n, device=x.device).repeat_interleave(self.k)
        weight = wk.reshape(-1)
        y = torch.zeros_like(x)
        for j in range(self.held):
            sel = torch.nonzero((flat == self.first + j) & keep).squeeze(1)
            if sel.numel() == 0:
                continue
            xe = x.index_select(0, tok[sel])
            ye = self.ffn(xe, w1[j], w3[j], w2[j]) * weight[sel, None]
            y = y.index_add(0, tok[sel], ye)
        return y.reshape(shape), aux

    def dense_layer(self, x, ln1, wq, wkv_a, kv_ln, wkv_b, wo, ln2, w1, w3,
                    w2):
        x = x + self.mla(self.norm(x, ln1), wq, wkv_a, kv_ln, wkv_b, wo)
        return x + self.ffn(self.norm(x, ln2), w1, w3, w2)

    def moe_layer(self, x, bias, ln1, wq, wkv_a, kv_ln, wkv_b, wo, ln2, s1,
                  s3, s2, router, w1, w3, w2):
        x = x + self.mla(self.norm(x, ln1), wq, wkv_a, kv_ln, wkv_b, wo)
        h = self.norm(x, ln2)
        y, aux = self.moe(h, router, bias, w1, w3, w2)
        return x + y + self.ffn(h, s1, s3, s2), aux

    def objective(self, p: Dict[Path, torch.Tensor], tokens: torch.Tensor,
                  labels: torch.Tensor):
        """``(loss, aux)`` of one position's rows [B, T]."""
        x = p[("emb",)][tokens]
        lead = [("ln1",)] + [("mla", n) for n in MLA] + [("ln2",)] \
            + [("ffn", n) for n in FFN]
        for args in zip(*(p[("lead", "b0") + n].unbind(0) for n in lead)):
            x = checkpoint(self.dense_layer, x, *args, use_reentrant=False)
        names = lead + [("moe", n) for n in MOE]
        per_layer = list(zip(*(p[("blocks", "b0") + n].unbind(0)
                               for n in names)))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, args in enumerate(per_layer):
            bias = None if self.bias is None else self.bias[i]
            x, a = checkpoint(self.moe_layer, x, bias, *args,
                              use_reentrant=False)
            aux = aux + a
        x = self.norm(x, p[("final_ln",)])
        logits = self.mm(x.reshape(-1, self.d), p[("head",)])
        loss = F.cross_entropy(logits, labels.reshape(-1))
        return loss, aux


def steps(cfg: dict, opt: dict, draw: Callable[[Path], torch.Tensor],
          paths: List[Path], batches: List[Tuple[torch.Tensor, torch.Tensor]],
          bias: Optional[torch.Tensor] = None, lowp: Optional[Tuple] = None,
          fault: Optional[str] = None) -> dict:
    """``len(batches)`` training steps from the weights ``draw(path)``
    gives (each batch tokens / labels [M, B, T]) and the held correction
    bias [MoE layers, E]: the mean loss of each step, each leaf's norm of
    the first gradient as the optimizer gets it (after clipping), and
    each leaf's norm of its change over all the steps.  ``fault``:
    ``"half_batch"`` (only the first half of the positions, their mean),
    ``"no_exchange"`` (each position's gradient alone: position 0's over
    M), or None."""
    model = Model(cfg, bias, lowp)
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
