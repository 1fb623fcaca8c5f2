"""Model substrate: configs, init, norms, rope, embedding and head (reference: ``repro.models.common``).

The reference runs every model inside ``shard_map`` with the vocabulary
sharded over a ``model`` mesh axis.  The port runs on one device, with
the casts of the reference: matmuls in the activation dtype, norms and
the loss in float32.

Every function also takes *position-stacked* parameters: each leaf with
a leading axis of M data positions (vectors [M, h], matrices [M, d, h],
the tables [M, V, d]) and activations [M, ...] -- M model copies run as
one batched program (:func:`linear` is one batched matmul), so the
gradient of the summed per-position losses with respect to stacked
copies of one parameter set is each position's own gradient, stacked
(``repro_torch.train.step`` relies on it).

At tp > 1 the port holds every leaf whole, in the reference's global
shape at that tp, and what the reference replicates over the model axis
-- the residual stream, norms, routers, the loss -- runs once per data
row.  A column-sharded product followed by a row-sharded one (``w1`` /
``w3`` then ``w2``, mamba's ``in_x`` then ``out``) is the reference's
per-position partial products summed by its ``psum``; with the leaves
held whole it is the same two products as at tp = 1, taken once.  The
embedding (each vocab shard's masked lookup, summed) is the lookup in
the whole table, and the head's loss (each shard's float32 logits, the
``pmax`` stabilizer, ``denom`` and the picked logit summed over the
shards) is the loss over the whole padded vocabulary, up to the order of
``denom``'s float32 sum.  So :func:`embed`, :func:`lm_head_loss` and
:func:`linear` serve every tp; only the blocks whose function differs
at tp > 1 view their model positions (attention's padded heads and kv
slice, the MoE's token slices and exchanges), and the sparse gradient
sync runs per vocab shard (``repro_torch.train.step``).

Initialisation draws from an explicit ``torch.Generator`` (the
reference's ``KeyGen`` is a JAX key chain, so equal seeds do not give
equal weights across the two packages; tests copy weights over with
``repro_torch.models.transformer.params_from_jax``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The reference's config, field for field; ``dtype`` is a torch
    dtype."""
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    # block pattern for ONE period, repeated n_layers / len(pattern) times
    pattern: Tuple[str, ...] = ("attn",)
    ffn_pattern: Tuple[str, ...] = ("dense",)   # dense | moe | moe+dense | none
    # attention
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    window: int = 0                 # sliding window size; 0 = full
    window_pattern: Tuple[int, ...] = ()  # per-period-layer window (0=full)
    logit_softcap: float = 0.0
    # moe
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    # ssm
    ssm_state: int = 16
    ssm_conv: int = 4
    # enc-dec / frontend stubs
    enc_layers: int = 0             # >0 => encoder-decoder (audio)
    enc_seq: int = 0                # encoder length (stub frame embeddings)
    img_tokens: int = 0             # >0 => VLM stub patch embeddings
    # numerics / distribution
    dtype: Any = torch.bfloat16
    fsdp: bool = False
    tie_embeddings: bool = True
    act: str = "silu"               # silu (swiglu) | gelu
    norm_eps: float = 1e-6
    moe_capacity: float = 2.0
    remat_policy: str = "full"      # full | dots
    moe_token_shard: bool = True

    @property
    def hd(self) -> int:
        """Head dimension."""
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_periods(self) -> int:
        """Repeats of the block pattern."""
        assert self.n_layers % len(self.pattern) == 0, \
            f"{self.n_layers} layers vs period {len(self.pattern)}"
        return self.n_layers // len(self.pattern)

    def heads_local(self, tp: int) -> int:
        """Query heads per tensor-parallel shard (ceil; pads masked)."""
        return max(1, -(-self.n_heads // tp))

    def n_heads_padded(self, tp: int) -> int:
        """Query heads after padding to a multiple of tp."""
        return self.heads_local(tp) * tp

    def kv_local(self, tp: int) -> int:
        """KV heads per tensor-parallel shard."""
        return max(1, self.n_kv // tp)

    def experts_local(self, tp: int) -> int:
        """Experts per tensor-parallel shard."""
        return max(1, -(-self.n_experts // tp))

    def n_experts_padded(self, tp: int) -> int:
        """Experts after padding to a multiple of tp."""
        return self.experts_local(tp) * tp

    def reduced(self, **kw) -> "ModelConfig":
        """Smoke-test variant: <=2 periods, small dims, <=4 experts, f32."""
        period = len(self.pattern)
        small = dict(
            n_layers=period, d_model=256, n_heads=4, n_kv=2,
            d_ff=512, vocab=512, head_dim=64,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            expert_d_ff=128 if self.n_experts else 0,
            enc_layers=1 if self.enc_layers else 0,
            enc_seq=32 if self.enc_seq else 0,
            img_tokens=8 if self.img_tokens else 0,
            window=min(self.window, 16) if self.window else 0,
            window_pattern=tuple(min(w, 16) for w in self.window_pattern),
            dtype=torch.float32, fsdp=False)
        small.update(kw)
        return dataclasses.replace(self, **small)

    def param_count(self) -> float:
        """Approximate total parameters (the reference's formula)."""
        d, ff, hd = self.d_model, self.d_ff, self.hd
        attn = d * hd * self.n_heads + 2 * d * hd * self.n_kv + hd * self.n_heads * d
        dense_ffn = 3 * d * ff if self.act == "silu" else 2 * d * ff
        moe_ffn = self.n_experts * 3 * d * self.expert_d_ff + d * self.n_experts \
            if self.n_experts else 0
        ssm_inner = 2 * d
        mamba = d * ssm_inner * 2 + ssm_inner * (self.ssm_state * 2 + 2) \
            + ssm_inner * d
        total = 0.0
        for blk, ffn in zip(self.pattern, self.ffn_pattern):
            if blk == "attn":
                total += attn
            elif blk == "mamba":
                total += mamba
            elif blk in ("mlstm", "slstm"):
                total += 4 * d * d
            if ffn == "dense":
                total += dense_ffn
            elif ffn == "moe":
                total += moe_ffn
            elif ffn == "moe+dense":
                total += moe_ffn + dense_ffn
        total *= self.n_periods
        total += self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.enc_layers:
            total += self.enc_layers * (attn + dense_ffn)
        return total

    def active_param_count(self) -> float:
        """Active parameters a token (MoE: top_k of n_experts; the
        reference's formula)."""
        if not self.n_experts:
            return self.param_count()
        moe_total = self.n_periods * sum(
            self.n_experts * 3 * self.d_model * self.expert_d_ff
            for f in self.ffn_pattern if f in ("moe", "moe+dense"))
        return self.param_count() - moe_total \
            + moe_total * self.top_k / self.n_experts


@dataclasses.dataclass(frozen=True)
class DeepSeekV3Config(ModelConfig):
    """A DeepSeek-V3-style decoder (Moonlight, Kimi): the port's own
    configuration kind, kept apart from the reference's ``ModelConfig``
    fields.

    ``n_layers`` counts every layer: ``lead_dense`` leading layers of
    latent attention and a dense SwiGLU of width ``lead_d_ff``, then the
    repeated period (``pattern`` ``("mla",)``, ``ffn_pattern``
    ``("moe+dense",)``: the shared experts are the dense FFN of width
    ``d_ff`` beside the MoE).  Latent attention (``models.mla``): queries
    of ``q_nope_dim + q_rope_dim`` a head, a ``kv_rank``-wide latent and
    one ``q_rope_dim``-wide rope key shared by the heads, values of
    ``v_dim`` a head.  The router is a float32 sigmoid over
    ``n_experts`` outputs; experts are chosen by score plus
    ``router_bias`` (the held correction bias, ``n_periods * n_experts``
    floats, period-major; empty = zeros), and their weights are the
    chosen scores normalised and times ``router_scale``.  The layer
    holds and computes experts ``[expert_first, expert_first +
    experts_held)`` of them (``experts_held`` 0: all), the expert
    parallel share; routes to the others add nothing.  The MoE aux loss
    is DeepSeek-V3's sequence-wise balance, which the train step weighs
    by ``aux_alpha``.  tp = 1 only."""
    q_nope_dim: int = 128
    q_rope_dim: int = 64
    kv_rank: int = 512
    v_dim: int = 128
    lead_dense: int = 1
    lead_d_ff: int = 0
    router_scale: float = 1.0
    router_bias: Tuple[float, ...] = ()
    expert_first: int = 0
    experts_held: int = 0
    aux_alpha: float = 1e-4

    @property
    def n_periods(self) -> int:
        """Repeats of the block pattern after the leading dense layers."""
        rest = self.n_layers - self.lead_dense
        assert rest >= 0 and rest % len(self.pattern) == 0, \
            f"{self.n_layers} layers, {self.lead_dense} leading, period " \
            f"{len(self.pattern)}"
        return rest // len(self.pattern)

    def lead_config(self) -> "DeepSeekV3Config":
        """The leading dense layers' view: the pattern with a dense FFN of
        width ``lead_d_ff``."""
        return dataclasses.replace(
            self, ffn_pattern=("dense",) * len(self.pattern),
            d_ff=self.lead_d_ff)

    @property
    def held(self) -> int:
        """Experts this layer holds and computes (the expert leaves'
        leading dim; the router keeps ``n_experts`` outputs)."""
        return self.experts_held or self.n_experts

    def reduced(self, **kw) -> "DeepSeekV3Config":
        """Smoke-test variant: the leading dense layer and two MoE layers,
        small widths, 8 experts top-2 all held, f32."""
        small = dict(n_layers=self.lead_dense + 2, d_model=128, n_heads=4,
                     n_kv=4, d_ff=96, lead_d_ff=192, vocab=512, head_dim=0,
                     q_nope_dim=16, q_rope_dim=8, kv_rank=32, v_dim=16,
                     n_experts=8, top_k=2, expert_d_ff=48, router_bias=(),
                     expert_first=0, experts_held=0, dtype=torch.float32,
                     fsdp=False)
        small.update(kw)
        return dataclasses.replace(self, **small)

    def mla_param_count(self) -> int:
        """One latent attention block's parameters."""
        d, h = self.d_model, self.n_heads
        qk = self.q_nope_dim + self.q_rope_dim
        return (d * h * qk + d * (self.kv_rank + self.q_rope_dim)
                + self.kv_rank + self.kv_rank * h * (self.q_nope_dim
                                                     + self.v_dim)
                + h * self.v_dim * d)

    def param_count(self) -> float:
        """Parameters held: the embedding, head and final norm, the
        leading dense layers, and each MoE layer's attention, shared
        experts, router and held experts, norms included."""
        d = self.d_model
        lead = self.mla_param_count() + 3 * d * self.lead_d_ff + 2 * d
        moe = (self.mla_param_count() + 3 * d * self.d_ff + 2 * d
               + d * self.n_experts + self.held * 3 * d * self.expert_d_ff)
        return (self.lead_dense * lead + self.n_periods * moe + d
                + self.vocab * d * (1 if self.tie_embeddings else 2))

    def active_param_count(self) -> float:
        """Parameters a token uses: top_k of n_experts routed experts, of
        which ``held / n_experts`` are held here."""
        routed = self.n_periods * self.held * 3 * self.d_model \
            * self.expert_d_ff
        return self.param_count() - routed + routed * self.top_k \
            / self.n_experts


# ---------------------------------------------------------------------------
# Elementwise pieces
# ---------------------------------------------------------------------------

def vec(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A vector parameter shaped to broadcast over ``x`` [..., h]: as it is
    ([h]), or position-stacked [M, h] against x [M, ..., h]."""
    if p.ndim == 1:
        return p
    return p.reshape((p.shape[0],) + (1,) * (x.ndim - 2) + (p.shape[-1],))


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., d] times w [d, h]; position-stacked w [M, d, h] with x [M,
    ..., d] is one batched matmul over the M positions."""
    if w.ndim == 2:
        return torch.matmul(x, w)
    m = w.shape[0]
    y = torch.bmm(x.reshape(m, -1, x.shape[-1]), w)
    return y.reshape(x.shape[:-1] + (w.shape[-1],))


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32 with a zero-centred gain, cast back to x's dtype."""
    x32 = x.to(torch.float32)
    scale = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return ((x32 * scale) * (1.0 + vec(g, x).to(torch.float32))).to(x.dtype)


def act_fn(x: torch.Tensor, kind: str) -> torch.Tensor:
    """SiLU, or GELU in its tanh form (``jax.nn.gelu``'s default)."""
    return F.silu(x) if kind == "silu" else F.gelu(x, approximate="tanh")


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of the two halves; x [..., T, H, hd], positions
    [..., T] integer.  Angles in float32; the result in x's dtype."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.tensor(theta, dtype=torch.float32) ** (
        -torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs      # [..., T, half]
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding + LM head
# ---------------------------------------------------------------------------

def embed(emb_local: torch.Tensor, ids: torch.Tensor, shard: int = 0) -> torch.Tensor:
    """Rows of the vocab shard ``emb_local`` [V_local, d] for global ids
    (position-stacked: [M, V_local, d] with ids [M, ...]).

    The lookup is ``F.embedding``, whose backward on the card sums each
    row's gradient in a fixed order, so two backward passes give the same
    bits; ``x[idx]`` would backpropagate through an atomic ``index_put_``.
    Ids outside this shard read row 0 and are masked to 0, as in the
    reference."""
    v_local = emb_local.shape[-2]
    loc = ids - shard * v_local
    ok = (loc >= 0) & (loc < v_local)
    safe = torch.clamp(loc, 0, v_local - 1)
    if emb_local.ndim == 2:
        out = F.embedding(safe, emb_local)
    else:
        m = emb_local.shape[0]
        off = torch.arange(m, device=ids.device).reshape(
            (m,) + (1,) * (ids.ndim - 1)) * v_local
        out = F.embedding(safe + off,
                          emb_local.reshape(m * v_local, -1))
    return out * ok[..., None].to(emb_local.dtype)


class _StackedHeadLogits(torch.autograd.Function):
    """float32 logits of position-stacked x32 [M, N, d] against a head
    [M, d, V] in its own dtype, each position's product taken with its
    head cast to float32 one position at a time: the function of
    ``bmm(x32, head.to(float32))``, whose cast of a broadcast head would
    materialize M float32 copies and keep them for the backward.  The
    backward returns the head's gradient in the head's dtype (the cast's
    own backward), again position by position."""

    @staticmethod
    def forward(ctx, x32, head):
        ctx.save_for_backward(x32, head)
        out = x32.new_empty(x32.shape[:-1] + (head.shape[-1],))
        for i in range(head.shape[0]):
            torch.matmul(x32[i], head[i].to(torch.float32), out=out[i])
        return out

    @staticmethod
    def backward(ctx, g):
        x32, head = ctx.saved_tensors
        gx = torch.empty_like(x32)
        gh = head.new_empty(head.shape)
        for i in range(head.shape[0]):
            h32 = head[i].to(torch.float32)
            torch.matmul(g[i], h32.transpose(0, 1), out=gx[i])
            del h32
            gh[i] = torch.matmul(x32[i].transpose(0, 1), g[i])
        return gx, gh


def lm_head_loss(x: torch.Tensor, head_local: torch.Tensor,
                 labels: torch.Tensor, mask: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Mean cross-entropy with float32 logits; x [B, T, d], head_local
    [d, V_local] in any dtype (cast to float32 for the product), labels
    [B, T] global ids.  The max stabilizer carries no gradient (the
    reference's ``stop_gradient``).  Position-stacked (x [M, B, T, d],
    head [M, d, V_local]): the M positions' means, [M]; the head is cast
    one position at a time (:class:`_StackedHeadLogits`)."""
    if head_local.ndim == 3:
        m = head_local.shape[0]
        x32 = x.to(torch.float32)
        logits = _StackedHeadLogits.apply(
            x32.reshape(m, -1, x32.shape[-1]), head_local).reshape(
                x32.shape[:-1] + (head_local.shape[-1],))
    else:
        logits = linear(x.to(torch.float32), head_local.to(torch.float32))
    gmax = torch.amax(logits.detach(), dim=-1)                    # [B, T]
    z = torch.exp(logits - gmax[..., None])
    denom = torch.sum(z, dim=-1)                                  # [B, T]
    v_local = head_local.shape[-1]
    ok = (labels >= 0) & (labels < v_local)
    safe = torch.clamp(labels, 0, v_local - 1)
    picked = torch.gather(logits, -1, safe[..., None].long())[..., 0]
    picked = torch.where(ok, picked - gmax, torch.zeros_like(picked))
    nll = torch.log(denom) - picked
    if head_local.ndim == 3:                 # per position: [M, B*T]
        nll = nll.reshape(head_local.shape[0], -1)
        dims = -1
    else:
        dims = tuple(range(nll.ndim))
    if mask is None:
        return torch.mean(nll, dim=dims)
    mask = mask.to(torch.float32).reshape(nll.shape)
    return torch.sum(nll * mask, dim=dims) / torch.clamp(
        torch.sum(mask, dim=dims), min=1.0)


def lm_head_logits(x: torch.Tensor, head_local: torch.Tensor) -> torch.Tensor:
    """Local float32 logits [B, T, V_local]."""
    return linear(x.to(torch.float32), head_local.to(torch.float32))


# ---------------------------------------------------------------------------
# Init helpers
# ---------------------------------------------------------------------------

def dense_init(gen: Optional[torch.Generator], shape, scale_axis: int = 0,
               dtype=torch.float32) -> torch.Tensor:
    """Normal / sqrt(fan_in) drawn in float32 on ``gen``'s device, cast
    to ``dtype``; with no generator, a meta tensor of the shape and dtype
    (the dry run's stand-in: nothing is drawn or allocated)."""
    if gen is None:
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    fan_in = shape[scale_axis]
    return (torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                        device=gen.device) / math.sqrt(fan_in)).to(dtype)
