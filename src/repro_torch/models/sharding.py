"""Spec trees of every block kind, and FSDP's gather (reference: ``repro.models.sharding``).

Each leaf's entry is a tuple over its dims: ``"model"`` (the tensor
parallel axis), ``"fsdp"`` (sharded over the data axes when
``cfg.fsdp``) or ``None`` (replicated); ``full_model_spec_tuples``
prepends the period-stack dim.  The gradient sync and the grad norm
read the trees, as the reference's do, and so does FSDP's gather.

The model axis (tp > 1): parameters are held once, in the reference's
global shape at that tp.  A leaf's ``"model"`` dim splits into tp
contiguous shards, position m's being shard m (the reference's
``NamedSharding``); the blocks take a position's shard as a view where
its function needs one, and otherwise the whole leaf
(``models.common`` says why).

FSDP on the stacked data mesh (:class:`FsdpGather`): the reference
shards each ``"fsdp"`` dim over the data axes and all_gathers it per
period inside the scan, so the gather's transpose -- a reduce-scatter
over the data axes -- is the leaf's gradient sync.  The port holds such
a leaf once; its gather is the M-position broadcast view (no copy) and
its backward is that reduce-scatter on the stacked ``[M, ...]``
gradient, one stage of degree M, which returns the held-once leaf's
summed gradient.  At tp > 1 the model shards are views of the gathered
leaf, so the gather and its reduce-scatter are those of tp = 1.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from .common import DeepSeekV3Config, ModelConfig

Tree = Dict[str, Any]


def check_ported(cfg: ModelConfig, tp: int = 1) -> None:
    """Every block, FFN and frontend kind is ported, with FSDP and a
    model axis.  ``ValueError`` for what no config has: an
    encoder-decoder with FSDP (the reference gathers on the decoder path
    only), and at tp > 1 a sharded dim that does not split over tp, or
    ``moe_token_shard=False`` (the reference's model positions would then
    carry different residual streams after an MoE block)."""
    if cfg.enc_layers and cfg.fsdp:
        raise ValueError(
            "enc_layers with fsdp=True: no config has both, and the "
            "reference's encoder-decoder forward never gathers FSDP leaves")
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if isinstance(cfg, DeepSeekV3Config) and (tp > 1 or cfg.fsdp):
        raise ValueError(f"{cfg.name}: a DeepSeek-V3 decoder runs at tp = 1 "
                         f"without FSDP (its expert share is the expert "
                         f"parallel layer); got tp={tp}, fsdp={cfg.fsdp}")
    if tp == 1:
        return
    kinds = set(cfg.pattern)
    dims = {"d_ff": cfg.d_ff if any(f in ("dense", "moe+dense")
                                    for f in cfg.ffn_pattern) else 0,
            "kv heads": cfg.n_kv if cfg.n_kv >= tp and "attn" in kinds else 0,
            "mamba inner width": 2 * cfg.d_model if "mamba" in kinds else 0,
            "mLSTM head dim": (cfg.d_model // cfg.n_heads)
            if "mlstm" in kinds else 0}
    bad = [f"{k} {v}" for k, v in dims.items() if v % tp]
    if bad:
        raise ValueError(f"tp={tp} does not split {', '.join(bad)}")
    if cfg.n_experts and not cfg.moe_token_shard:
        raise ValueError("moe_token_shard=False at tp > 1: every model "
                         "position would route every token and keep its "
                         "own output; no config runs it")


def attn_spec(cfg: ModelConfig, tp: int) -> Tree:
    """Attention leaves (kv sharded when n_kv >= tp)."""
    kv_sh = cfg.n_kv >= tp
    s = {"wq": ("fsdp", "model"),
         "wk": ("fsdp", "model" if kv_sh else None),
         "wv": ("fsdp", "model" if kv_sh else None),
         "wo": ("model", "fsdp")}
    if cfg.qkv_bias:
        s["bq"] = ("model",)
        s["bk"] = ("model" if kv_sh else None,)
        s["bv"] = ("model" if kv_sh else None,)
    return s


def mla_spec(cfg: ModelConfig, tp: int) -> Tree:
    """Latent attention leaves (tp = 1: heads over the model axis where a
    product's columns or rows are per head)."""
    return {"wq": ("fsdp", "model"), "wkv_a": ("fsdp", None),
            "kv_ln": (None,), "wkv_b": (None, "model"),
            "wo": ("model", "fsdp")}


def ffn_spec(cfg: ModelConfig, tp: int) -> Tree:
    """Gated dense FFN leaves."""
    return {"w1": ("fsdp", "model"), "w3": ("fsdp", "model"),
            "w2": ("model", "fsdp")}


def moe_spec(cfg: ModelConfig, tp: int) -> Tree:
    """Router (float32) and experts, sharded over the experts dim."""
    return {"router": ("fsdp", None),
            "w1": ("model", "fsdp", None),
            "w3": ("model", "fsdp", None),
            "w2": ("model", None, "fsdp")}


def mamba_spec(cfg: ModelConfig, tp: int) -> Tree:
    """Mamba leaves (inner channels over the model axis)."""
    return {"in_x": ("fsdp", "model"), "in_z": ("fsdp", "model"),
            "conv": (None, "model"), "w_dt": ("fsdp", "model"),
            "w_B": ("fsdp", None), "w_C": ("fsdp", None),
            "A_log": ("model", None), "D": ("model",),
            "out": ("model", "fsdp")}


def mlstm_spec(cfg: ModelConfig, tp: int) -> Tree:
    """mLSTM leaves (value dim over the model axis)."""
    return {"wq": ("fsdp", None), "wk": ("fsdp", None),
            "wv": ("fsdp", "model"), "wi": ("fsdp", None),
            "wf": ("fsdp", None), "out": ("model", "fsdp")}


def slstm_spec(cfg: ModelConfig, tp: int) -> Tree:
    """sLSTM leaves (replicated over the model axis: a sequential block)."""
    return {"wx": ("fsdp", None), "wr": (None, None, None),
            "out": ("fsdp", None), "bias": (None,)}


BLOCK_SPECS = {"attn": attn_spec, "mla": mla_spec, "mamba": mamba_spec,
               "mlstm": mlstm_spec, "slstm": slstm_spec}


def period_spec(cfg: ModelConfig, tp: int) -> Tree:
    """One period of blocks: ``ln1`` and the mixer, then ``ln2`` and the
    dense FFN and / or the MoE unless the FFN kind is ``none``."""
    out: Tree = {}
    for j, (blk, ffn) in enumerate(zip(cfg.pattern, cfg.ffn_pattern)):
        e: Tree = {"ln1": (None,), blk: BLOCK_SPECS[blk](cfg, tp)}
        if ffn != "none":
            e["ln2"] = (None,)
        if ffn in ("dense", "moe+dense"):
            e["ffn"] = ffn_spec(cfg, tp)
        if ffn in ("moe", "moe+dense"):
            e["moe"] = moe_spec(cfg, tp)
        out[f"b{j}"] = e
    return out


def model_spec(cfg: ModelConfig, tp: int) -> Tree:
    """The model's spec tree (blocks without the period dim)."""
    s: Tree = {"emb": ("model", None), "final_ln": (None,),
               "blocks": period_spec(cfg, tp)}
    if not cfg.tie_embeddings:
        s["head"] = (None, "model")
    if cfg.enc_layers:
        s["enc_blocks"] = {"b0": {"ln1": (None,), "attn": attn_spec(cfg, tp),
                                  "ln2": (None,), "ffn": ffn_spec(cfg, tp)}}
        s["enc_ln"] = (None,)
        s["cross"] = attn_spec(cfg, tp)       # per-period cross attention
        s["ln_cross"] = (None,)
    if isinstance(cfg, DeepSeekV3Config) and cfg.lead_dense:
        s["lead"] = period_spec(cfg.lead_config(), tp)
    return s


def _stack_spec(t):
    """A spec tree with the period dim prepended to every leaf."""
    if isinstance(t, dict):
        return {k: _stack_spec(v) for k, v in t.items()}
    return (None,) + tuple(t)


def full_model_spec_tuples(cfg: ModelConfig, tp: int) -> Tree:
    """Spec tuples mirroring ``init_params`` (blocks with the period dim
    prepended): what the gradient sync classifies leaves by."""
    spec = model_spec(cfg, tp)
    out = {"emb": tuple(spec["emb"]), "final_ln": tuple(spec["final_ln"]),
           "blocks": _stack_spec(spec["blocks"])}
    if "head" in spec:
        out["head"] = tuple(spec["head"])
    if cfg.enc_layers:
        out["enc_blocks"] = _stack_spec(spec["enc_blocks"])
        out["enc_ln"] = tuple(spec["enc_ln"])
        out["cross"] = _stack_spec(spec["cross"])
        out["ln_cross"] = tuple(spec["ln_cross"])
    if "lead" in spec:
        out["lead"] = _stack_spec(spec["lead"])
    return out


def is_fsdp_leaf(spec_leaf) -> bool:
    """Whether a leaf's spec names the fsdp dim."""
    return any(d == "fsdp" for d in spec_leaf)


def fsdp_block_paths(cfg: ModelConfig, tp: int = 1) -> frozenset:
    """The paths within a period (``("b0", "attn", "wq")``, ...) of the
    leaves FSDP gathers: none unless ``cfg.fsdp``."""
    if not cfg.fsdp:
        return frozenset()
    return frozenset(path for path, s in _flat(period_spec(cfg, tp))
                     if is_fsdp_leaf(s))


def _flat(tree, prefix=()):
    """``[(path, spec tuple)]`` of a spec tree."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def fsdp_dim(spec_leaf) -> int:
    """The dim a leaf's spec shards over the data axes."""
    return list(spec_leaf).index("fsdp")


class FsdpGather(torch.autograd.Function):
    """The reference's per-period ``lax.all_gather(tiled=True)`` of one
    FSDP leaf over the whole data axis, on the stacked mesh.

    Forward: the held-once leaf ``x`` as M positions' copies, ``[M,
    ...]``, a broadcast view.  Backward: the transpose, a tiled
    reduce-scatter of the stacked gradient ``[M, ...]`` along ``dim``
    over one stage of degree M (``transport``, built on
    ``ButterflyPlan(M, (M,))``): position j receives chunk j of the sum,
    the members added in member order, and the M chunks laid end to end
    along ``dim`` are the held-once leaf's gradient.  One exchange."""

    @staticmethod
    def forward(ctx, x, dim, transport):
        ctx.dim, ctx.transport = dim, transport
        return x.unsqueeze(0).expand((transport.num_nodes,) + tuple(x.shape))

    @staticmethod
    def backward(ctx, g):
        m, dim = ctx.transport.num_nodes, ctx.dim
        if m == 1:
            return g[0], None, None
        if g.shape[1 + dim] % m:
            raise ValueError(f"fsdp dim {dim} of {tuple(g.shape[1:])} does "
                             f"not split over {m} data positions")
        shards = ctx.transport.reduce_scatter(
            0, g.movedim(1 + dim, 1).contiguous())       # [M, n / M, ...]
        full = shards.reshape((-1,) + tuple(shards.shape[2:]))
        return full.movedim(0, dim), None, None


def fsdp_gather(params: Tree, spec: Tree, transport) -> Tree:
    """A period's leaves with every ``"fsdp"`` leaf gathered
    (:class:`FsdpGather`) and the rest as given."""
    if isinstance(spec, dict):
        return {k: fsdp_gather(params[k], spec[k], transport) for k in spec}
    if is_fsdp_leaf(spec):
        return FsdpGather.apply(params, fsdp_dim(spec), transport)
    return params
