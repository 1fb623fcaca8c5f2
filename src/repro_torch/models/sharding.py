"""Spec trees of every block kind (reference: ``repro.models.sharding``).

Each leaf's entry is a tuple over its dims: ``"model"`` (the tensor
parallel axis), ``"fsdp"`` (sharded over the data axes when
``cfg.fsdp``) or ``None`` (replicated); ``full_model_spec_tuples``
prepends the period-stack dim.  The port runs at tp = 1 without FSDP, so
the trees only classify leaves: the gradient sync and the grad norm read
them, as the reference's do.  :func:`check_ported` raises for what the
port's models do not cover yet (ROADMAP Queue 1 items 18-20).
"""
from __future__ import annotations

from typing import Any, Dict

from .common import ModelConfig

Tree = Dict[str, Any]


def check_ported(cfg: ModelConfig, tp: int = 1) -> None:
    """Raise for an encoder or image tokens (item 18), FSDP (item 19) or
    a model axis (item 20); every block and FFN kind is ported."""
    if cfg.enc_layers or cfg.img_tokens:
        raise NotImplementedError(
            "encoder-decoder and VLM stubs (enc_layers, img_tokens) are not "
            "ported yet (ROADMAP Queue 1 item 18)")
    if cfg.fsdp:
        raise NotImplementedError(
            "fsdp=True is not ported yet (ROADMAP Queue 1 item 19)")
    if tp != 1:
        raise NotImplementedError(
            "the model axis (tp > 1) is not ported yet (ROADMAP Queue 1 "
            "item 20)")


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


BLOCK_SPECS = {"attn": attn_spec, "mamba": mamba_spec,
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
    return out


def is_fsdp_leaf(spec_leaf) -> bool:
    """Whether a leaf's spec names the fsdp dim."""
    return any(d == "fsdp" for d in spec_leaf)
