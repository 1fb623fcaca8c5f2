"""Spec trees of the dense attention family (reference: ``repro.models.sharding``).

Each leaf's entry is a tuple over its dims: ``"model"`` (the tensor
parallel axis), ``"fsdp"`` (sharded over the data axes when
``cfg.fsdp``) or ``None`` (replicated); ``full_model_spec_tuples``
prepends the period-stack dim.  The port runs at tp = 1 without FSDP, so
the trees only classify leaves: the gradient sync and the grad norm read
them, as the reference's do.  Block kinds other than attention with a
dense FFN raise (ROADMAP Queue 1 items 16-18).
"""
from __future__ import annotations

from typing import Any, Dict

from .common import ModelConfig

Tree = Dict[str, Any]

_MISSING = {"mamba": ("models/ssm.py", 17), "mlstm": ("models/ssm.py", 17),
            "slstm": ("models/ssm.py", 17), "moe": ("models/moe.py", 16),
            "moe+dense": ("models/moe.py", 16)}


def unported(kind: str) -> NotImplementedError:
    """The error for a block or FFN kind the port does not have yet."""
    module, item = _MISSING.get(kind, ("its module", 16))
    return NotImplementedError(
        f"block kind {kind!r} needs {module}, not ported yet (ROADMAP "
        f"Queue 1 item {item})")


def check_dense_family(cfg: ModelConfig) -> None:
    """Raise for what the port's models do not cover yet: blocks other
    than attention, FFNs other than dense, an encoder, image tokens,
    FSDP."""
    for blk in cfg.pattern:
        if blk != "attn":
            raise unported(blk)
    for ffn in cfg.ffn_pattern:
        if ffn != "dense":
            raise unported(ffn)
    if cfg.enc_layers or cfg.img_tokens:
        raise NotImplementedError(
            "encoder-decoder and VLM stubs (enc_layers, img_tokens) are not "
            "ported yet (ROADMAP Queue 1 item 18)")
    if cfg.fsdp:
        raise NotImplementedError(
            "fsdp=True is not ported yet (ROADMAP Queue 1 item 19)")


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


def period_spec(cfg: ModelConfig, tp: int) -> Tree:
    """One period of blocks."""
    check_dense_family(cfg)
    return {f"b{j}": {"ln1": (None,), "attn": attn_spec(cfg, tp),
                      "ln2": (None,), "ffn": ffn_spec(cfg, tp)}
            for j in range(len(cfg.pattern))}


def model_spec(cfg: ModelConfig, tp: int) -> Tree:
    """The model's spec tree (blocks without the period dim)."""
    s: Tree = {"emb": ("model", None), "final_ln": (None,),
               "blocks": period_spec(cfg, tp)}
    if not cfg.tie_embeddings:
        s["head"] = (None, "model")
    return s


def full_model_spec_tuples(cfg: ModelConfig, tp: int) -> Tree:
    """Spec tuples mirroring ``init_params`` (blocks with the period dim
    prepended): what the gradient sync classifies leaves by."""
    spec = model_spec(cfg, tp)

    def stack(t):
        if isinstance(t, dict):
            return {k: stack(v) for k, v in t.items()}
        return (None,) + tuple(t)

    out = {"emb": tuple(spec["emb"]), "final_ln": tuple(spec["final_ln"]),
           "blocks": stack(spec["blocks"])}
    if "head" in spec:
        out["head"] = tuple(spec["head"])
    return out


def is_fsdp_leaf(spec_leaf) -> bool:
    """Whether a leaf's spec names the fsdp dim."""
    return any(d == "fsdp" for d in spec_leaf)
