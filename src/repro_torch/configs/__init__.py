"""Config registry: the 10 assigned architectures, input shapes and long-context policy (reference: ``repro.configs``).

Copied as data; ``ModelConfig.dtype`` is a torch dtype here.  The port's
own configurations, which the reference has no model for, are in
``PORT_ARCHS`` (``get_config`` finds both).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.models.common import ModelConfig

from .arctic_480b import CONFIG as _arctic
from .command_r_plus_104b import CONFIG as _commandr
from .gemma3_12b import CONFIG as _gemma3
from .granite_moe_3b import CONFIG as _granite
from .internvl2_26b import CONFIG as _internvl
from .jamba_1_5_large import CONFIG as _jamba
from .moonlight_16b_a3b import CONFIG as _moonlight
from .qwen1_5_0_5b import CONFIG as _qwen
from .starcoder2_15b import CONFIG as _starcoder
from .whisper_base import CONFIG as _whisper
from .xlstm_1_3b import CONFIG as _xlstm

ARCHS: Dict[str, ModelConfig] = {
    "starcoder2-15b": _starcoder,
    "jamba-1.5-large-398b": _jamba,
    "gemma3-12b": _gemma3,
    "qwen1.5-0.5b": _qwen,
    "internvl2-26b": _internvl,
    "arctic-480b": _arctic,
    "xlstm-1.3b": _xlstm,
    "granite-moe-3b-a800m": _granite,
    "command-r-plus-104b": _commandr,
    "whisper-base": _whisper,
}

# the port's own configurations, beside the reference's registry (which
# ``ARCHS`` mirrors field for field): training through the same step
PORT_ARCHS: Dict[str, ModelConfig] = {
    "moonlight-16b-a3b": _moonlight,
}


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode" | "decode_long"


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode_long"),
    # extra shape for SPerf H1 only (the paper's mini-batch regime, SI-A.1):
    # small batches are where embedding gradients are actually sparse.
    "train_minibatch": InputShape("train_minibatch", 64, 16, "train"),
}

# long_500k policy (DESIGN.md §shape-skips):
#   native  — sub-quadratic family (SSM/hybrid) or built-in sliding window
#   swa     — dense arch runs via the explicit sliding-window variant
#   skip    — full-attention family with no sub-quadratic variant
LONG_CTX = {
    "starcoder2-15b": "swa",
    "jamba-1.5-large-398b": "native",
    "gemma3-12b": "native",
    "qwen1.5-0.5b": "swa",
    "internvl2-26b": "skip",     # LM context undefined past 32k; full attn
    "arctic-480b": "swa",
    "xlstm-1.3b": "native",
    "granite-moe-3b-a800m": "swa",
    "command-r-plus-104b": "swa",
    "whisper-base": "skip",      # enc-dec, 448-token decoder family
}

SWA_WINDOW = 4096


def get_config(name: str, variant: Optional[str] = None) -> ModelConfig:
    cfg = ARCHS[name] if name in ARCHS else PORT_ARCHS[name]
    if variant == "swa":
        cfg = dataclasses.replace(
            cfg, window=SWA_WINDOW,
            window_pattern=tuple(SWA_WINDOW for _ in cfg.pattern))
    elif variant == "untied":
        # sparse embedding-grad sync acts on the input table (DESIGN Ssync)
        cfg = dataclasses.replace(cfg, tie_embeddings=False)
    elif variant not in (None, "base"):
        raise ValueError(f"unknown variant {variant!r}")
    return cfg


def pair_plan(arch: str, shape: str) -> Optional[str]:
    """Variant to use for this (arch, shape) pair, or None if skipped."""
    if shape != "long_500k":
        return "base"
    mode = LONG_CTX[arch]
    if mode == "skip":
        return None
    return "swa" if mode == "swa" else "base"


ASSIGNED_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def all_pairs():
    out = []
    for a in ARCHS:
        for s in ASSIGNED_SHAPES:
            out.append((a, s, pair_plan(a, s)))
    return out
