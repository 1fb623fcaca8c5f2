"""The training cell's parameter tree, drawn on the device from the seed.

The benchmark fixes the tree itself, from the configuration's published
sizes (``decoder_tree``), and checks that the program's tree has the same
paths, shapes and dtypes before it hands the weights over.  Each leaf is
one draw on its own generator stream (``leaf``), so the plain reference
can draw any leaf again from the seed alone: matrices normal with
variance 1 / fan-in, the zero-centred norm gains 0.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from portbench import generate

Path = Tuple[str, ...]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def padded_vocab(cfg: dict) -> int:
    """The vocabulary rounded up to ``vocab_pad_multiple`` rows."""
    k = int(cfg["vocab_pad_multiple"])
    return -(-int(cfg["vocab_size"]) // k) * k


def decoder_tree(cfg: dict) -> Dict[Path, Tuple[Tuple[int, ...], torch.dtype]]:
    """``{path: (shape, dtype)}`` of an untied MoE decoder whose layers
    are stacked over their depth: attention ``wq`` / ``wk`` / ``wv`` /
    ``wo``, the router (float32) and the experts' ``w1`` / ``w3`` /
    ``w2``, the float32 norm gains, the embedding and the head."""
    d = int(cfg["hidden_size"])
    hd = d // int(cfg["num_attention_heads"])
    hq = int(cfg["num_attention_heads"]) * hd
    kv = int(cfg["num_key_value_heads"]) * hd
    n = int(cfg["num_hidden_layers"])
    e, ff = int(cfg["num_local_experts"]), int(cfg["intermediate_size"])
    vp = padded_vocab(cfg)
    dt = DTYPES[cfg["torch_dtype"]]
    f32 = torch.float32
    b = ("blocks", "b0")
    return {
        ("emb",): ((vp, d), dt),
        ("head",): ((d, vp), dt),
        ("final_ln",): ((d,), f32),
        b + ("ln1",): ((n, d), f32),
        b + ("ln2",): ((n, d), f32),
        b + ("attn", "wq"): ((n, d, hq), dt),
        b + ("attn", "wk"): ((n, d, kv), dt),
        b + ("attn", "wv"): ((n, d, kv), dt),
        b + ("attn", "wo"): ((n, hq, d), dt),
        b + ("moe", "router"): ((n, d, e), f32),
        b + ("moe", "w1"): ((n, e, d, ff), dt),
        b + ("moe", "w3"): ((n, e, d, ff), dt),
        b + ("moe", "w2"): ((n, e, ff, d), dt),
    }


def is_gain(path: Path) -> bool:
    return path[-1] in ("ln1", "ln2", "final_ln")


def leaf(path: Path, shape, dtype, seed: int, device) -> torch.Tensor:
    """One leaf: zeros for a norm gain, else a normal draw over its
    fan-in (the row count of a matrix, the width of an embedding row),
    drawn in float32 on the leaf's own stream and cast to ``dtype``."""
    if is_gain(path):
        return torch.zeros(shape, dtype=dtype, device=device)
    stream = 1000 + sum((i + 1) * ord(c) for i, c in enumerate("/".join(path)))
    gen = generate.generator(seed, device, stream=stream)
    fan_in = shape[-1] if path == ("emb",) else shape[-2]
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    w.mul_(1.0 / math.sqrt(fan_in))
    return w.to(dtype)


def nest(flat: Dict[Path, torch.Tensor]) -> dict:
    """The dict tree of ``{path: tensor}``."""
    out: dict = {}
    for p, t in flat.items():
        node = out
        for k in p[:-1]:
            node = node.setdefault(k, {})
        node[p[-1]] = t
    return out
