"""Meta-device stand-ins for every (arch x input shape) pair (reference: ``repro.launch.specs``).

The reference hands ``jax.ShapeDtypeStruct`` trees to its lowering; the
port hands tensors on the meta device to its step functions, which run
on them for shapes and dtypes only, allocating nothing.  A VLM's patch
embeddings and an encoder-decoder's frames are stub inputs of the
backbone's width, as in the reference.  Token ids are the one exception:
the batches carry seeded Zipf ids as host numpy arrays, as a user's
batch arrives (the steps move them to the mesh's device, where on meta
only their shape is kept).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs import InputShape
from repro_torch.data.pipeline import zipf_tokens
from repro_torch.models.common import ModelConfig
from repro_torch.optim.adamw import AdamW
from repro_torch.train.step import MeshCtx, init_cache_global

META = torch.device("meta")


def meta(shape, dtype) -> torch.Tensor:
    """A meta tensor of ``shape`` and ``dtype``."""
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype,
                       device=META)


def _ids(cfg: ModelConfig, b: int, t: int, seed: int) -> np.ndarray:
    return zipf_tokens(np.random.RandomState(seed), (b, t), cfg.vocab)


def train_batch_specs(cfg: ModelConfig, shape: InputShape,
                      seed: int = 0) -> Dict[str, Any]:
    """tokens / labels [B, T - img_tokens] (host Zipf ids), the stub
    image embeddings / encoder frames (meta, float32)."""
    b, t = shape.global_batch, shape.seq_len
    t_text = t - cfg.img_tokens if cfg.img_tokens else t
    out = {"tokens": _ids(cfg, b, t_text, seed),
           "labels": _ids(cfg, b, t_text, seed + 1)}
    return _frontend(cfg, b, out)


def prefill_batch_specs(cfg: ModelConfig, shape: InputShape,
                        seed: int = 0) -> Dict[str, Any]:
    """A prefill batch: the train batch without labels."""
    b, t = shape.global_batch, shape.seq_len
    t_text = t - cfg.img_tokens if cfg.img_tokens else t
    return _frontend(cfg, b, {"tokens": _ids(cfg, b, t_text, seed)})


def _frontend(cfg: ModelConfig, b: int, out: Dict[str, Any]):
    if cfg.img_tokens:
        out["img_embeds"] = meta((b, cfg.img_tokens, cfg.d_model),
                                 torch.float32)
    if cfg.enc_layers:
        out["enc_frames"] = meta((b, cfg.enc_seq, cfg.d_model),
                                 torch.float32)
    return out


def params_specs(cfg: ModelConfig, tp: int):
    """The parameter tree at tp on the meta device."""
    from repro_torch.models import transformer as T
    return T.init_params(cfg, tp, device=META)


def opt_specs(cfg: ModelConfig, tp: int, params=None):
    """AdamW's state (float32 moments) of the parameter tree, on meta."""
    return AdamW().init(params if params is not None
                        else params_specs(cfg, tp))


def decode_arg_specs(cfg: ModelConfig, shape: InputShape, mc: MeshCtx,
                     seq_sharded: bool):
    """``(token, pos, cache, extras)`` of one decode step of the shape's
    global batch: ids and positions [B] (meta int64), the cache (either
    layout: ``init_cache_global``), and an encoder-decoder's cross cache."""
    b = shape.global_batch
    cache = init_cache_global(cfg, mc, b, shape.seq_len, seq_sharded)
    token, pos = meta((b,), torch.int64), meta((b,), torch.int64)
    extras = ()
    if cfg.enc_layers:
        kvg = cfg.kv_local(mc.tp) * mc.tp
        extras = (tuple(meta((cfg.n_periods, b, cfg.enc_seq, kvg, cfg.hd),
                             cfg.dtype) for _ in range(2)),)
    return token, pos, cache, extras
