"""Analytic per-card memory model (reference: ``repro.launch.memmodel``).

The reference's arithmetic on the port's spec trees, per mesh position
(one card of a job with one card a position):

  params    -- exact: every leaf of the meta parameter tree divided by its
               spec's shard count (``model`` -> tp, ``fsdp`` -> the data
               positions when ``cfg.fsdp``)
  optimizer -- 2 x the float32 parameters (AdamW's m and v)
  grads     -- 2 x the float32 parameters (accumulator and current)
  acts      -- the period residuals plus one block's working set (the
               attention chunk's scores, the FFN / MoE dispatch buffers,
               the SSM's chunk tensors), or at serving the KV cache and a
               step's activations
  logits    -- a microbatch's float32 logits, vocab-sharded

``fits`` is judged against the H100's 80 GB (``core.netmodel.HBM_BYTES``).
"""
from __future__ import annotations

import math
from typing import Dict

from repro_torch.configs import InputShape
from repro_torch.core.netmodel import HBM_BYTES
from repro_torch.models.common import ModelConfig
from repro_torch.models.sharding import full_model_spec_tuples
from repro_torch.models.transformer import padded_vocab, tree_leaves
from repro_torch.train.step import MeshCtx


def _divisor(spec, cfg: ModelConfig, mc: MeshCtx) -> int:
    div = 1
    for entry in spec:
        if entry == "model":
            div *= mc.tp
        elif entry == "fsdp" and cfg.fsdp:
            div *= mc.dp
    return div


def params_bytes_per_device(cfg: ModelConfig, mc: MeshCtx) -> float:
    """Bytes of one position's parameter shards."""
    from .specs import params_specs
    params = params_specs(cfg, mc.tp)
    spec = dict(tree_leaves(full_model_spec_tuples(cfg, mc.tp)))
    return float(sum(t.numel() * t.element_size() / _divisor(spec[p], cfg, mc)
                     for p, t in tree_leaves(params)))


def modeled_memory(cfg: ModelConfig, shape: InputShape, mc: MeshCtx,
                   micro: int = 1) -> Dict[str, float]:
    """The reference's per-device model: bytes by part and ``total``."""
    tp, dp = mc.tp, mc.dp
    pb = params_bytes_per_device(cfg, mc)
    f32_params = pb * (4.0 / cfg.dtype.itemsize)
    out: Dict[str, float] = {"params": pb}
    d = cfg.d_model
    b_loc = max(1, shape.global_batch // dp)
    if shape.kind == "train":
        out["optimizer"] = 2.0 * f32_params
        out["grads"] = 2.0 * f32_params
        tok_mb = (b_loc // micro) * shape.seq_len
        resid = cfg.n_layers * 2 * tok_mb * d * 2.0
        hl = cfg.heads_local(tp)
        qc = min(1024, shape.seq_len)
        scores = (tok_mb // shape.seq_len) * hl * qc * shape.seq_len * 4.0
        ffl = max(cfg.d_ff // tp, cfg.expert_d_ff)
        ffn_ws = 3 * tok_mb * ffl * 2.0
        if cfg.n_experts:
            cap_dev = math.ceil(tok_mb * cfg.top_k / tp) * 2
            ffn_ws = max(ffn_ws, 4 * tp * cap_dev * d * 2.0)
        ssm_ws = 6 * tok_mb * (2 * d // tp) * 4.0 if any(
            b in ("mamba", "mlstm", "slstm") for b in cfg.pattern) else 0.0
        out["activations"] = resid + max(scores, ffn_ws, ssm_ws) \
            + 8 * tok_mb * d * 2.0
        out["logits"] = tok_mb * (padded_vocab(cfg, tp) // tp) * 4.0
    else:
        kvg = cfg.kv_local(tp)
        n_attn = sum(1 for b in cfg.pattern if b == "attn") * cfg.n_periods
        s_loc = shape.seq_len // mc.data if shape.kind == "decode_long" \
            else shape.seq_len
        out["kv_cache"] = n_attn * b_loc * s_loc * kvg * cfg.hd * 2 * 2.0
        tok = b_loc * (shape.seq_len if shape.kind == "prefill" else 1)
        out["activations"] = 12 * tok * d * 2.0
        out["logits"] = b_loc * (padded_vocab(cfg, tp) // tp) * 4.0
    out["total"] = sum(out.values())
    return out


def fits(mem: Dict[str, float]) -> bool:
    """Whether a modeled total fits one H100's 80 GB."""
    return mem["total"] < HBM_BYTES
