"""qwen1.5-0.5b [dense]: 24L d_model=1024 16H (GQA kv=16) d_ff=2816
vocab=151936 — QKV bias [hf:Qwen/Qwen1.5-0.5B].

Smallest assigned model: gradient sync is latency-dominated, which is
exactly the paper's heterogeneous-degree tuning regime (packet floor).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv=16, d_ff=2816,
    vocab=151936, head_dim=64,
    pattern=("attn",), ffn_pattern=("dense",),
    qkv_bias=True, rope_theta=1e6, act="silu", tie_embeddings=True,
)
