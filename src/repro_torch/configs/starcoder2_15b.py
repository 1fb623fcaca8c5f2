"""starcoder2-15b [dense]: 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152 — GQA, RoPE [arXiv:2402.19173].

Deviation note: starcoder2 uses an ungated gelu MLP; our FFN substrate is
gated (w1*w3), so this config is geglu with the same d_ff (params +50% on
the up-projection; recorded in DESIGN.md deviations).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv=4, d_ff=24576,
    vocab=49152, head_dim=128,
    pattern=("attn",), ffn_pattern=("dense",),
    rope_theta=1e5, act="gelu", tie_embeddings=True,
)
