"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16e top-2 — Mamba+attn 1:7 interleave, MoE
[arXiv:2403.19887].

Period of 8 layers: one attention layer (position 3) among seven Mamba
layers; MoE replaces the dense FFN on every other layer (jamba's e/2).
FSDP over the data axes (398B params cannot replicate).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv=8, d_ff=24576,
    vocab=65536, head_dim=128,
    pattern=("mamba", "mamba", "mamba", "attn",
             "mamba", "mamba", "mamba", "mamba"),
    ffn_pattern=("dense", "moe", "dense", "moe",
                 "dense", "moe", "dense", "moe"),
    n_experts=16, top_k=2, expert_d_ff=24576,
    ssm_state=16, ssm_conv=4,
    rope_theta=1e6, act="silu", tie_embeddings=True, fsdp=True,
)
