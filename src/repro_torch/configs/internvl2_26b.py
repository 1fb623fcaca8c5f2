"""internvl2-26b [vlm]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553 — InternViT + InternLM2 [arXiv:2404.16821].

Per the brief, the vision frontend (InternViT-6B + MLP projector) is a STUB:
``input_specs`` provides 1024 precomputed patch embeddings at d_model; this
config is the InternLM2-20B language backbone that consumes them.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv=8, d_ff=16384,
    vocab=92553, head_dim=128, img_tokens=1024,
    pattern=("attn",), ffn_pattern=("dense",),
    rope_theta=1e6, act="silu", tie_embeddings=True, fsdp=True,
)
