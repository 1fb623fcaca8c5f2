"""Moonlight-16B-A3B [moe, DeepSeek-V3 layout]: 27L d_model=2048, layer 0
dense (SwiGLU 11264), layers 1-26 MoE of 64 routed experts (width 1408,
top-6, sigmoid router with a correction bias, weights normalised and x
2.446) plus 2 shared experts (one SwiGLU of width 2816), MLA with 16
heads (128 nope + 64 rope query and key columns, a 512-wide latent, 128
value columns, no q latent), rope theta 5e4, RMS eps 1e-5, vocab 163840
untied [hf:moonshotai/Moonlight-16B-A3B, config.json].

The port's own configuration (not in the reference's registry, so not in
``ARCHS``).  Every expert is held; ``experts_held`` / ``expert_first``
give a card its expert-parallel share.  The correction bias starts at 0,
as in pre-training, whose update rule the port does not run.  RoPE
rotates halves, not the published interleaved pairs (``models.mla``).
"""
from repro_torch.models.common import DeepSeekV3Config

CONFIG = DeepSeekV3Config(
    name="moonlight-16b-a3b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv=16, d_ff=2 * 1408,
    vocab=163840,
    pattern=("mla",), ffn_pattern=("moe+dense",),
    n_experts=64, top_k=6, expert_d_ff=1408,
    rope_theta=5e4, act="silu", norm_eps=1e-5, tie_embeddings=False,
    q_nope_dim=128, q_rope_dim=64, kv_rank=512, v_dim=128,
    lead_dense=1, lead_d_ff=11264, router_scale=2.446, aux_alpha=1e-4,
)
