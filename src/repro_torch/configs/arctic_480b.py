"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128e top-2 + dense residual [hf:Snowflake/snowflake-arctic-base].

Dense-MoE hybrid: every layer has a (small) dense residual FFN *in parallel*
with a 128-expert top-2 MoE.  128 experts top-2 is the most extreme
power-law token->expert exchange in the pool — the all_to_all dispatch is
structurally one butterfly layer of the paper's network.  56 heads pad to 64
for TP=16 (4 per device; padding FLOPs charged in the roofline).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv=8, d_ff=4864,
    vocab=32000, head_dim=128,
    pattern=("attn",), ffn_pattern=("moe+dense",),
    n_experts=128, top_k=2, expert_d_ff=4864,
    rope_theta=1e4, act="silu", tie_embeddings=True, fsdp=True,
)
