"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8), MoE 40e
top-8, expert d_ff=512, vocab=49155 [hf:ibm-granite family].

High top-k (8 of 40) => much denser expert traffic than arctic's 2 of 128 —
the contrasting point on the expert-exchange sparsity curve.  40 experts pad
to 48 for TP=16 (3 per device; router masks the pads).  24 heads pad to 32.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv=8, d_ff=512,
    vocab=49155, head_dim=64,
    pattern=("attn",), ffn_pattern=("moe",),
    n_experts=40, top_k=8, expert_d_ff=512,
    rope_theta=1e4, act="silu", tie_embeddings=True,
)
