"""command-r-plus-104b [dense]: 64L d_model=12288 96H (GQA kv=8)
d_ff=33792 vocab=256000 — GQA, no-bias [hf:CohereForAI/c4ai-command-r].

Largest dense assigned arch: TP-dominant, the collective-bound roofline
case.  FSDP over the data axes (104B params cannot replicate).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv=8, d_ff=33792,
    vocab=256000, head_dim=128,
    pattern=("attn",), ffn_pattern=("dense",),
    rope_theta=75e5, act="silu", tie_embeddings=True, fsdp=True,
)
