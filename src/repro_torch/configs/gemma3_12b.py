"""gemma3-12b [dense]: 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144 — 5:1 local:global sliding window, 128k context
[hf:google/gemma-3-1b-pt family].

Period of 6 layers: five local (window 1024) + one global (full attention).
The 262k vocabulary is the flagship sparse-embedding-gradient-sync case for
the paper's primitive.  long_500k decode runs: local layers use the window,
the global layer uses sequence-sharded split-KV decode.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv=8, d_ff=15360,
    vocab=262144, head_dim=256,
    pattern=("attn",) * 6, ffn_pattern=("dense",) * 6,
    window=1024, window_pattern=(1024, 1024, 1024, 1024, 1024, 0),
    rope_theta=1e6, act="gelu", tie_embeddings=True,
)
