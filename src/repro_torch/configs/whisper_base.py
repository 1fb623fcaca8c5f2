"""whisper-base [audio]: 6L d_model=512 8H d_ff=2048 vocab=51865 — enc-dec,
conv frontend STUB [arXiv:2212.04356].

Per the brief the mel-spectrogram + conv feature extractor is stubbed:
``input_specs`` provides 1500 precomputed frame embeddings at d_model.  This
config is the transformer backbone: 6 encoder + 6 decoder layers with
cross-attention.  Deviation: positions extend past the model card's 448
decoder slots to honor the assigned 32k decode shape; long_500k is SKIPPED
(full-attention enc-dec, no sub-quadratic variant in the family).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv=8, d_ff=2048,
    vocab=51865, head_dim=64,
    pattern=("attn",), ffn_pattern=("dense",),
    enc_layers=6, enc_seq=1500,
    rope_theta=1e4, act="gelu", tie_embeddings=True,
)
