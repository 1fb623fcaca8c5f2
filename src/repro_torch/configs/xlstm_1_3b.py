"""xlstm-1.3b [ssm]: 48L d_model=2048 4H d_ff=0 vocab=50304 — sLSTM + mLSTM
blocks [arXiv:2405.04517].

Period of 8: seven mLSTM (chunkwise-parallel matrix memory) + one sLSTM
(sequential scalar memory with true recurrence).  d_ff=0 per the
assignment: blocks carry their own projections, no separate FFN.
mLSTM value dim shards over "model"; sLSTM runs replicated (DESIGN §ssm).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv=4, d_ff=0,
    vocab=50304, head_dim=512,
    pattern=("mlstm",) * 7 + ("slstm",),
    ffn_pattern=("none",) * 8,
    act="gelu", tie_embeddings=True,
)
