"""falcon-mamba-7b [ssm] — 64L d_model=4096 attn-free d_ff=0 vocab=65024,
ssm_state=16 (mamba-1).  [arXiv:2410.05355; unverified]

Pure Mamba-1: every block is mixer-only (no FFN sublayer — ``d_ff=0``);
d_inner = 2*4096 = 8192, dt_rank = 256.  O(1) state in context length =>
the flagship long_500k architecture.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    vocab_size=65_024,
    layer_pattern=("mamba",),
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    tie_embeddings=True,
)
