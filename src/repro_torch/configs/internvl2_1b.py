"""internvl2-1b [vlm] — 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655, InternViT + LM decoder.  [arXiv:2404.16821; hf]

The vision tower is a STUB per the task spec: ``input_specs()`` provides
256 precomputed patch embeddings (`frontend_len`) prefixed to the token
stream; labels over the patch prefix are -1 (ignored by the loss).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151_655,
    ffn_act="swiglu",
    frontend="vision",
    frontend_len=256,
    rope_theta=1_000_000.0,
)
