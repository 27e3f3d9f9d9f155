"""qwen3-0.6b [dense] — 28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936, qk-norm.  [hf:Qwen/Qwen3-8B; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151_936,
    qk_norm=True,
    ffn_act="swiglu",
    rope_theta=1_000_000.0,
)
