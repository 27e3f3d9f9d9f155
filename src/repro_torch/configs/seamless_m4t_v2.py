"""seamless-m4t-large-v2 [audio] — enc-dec, 24L each side, d_model=1024
16H (MHA kv=16) d_ff=8192 vocab=256206.  [arXiv:2308.11596; hf]

The speech frontend is a STUB per the task spec: the encoder consumes
1024 precomputed frame embeddings (``frontend_len``; ~20 s of speech at
20 ms stride).  Decoder shapes (seq_len x batch) apply to the text
decoder; cross-attention K/V over the encoder output are computed at
prefill and cached.  Positions use RoPE (adaptation from the original
sinusoidal encodings; documented in DESIGN.md).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256_206,
    is_encoder_decoder=True,
    n_enc_layers=24,
    ffn_act="relu",
    frontend="audio",
    frontend_len=1024,
)
