"""gemma3-27b [dense] — 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144, 5:1 local:global, 128k context.  [hf:google/gemma-3-1b-pt]

Five sliding-window (1024) layers per global layer => only ~1/6 of the
layers hold an unbounded KV cache; this is what qualifies gemma3 for the
long_500k cell (the global layers' 500k KV shards over the data axis).
62 = 10 full (5 local + 1 global) periods + 2 remainder local layers —
exercised by the segment-remainder path of the trunk.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21_504,
    vocab_size=262_144,
    layer_pattern=(
        "attn_local", "attn_local", "attn_local", "attn_local", "attn_local", "attn",
    ),
    window_size=1024,
    qk_norm=True,
    ffn_act="geglu",
    rope_theta=1_000_000.0,
)
