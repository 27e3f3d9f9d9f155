"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8e top-2 on every layer, sliding-window attention.
[hf:mistralai/Mixtral-8x7B-v0.1; unverified]

Added as the search-tractable MoE reference for the config-zoo sweep:
8 experts keep the traced superblock small enough that exact fusion
search (``optimal_cuts``/frontier DP) completes where llama4's 128-expert
fan-out only admits the heuristic searchers.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=32_000,
    layer_pattern=("attn_local",),
    window_size=4096,
    n_experts=8,
    top_k=2,
    moe_every=1,
    moe_offset=0,
    ffn_act="swiglu",
    rope_theta=1_000_000.0,
)
