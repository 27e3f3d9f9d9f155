"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16e top-2, Mamba:attn 7:1.  [arXiv:2403.19887]

Jamba period-8 block: one attention layer (index 3) per seven Mamba
layers; MoE replaces the dense MLP on every other layer.  72 = 9 periods.
Mamba layers make the model O(state) in context => long_500k runs; the
9 attention layers' 500k KV (batch 1) shards its sequence axis over the
data axis (sequence parallelism).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24_576,
    vocab_size=65_536,
    layer_pattern=(
        "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba", "mamba",
    ),
    n_experts=16,
    top_k=2,
    moe_every=2,
    moe_offset=1,
    ffn_act="swiglu",
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
)
