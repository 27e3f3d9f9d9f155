"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128e top-1, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Assumptions beyond the assigned line (documented in DESIGN.md):
* MoE on every *other* layer (alternating dense/MoE, as in the released
  Maverick) — this is also what makes the "400b total / a17b active"
  numbers come out: 24 MoE layers x 128 experts x 3*5120*8192 ~= 386 B.
* iRoPE-style attention: 3 of every 4 layers use chunked-local attention
  (8192-token chunks), the 4th is global — this is the sub-quadratic
  structure that makes the long_500k cell runnable for this arch.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202_048,
    layer_pattern=("attn_chunked", "attn_chunked", "attn_chunked", "attn"),
    chunk_size=8192,
    n_experts=128,
    top_k=1,
    moe_every=2,
    moe_offset=1,
    ffn_act="swiglu",
    rope_theta=500_000.0,
)
