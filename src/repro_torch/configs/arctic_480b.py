"""arctic-480b [moe] — 35L d_model=7168 56H (GQA kv=8) d_ff=4864
vocab=32000, MoE 128e top-2 + dense residual.
[hf:Snowflake/snowflake-arctic-base; hf]

Snowflake Arctic's dense-MoE hybrid: every layer runs a 128-expert top-2
MoE **in parallel with** a dense residual MLP (``dense_residual_ff``).
Total params: 35 x 128 x 3*7168*4864 ~= 469 B experts + trunk ~= 480 B.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32_000,
    n_experts=128,
    top_k=2,
    moe_every=1,
    dense_residual_ff=4864,
    ffn_act="swiglu",
)
