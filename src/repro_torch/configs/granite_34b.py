"""granite-34b [dense] — 88L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152, code model.  [arXiv:2405.04324; hf]

GPTBigCode-style MQA with a wide 4x GELU FFN; the 88-layer depth makes it
the longest fusion chain the evaluator sees (and the scan-over-layers
compile-time stress test).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24_576,
    vocab_size=49_152,
    ffn_act="gelu",
)
