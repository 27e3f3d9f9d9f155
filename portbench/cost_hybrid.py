"""The frozen cost arithmetic of a hybrid configuration (Mamba-1 mixers
beside attention): the model FLOPs of a prefill and the bytes of the
selective scan (K4).

Model FLOPs count the products: 2 a weight and token of every matrix a
token multiplies (the attention's four projections, or the Mamba mixer's
``in_proj``, ``x_proj``, ``dt_proj`` and ``out_proj``; the dense MLP, or
the router and ``top_k`` experts), the head at each prompt's last
position, and 4 hd x heads a visible pair of each attention layer (QK^T and
PV).  The convolution, the discretisation and the scan are not counted: they
are elementwise work and a recurrence, bound by memory, not products.

The scan's bytes are what one launch must move: dA and dBx read as
float32 (B, S, di, ds), C read (B, S, ds), y written (B, S, di), and the
state read and written (B, di, ds) each.  Configurations are the dicts of
``configs/<name>.json``.
"""
from __future__ import annotations

from . import cost
from .weights_hybrid import d_inner, dt_rank, is_mamba


def mamba_matmul_params(cfg: dict) -> int:
    """Weights of one Mamba mixer that a token multiplies."""
    d, di, ds, dr = cfg["d_model"], d_inner(cfg), cfg["ssm_state"], dt_rank(cfg)
    return d * 2 * di + di * (dr + 2 * ds) + dr * di + di * d


def layer_matmul_params(cfg: dict, i: int) -> int:
    """Weights of layer ``i`` that one token multiplies: its mixer's and its
    feed-forward's (``cost.layer_matmul_params`` with the Mamba mixer in
    place of the attention's projections)."""
    n = cost.layer_matmul_params(cfg, i)
    if not is_mamba(cfg, i):
        return n
    d, hd = cfg["d_model"], cost.head_dim(cfg)
    q_dim, kv_dim = cfg["n_heads"] * hd, cfg["n_kv_heads"] * hd
    return n - (d * q_dim + 2 * d * kv_dim + q_dim * d) + mamba_matmul_params(cfg)


def prefill_model_flops(cfg: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one prefill of ``batch`` prompts of ``seq`` tokens."""
    n = sum(layer_matmul_params(cfg, i) for i in range(cfg["n_layers"]))
    pairs = sum(cost.visible_pairs(seq, seq) for i in range(cfg["n_layers"])
                if not is_mamba(cfg, i))
    return (2.0 * n * batch * seq + 2.0 * cfg["d_model"] * cfg["vocab_size"] * batch
            + 4.0 * cost.head_dim(cfg) * cfg["n_heads"] * pairs * batch)


def scan_bytes(cfg: dict, tokens: int, scans: int, batch: int) -> float:
    """Bytes the selective scan moves over ``tokens`` (B x S summed over its
    calls) in ``scans`` calls of ``batch`` rows each."""
    di, ds = d_inner(cfg), cfg["ssm_state"]
    per_token = 4 * (2 * di * ds + ds + di)
    return float(tokens) * per_token + float(scans) * batch * 2 * 4 * di * ds
