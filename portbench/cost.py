"""The benchmark's frozen cost arithmetic: the card's peaks, the pairs an
attention mask leaves visible, each attention launch's bound, and the model
FLOPs of a training step and of a prefill.

Copied from the port's ``core/roofline.py`` (``visible_pairs``,
``kernel_cost``, ``model_flops``) so that a change to the program cannot
move the yardstick, with two corrections:

* the attention backward is billed for every tensor it reads and writes
  once: q, out, dout and dq (q-sized), k, v, dk and dv (kv-sized) and the
  float32 logsumexp (the port's copy leaves out ``out``);
* model FLOPs count the attention's own products (QK^T and PV over the
  visible pairs), which ``model_flops`` leaves out, and the embedding
  lookup as no FLOPs.

Configurations are the dicts of ``configs/<name>.json``.
"""
from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, dense, at its 700 W power limit.
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def visible_pairs(Sq: int, Skv: int, causal: bool = True, window: int = 0,
                  chunk: int = 0) -> int:
    """(query, key) pairs the mask leaves visible, queries and keys at
    positions 0..: ``window`` masks ``q - k >= window`` (and ``k - q >=
    window`` when not causal); ``chunk`` keeps pairs in one ``chunk``-wide
    block."""
    q = np.arange(Sq, dtype=np.int64)
    lo = np.zeros(Sq, dtype=np.int64)
    hi = np.full(Sq, Skv, dtype=np.int64)
    if causal:
        hi = np.minimum(hi, q + 1)
    if window:
        lo = np.maximum(lo, q - window + 1)
        if not causal:
            hi = np.minimum(hi, q + window)
    elif chunk:
        lo = np.maximum(lo, q // chunk * chunk)
        hi = np.minimum(hi, (q // chunk + 1) * chunk)
    return int(np.maximum(hi - lo, 0).sum())


def attention_cost(B: int, Sq: int, Skv: int, H: int, KV: int, hd: int, *,
                   itemsize: int, causal: bool = True, window: int = 0,
                   chunk: int = 0, backward: bool = False,
                   lse: bool = False) -> tuple[int, int]:
    """(FLOPs, bytes) of one flash-attention launch, each input read once
    and each output written once.  Forward: 4 hd FLOPs a visible pair and
    head (QK^T and PV); reads q, k, v, writes out (and the float32
    logsumexp with ``lse``).  Backward: 10 hd FLOPs a visible pair and head
    (the recomputed QK^T, dV, dP, dQ, dK); reads q, k, v, out, dout and the
    logsumexp, writes dq, dk, dv."""
    pairs = visible_pairs(Sq, Skv, causal, window, chunk)
    n_q, n_kv, n_lse = B * Sq * H * hd, B * Skv * KV * hd, B * H * Sq
    if backward:
        return 10 * B * H * hd * pairs, itemsize * (4 * n_q + 4 * n_kv) + 4 * n_lse
    return 4 * B * H * hd * pairs, itemsize * (2 * n_q + 2 * n_kv) + (4 * n_lse if lse else 0)


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time the card takes: the larger of the compute and the
    memory bound."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def is_moe_layer(cfg: dict, i: int) -> bool:
    return cfg.get("n_experts", 0) > 1 and i % cfg.get("moe_every", 1) == cfg.get("moe_offset", 0)


def layer_matmul_params(cfg: dict, i: int) -> int:
    """Weights of layer ``i`` that one token multiplies: the attention's
    four projections, then the dense MLP or the router and ``top_k``
    experts (swiglu: three matrices, else two)."""
    d, hd = cfg["d_model"], head_dim(cfg)
    q_dim, kv_dim = cfg["n_heads"] * hd, cfg["n_kv_heads"] * hd
    attn = d * q_dim + 2 * d * kv_dim + q_dim * d
    mats = 3 if cfg.get("ffn_act", "swiglu") in ("swiglu", "geglu") else 2
    mlp = mats * d * cfg["d_ff"]
    if is_moe_layer(cfg, i):
        return attn + d * cfg["n_experts"] + cfg["top_k"] * mlp
    return attn + mlp


def attention_pairs(cfg: dict, i: int, S: int) -> int:
    """Visible pairs of layer ``i``'s causal self-attention over ``S``
    tokens (its window when the layer is a local one)."""
    pattern = cfg.get("layer_pattern", ["attn"])
    window = cfg.get("window_size", 0) if pattern[i % len(pattern)] == "attn_local" else 0
    return visible_pairs(S, S, True, window)


def train_model_flops(cfg: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step over ``batch`` sequences of ``seq``
    tokens: 6 x the multiplied weights x tokens (the head's too) plus 12 hd
    x heads x visible pairs per layer and sequence (QK^T and PV, forward and
    backward).  Recomputation is not counted."""
    tokens = batch * seq
    n = sum(layer_matmul_params(cfg, i) for i in range(cfg["n_layers"]))
    n += cfg["d_model"] * cfg["vocab_size"]
    attn = sum(attention_pairs(cfg, i, seq) for i in range(cfg["n_layers"]))
    return 6.0 * n * tokens + 12.0 * head_dim(cfg) * cfg["n_heads"] * attn * batch


def prefill_model_flops(cfg: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one prefill of ``batch`` prompts of ``seq`` tokens:
    2 x the multiplied weights x tokens, the head at the last position of
    each prompt, and 4 hd x heads x visible pairs per layer and prompt."""
    n = sum(layer_matmul_params(cfg, i) for i in range(cfg["n_layers"]))
    attn = sum(attention_pairs(cfg, i, seq) for i in range(cfg["n_layers"]))
    return (2.0 * n * batch * seq + 2.0 * cfg["d_model"] * cfg["vocab_size"] * batch
            + 4.0 * head_dim(cfg) * cfg["n_heads"] * attn * batch)
