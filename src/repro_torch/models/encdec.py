"""Encoder-decoder backbone (seamless-m4t-large-v2) — the port of the JAX
package's ``models/encdec.py``.

The audio frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings ``(B, S_enc, d)``.  Encoder layers are
non-causal self-attention (RoPE on) + FFN; decoder layers are causal
self-attention + cross-attention + FFN.  The cross-attention keys and
values are projected from the encoder's output once, at prefill, and kept
in the cache for decoding.

The reference stacks each stack's layers on a leading axis and scans over
it; here ``enc_stack`` and ``dec_stack`` are Python lists of per-layer
parameter dicts, looped over in Python, and the cache holds one
``{"k", "v"}`` per decoder layer for the self-attention (``"self"``) and
the cross-attention (``"xkv"``).  Both are written in place: a prefill
projects the encoder's keys and values straight into the ``"xkv"``
buffers.  ``cache["len"]`` counts decoder tokens only.

On a CUDA tensor every attention with more than one query is the
flash-attention kernel (K2: the encoder's non-causal self-attention, the
decoder's causal one, and cross-attention over the encoder's frames) and
every FFN the fused-MLP kernel (K3); single-query decode attention is
plain PyTorch, as in the reference.  Training (``models.model.loss_fn``)
runs the uncached forward with each encoder and decoder layer under the
run's activation checkpointing (``transformer._remat_wrap``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import ops
from ..parallel import sharding as SH
from . import layers as L


def _init_enc_layer(gen: torch.Generator, cfg, dtype) -> dict:
    dev = gen.device
    return {
        "norm1": L.rmsnorm_init(cfg.d_model, dtype, dev),
        "attn": L.init_attention(gen, cfg, dtype),
        "norm2": L.rmsnorm_init(cfg.d_model, dtype, dev),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.ffn_act, dtype),
    }


def _init_dec_layer(gen: torch.Generator, cfg, dtype) -> dict:
    dev = gen.device
    return {
        "norm1": L.rmsnorm_init(cfg.d_model, dtype, dev),
        "attn": L.init_attention(gen, cfg, dtype),
        "norm_x": L.rmsnorm_init(cfg.d_model, dtype, dev),
        "xattn": L.init_attention(gen, cfg, dtype),
        "norm2": L.rmsnorm_init(cfg.d_model, dtype, dev),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.ffn_act, dtype),
    }


def init_params(gen: torch.Generator, cfg) -> dict:
    """Parameters on ``gen``'s device, in ``cfg.dtype``, drawn from ``gen``
    with the reference's initialisation scales (not its random stream)."""
    dtype = getattr(torch, cfg.dtype)
    dev = gen.device
    return {
        "embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
        "enc_stack": [_init_enc_layer(gen, cfg, dtype) for _ in range(cfg.n_enc_layers)],
        "enc_final_norm": L.rmsnorm_init(cfg.d_model, dtype, dev),
        "dec_stack": [_init_dec_layer(gen, cfg, dtype) for _ in range(cfg.n_layers)],
        "final_norm": L.rmsnorm_init(cfg.d_model, dtype, dev),
    }


def params_from_jax(tree: dict) -> dict:
    """The reference's parameter pytree (numpy arrays; ``enc_stack`` and
    ``dec_stack`` stacked on a leading layer axis) as this module's
    parameters (one dict per layer), on the CPU, every leaf in its dtype."""

    def layer(node, i):
        if isinstance(node, dict):
            return {k: layer(v, i) for k, v in node.items()}
        return L.to_torch(np.asarray(node)[i])

    def n_layers(node):
        while isinstance(node, dict):
            node = next(iter(node.values()))
        return len(np.asarray(node))

    out = {k: L.to_torch(v) for k, v in tree.items()
           if k not in ("enc_stack", "dec_stack")}
    for name in ("enc_stack", "dec_stack"):
        out[name] = [layer(tree[name], i) for i in range(n_layers(tree[name]))]
    return out


def encode(params, cfg, rc, frames: torch.Tensor, *,
           kernels: ops.FusedKernels = ops.KERNELS) -> torch.Tensor:
    """frames: (B, S_enc, d) precomputed embeddings -> encoder states."""
    from .transformer import _remat_wrap

    positions = range(frames.shape[1])
    x = frames.to(getattr(torch, cfg.dtype))

    def layer(x, p):
        h = L.rmsnorm(p["norm1"], x, cfg.rmsnorm_eps)
        out, _ = L.attention_block(p["attn"], h, cfg, mixer="attn", positions=positions,
                                   causal=False, kv_block=rc.attn_chunk_kv,
                                   flash=kernels.attention)
        x = x + out
        h = L.rmsnorm(p["norm2"], x, cfg.rmsnorm_eps)
        return x + L.mlp_block(p["mlp"], h, cfg.ffn_act, fused=kernels.mlp, width=cfg.d_ff)

    layer = _remat_wrap(layer, rc)
    for p in params["enc_stack"]:
        x = layer(x, p)
    return L.rmsnorm(params["enc_final_norm"], x, cfg.rmsnorm_eps)


def cross_kv(params, cfg, enc_h: torch.Tensor, out: list | None = None) -> list:
    """Per-decoder-layer cross-attention ``{"k", "v": (B, S_enc, KV, hd)}``,
    computed once.  ``out`` (a cache's ``"xkv"``): the products are written
    into its buffers, which must have that shape, and returned.  On a mesh
    a ``wk`` / ``wv`` of fewer columns gives this rank's KV heads; a cache
    piece gathered at use (``sharding.cache_open``) takes its share of the
    whole product."""
    B, Se, d = enc_h.shape
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    flat = enc_h.reshape(B * Se, d)
    layers = []
    for i, p in enumerate(params["dec_stack"]):
        kv = {}
        for name, w in (("k", p["xattn"]["wk"]), ("v", p["xattn"]["wv"])):
            KVl = w.shape[1] // hd
            shape = (B, Se, KVl, hd)
            src = SH.enter_model(flat) if KVl < KV else flat
            if out is None:
                kv[name] = (src @ w).reshape(shape)
                continue
            buf = out[i][name]
            if SH.cache_registered(buf):
                SH.cache_store(buf, (src @ w).reshape(shape))
            elif tuple(buf.shape) != shape:
                raise ValueError(f"the cache's cross-attention buffers are "
                                 f"{tuple(buf.shape)}, the encoder gives {shape}")
            else:
                torch.mm(src, w, out=buf.view(B * Se, -1))
            kv[name] = buf
        layers.append(kv)
    return layers


def decode_stack(params, cfg, rc, tokens: torch.Tensor, xkv: list,
                 cache: dict | None = None, *,
                 kernels: ops.FusedKernels = ops.KERNELS):
    """Decoder trunk over ``tokens`` (B, S).  ``cache``: ``{"self": [{"k",
    "v": (B, max_seq, KV, hd)}, ...], "len": int}``.  Returns (hidden,
    new cache | None)."""
    x = L.embed_lookup(params["embed"], tokens, cfg.vocab_size)
    start = cache["len"] if cache is not None else 0
    positions = range(start, start + x.shape[1])

    def layer(x, p, layer_xkv, attn_cache):
        h = L.rmsnorm(p["norm1"], x, cfg.rmsnorm_eps)
        out, nc = L.attention_block(p["attn"], h, cfg, mixer="attn", positions=positions,
                                    cache=attn_cache, kv_block=rc.attn_chunk_kv,
                                    flash=kernels.attention)
        x = x + out
        h = L.rmsnorm(p["norm_x"], x, cfg.rmsnorm_eps)
        out, _ = L.attention_block(p["xattn"], h, cfg, mixer="attn", positions=positions,
                                   cross_kv=(layer_xkv["k"], layer_xkv["v"]),
                                   kv_block=rc.attn_chunk_kv, flash=kernels.attention)
        x = x + out
        h = L.rmsnorm(p["norm2"], x, cfg.rmsnorm_eps)
        return x + L.mlp_block(p["mlp"], h, cfg.ffn_act, fused=kernels.mlp,
                               width=cfg.d_ff), nc

    if cache is None:  # training / an uncached forward: each layer under the run's remat
        from .transformer import _remat_wrap

        remat_layer = _remat_wrap(lambda x, p, kv: layer(x, p, kv, None)[0], rc)
        for i, p in enumerate(params["dec_stack"]):
            x = remat_layer(x, p, xkv[i])
        return L.rmsnorm(params["final_norm"], x, cfg.rmsnorm_eps), None
    new_self = []
    for i, p in enumerate(params["dec_stack"]):
        attn_cache = {"k": cache["self"][i]["k"], "v": cache["self"][i]["v"],
                      "len": start}
        x, nc = layer(x, p, xkv[i], attn_cache)
        new_self.append({"k": nc["k"], "v": nc["v"]})
    x = L.rmsnorm(params["final_norm"], x, cfg.rmsnorm_eps)
    return x, {"self": new_self, "len": start + tokens.shape[1]}


def forward(params, cfg, rc, batch: dict, cache: dict | None = None, *,
            kernels: ops.FusedKernels = ops.KERNELS):
    """batch: {"frontend": (B, S_enc, d), "tokens": (B, S_dec)}.

    ``batch["frontend"]`` present selects encode (prefill, or an uncached
    forward); decode steps omit it and reuse ``cache["xkv"]``.  Returns
    (hidden, new_cache, aux = 0)."""
    aux = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
    if cache is not None and "frontend" not in batch:
        xkv = cache["xkv"]
    else:
        enc_h = encode(params, cfg, rc, batch["frontend"], kernels=kernels)
        xkv = cross_kv(params, cfg, enc_h, None if cache is None else cache["xkv"])
    inner = None if cache is None else {"self": cache["self"], "len": cache["len"]}
    h, new_inner = decode_stack(params, cfg, rc, batch["tokens"], xkv, inner,
                                kernels=kernels)
    if cache is None:
        return h, None, aux
    return h, {"xkv": xkv, **new_inner}, aux


def init_cache(cfg, batch: int, max_seq: int, enc_len: int, *, device) -> dict:
    """A zeroed cache in ``cfg.dtype``: per decoder layer, self-attention
    ``{"k", "v": (batch, max_seq, KV, hd)}`` and cross-attention
    ``{"k", "v": (batch, enc_len, KV, hd)}``; ``"len": 0``."""
    dtype = getattr(torch, cfg.dtype)
    hd = cfg.resolved_head_dim

    def kv(n):
        shape = (batch, n, cfg.n_kv_heads, hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    return {"self": [kv(max_seq) for _ in range(cfg.n_layers)],
            "xkv": [kv(enc_len) for _ in range(cfg.n_layers)],
            "len": 0}
