"""Flash attention with a custom backward (the port of the JAX package's
``models/flash.py``).

Plain autograd through a blocked attention saves the probability tile of
every KV block for the backward pass.  The flash backward instead saves
only ``(q, k, v, out, lse)`` and recomputes each block's probabilities from
the logsumexp, so the probability frame never exists outside the fused
group, in the backward pass as in the forward.

:func:`flash_attention_vjp` is a ``torch.autograd.Function`` on a CPU
tensor: its forward (:func:`_fwd_scan`) and backward (:func:`_bwd`) follow
the reference's ``_fwd_scan`` and ``bwd`` line for line, over ``kv_block``
keys at a time; ``bf16_tiles=True`` rounds the probability and gradient
tiles to bfloat16 for the products, which sum in float32.  On a CUDA tensor
it is the flash-attention kernel K2 with its logsumexp output and the
backward kernel (``fused_attention.flash_attention``, differentiable there),
with queries and keys at positions 0..S-1; the kernels' dtype decides their
tiles (bfloat16 inputs run on the tensor cores with bfloat16 tiles).
"""
from __future__ import annotations

import math

import torch

from ..kernels import fused_attention
from .layers import NEG_INF, attention_bias, positions_tensor, repeat_kv


def _mask_bias(q_pos, p_c, mixer, window, chunk, device):
    return attention_bias(q_pos, p_c, mixer=mixer, causal=True, window=window,
                          chunk=chunk, kv_len=None, device=device)


def _tile(x: torch.Tensor, bf16_tiles: bool) -> torch.Tensor:
    """A product operand: rounded to bfloat16 with ``bf16_tiles`` (the
    products of two bfloat16 values are exact in float32, so a float32
    product of the rounded operands is the reference's bfloat16 dot with
    float32 accumulation)."""
    return x.to(torch.bfloat16).float() if bf16_tiles else x


def _fwd_scan(q, k, v, q_pos, kv_pos, *, mixer, window, chunk, kv_block,
              bf16_tiles):
    """(out (B, H, Sq, hd) float32, lse (B, H, Sq) float32): the online
    softmax over ``kv_block`` keys at a time."""
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    if Skv % kv_block:
        kv_block = Skv
    scale = 1.0 / math.sqrt(hd)
    qh = q.float()
    kvp = positions_tensor(kv_pos, q.device)
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, H, Sq, hd), dtype=torch.float32, device=q.device)
    for c0 in range(0, Skv, kv_block):
        blk = slice(c0, c0 + kv_block)
        k_r = repeat_kv(k[:, blk], H).float()
        v_r = repeat_kv(v[:, blk], H).float()
        s = torch.einsum("bqhd,bchd->bhqc", qh, k_r) * scale
        s = s + _mask_bias(q_pos, kvp[blk], mixer, window, chunk, q.device)[None, None]
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhqc,bchd->bhqd", _tile(p, bf16_tiles),
                          _tile(v_r, bf16_tiles))
        acc = acc * corr[..., None] + pv
        m = m_new
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out, lse


def _bwd(q, k, v, q_pos, kv_pos, out, lse, dout, *, mixer, window, chunk,
         kv_block, bf16_tiles):
    """(dq, dk, dv) in the inputs' dtypes: each block's probabilities
    recomputed from ``lse``, ``D = rowsum(dO * O)``, and the repeated heads'
    dK and dV folded back onto the KV heads."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    block = kv_block if Skv % kv_block == 0 else Skv
    scale = 1.0 / math.sqrt(hd)
    qh = q.float()
    do = dout.float().transpose(1, 2)  # (B, H, Sq, hd)
    D = torch.sum(do * out, dim=-1)  # (B, H, Sq)
    kvp = positions_tensor(kv_pos, q.device)
    dq = torch.zeros((B, Sq, H, hd), dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for c0 in range(0, Skv, block):
        blk = slice(c0, c0 + block)
        k_r = repeat_kv(k[:, blk], H).float()
        v_r = repeat_kv(v[:, blk], H).float()
        s = torch.einsum("bqhd,bchd->bhqc", qh, k_r) * scale
        s = s + _mask_bias(q_pos, kvp[blk], mixer, window, chunk, q.device)[None, None]
        p = torch.exp(s - lse[..., None])  # recomputed, never stored
        dv_r = torch.einsum("bhqc,bhqd->bchd", _tile(p, bf16_tiles), _tile(do, bf16_tiles))
        dp = torch.einsum("bhqd,bchd->bhqc", _tile(do, bf16_tiles), _tile(v_r, bf16_tiles))
        ds = p * (dp - D[..., None]) * scale
        dq = dq + torch.einsum("bhqc,bchd->bqhd", _tile(ds, bf16_tiles),
                               _tile(k_r, bf16_tiles))
        dk_r = torch.einsum("bhqc,bqhd->bchd", _tile(ds, bf16_tiles), _tile(qh, bf16_tiles))
        # fold repeated heads back onto the KV heads
        dks.append(dk_r.reshape(B, -1, KV, G, hd).sum(dim=3))
        dvs.append(dv_r.reshape(B, -1, KV, G, hd).sum(dim=3))
    dk = torch.cat(dks, dim=1)
    dv = torch.cat(dvs, dim=1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashVJP(torch.autograd.Function):
    """The plain flash attention, saving only (q, k, v, out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, mixer, window, chunk, kv_block,
                bf16_tiles):
        kw = dict(mixer=mixer, window=window, chunk=chunk, kv_block=kv_block,
                  bf16_tiles=bf16_tiles)
        out, lse = _fwd_scan(q, k, v, q_pos, kv_pos, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.positions = (q_pos, kv_pos)
        ctx.kw = kw
        return out.transpose(1, 2).to(q.dtype)  # (B, Sq, H, hd)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _bwd(q, k, v, *ctx.positions, out, lse, dout, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_attention_vjp(q, k, v, *, q_pos, kv_pos, mixer="attn", window=0,
                        chunk=0, kv_block=1024, bf16_tiles=False,
                        logit_cap=0.0, flash=None):
    """Causal attention of ``q`` (B, Sq, H, hd) over ``k``, ``v`` (B, Skv,
    KV, hd) under the mixer's mask (a sliding ``window`` for
    ``attn_local``, ``chunk``-local for ``attn_chunked``), whose backward
    recomputes the probabilities from the saved logsumexp.  A CUDA tensor
    runs the kernels through ``flash`` (default: the K2 wrapper; positions
    must be 0..S-1 for both); a CPU tensor the plain version."""
    if logit_cap != 0.0:
        raise NotImplementedError("softcap unsupported in the flash-vjp path")
    window = int(window) if mixer == "attn_local" else 0
    chunk = int(chunk) if mixer == "attn_chunked" else 0
    if q.device.type == "cpu":
        return _FlashVJP.apply(q, k, v, q_pos, kv_pos, mixer, window, chunk,
                               int(kv_block), bool(bf16_tiles))
    Sq, Skv = q.shape[1], k.shape[1]
    if not (isinstance(q_pos, range) and q_pos == range(Sq)
            and isinstance(kv_pos, range) and kv_pos == range(Skv)):
        raise NotImplementedError(
            "the flash_attention kernels take queries and keys at positions 0..")
    flash = fused_attention.flash_attention if flash is None else flash
    return flash(q, k, v, causal=True, window=window, chunk=chunk)
