"""Shared transformer building blocks (functions over parameter dicts).

The port of the JAX package's ``models/layers.py``.

Conventions
-----------
* Activations: ``(batch, seq, ...)``; attention heads laid out
  ``(batch, seq, heads, head_dim)``; weights ``(d_in, d_out)``.
* Every ``init_*`` returns a dict of tensors drawn from an explicit
  ``torch.Generator``; the matching ``apply`` is a function of
  ``(params, inputs)``.
* Numerics: parameters/activations in the config dtype (bf16 at scale);
  softmax/normalisation statistics and attention accumulators in float32.
* Positions are Python ``range`` objects on the model's path (the query
  start is then known on the host, with no device sync); the functions
  also take integer tensors.
* On a CUDA tensor, :func:`attention_chunked` with more than one query is
  the flash-attention kernel (K2) and :func:`mlp_block` the fused-MLP
  kernel (K3).  Every serving call reaches K2 with queries and keys at
  positions 0..: causal or not (the encoder, cross-attention), windowed or
  chunked, a ring-cache prefill included (it attends to the fresh keys).
  What K2 does not take (a logit softcap, queries not starting at position
  0, arbitrary KV positions) raises ``NotImplementedError`` there.  On a
  CPU tensor the plain versions compute the whole reference function.
  Single-query decode attention (:func:`attention_decode`, over a full
  cache, a ring or the encoder's keys) is plain PyTorch on both, as the
  reference computes it outside any Pallas kernel.
* Training: every function here is differentiable by torch autograd.  On
  a CUDA tensor that requires grad, K2 runs with its backward kernel
  (``fused_attention.flash_attention`` is an ``autograd.Function`` there);
  ``attention_block(flash_vjp=True)`` takes the custom-VJP flash attention
  of :mod:`repro_torch.models.flash`, which lands on the same kernels on
  the card.  :func:`chunked_cross_entropy` recomputes each chunk's logits
  in the backward.
* On a mesh (``parallel.sharding.use_mesh``) a parameter narrower than
  the config says is this rank's piece on the ``model`` axis, and the
  function computes its share, as the reference's sharding hints have
  GSPMD partition it: q heads (k and v too when the KV heads split whole,
  else the q heads' KV heads of a replicated k / v), MLP columns, the
  vocabulary rows of the embedding and the head.  It enters such compute
  through ``sharding.enter_model`` and leaves it through
  ``sharding.leave_model`` (one all-reduce after a row-parallel product);
  a cache piece the model reads whole is gathered at use
  (``sharding.cache_open``).  Off a mesh every parameter is whole and
  nothing changes.
"""
from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import checkpoint

from ..kernels import ops
from ..parallel import sharding as SH

NEG_INF = -1e30
GATED_ACTS = ("swiglu", "geglu")
ACTS = ("swiglu", "geglu", "gelu", "relu")

# ---------------------------------------------------------------------------
# Initialisers (the reference's scales; draws from ``gen``)
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype) -> torch.Tensor:
    """(d_in, d_out) normal weights scaled by 1/sqrt(d_in)."""
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * (1.0 / math.sqrt(d_in))).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype) -> torch.Tensor:
    """(vocab, d) normal embeddings scaled by 0.02."""
    w = torch.randn((vocab, d), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * 0.02).to(dtype)


def rmsnorm_init(d: int, dtype, device) -> torch.Tensor:
    """(d,) ones."""
    return torch.ones((d,), dtype=dtype, device=device)


def to_torch(a) -> torch.Tensor:
    """A numpy (or array-like) value as a CPU tensor; bfloat16 arrays go
    through their 16-bit pattern, which numpy cannot hand to torch."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree):
    """A reference parameter tree (dicts and lists of numpy or jax arrays)
    as CPU tensors of the same structure; every leaf keeps its dtype."""
    return pytree.tree_map(to_torch, tree)


def param_specs_of(init: Callable[[torch.Generator], Any]) -> Any:
    """The tree ``init(generator)`` returns, as ``device="meta"`` tensors of
    the same shapes and dtypes — the counterpart of the reference's
    ``jax.eval_shape`` hooks.  ``init`` runs under a fake-tensor mode, so
    nothing is allocated (arctic's experts cost nothing to spec)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        tree = init(torch.Generator().manual_seed(0))
    return pytree.tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), tree)


# ---------------------------------------------------------------------------
# Normalisation / positional encoding
# ---------------------------------------------------------------------------


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32, cast back to ``x.dtype`` before ``* scale``."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def positions_tensor(pos, device) -> torch.Tensor:
    """``pos`` (a ``range`` or an integer tensor) as an int64 tensor."""
    if isinstance(pos, range):
        return torch.arange(pos.start, pos.stop, pos.step, device=device)
    return torch.as_tensor(pos, device=device)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim // 2,) inverse frequencies."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions, theta: float) -> torch.Tensor:
    """Rotate-half RoPE.  x: (..., seq, heads, head_dim); positions: (seq,)."""
    hd = x.shape[-1]
    inv = rope_frequencies(hd, theta, x.device)
    angles = positions_tensor(positions, x.device)[..., :, None].float() * inv
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    """``cap * tanh(logits / cap)``; off when ``cap <= 0``."""
    if cap <= 0:
        return logits
    return cap * torch.tanh(logits / cap)


# ---------------------------------------------------------------------------
# Attention masks (positions are absolute token indices)
# ---------------------------------------------------------------------------


def attention_bias(q_pos, kv_pos, *, mixer: str, causal: bool, window: int,
                   chunk: int, kv_len=None, device=None) -> torch.Tensor:
    """(Sq, Skv) additive float32 bias (0 or NEG_INF).

    Negative kv positions are invalid (unwritten ring-buffer slots)."""
    qp = positions_tensor(q_pos, device)[:, None]
    kp = positions_tensor(kv_pos, device)[None, :]
    ok = kp >= 0
    if causal:
        ok = ok & (kp <= qp)
    if mixer == "attn_local":
        ok = ok & ((qp - kp) < window)
        if not causal:
            ok = ok & ((kp - qp) < window)
    elif mixer == "attn_chunked":
        ok = ok & ((qp // chunk) == (kp // chunk))
    if kv_len is not None:
        ok = ok & (kp < kv_len)
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def ring_insert(buf: torch.Tensor, new: torch.Tensor, start: int) -> torch.Tensor:
    """Write ``new`` (B, S, KV, hd) into the W-entry ring buffer ``buf``
    (B, W, KV, hd) keyed by absolute position (slot = position % W), in
    place, and return ``buf`` (the reference returns a new buffer).

    S == 1: a decode step at position ``start`` writes slot ``start % W``.
    S > 1: a prefill, which the reference assumes starts at position 0 (the
    serving flow always primes the ring from scratch; ``start`` is not
    read): S >= W keeps the last W keys, rolled by (S - W) % W so that key
    p lands in slot p % W; S < W writes slots 0..S-1 and leaves the rest.
    The roll reads only ``new``, which must not alias ``buf``, so no slot
    is read after it was overwritten.
    """
    W, S = buf.shape[1], new.shape[1]
    if S == 1:
        buf[:, start % W] = new[:, 0]
    elif S >= W:
        shift = (S - W) % W
        keep = new[:, S - W:]
        buf[:, shift:] = keep[:, :W - shift]
        buf[:, :shift] = keep[:, W - shift:]
    else:
        buf[:, :S] = new
    return buf


def ring_positions(W: int, p_last: int, device=None) -> torch.Tensor:
    """(W,) absolute position held by each ring slot after the token at
    ``p_last`` was written; unwritten slots come out negative, which
    :func:`attention_bias` masks."""
    return p_last - ((p_last - torch.arange(W, device=device)) % W)


# ---------------------------------------------------------------------------
# Attention: reference (materialised scores) — the oracle
# ---------------------------------------------------------------------------


def repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, H, hd) via head-index gather."""
    KV = k.shape[2]
    idx = torch.arange(n_heads, device=k.device) // (n_heads // KV)
    return k.index_select(2, idx)


def attention_reference(q, k, v, *, q_pos, kv_pos, mixer: str = "attn",
                        causal: bool = True, window: int = 0, chunk: int = 0,
                        kv_len=None, logit_cap: float = 0.0) -> torch.Tensor:
    """Materialised-scores attention in float32, the result in ``q.dtype``."""
    H, hd = q.shape[2], q.shape[3]
    kr = repeat_kv(k, H).float()
    vr = repeat_kv(v, H).float()
    # The two products take their operands in the order of the reference's
    # dot_generals (q then k; v then the probabilities), so a traced graph
    # gives each actmul the reference's frame.
    scores = (q.float().transpose(1, 2) @ kr.permute(0, 2, 3, 1)) * (1.0 / math.sqrt(hd))
    scores = softcap(scores, logit_cap)
    bias = attention_bias(q_pos, kv_pos, mixer=mixer, causal=causal,
                          window=window, chunk=chunk, kv_len=kv_len,
                          device=q.device)
    probs = torch.softmax(scores + bias[None, None], dim=-1)  # (B, H, Sq, Skv)
    out = vr.permute(0, 2, 3, 1) @ probs.transpose(-1, -2)  # (B, H, hd, Sq)
    return out.permute(0, 3, 1, 2).to(q.dtype)


def attention_decode(q, k, v, *, q_pos, kv_pos, mixer: str = "attn",
                     causal: bool = True, window: int = 0, chunk: int = 0,
                     kv_len=None, logit_cap: float = 0.0) -> torch.Tensor:
    """Single-query attention in KV-head space (no head repeat).

    The reference's dots take the cache's dtype with float32 accumulation;
    a product of two bf16 values is exact in float32, so widening both
    operands to float32 computes the same sums.  The probabilities are
    rounded to the cache's dtype before PV, as the reference rounds them.
    """
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, hd).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * (1.0 / math.sqrt(hd))
    s = softcap(s, logit_cap)
    bias = attention_bias(q_pos, kv_pos, mixer=mixer, causal=causal,
                          window=window, chunk=chunk, kv_len=kv_len,
                          device=q.device)  # (1, Skv)
    p = torch.softmax(s + bias[0][None, None, None, :], dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(k.dtype).float(), v.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Attention: chunked online-softmax (the fused-layer execution)
# ---------------------------------------------------------------------------


def _flash_case(q, k, *, q_pos, kv_pos, mixer, window, chunk, kv_len,
                logit_cap):
    """The (window, chunk) K2 masks for this call, or the name of the case
    K2 does not take."""
    Sq, Skv = q.shape[1], k.shape[1]
    if logit_cap > 0:
        return "a logit softcap"
    if not isinstance(q_pos, range) or q_pos != range(Sq):
        return "queries not starting at position 0"
    if not isinstance(kv_pos, range) or kv_pos != range(Skv):
        return "KV positions other than 0..Skv-1 (as a ring cache's)"
    if kv_len is not None and not (isinstance(kv_len, int) and kv_len >= Skv):
        return "a kv_len shorter than the keys given"
    return (window if mixer == "attn_local" else 0,
            chunk if mixer == "attn_chunked" else 0)


def attention_chunked(q, k, v, *, q_pos, kv_pos, mixer: str = "attn",
                      causal: bool = True, window: int = 0, chunk: int = 0,
                      kv_len=None, logit_cap: float = 0.0, kv_block: int = 1024,
                      flash=None) -> torch.Tensor:
    """Flash-style attention: the (Sq, Skv) score frame is never built whole.

    One query goes to :func:`attention_decode`.  Queries and keys at
    positions 0.. with no softcap go to ``flash(q, k, v, causal=, window=,
    chunk=)`` (default: the K2 wrapper, which runs the kernel on a CUDA
    tensor and its plain version on a CPU one).  Anything else raises
    ``NotImplementedError`` on a CUDA tensor and, on a CPU tensor, runs the
    reference's loop over ``kv_block``-key blocks with running (m, l, acc).
    """
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    kw = dict(q_pos=q_pos, kv_pos=kv_pos, mixer=mixer, causal=causal,
              window=window, chunk=chunk, kv_len=kv_len, logit_cap=logit_cap)
    if Sq == 1:
        return attention_decode(q, k, v, **kw)
    case = _flash_case(q, k, q_pos=q_pos, kv_pos=kv_pos, mixer=mixer,
                       window=window, chunk=chunk, kv_len=kv_len,
                       logit_cap=logit_cap)
    if not isinstance(case, str):
        flash = ops.KERNELS.attention if flash is None else flash
        return flash(q, k, v, causal=causal, window=case[0], chunk=case[1])
    if q.device.type != "cpu":
        raise NotImplementedError(
            f"the flash_attention kernel does not take {case} (ROADMAP Queue 1)")
    if Skv % kv_block:
        kv_block = Skv  # degenerate single block (small/test shapes)
    scale = 1.0 / math.sqrt(hd)
    qf = q.float()
    kvp = positions_tensor(kv_pos, q.device)
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, H, Sq, hd), dtype=torch.float32, device=q.device)
    for c0 in range(0, Skv, kv_block):
        blk = slice(c0, c0 + kv_block)
        k_r = repeat_kv(k[:, blk], H).float()
        v_r = repeat_kv(v[:, blk], H).float()
        s = softcap(torch.einsum("bqhd,bchd->bhqc", qf, k_r) * scale, logit_cap)
        s = s + attention_bias(q_pos, kvp[blk], mixer=mixer, causal=causal,
                               window=window, chunk=chunk, kv_len=kv_len,
                               device=q.device)[None, None]
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqc,bchd->bhqd", p, v_r)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)  # (B, Sq, H, hd)


# ---------------------------------------------------------------------------
# Attention module (projections + rope + qk-norm + cache handling)
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg, dtype) -> dict:
    """wq, wk, wv, wo (and the qk-norm scales) for one attention sublayer."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    p = {
        "wq": dense_init(gen, d, cfg.n_heads * hd, dtype),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd, dtype),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd, dtype),
        "wo": dense_init(gen, cfg.n_heads * hd, d, dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, dtype, gen.device)
        p["k_norm"] = rmsnorm_init(hd, dtype, gen.device)
    return p


def attention_block(params: dict, x: torch.Tensor, cfg, *, mixer: str,
                    positions, cache: dict | None = None,
                    cross_kv: tuple | None = None, causal: bool = True,
                    kv_block: int = 1024, ring: bool = False,
                    flash=None, impl: str = "chunked", flash_vjp: bool = False,
                    bf16_tiles: bool = False
                    ) -> tuple[torch.Tensor, dict | None]:
    """Self- (or cross-) attention sub-layer.  Returns (out, new_cache).

    ``impl="reference"`` computes the scores whole
    (:func:`attention_reference`), as the reference's tracing hook does;
    the default ``"chunked"`` goes through :func:`attention_chunked`.

    ``cache``: ``{"k", "v": (B, entries, KV, hd), "len": int}``.  The new
    keys and values are written into the cache's buffers in place (the
    reference returns new buffers; the port saves the copy) and
    ``new_cache`` holds the same buffers with ``len`` advanced.  A full
    cache (``ring=False``) is written at [len, len + S); a prefill that
    starts at position 0 attends to the fresh keys: the reference attends
    to the whole buffer, but the slots past ``len`` are masked, so the
    function is the same.  ``ring=True``: the buffer is a window-sized ring
    (local-attention layers, :func:`ring_insert`); a prefill attends to the
    fresh keys and keeps only the last window, a decode step attends to the
    ring at :func:`ring_positions`.

    ``cross_kv``: the encoder's (k, v), attended to without a mask; the
    queries take ``q_norm`` only, no RoPE (the keys were projected from the
    encoder's states once, :func:`repro_torch.models.encdec.cross_kv`).
    A config with ``rope`` false (jamba) rotates no self-attention either:
    its layers take no positional encoding.

    ``flash_vjp``: an uncached self-attention over more than one token with
    no softcap runs :func:`repro_torch.models.flash.flash_attention_vjp`
    (causal, the mixer's window or chunk; ``bf16_tiles`` for its plain
    version), as the reference's training path does.
    """
    B, S, d = x.shape
    hd = cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    Hl = params["wq"].shape[1] // hd  # this rank's q heads (H off a mesh)
    xin = SH.enter_model(x) if Hl < H else x

    q = (xin @ params["wq"]).reshape(B, S, Hl, hd)
    if cross_kv is None:
        KVl = params["wk"].shape[1] // hd
        xk = xin if KVl < KV else x
        k = (xk @ params["wk"]).reshape(B, S, KVl, hd)
        v = (xk @ params["wv"]).reshape(B, S, KVl, hd)
    else:
        k, v = SH.cache_open(cross_kv[0]), SH.cache_open(cross_kv[1])
    if cfg.qk_norm:  # a replicated scale on this rank's heads enters their compute
        q = rmsnorm(SH.enter_model(params["q_norm"]) if Hl < H else params["q_norm"], q,
                    cfg.rmsnorm_eps)
        if cross_kv is None:
            k_norm = params["k_norm"]
            k = rmsnorm(SH.enter_model(k_norm) if k.shape[2] < KV else k_norm, k,
                        cfg.rmsnorm_eps)
    if cross_kv is None and cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cross_kv is not None:
        kv_pos, kv_len, causal = range(k.shape[1]), None, False
    elif cache is not None and ring:
        start = cache["len"]
        k_ring = ring_insert(SH.cache_open(cache["k"]), k, start)
        v_ring = ring_insert(SH.cache_open(cache["v"]), v, start)
        SH.cache_store(cache["k"], k_ring)
        SH.cache_store(cache["v"], v_ring)
        new_cache = {"k": cache["k"], "v": cache["v"], "len": start + S}
        if S == 1:
            k, v = k_ring, v_ring
            kv_pos = ring_positions(k.shape[1], start, device=x.device)
            kv_len = None  # validity from kp >= 0 and the causal / window masks
        else:
            kv_pos, kv_len = positions, start + S
    elif cache is not None:
        start = cache["len"]
        k_buf, v_buf = SH.cache_open(cache["k"]), SH.cache_open(cache["v"])
        k_buf[:, start:start + S] = k
        v_buf[:, start:start + S] = v
        SH.cache_store(cache["k"], k_buf)
        SH.cache_store(cache["v"], v_buf)
        new_cache = {"k": cache["k"], "v": cache["v"], "len": start + S}
        if start == 0 and S > 1:
            kv_pos, kv_len = positions, None
        else:
            k = k_buf[:, :start + S]
            v = v_buf[:, :start + S]
            kv_pos, kv_len = range(start + S), start + S
    else:
        kv_pos, kv_len = positions, None
    if Hl < H and k.shape[2] == KV:  # replicated k / v: this rank's q heads' groups
        k = local_kv_heads(SH.enter_model(k), H, Hl)
        v = local_kv_heads(SH.enter_model(v), H, Hl)

    if (flash_vjp and cache is None and cross_kv is None and S > 1
            and cfg.logit_softcap == 0.0):
        from .flash import flash_attention_vjp

        out = flash_attention_vjp(
            q, k, v, q_pos=positions, kv_pos=kv_pos, mixer=mixer,
            window=cfg.window_size, chunk=cfg.chunk_size, kv_block=kv_block,
            bf16_tiles=bf16_tiles, flash=flash)
        return _heads_out(out.reshape(B, S, Hl * hd), params["wo"], Hl < H), None

    kw = dict(q_pos=positions, kv_pos=kv_pos, mixer=mixer, causal=causal,
              window=cfg.window_size, chunk=cfg.chunk_size, kv_len=kv_len,
              logit_cap=cfg.logit_softcap)
    if impl == "reference":
        out = attention_reference(q, k, v, **kw)
    else:
        out = attention_chunked(q, k, v, **kw, kv_block=kv_block, flash=flash)
    return _heads_out(out.reshape(B, S, Hl * hd), params["wo"], Hl < H), new_cache


def _heads_out(out: torch.Tensor, wo: torch.Tensor, split: bool) -> torch.Tensor:
    """The output projection; a rank's heads give a partial sum, which the
    model axis adds up (a row-parallel product)."""
    y = out @ wo
    return SH.leave_model(y) if split else y


def local_kv_heads(k: torch.Tensor, H: int, Hl: int) -> torch.Tensor:
    """The KV heads (B, S, KV, hd) that this rank's ``Hl`` of ``H`` q heads
    read, contiguous: a run of whole groups, or the one group they share,
    or else one KV head per q head."""
    KV = k.shape[2]
    G = H // KV
    start = SH.head_slice(H, Hl).start
    idx = [(start + j) // G for j in range(Hl)]
    n = idx[-1] - idx[0] + 1
    if Hl % n == 0 and all(i == idx[0] + j // (Hl // n) for j, i in enumerate(idx)):
        return k[:, :, idx[0]:idx[-1] + 1].contiguous()
    return k[:, :, idx].contiguous()


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, d: int, d_ff: int, act: str, dtype) -> dict:
    """w1 (d, d_ff), w2 (d_ff, d) and, for the gated acts, w3 (d, d_ff)."""
    p = {"w1": dense_init(gen, d, d_ff, dtype), "w2": dense_init(gen, d_ff, d, dtype)}
    if act in GATED_ACTS:
        p["w3"] = dense_init(gen, d, d_ff, dtype)
    return p


def mlp_block(params: dict, x: torch.Tensor, act: str, *, fused=None,
              width: int | None = None) -> torch.Tensor:
    """``act(x @ w1) [* (x @ w3)] @ w2`` over the rows of ``x`` (..., d),
    through ``fused(x, w1, w2, w3, act=)`` (default: the K3 wrapper — the
    kernel on a CUDA tensor, its plain float32 version on a CPU one).  ``x``
    keeps its leading shape, as in the reference, so a traced gate has the
    reference's frame.  A ``w1`` narrower than ``width`` (the config's
    d_ff) is this rank's columns on the model axis: the fusion group runs
    on them and the model axis adds up the partial outputs.  On a mesh
    whose model axis has several ranks, ``width`` must be given
    (ValueError): without it a piece could not be told from the whole."""
    if act not in ACTS:
        raise ValueError(act)
    if width is None and SH.model_parallel() is not None:
        raise ValueError("mlp_block on a model-parallel mesh needs width= (the d_ff "
                         "its w1 is a piece of)")
    fused = ops.KERNELS.mlp if fused is None else fused
    split = width is not None and params["w1"].shape[1] < width
    if split:
        x = SH.enter_model(x)
    y = fused(x, params["w1"], params["w2"], params.get("w3"), act=act)
    return SH.leave_model(y) if split else y


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor, vocab: int) -> torch.Tensor:
    """The rows of ``table`` (vocab, d) for ``tokens``.  A table of fewer
    rows is this rank's vocabulary piece on the model axis: it looks up the
    tokens it holds (zeros for the others) and the model axis sums."""
    if table.shape[0] == vocab:
        return table[tokens]
    v0 = SH.head_slice(vocab, table.shape[0]).start
    local = tokens - v0
    held = (local >= 0) & (local < table.shape[0])
    rows = table[torch.where(held, local, 0)] * held[..., None].to(table.dtype)
    return SH.leave_model(rows)


def vocab_logits(h: torch.Tensor, head: torch.Tensor, vocab: int) -> torch.Tensor:
    """``h @ head`` in float32 over the whole vocabulary: a head of fewer
    columns is this rank's piece, its logits gathered over the model
    axis."""
    if head.shape[1] == vocab:
        return (h @ head).float()
    return SH.gather_model((SH.enter_model(h) @ head).float(), -1)


# ---------------------------------------------------------------------------
# Chunked cross-entropy (vocab logits never fully materialised)
# ---------------------------------------------------------------------------


def _xent_chunk(hc: torch.Tensor, lm_head: torch.Tensor, lc: torch.Tensor,
                mc: torch.Tensor) -> torch.Tensor:
    """Summed NLL of one chunk: (B, chunk, V) float32 logits, their
    logsumexp and the gold logit."""
    logits = (hc @ lm_head).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc[..., None])[..., 0]
    return torch.where(mc, lse - gold, 0.0).sum()


def _xent_chunk_split(hc: torch.Tensor, head: torch.Tensor, lc: torch.Tensor,
                      mc: torch.Tensor, v0: int) -> torch.Tensor:
    """:func:`_xent_chunk` over this rank's vocabulary columns ``[v0, v0 +
    Vl)``: the logsumexp's max and sum, and the gold logit (from the rank
    that holds it), taken over the model axis."""
    logits = (hc @ head).float()
    m = SH.all_max_model(logits.amax(dim=-1))
    lse = m + torch.log(SH.leave_model(torch.exp(logits - m[..., None]).sum(dim=-1)))
    local = lc - v0
    held = (local >= 0) & (local < logits.shape[-1])
    gold = torch.gather(logits, -1, torch.where(held, local, 0)[..., None])[..., 0]
    gold = SH.leave_model(torch.where(held, gold, 0.0))
    return torch.where(mc, lse - gold, 0.0).sum()


def chunked_cross_entropy(h: torch.Tensor, lm_head: torch.Tensor,
                          labels: torch.Tensor, *, chunk: int = 512,
                          mask: torch.Tensor | None = None,
                          vocab: int | None = None) -> torch.Tensor:
    """Mean next-token NLL of ``h`` (B, S, d) under ``lm_head`` (d, V) over
    the positions where ``mask`` (B, S) is True, computed over sequence
    chunks of ``chunk`` (the whole sequence when S is not a multiple).

    The (B, S, V) logits are the "intermediate frame" here: a chunk's (B,
    chunk, V) float32 logits live only while its NLL is taken and are
    recomputed in the backward (``torch.utils.checkpoint``), never stored.
    A head narrower than ``vocab`` is this rank's vocabulary piece on the
    model axis (:func:`_xent_chunk_split`); on a mesh whose model axis has
    several ranks, ``vocab`` must be given (ValueError).
    """
    if vocab is None and SH.model_parallel() is not None:
        raise ValueError("chunked_cross_entropy on a model-parallel mesh needs vocab= "
                         "(the vocabulary its head is a piece of)")
    B, S, d = h.shape
    if S % chunk:
        chunk = S
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.bool, device=h.device)
    fn, extra = _xent_chunk, ()
    if vocab is not None and lm_head.shape[1] < vocab:
        h = SH.enter_model(h)
        fn, extra = _xent_chunk_split, (SH.head_slice(vocab, lm_head.shape[1]).start,)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, S, chunk):
        part = (h[:, c0:c0 + chunk], lm_head, labels[:, c0:c0 + chunk],
                mask[:, c0:c0 + chunk], *extra)
        if torch.is_grad_enabled():
            tot = tot + checkpoint(fn, *part, use_reentrant=False)
        else:
            tot = tot + fn(*part)
    cnt = mask.sum().to(torch.int32)
    return tot / torch.clamp(cnt, min=1)
