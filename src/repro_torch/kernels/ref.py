"""Plain PyTorch versions of the kernels (the ground truth in tests).

Each repeats its kernel's function in the simplest PyTorch: the conv group
as a cuDNN convolution, attention with materialised scores (and its
backward, from the saved logsumexp), the MLP as three float32 matrix
products, the selective scan as a sequential float32 loop over the
sequence.  On the GPU a float32 matrix product runs in
full float32 (``torch.backends.cuda.matmul.allow_tf32`` is False by
default).

On the GPU a float32 convolution goes through cuDNN, which by default
(``torch.backends.cudnn.allow_tf32 = True``) rounds its operands to TF32
and keeps about three decimal digits.  The plain version switches that off
for its own call, so it computes in full float32 like the kernel it is held
against.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30  # the finite mask value of the reference kernels


@contextlib.contextmanager
def no_tf32():
    """Full-precision float32 convolutions for the duration of the block
    (cuDNN's TF32 switched off, then restored)."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def fused_conv3x3_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                      pool: bool = False) -> torch.Tensor:
    """3x3 SAME conv + bias + ReLU (+ 2x2/2 max-pool), in float32.

    ``x`` is NHWC ``(B, H, W, Cin)``, ``w`` HWIO ``(3, 3, Cin, Cout)``, ``b``
    ``(Cout,)``; the result is NHWC in ``x.dtype``, pooled to
    ``(B, H // 2, W // 2, Cout)`` when ``pool`` (an odd edge row/column is
    dropped, as a VALID 2x2 window does).
    """
    with no_tf32():
        y = F.conv2d(
            x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1),
            padding=1,
        )
    y = torch.relu(y + b.float()[None, :, None, None])
    if pool:
        y = F.max_pool2d(y, 2)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def _visible(Sq: int, Skv: int, causal: bool, window: int, chunk: int,
             device) -> torch.Tensor:
    """(Sq, Skv) bool: the (query, key) pairs the masks leave visible, at
    positions 0.. (a sliding window when ``window``, else chunked-local when
    ``chunk``; causal on top) -- the model's ``attention_bias``."""
    qp = torch.arange(Sq, device=device)[:, None]
    kp = torch.arange(Skv, device=device)[None, :]
    ok = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= (qp - kp) < window
        if not causal:
            ok &= (kp - qp) < window
    elif chunk:
        ok &= (qp // chunk) == (kp // chunk)
    return ok


def _scores(q, k, causal, window, chunk):
    """(masked float32 scores (B, H, Sq, Skv) scaled by 1/sqrt(hd), the
    visible pairs (Sq, Skv), the KV-head index of each query head)."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    idx = torch.arange(H, device=q.device) // (H // KV)
    kr = k.index_select(2, idx).float()
    scores = torch.einsum("bqhd,bchd->bhqc", q.float(), kr) * (1.0 / math.sqrt(hd))
    ok = _visible(Sq, Skv, causal, window, chunk, q.device)
    return scores + torch.where(ok, 0.0, NEG_INF), ok, idx


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        chunk: int = 0) -> torch.Tensor:
    """Materialised-scores attention, GQA-aware, in float32.

    ``q`` (B, Sq, H, hd), ``k`` and ``v`` (B, Skv, KV, hd) at positions
    0..; query head h reads KV head h // (H // KV).  The masks are those of
    the model's ``attention_bias`` (a sliding window when ``window``, else
    chunked-local when ``chunk``; causal on top), added as 0 / ``NEG_INF``
    to the scores scaled by 1/sqrt(hd).  The result is in ``q.dtype``.
    """
    scores, _, idx = _scores(q, k, causal, window, chunk)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqc,bchd->bqhd", probs, v.index_select(2, idx).float()
                        ).to(q.dtype)


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
                      window: int = 0, chunk: int = 0) -> torch.Tensor:
    """(B, H, Sq) float32: the logsumexp of each query's masked, scaled
    scores -- what the flash-attention kernel's ``lse`` output holds for a
    row that sees at least one key."""
    scores, _, _ = _scores(q, k, causal, window, chunk)
    return torch.logsumexp(scores, dim=-1)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            out: torch.Tensor, dout: torch.Tensor,
                            lse: torch.Tensor, *, causal: bool = True,
                            window: int = 0, chunk: int = 0
                            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The flash-attention backward in float32, materialised: (dq, dk, dv)
    of the attention :func:`flash_attention_ref` computes, given its output
    ``out`` (B, Sq, H, hd), the output's gradient ``dout`` and the rows'
    logsumexp ``lse`` (B, H, Sq).  The probabilities are recomputed as
    ``exp(s - lse)`` on the visible pairs and 0 elsewhere, ``dS = P (dP -
    D) / sqrt(hd)`` with ``D = rowsum(dout * out)``, which is ``rowsum(P *
    dP)``: the kernel takes the first for a float32 ``out`` and the second
    for a bfloat16 one, whose rounding would leave each row of dS adding to
    about 2^-9 |D| instead of 0; dk and dv sum the H / KV query heads of
    each KV head.  A query that sees no key gets 0 and adds nothing to dk
    and dv.  The results are in the inputs' dtypes."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    scores, ok, idx = _scores(q, k, causal, window, chunk)
    p = torch.where(ok, torch.exp(scores - lse.float()[..., None]), 0.0)
    do = dout.float()
    kr = k.index_select(2, idx).float()
    vr = v.index_select(2, idx).float()
    dv_r = torch.einsum("bhqc,bqhd->bchd", p, do)
    dp = torch.einsum("bqhd,bchd->bhqc", do, vr)
    if out.dtype == torch.float32:
        D = torch.sum(do * out, dim=-1).transpose(1, 2)  # (B, H, Sq)
    else:
        D = torch.sum(p * dp, dim=-1)
    ds = p * (dp - D[..., None]) * (1.0 / math.sqrt(hd))
    dq = torch.einsum("bhqc,bchd->bqhd", ds, kr)
    dk_r = torch.einsum("bhqc,bqhd->bchd", ds, q.float())
    G = H // KV
    dk = dk_r.reshape(B, Skv, KV, G, hd).sum(dim=3)
    dv = dv_r.reshape(B, Skv, KV, G, hd).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def activation(h: torch.Tensor, act: str) -> torch.Tensor:
    """The MLPs' activation of ``h = x @ w1`` (before the gate of ``swiglu``
    and ``geglu``): silu, or gelu in its tanh form (``jax.nn.gelu``'s
    default, not PyTorch's default erf form), or relu."""
    if act == "swiglu":
        return F.silu(h)
    if act in ("geglu", "gelu"):
        return F.gelu(h, approximate="tanh")
    if act == "relu":
        return torch.relu(h)
    raise ValueError(f"unknown act {act!r}")


def mlp(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
        w3: torch.Tensor | None = None, *, act: str = "swiglu") -> torch.Tensor:
    """``act(x @ w1) [* (x @ w3)] @ w2`` in the operands' dtype, the
    reference's ``mlp_block``; differentiable."""
    h = activation(x @ w1, act)
    if act in ("swiglu", "geglu"):
        h = h * (x @ w3)
    return h @ w2


def fused_mlp_ref(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                  w3: torch.Tensor | None = None, *,
                  act: str = "swiglu") -> torch.Tensor:
    """:func:`mlp` in float32 (float64 for float64 inputs), the result in
    ``x.dtype``."""
    acc = torch.promote_types(x.dtype, torch.float32)
    return mlp(x.to(acc), w1.to(acc), w2.to(acc), None if w3 is None else w3.to(acc),
               act=act).to(x.dtype)


def selective_scan_ref(dA: torch.Tensor, dBx: torch.Tensor, C: torch.Tensor,
                       h0: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-1 recurrence ``h_t = dA_t * h + dBx_t`` with the readout
    ``y_t[d] = sum_s h_t[d, s] * C_t[s]``, a sequential float32 loop over S.

    ``dA`` and ``dBx`` are (B, S, di, ds), ``C`` (B, S, ds), ``h0`` the
    (B, di, ds) state before the first step (zeros when ``None``), all
    float32.  Returns ``(y (B, S, di), h_last (B, di, ds))``.
    """
    B, S, di, ds = dA.shape
    h = torch.zeros((B, di, ds), dtype=torch.float32, device=dA.device) if h0 is None else h0
    ys = []
    for t in range(S):
        h = dA[:, t] * h + dBx[:, t]
        ys.append(torch.einsum("bds,bs->bd", h, C[:, t]))
    return torch.stack(ys, dim=1), h
