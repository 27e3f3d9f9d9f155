"""Plain PyTorch versions of the kernels (the ground truth in tests).

Each repeats its kernel's function in the simplest PyTorch: the conv group
as a cuDNN convolution, attention with materialised scores, the MLP as
three float32 matrix products, the selective scan as a sequential float32
loop over the sequence.  On the GPU a float32 matrix product runs in
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
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    idx = torch.arange(H, device=q.device) // (H // KV)
    kr = k.index_select(2, idx).float()
    vr = v.index_select(2, idx).float()
    scores = torch.einsum("bqhd,bchd->bhqc", q.float(), kr) * (1.0 / math.sqrt(hd))
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Skv, device=q.device)[None, :]
    ok = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= (qp - kp) < window
        if not causal:
            ok &= (kp - qp) < window
    elif chunk:
        ok &= (qp // chunk) == (kp // chunk)
    scores = scores + torch.where(ok, 0.0, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqc,bchd->bqhd", probs, vr).to(q.dtype)


def fused_mlp_ref(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                  w3: torch.Tensor | None = None, *,
                  act: str = "swiglu") -> torch.Tensor:
    """``act(x @ w1) [* (x @ w3)] @ w2`` in float32 (float64 for float64
    inputs), the result in ``x.dtype``.  gelu is the tanh form
    (``jax.nn.gelu``'s default), not PyTorch's default erf form."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc)
    h = xf @ w1.to(acc)
    if act == "swiglu":
        h = F.silu(h) * (xf @ w3.to(acc))
    elif act == "geglu":
        h = F.gelu(h, approximate="tanh") * (xf @ w3.to(acc))
    elif act == "gelu":
        h = F.gelu(h, approximate="tanh")
    elif act == "relu":
        h = torch.relu(h)
    else:
        raise ValueError(f"unknown act {act!r}")
    return (h @ w2.to(acc)).to(x.dtype)


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
