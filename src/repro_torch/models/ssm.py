"""Mamba-1 selective-state-space mixer (falcon-mamba-7b, jamba) — the port
of the JAX package's ``models/ssm.py``.

:func:`mamba_block` computes the discretised transitions (dA, dBx) and the
readout C in PyTorch and hands the recurrence to the fusion group it is
given (``scan``): on the model's path that is ``ops.KERNELS.ssm_scan``, the
selective-scan kernel K4 on a CUDA tensor (its plain sequential version on
a CPU one), or ``ops.PLAIN.ssm_scan``; training takes the chunked scan
(``ops.train_kernels``), differentiable, as the reference trains.  The two
pure-PyTorch scans of the reference are kept beside it: :func:`selective_scan_reference` (the
sequential oracle) and :func:`selective_scan_chunked` (chunk-recurrent; the
in-chunk scan is a log-depth doubling loop, since PyTorch has no
``associative_scan``).

:func:`mamba_param_specs` is the tracing frontend's hook: the parameter
shapes as meta tensors.  The frontend passes its own ``scan`` (one marker
op, so the recurrence traces to a single graph node); the model's path
keeps ``ops.KERNELS.ssm_scan``.

Jamba's mixer (``cfg.ssm_inner_norms``) RMS-normalises dt, B and C after
``x_proj`` (its ``dt_layernorm``, ``b_layernorm`` and ``c_layernorm``), with
scales ``dt_norm``, ``b_norm`` and ``c_norm``.  With grad mode off (serving)
the discretisation and the scan run over chunks of time of
:func:`time_chunk` steps, the state carried from one chunk's scan to the
next, so that dA and dBx of a long prompt never exist whole; the
projections, the convolution and dt stay whole.  A chunk's arithmetic is
the whole prompt's, element for element, and the scan is sequential, so
the chunked result is the same bits.  With tracing on
(:mod:`repro_torch.runtime.spans`) the mixer runs in the spans
``repro_torch.mamba.in``, ``.discretize``, ``.scan`` (each scan call) and
``.out``, and counts its tokens (``mamba.tokens``) and scan calls
(``mamba.scans``).

On a mesh (``parallel.sharding.use_mesh``), a ``conv_w`` narrower than
``d_inner`` holds this rank's channels on the ``model`` axis (channel
parallelism): ``in_proj`` comes whole (its column piece would hold x- or
z-channels, not a rank's both) and the rank takes its channels' columns of
it; the convolution, the discretisation and the scan (K4) run on the local
channels; ``x_proj`` and ``out_proj`` are row-parallel, each followed by
one all-reduce over ``model``.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels import ops, ref
from ..parallel import sharding as SH
from ..runtime import spans
from . import layers as L
from .layers import dense_init

# Bytes of float32 dA and dBx together that one chunk of time may hold
# while serving: 8 GiB, what jamba-1.5-large's 8 x 512 prefill (d_inner
# 16,384) held in one call, so no shape the registry serves is cut, while a
# 32,768-token prompt of d_inner 8192 runs in four chunks (32 GiB whole).
SCAN_BUDGET_BYTES = 8 << 30


def init_mamba(gen: torch.Generator, cfg, dtype) -> dict:
    """One Mamba mixer's parameters, drawn from ``gen`` with the reference's
    initialisation: S4D-real ``A_log`` = log [1..ds] per channel, ``dt_bias``
    the inverse softplus of dt uniform in [1e-3, 0.1]; ``A_log``, ``D`` and
    ``dt_bias`` in float32, the rest in ``dtype``; with
    ``cfg.ssm_inner_norms`` the inner norms' scales, ones."""
    d, di, ds = cfg.d_model, cfg.d_inner, cfg.ssm_state
    dr, dc = cfg.dt_rank, cfg.ssm_conv
    dev = gen.device
    a_init = torch.arange(1, ds + 1, dtype=torch.float32, device=dev).repeat(di, 1)
    u = torch.rand((di,), generator=gen, device=dev, dtype=torch.float32)
    dt = torch.clamp(u * (0.1 - 1e-3) + 1e-3, min=1e-4)
    dt_bias = torch.log(torch.exp(dt) - 1.0)  # softplus^-1 of dt
    conv_w = torch.randn((dc, di), generator=gen, device=dev, dtype=torch.float32)
    p = {
        "in_proj": dense_init(gen, d, 2 * di, dtype),
        "conv_w": (conv_w / math.sqrt(dc)).to(dtype),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "x_proj": dense_init(gen, di, dr + 2 * ds, dtype),
        "dt_proj": dense_init(gen, dr, di, dtype),
        "dt_bias": dt_bias,
        "A_log": torch.log(a_init),
        "D": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, di, d, dtype),
    }
    if cfg.ssm_inner_norms:
        p["dt_norm"] = L.rmsnorm_init(dr, dtype, dev)
        p["b_norm"] = L.rmsnorm_init(ds, dtype, dev)
        p["c_norm"] = L.rmsnorm_init(ds, dtype, dev)
    return p


def mamba_param_specs(cfg, *, dtype=torch.float32) -> dict:
    """:func:`init_mamba`'s tree as ``device="meta"`` tensors (nothing
    materialised)."""
    return L.param_specs_of(lambda gen: init_mamba(gen, cfg, dtype))


def causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          state: torch.Tensor | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, di); w: (dc, di); state: the (B, dc-1, di) inputs before
    x (zeros when ``None``).  Returns (y (B, S, di), new_state (B, dc-1,
    di)).  The new state is a copy, so a cache holding it does not keep the
    padded input alive."""
    dc = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], dc - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)  # (B, S+dc-1, di)
    S = x.shape[1]
    y = sum(xp[:, j:j + S, :] * w[j][None, None, :] for j in range(dc))
    new_state = xp[:, S:, :].clone() if dc > 1 else state
    return y + b[None, None, :], new_state


def time_chunk(batch: int, d_inner: int, d_state: int) -> int:
    """Steps of time one chunk of the serving path's discretisation and
    scan takes: the most whose float32 dA and dBx fit
    :data:`SCAN_BUDGET_BYTES`, at least one."""
    return max(1, SCAN_BUDGET_BYTES // (2 * 4 * batch * d_inner * d_state))


def _selection(params: dict, x_c: torch.Tensor, cfg
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The input-dependent (dt (B, S, di), B (B, S, ds), C (B, S, ds)),
    float32, C contiguous (as the scan kernel takes it): ``x_proj``, jamba's
    inner norms where the config has them, ``dt_proj`` and softplus."""
    dr, ds = cfg.dt_rank, cfg.ssm_state
    if params["x_proj"].shape[0] < cfg.d_inner:  # this rank's channels' rows
        proj = SH.enter_model(SH.leave_model((x_c @ params["x_proj"]).float()))
    else:
        proj = (x_c @ params["x_proj"]).float()  # (B, S, dr + 2 ds)
    dt_low, Bs, Cs = torch.split(proj, [dr, ds, ds], dim=-1)
    if cfg.ssm_inner_norms:
        dt_low = L.rmsnorm(params["dt_norm"], dt_low, cfg.rmsnorm_eps)
        Bs = L.rmsnorm(params["b_norm"], Bs, cfg.rmsnorm_eps)
        Cs = L.rmsnorm(params["c_norm"], Cs, cfg.rmsnorm_eps)
    dt = F.softplus(dt_low @ params["dt_proj"].float() + params["dt_bias"])  # (B, S, di)
    return dt, Bs, Cs.contiguous()


def _discretize(dt: torch.Tensor, A: torch.Tensor, Bs: torch.Tensor,
                x_c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(dA, dBx) (B, T, di, ds), float32 and contiguous, of T steps' dt
    (B, T, di), B (B, T, ds) and conv output x_c (B, T, di).  With grad mode
    off the exponential and the last product are taken in place, which
    saves one (B, T, di, ds) temporary each."""
    if torch.is_grad_enabled():
        dA = torch.exp(dt[..., None] * A[None, None])
        dBx = dt[..., None] * Bs[:, :, None, :] * x_c.float()[..., None]
    else:
        dA = (dt[..., None] * A[None, None]).exp_()
        dBx = (dt[..., None] * Bs[:, :, None, :]).mul_(x_c.float()[..., None])
    return dA, dBx


# The sequential oracle, (dA, dBx, Cs, h0=None) -> (y, h_last): the scan
# kernel's plain version.
selective_scan_reference = ref.selective_scan_ref


def _assoc_combine(e1, e2):
    """The scan's operator: e1 then e2, each a (decay, offset) pair."""
    a1, b1 = e1
    a2, b2 = e2
    return a2 * a1, a2 * b1 + b2


def _assoc_scan(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of :func:`_assoc_combine` along axis 1 by doubling
    (Hillis-Steele): log2(n) rounds, each combining element i with i - k."""
    k = 1
    while k < a.shape[1]:
        a2, b2 = _assoc_combine((a[:, :-k], b[:, :-k]), (a[:, k:], b[:, k:]))
        a = torch.cat([a[:, :k], a2], dim=1)
        b = torch.cat([b[:, :k], b2], dim=1)
        k *= 2
    return a, b


def _scan_chunk(a: torch.Tensor, bx: torch.Tensor, c: torch.Tensor, h: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk of :func:`selective_scan_chunked`: (y, the state after
    it) from the chunk's (a, bx, c) and the state ``h`` before it."""
    # h_t = (prod a)(h_in) + scan(b): fold h_in in via the first b term
    bx0 = bx.clone()
    bx0[:, 0] += a[:, 0] * h
    _, h_all = _assoc_scan(a, bx0)
    return torch.einsum("bcds,bcs->bcd", h_all, c), h_all[:, -1].clone()


def selective_scan_chunked(dA: torch.Tensor, dBx: torch.Tensor, Cs: torch.Tensor,
                           h0: torch.Tensor | None = None, chunk: int = 256
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunk-recurrent parallel scan (the fused-layer execution): a loop
    over chunks carries the state; inside a chunk the recurrence runs as a
    parallel scan.  The returned state is a copy, so a cache holding it
    does not keep the chunk's (B, chunk, di, ds) state sequence alive.

    With grad mode on, each chunk is recomputed in the backward
    (``torch.utils.checkpoint``): the doubling scan's log2(chunk) rounds
    of (B, chunk, di, ds) pairs are saved for one chunk at a time, not for
    all of them (40 GB a falcon-mamba layer at 4096 tokens otherwise).  The
    gradients are the same bits."""
    B, S, di, ds = dA.shape
    if S % chunk:
        chunk = S
    h = torch.zeros((B, di, ds), dtype=torch.float32, device=dA.device) if h0 is None else h0
    ys = []
    for i in range(0, S, chunk):
        part = (dA[:, i:i + chunk], dBx[:, i:i + chunk], Cs[:, i:i + chunk], h)
        if torch.is_grad_enabled():
            y, h = checkpoint(_scan_chunk, *part, use_reentrant=False)
        else:
            y, h = _scan_chunk(*part)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def mamba_block(params: dict, x: torch.Tensor, cfg, cache: dict | None = None, *,
                scan: Callable | None = None
                ) -> tuple[torch.Tensor, dict | None]:
    """One Mamba-1 mixer over x (B, S, d).

    ``cache`` is ``{"conv": (B, dc-1, di), "h": (B, di, ds) float32}`` or
    ``None``; the new one is returned (``None`` without a cache).
    ``scan(dA, dBx, C, h0) -> (y, h_last)`` is the recurrence's fusion group
    (default ``ops.KERNELS.ssm_scan``: the kernel on a CUDA tensor, the
    plain version on a CPU one).  Projections and the convolution run in
    ``x.dtype``; the discretisation, the scan and ``y + D x`` in float32.
    """
    scan = ops.KERNELS.ssm_scan if scan is None else scan
    B, S, _ = x.shape
    di, dil = cfg.d_inner, params["conv_w"].shape[1]
    split = dil < di  # this rank's channels of d_inner
    spans.count("mamba.tokens", B * S)
    with spans.span(spans.MAMBA_IN):
        if split:
            mine = SH.head_slice(di, dil)
            w = SH.enter_model(params["in_proj"])
            w = torch.cat([w[:, mine], w[:, di + mine.start:di + mine.stop]], dim=1)
            xz = SH.enter_model(x) @ w
        else:
            xz = x @ params["in_proj"]
        x_in, z = torch.chunk(xz, 2, dim=-1)

        conv_state = SH.cache_open(cache["conv"]) if cache is not None else None
        x_c, new_conv = causal_depthwise_conv(x_in, params["conv_w"], params["conv_b"],
                                              conv_state)
        x_c = F.silu(x_c)

    with spans.span(spans.MAMBA_DISCRETIZE):
        dt, Bs, Cs = _selection(params, x_c, cfg)
        A = -torch.exp(params["A_log"])  # (di, ds)
    h = SH.cache_open(cache["h"]) if cache is not None else None
    T = S if torch.is_grad_enabled() else time_chunk(B, dil, cfg.ssm_state)
    ys = []
    for t in range(0, S, T):
        part = slice(t, t + T)
        with spans.span(spans.MAMBA_DISCRETIZE):
            dA, dBx = _discretize(dt[:, part], A, Bs[:, part], x_c[:, part])
        with spans.span(spans.MAMBA_SCAN):
            y_part, h = scan(dA, dBx, Cs[:, part].contiguous(), h)
        spans.count("mamba.scans", 1)
        del dA, dBx
        ys.append(y_part)
    y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)
    del ys, dt

    with spans.span(spans.MAMBA_OUT):
        y = y + params["D"][None, None, :] * x_c.float()
        y = y.to(x.dtype) * F.silu(z)
        out = y @ params["out_proj"]
        if split:
            out = SH.leave_model(out)
    new_cache = None
    if cache is not None:
        new_cache = {"conv": SH.cache_piece(cache["conv"], new_conv),
                     "h": SH.cache_piece(cache["h"], h)}
    return out, new_cache


def init_mamba_cache(cfg, batch: int, dtype, device) -> dict:
    """A zeroed Mamba cache: the conv inputs in ``dtype``, the state in
    float32."""
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state), dtype=torch.float32,
                         device=device),
    }
