"""Dispatch wrappers the models call, and the kernel sets they run through.

A CPU tensor goes to the plain PyTorch version of a kernel; a CUDA tensor
goes to the hand-written Hopper kernel or raises — nothing on a GPU falls
back to the plain version.  This replaces the reference's ``INTERPRET``
flag: the tensor's device decides, and ``device=`` (default ``"cuda"``)
states which one the caller means, so a CPU run has to be asked for.

Three kernel sets (:class:`FusedKernels`): :data:`KERNELS` (serving: K2,
K3, K4), :data:`PLAIN` (their plain versions, for comparison) and
:func:`train_kernels` (training: K2 with its backward kernel; the MLP and
the scan in the model's own torch ops, as the reference trains them
through ``jnp``).  K1, K3 and K4 have no backward
kernel and raise on CUDA tensors that require grad.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from ..device import resolve_device
from . import fused_attention, fused_conv, fused_mlp, mamba_scan, ref


def _on(device, x: torch.Tensor, name: str) -> None:
    """Resolve ``device`` and check that ``x`` lies on it."""
    dev = resolve_device(device)
    if x.device.type != dev.type:
        raise ValueError(f"{name}(device={str(dev)!r}) was given a tensor on {x.device}")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, chunk: int = 0,
              block_q: int | None = None, block_k: int | None = None,
              device: "str | torch.device" = "cuda") -> torch.Tensor:
    """Flash attention (K2) of ``q`` (B, Sq, H, hd) over ``k``, ``v``
    (B, Skv, KV, hd), positions from 0.  On ``device="cuda"`` (the
    default) the tensors must be CUDA tensors and the kernel runs at the
    tile ``block_q`` x ``block_k`` (``None``: the kernel's default); on
    ``device="cpu"`` the plain version runs.  Without CUDA the default
    raises."""
    _on(device, q, "attention")
    return fused_attention.flash_attention(
        q, k, v, causal=causal, window=window, chunk=chunk,
        block_q=block_q, block_k=block_k)


def mlp(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
        w3: torch.Tensor | None = None, *, act: str = "swiglu",
        block_m: int | None = None, block_f: int | None = None,
        device: "str | torch.device" = "cuda") -> torch.Tensor:
    """Fused MLP (K3), ``act(x @ w1) [* (x @ w3)] @ w2`` for ``x`` (T, d).
    Devices as :func:`attention`; ``None`` tiles take the kernel's default
    for T."""
    _on(device, x, "mlp")
    return fused_mlp.fused_mlp(x, w1, w2, w3, act=act, block_m=block_m,
                               block_f=block_f)


def ssm_scan(dA: torch.Tensor, dBx: torch.Tensor, C: torch.Tensor, *,
             h0: torch.Tensor | None = None, chunk: int | None = None,
             block_d: int | None = None,
             device: "str | torch.device" = "cuda"
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Selective scan (K4) of ``dA``, ``dBx`` (B, S, di, ds) and ``C``
    (B, S, ds) from the state ``h0`` (zeros when ``None``); returns ``(y
    (B, S, di), h_last (B, di, ds))``.  Devices as :func:`attention`;
    ``None`` tiles take the planner's (chunk 64, block_d min(512, di))."""
    _on(device, dA, "ssm_scan")
    return mamba_scan.selective_scan(dA, dBx, C, h0, chunk=chunk, block_d=block_d)


@dataclasses.dataclass(frozen=True)
class FusedKernels:
    """The fusion groups the model runs through: ``attention(q, k, v, *,
    causal, window, chunk)``, ``mlp(x, w1, w2, w3, *, act)`` and
    ``ssm_scan(dA, dBx, C, h0) -> (y, h_last)``.  The default is the
    kernels' wrappers (the kernels on a CUDA tensor, their plain versions on
    a CPU one); :data:`PLAIN` is the plain versions on any device, for
    comparison."""

    attention: Callable = fused_attention.flash_attention
    mlp: Callable = fused_mlp.fused_mlp
    ssm_scan: Callable = mamba_scan.selective_scan


KERNELS = FusedKernels()
PLAIN = FusedKernels(attention=ref.flash_attention_ref, mlp=ref.fused_mlp_ref,
                     ssm_scan=ref.selective_scan_ref)


def train_kernels(mamba_chunk: int = 256) -> FusedKernels:
    """The training path's kernel set: attention through K2, which is
    differentiable on CUDA tensors (its backward kernel); the MLP and the
    selective scan (chunks of ``mamba_chunk``) in the model's own torch
    ops, as the reference trains them."""
    from ..models.ssm import selective_scan_chunked

    return FusedKernels(attention=fused_attention.flash_attention, mlp=ref.mlp,
                        ssm_scan=functools.partial(selective_scan_chunked, chunk=mamba_chunk))


def conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
            pool: bool = False,
            device: "str | torch.device" = "cuda") -> torch.Tensor:
    """Fused 3x3 SAME conv + bias + ReLU (+ 2x2 max-pool), NHWC / HWIO.

    On ``device="cuda"`` (the default) ``x`` must be a CUDA tensor and the
    fused_conv3x3 kernel runs; on ``device="cpu"`` ``x`` must be a CPU
    tensor and the plain version runs.  Without CUDA the default raises.
    """
    _on(device, x, "conv3x3")
    return fused_conv.fused_conv3x3(x, w, b, pool=pool)


def fused_conv_fn(plan=None, *, device: "str | torch.device" = "cuda"):
    """Adapter for ``VGG16.forward(x, fused_conv_fn=...)``: every conv +
    ReLU (+ pool) group through :func:`conv3x3` on ``device``.

    ``plan`` is a :class:`repro_torch.core.planner.FusionPlan` or ``None``.
    The Hopper kernel's tiles are fixed at build time, so a plan is taken
    when its ``conv_block_c`` is the built ``fused_conv.BLOCK_C`` (the
    planner's choice) and refused otherwise.
    """
    if plan is not None and plan.conv_block_c != fused_conv.BLOCK_C:
        raise ValueError(
            f"plan.conv_block_c = {plan.conv_block_c}: the fused_conv3x3 "
            f"kernel is built for {fused_conv.BLOCK_C} output channels a block"
        )
    resolve_device(device)

    def fn(x, w, b, *, pool):
        return conv3x3(x, w, b, pool=pool, device=device)

    return fn
