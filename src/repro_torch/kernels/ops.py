"""Dispatch wrappers the models call.

A CPU tensor goes to the plain PyTorch version of a kernel; a CUDA tensor
goes to the hand-written Hopper kernel or raises — nothing on a GPU falls
back to the plain version.  This replaces the reference's ``INTERPRET``
flag: the tensor's device decides, and ``device=`` (default ``"cuda"``)
states which one the caller means, so a CPU run has to be asked for.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from . import fused_conv


def conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
            pool: bool = False,
            device: "str | torch.device" = "cuda") -> torch.Tensor:
    """Fused 3x3 SAME conv + bias + ReLU (+ 2x2 max-pool), NHWC / HWIO.

    On ``device="cuda"`` (the default) ``x`` must be a CUDA tensor and the
    fused_conv3x3 kernel runs; on ``device="cpu"`` ``x`` must be a CPU
    tensor and the plain version runs.  Without CUDA the default raises.
    """
    dev = resolve_device(device)
    if x.device.type != dev.type:
        raise ValueError(
            f"conv3x3(device={str(dev)!r}) was given a tensor on {x.device}"
        )
    return fused_conv.fused_conv3x3(x, w, b, pool=pool)


def fused_conv_fn(plan=None, *, device: "str | torch.device" = "cuda"):
    """Adapter for ``VGG16.forward(x, fused_conv_fn=...)``: every conv +
    ReLU (+ pool) group through :func:`conv3x3` on ``device``.

    ``plan`` mirrors the reference signature; the Hopper kernel's tiles are
    fixed at build time (``fused_conv.BLOCK_C`` etc.), so only ``None`` is
    accepted until a planner sizes them.
    """
    if plan is not None:
        raise NotImplementedError(
            "plan-sized conv tiles are not supported: the fused_conv3x3 "
            "kernel's tiles are fixed at build time"
        )
    resolve_device(device)

    def fn(x, w, b, *, pool):
        return conv3x3(x, w, b, pool=pool, device=device)

    return fn
