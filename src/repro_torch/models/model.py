"""Model dispatch: one API over the decoder-only models (attention and
Mamba-1 sublayers: qwen3, falcon-mamba, ...).

``init_params / forward / init_cache / prefill / decode``, the port of the
JAX package's ``models/model.py``; launch scripts and tests import this
module.  Encoder-decoder configs raise ``NotImplementedError`` (ROADMAP).
Entry points that create tensors default to ``device="cuda"`` and raise
without CUDA.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from ..kernels import ops
from . import transformer as T


def _decoder_only(cfg) -> None:
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported (ROADMAP Queue 1)")


def init_params(cfg, *, generator: torch.Generator | None = None,
                device: "str | torch.device" = "cuda") -> dict:
    """Parameters on ``device`` drawn from ``generator`` (which must live on
    that device; ``None`` seeds a fresh one with 0)."""
    _decoder_only(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator lives on {generator.device}, not {dev}")
    return T.init_params(generator, cfg)


def forward(params, cfg, rc, batch: dict, cache=None, *,
            kernels: ops.FusedKernels = ops.KERNELS):
    """(hidden, new_cache | None, aux); see :func:`transformer.forward`."""
    _decoder_only(cfg)
    return T.forward(params, cfg, rc, batch, cache, kernels=kernels)


def init_cache(cfg, batch: int, max_seq: int, *, ring: bool = False,
               device: "str | torch.device" = "cuda") -> dict:
    """A zeroed decode cache for ``batch`` sequences of ``max_seq``: KV
    buffers for attention sublayers, conv inputs and the float32 SSM state
    for Mamba sublayers (their size does not grow with ``max_seq``)."""
    _decoder_only(cfg)
    if ring:
        raise NotImplementedError("the window-sized ring cache is not ported "
                                  "(ROADMAP Queue 1)")
    return T.init_cache(cfg, batch, max_seq, device=resolve_device(device))


def prefill(params, cfg, rc, batch: dict, cache, *,
            kernels: ops.FusedKernels = ops.KERNELS):
    """Run the prompt through the model, filling the cache.

    Returns (last-position logits (B, 1, V) float32, new_cache).
    """
    h, new_cache, _ = forward(params, cfg, rc, batch, cache, kernels=kernels)
    return T.logits_last(params, cfg, rc, h), new_cache


def decode(params, cfg, rc, tokens: torch.Tensor, cache, extras: dict | None = None,
           *, kernels: ops.FusedKernels = ops.KERNELS):
    """One decode step.  tokens: (B, 1).  Returns (logits (B, 1, V), cache)."""
    batch = {"tokens": tokens}
    if extras:
        batch.update(extras)
    h, new_cache, _ = forward(params, cfg, rc, batch, cache, kernels=kernels)
    return T.logits_last(params, cfg, rc, h), new_cache
