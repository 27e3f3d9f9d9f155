"""Prefill / decode step builders (the port of the JAX package's
``runtime/steps.py`` for serving; the train step waits for the training
slice).  PyTorch runs eagerly, so a step is a plain closure over the
config and the fusion groups it runs through."""
from __future__ import annotations

from ..kernels import ops
from ..models import model as M


def make_prefill_step(cfg, rc, *, kernels: ops.FusedKernels = ops.KERNELS):
    """prefill_step(params, cache, batch) -> (logits (B, 1, V), cache)."""

    def prefill_step(params, cache, batch):
        return M.prefill(params, cfg, rc, batch, cache, kernels=kernels)

    return prefill_step


def make_decode_step(cfg, rc, *, kernels: ops.FusedKernels = ops.KERNELS):
    """decode_step(params, cache, tokens) -> (logits (B, 1, V), cache)."""

    def decode_step(params, cache, tokens):
        return M.decode(params, cfg, rc, tokens, cache, kernels=kernels)

    return decode_step
