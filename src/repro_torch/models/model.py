"""Model dispatch: one API over the decoder-only models (attention, MoE and
Mamba-1 sublayers: qwen3, mixtral, falcon-mamba, ...) and the
encoder-decoder (seamless).

``init_params / abstract_params / params_from_jax / forward / loss_fn /
init_cache / abstract_cache / prefill / decode``, the port of the JAX package's ``models/model.py``, dispatch on
``cfg.is_encoder_decoder``; launch scripts and tests import this module.
Entry points that create tensors default to ``device="cuda"`` and raise
without CUDA.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from ..kernels import ops
from . import encdec as ED
from . import layers as L
from . import transformer as T


def init_params(cfg, *, generator: torch.Generator | None = None,
                device: "str | torch.device" = "cuda") -> dict:
    """Parameters on ``device`` drawn from ``generator`` (which must live on
    that device; ``None`` seeds a fresh one with 0)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator lives on {generator.device}, not {dev}")
    if cfg.is_encoder_decoder:
        return ED.init_params(generator, cfg)
    return T.init_params(generator, cfg)


def abstract_params(cfg) -> dict:
    """The parameters :func:`init_params` makes for ``cfg``, as ``"meta"``
    tensors of the same shapes and dtypes (nothing is drawn or allocated):
    the counterpart of the reference's ``jax.eval_shape`` of its init."""
    if cfg.is_encoder_decoder:
        return L.param_specs_of(lambda gen: ED.init_params(gen, cfg))
    return L.param_specs_of(lambda gen: T.init_params(gen, cfg))


def params_from_jax(cfg, tree: dict) -> dict:
    """The reference's parameter pytree (numpy arrays, layers stacked) as
    this package's parameters (one dict per layer), on the CPU."""
    if cfg.is_encoder_decoder:
        return ED.params_from_jax(tree)
    return T.params_from_jax(tree)


def forward(params, cfg, rc, batch: dict, cache=None, *,
            kernels: ops.FusedKernels = ops.KERNELS):
    """(hidden, new_cache | None, aux); see :func:`transformer.forward` and
    :func:`encdec.forward`."""
    if cfg.is_encoder_decoder:
        return ED.forward(params, cfg, rc, batch, cache, kernels=kernels)
    return T.forward(params, cfg, rc, batch, cache, kernels=kernels)


_STACKS = ("segments", "enc_stack", "dec_stack")


def decay_mask(params) -> object:
    """Which parameters AdamW decays, a tree of bools shaped like
    ``params``, as the reference decides: the tensors of >= 2 dims in the
    reference's layout, which stacks the layers of each segment (and of
    each encoder-decoder stack) on a leading axis.  So every per-layer
    tensor decays, its norm scales too, as do the embedding and the head;
    the final norms do not."""

    def mark(node, stacked: bool):
        if isinstance(node, dict):
            return {k: mark(v, stacked or k in _STACKS) for k, v in node.items()}
        if isinstance(node, list):
            return [mark(v, stacked) for v in node]
        return node.dim() + int(stacked) >= 2

    return mark(params, False)


def loss_fn(params, cfg, rc, batch: dict, *,
            kernels: ops.FusedKernels | None = None) -> tuple[torch.Tensor, dict]:
    """(loss, {"nll", "aux"}): the decoder-only trunk's
    (:func:`transformer.loss_fn`: NLL + 0.01 x the MoE aux), or the
    encoder-decoder's NLL over the decoder's tokens under its tied
    embedding.  Labels < 0 are ignored; ``kernels`` defaults to
    ``ops.train_kernels(rc.mamba_chunk)``."""
    if not cfg.is_encoder_decoder:
        return T.loss_fn(params, cfg, rc, batch, kernels=kernels)
    kernels = ops.train_kernels(rc.mamba_chunk) if kernels is None else kernels
    h, _, aux = ED.forward(params, cfg, rc, batch, kernels=kernels)
    labels = batch["labels"]
    mask = labels >= 0
    nll = L.chunked_cross_entropy(h, params["embed"].T, torch.clamp(labels, min=0).long(),
                                  chunk=rc.xent_chunk, mask=mask)
    return nll, {"nll": nll, "aux": aux}


def init_cache(cfg, batch: int, max_seq: int, *, ring: bool = False,
               device: "str | torch.device" = "cuda") -> dict:
    """A zeroed decode cache for ``batch`` sequences of ``max_seq``: KV
    buffers for attention sublayers (window-sized rings for the local ones
    with ``ring=True``), conv inputs and the float32 SSM state for Mamba
    sublayers (their size does not grow with ``max_seq``); for the
    encoder-decoder, the decoder's self-attention buffers and the
    cross-attention buffers for ``cfg.frontend_len`` encoder frames."""
    dev = resolve_device(device)
    if cfg.is_encoder_decoder:
        return ED.init_cache(cfg, batch, max_seq, cfg.frontend_len, device=dev)
    return T.init_cache(cfg, batch, max_seq, ring=ring, device=dev)


def abstract_cache(cfg, batch: int, max_seq: int, *, ring: bool = False) -> dict:
    """The cache :func:`init_cache` makes, as ``"meta"`` tensors (its
    ``"len"`` stays the int 0)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils import _pytree as pytree

    with FakeTensorMode():
        if cfg.is_encoder_decoder:
            tree = ED.init_cache(cfg, batch, max_seq, cfg.frontend_len,
                                 device=torch.device("cpu"))
        else:
            tree = T.init_cache(cfg, batch, max_seq, ring=ring, device=torch.device("cpu"))
    return pytree.tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta")
        if isinstance(t, torch.Tensor) else t, tree)


def _logits_last(params, cfg, rc, h: torch.Tensor) -> torch.Tensor:
    """Logits of the final position, float32; the encoder-decoder's head is
    its tied embedding."""
    if cfg.is_encoder_decoder:
        return (h[:, -1:, :] @ params["embed"].T).float()
    return T.logits_last(params, cfg, rc, h)


def prefill(params, cfg, rc, batch: dict, cache, *,
            kernels: ops.FusedKernels = ops.KERNELS):
    """Run the prompt through the model, filling the cache.

    Returns (last-position logits (B, 1, V) float32, new_cache).
    """
    h, new_cache, _ = forward(params, cfg, rc, batch, cache, kernels=kernels)
    return _logits_last(params, cfg, rc, h), new_cache


def decode(params, cfg, rc, tokens: torch.Tensor, cache, extras: dict | None = None,
           *, kernels: ops.FusedKernels = ops.KERNELS):
    """One decode step.  tokens: (B, 1).  Returns (logits (B, 1, V), cache)."""
    batch = {"tokens": tokens}
    if extras:
        batch.update(extras)
    h, new_cache, _ = forward(params, cfg, rc, batch, cache, kernels=kernels)
    return _logits_last(params, cfg, rc, h), new_cache
