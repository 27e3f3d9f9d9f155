"""Train / prefill / decode step builders (the port of the JAX package's
``runtime/steps.py``).  PyTorch runs eagerly, so a step is a plain closure
over the config and the fusion groups it runs through.

``make_train_step`` supports gradient accumulation (``rc.microbatches``),
the lever that keeps activation memory inside the card for the large
train cells, with float32 gradient accumulators.  The step is functional,
as the reference's is: it returns new parameters and optimizer state and
leaves its arguments as they were.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..kernels import ops
from ..models import model as M
from ..optim import AdamWConfig, adamw_update, init_opt_state, warmup_cosine


def batch_to_device(batch: dict, device) -> dict:
    """A batch (numpy arrays, as ``TokenStream`` makes them, or tensors) as
    tensors on ``device``: integer arrays as int64, the rest as they are."""

    def move(x):
        t = torch.from_numpy(x) if isinstance(x, np.ndarray) else torch.as_tensor(x)
        if not t.dtype.is_floating_point:
            t = t.long()
        return t.to(device)

    return {k: move(v) for k, v in batch.items()}


def make_train_step(cfg, rc, opt_cfg: AdamWConfig | None = None,
                    grad_shardings=None, *,
                    kernels: ops.FusedKernels | None = None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics) with metrics {"loss", "grad_norm", "lr"} (float32 scalars).

    The batch is split into ``rc.microbatches`` equal parts along its first
    axis (a batch that does not divide raises ``ValueError``); each
    microbatch's gradients are added into float32 sums, which are divided
    by the count; then ``warmup_cosine`` at the state's step and
    ``adamw_update`` with the reference's decay mask (``M.decay_mask``).
    ``kernels`` defaults to ``ops.train_kernels(rc.mamba_chunk)``.  ``grad_shardings`` pins the
    reference's gradients to an FSDP sharding; one device has none, so
    only ``None`` is taken.
    """
    if grad_shardings is not None:
        raise NotImplementedError("grad_shardings: one device has no sharding to pin")
    opt_cfg = opt_cfg or AdamWConfig(
        weight_decay=rc.weight_decay,
        grad_clip=rc.grad_clip,
        state_dtype=rc.opt_state_dtype,
    )
    kernels = ops.train_kernels(rc.mamba_chunk) if kernels is None else kernels

    def grad_fn(leaves, spec, mb):
        """(loss, grads): the gradient of every leaf (zeros for a leaf the
        loss does not reach, as the reference's)."""
        params = pytree.tree_unflatten(leaves, spec)
        loss, _aux = M.loss_fn(params, cfg, rc, mb, kernels=kernels)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return loss.detach(), grads

    def train_step(params, opt_state, batch):
        flat, spec = pytree.tree_flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in flat]
        batch = batch_to_device(batch, opt_state["step"].device)
        n = rc.microbatches
        if n > 1:
            for k, v in batch.items():
                if v.shape[0] % n:
                    raise ValueError(f"batch[{k!r}] has {v.shape[0]} rows, not a multiple "
                                     f"of microbatches={n}")
            size = next(iter(batch.values())).shape[0] // n
            gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    for p in flat]
            lsum = torch.zeros((), dtype=torch.float32, device=flat[0].device)
            for i in range(n):
                mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                loss_i, g = grad_fn(leaves, spec, mb)
                for a, b in zip(gsum, g):
                    a.add_(b.float())
                del g
                lsum = lsum + loss_i
            grads = [g / n for g in gsum]
            loss_val = lsum / n
        else:
            loss_val, grads = grad_fn(leaves, spec, batch)
        del leaves
        lr = warmup_cosine(opt_state["step"], peak_lr=rc.learning_rate,
                           warmup_steps=rc.warmup_steps)
        params, opt_state, gnorm = adamw_update(
            pytree.tree_unflatten(grads, spec), opt_state, params, lr=lr, cfg=opt_cfg,
            decay=M.decay_mask(params))
        metrics = {"loss": loss_val, "grad_norm": gnorm, "lr": lr}
        return params, opt_state, metrics

    return train_step


def make_init(cfg, rc, opt_cfg: AdamWConfig | None = None, *,
              device: "str | torch.device" = "cuda"):
    """Returns init(generator) -> (params, opt_state): the parameters drawn
    from ``generator`` on ``device`` and zero optimizer state."""
    opt_cfg = opt_cfg or AdamWConfig(state_dtype=rc.opt_state_dtype)

    def init(generator: torch.Generator | None = None):
        params = M.init_params(cfg, generator=generator, device=device)
        return params, init_opt_state(params, opt_cfg)

    return init


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
