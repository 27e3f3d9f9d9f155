"""AdamW with global-norm clipping and a configurable state dtype.

The port of the JAX package's ``optim/adamw.py``.  Parameters, gradients
and the moments are trees (dicts and lists) of tensors with one structure;
the update math runs in float32 whatever the parameters' and the state's
dtypes, and the moments are stored in ``state_dtype`` (float32 or
bfloat16: bfloat16 halves the state of the largest models).  The update is
functional: new tensors are returned and the inputs are left as they are.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils import _pytree as pytree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"  # "float32" | "bfloat16"


def _state_dtype(cfg: AdamWConfig) -> torch.dtype:
    if cfg.state_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"state_dtype {cfg.state_dtype!r}: float32 or bfloat16")
    return getattr(torch, cfg.state_dtype)


def init_opt_state(params, cfg: AdamWConfig) -> dict:
    """Zero moments ``m`` and ``v`` shaped like ``params`` (on their
    devices, in ``cfg.state_dtype``) and ``step``, an int32 scalar on the
    first parameter's device."""
    dt = _state_dtype(cfg)
    leaves = pytree.tree_leaves(params)
    device = leaves[0].device if leaves else torch.device("cpu")

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return {"m": pytree.tree_map(zeros, params), "v": pytree.tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    leaves = pytree.tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))


def _decay_mask(p: torch.Tensor) -> bool:
    """Weight decay only on >=2-D tensors (skip norms, biases, scalars)."""
    return p.dim() >= 2


def adamw_update(grads, opt_state: dict, params, *, lr, cfg: AdamWConfig,
                 decay=None, grad_norm: torch.Tensor | None = None):
    """Returns (new_params, new_opt_state, grad_norm).  Math in float32:
    the gradients are clipped to a global norm of ``cfg.grad_clip``, the
    moments updated and bias-corrected, decoupled weight decay added where
    ``decay`` (a tree of bools shaped like ``params``; default: the >=2-D
    tensors) says, and each new parameter rounded to its own dtype.  The
    update is elementwise, so it runs as well on shards of the tensors; the
    clipping norm is then the whole gradient's, given as ``grad_norm``
    (default: :func:`global_norm` of ``grads``)."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=stepf.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=stepf.device), stepf)
    state_dt = _state_dtype(cfg)
    lr = torch.as_tensor(lr, dtype=torch.float32)

    def upd(p, g, m, v, d):
        g = g.float() * scale
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if d:
            delta = delta + cfg.weight_decay * p.float()
        new_p = p.float() - lr * delta
        return new_p.to(p.dtype), m32.to(state_dt), v32.to(state_dt)

    flat_p, spec = pytree.tree_flatten(params)
    flat_g = pytree.tree_leaves(grads)
    flat_m = pytree.tree_leaves(opt_state["m"])
    flat_v = pytree.tree_leaves(opt_state["v"])
    flat_d = ([_decay_mask(p) for p in flat_p] if decay is None
              else pytree.tree_leaves(decay))
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v) == len(flat_d):
        raise ValueError("params, grads, the moments and the decay mask differ "
                         "in structure")
    out = [upd(*leaf) for leaf in zip(flat_p, flat_g, flat_m, flat_v, flat_d)]
    new_params = pytree.tree_unflatten([o[0] for o in out], spec)
    new_m = pytree.tree_unflatten([o[1] for o in out], spec)
    new_v = pytree.tree_unflatten([o[2] for o in out], spec)
    return new_params, {"m": new_m, "v": new_v, "step": step}, gnorm
