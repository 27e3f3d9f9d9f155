"""Train step with explicit cross-pod gradient compression.

The port of the JAX package's ``runtime/spmd_train.py``.  The sharded step
(:func:`repro_torch.runtime.steps.make_train_step` with shardings) sums
gradients at full precision; this variant keeps full precision inside a
pod and sends int8 over the slow cross-pod links: each pod's mean gradient
is summed over the pod's data ranks, then :func:`~repro_torch.parallel.
compression.compressed_psum` averages it across pods with error feedback
carried between steps.

Parameters and optimizer state are replicated (every rank holds them
whole); the batch is split over ``pod`` and, inside a pod, over the other
data axes.  Ranks along ``model`` compute the same rows.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from ..kernels import ops
from ..models import model as M
from ..optim import AdamWConfig, adamw_update, warmup_cosine
from ..parallel import sharding as SH
from ..parallel.compression import compressed_psum, ef_apply
from .steps import batch_to_device, data_rows, token_weights


def make_compressed_train_step(cfg, rc, mesh, opt_cfg: AdamWConfig | None = None, *,
                               kernels: ops.FusedKernels | None = None):
    """Returns (step, init_ef).

    ``step(params, opt_state, ef, batch) -> (params, opt_state, ef,
    metrics)``: ``params`` and ``opt_state`` whole on every rank, ``ef``
    the float32 error-feedback buffers (``init_ef(params)``: zeros), the
    batch given whole.  The loss is each pod's masked mean over its rows,
    averaged over the pods; metrics {"loss", "grad_norm", "lr"}.
    """
    import torch.distributed as dist

    if "pod" not in SH.mesh_axis_names(mesh):
        raise ValueError("compressed sync needs a pod axis")
    opt_cfg = opt_cfg or AdamWConfig(
        weight_decay=rc.weight_decay, grad_clip=rc.grad_clip,
        state_dtype=rc.opt_state_dtype,
    )
    kernels = ops.train_kernels(rc.mamba_chunk) if kernels is None else kernels
    inner = tuple(a for a in SH.data_axes(mesh) if a != "pod")

    def step(params, opt_state, ef, batch):
        pod_group, _ = SH.axis_group(mesh, ("pod",))
        inner_group, _ = SH.axis_group(mesh, inner)
        n_pods = SH.mesh_axis_sizes(mesh)["pod"]
        batch = batch_to_device(batch, opt_state["step"].device)
        rows = data_rows(next(iter(batch.values())).shape[0], mesh, ("pod",) + inner)
        mb = {k: v[rows] for k, v in batch.items()}
        (w,) = token_weights([mb], inner_group)
        flat, spec = pytree.tree_flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in flat]
        loss, _aux = M.loss_fn(pytree.tree_unflatten(leaves, spec), cfg, rc, mb,
                               kernels=kernels)
        loss = loss * w
        g = torch.autograd.grad(loss, leaves, allow_unused=True)
        g = [torch.zeros_like(p) if x is None else x for p, x in zip(leaves, g)]
        del leaves
        # The pod's mean gradient: its ranks' weighted gradients summed.
        for x in g:
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=inner_group)
        loss = loss.detach()
        dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=inner_group)
        g = ef_apply(pytree.tree_unflatten(g, spec), ef)
        synced, new_ef = [], []
        for leaf in pytree.tree_leaves(g):
            red, err = compressed_psum(leaf, pod_group, mean=True)
            synced.append(red.to(leaf.dtype))
            new_ef.append(err)
        lr = warmup_cosine(opt_state["step"], peak_lr=rc.learning_rate,
                           warmup_steps=rc.warmup_steps)
        params, opt_state, gnorm = adamw_update(
            pytree.tree_unflatten(synced, spec), opt_state, params, lr=lr, cfg=opt_cfg,
            decay=M.decay_mask(params))
        dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=pod_group)
        metrics = {"loss": loss / n_pods, "grad_norm": gnorm, "lr": lr}
        return params, opt_state, pytree.tree_unflatten(new_ef, spec), metrics

    def init_ef(params):
        return pytree.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                     device=p.device), params)

    return step, init_ef
