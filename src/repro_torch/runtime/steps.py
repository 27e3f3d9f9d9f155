"""Train / prefill / decode step builders (the port of the JAX package's
``runtime/steps.py``).  PyTorch runs eagerly, so a step is a plain closure
over the config and the fusion groups it runs through.

``make_train_step`` supports gradient accumulation (``rc.microbatches``),
the lever that keeps activation memory inside the card for the large
train cells, with float32 gradient accumulators.  The step is functional,
as the reference's is: it returns new parameters and optimizer state and
leaves its arguments as they were.  Given shardings, it is the sharded
(ZeRO-3 style) step over a device mesh: see :func:`make_train_step`.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..kernels import ops
from ..models import model as M
from ..optim import AdamWConfig, adamw_update, init_opt_state, warmup_cosine
from ..parallel import sharding as SH


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
    ``kernels`` defaults to ``ops.train_kernels(rc.mamba_chunk)``.

    ``grad_shardings`` (a tree of :class:`~repro_torch.parallel.sharding.
    NamedSharding` shaped like the parameters, from ``param_shardings``)
    makes it the sharded step, ZeRO-3 style: ``params`` and ``opt_state``
    are this rank's pieces under those shardings (``opt_state_shardings``)
    and the result is too.  Each step gathers the parameters, computes the
    gradients of this rank's rows of each microbatch (the rows split over
    the mesh's data axes, as ``batch_shardings`` splits them; the batch is
    given whole, the same on every rank), sums them in float32 over the
    data axes with one reduce-scatter to each rank's pieces, clips by the
    whole gradient's norm (each piece counted once) and runs AdamW on the
    pieces.  The loss is the global masked mean: each rank's weighted by
    its share of the microbatch's tokens.  The ``model`` axis stores
    pieces but computes nothing in parallel: its ranks compute the same
    rows (column- and row-parallel products are a later step).  An MoE
    config's load-balance term is each rank's own, token-weighted: a
    product of batch statistics, it differs from the whole microbatch's
    when the data axes have more than one rank.
    """
    opt_cfg = opt_cfg or AdamWConfig(
        weight_decay=rc.weight_decay,
        grad_clip=rc.grad_clip,
        state_dtype=rc.opt_state_dtype,
    )
    kernels = ops.train_kernels(rc.mamba_chunk) if kernels is None else kernels

    def grad_fn(leaves, spec, mb, weight=None):
        """(loss, grads): the gradient of every leaf (zeros for a leaf the
        loss does not reach, as the reference's), of the loss times
        ``weight`` when one is given."""
        params = pytree.tree_unflatten(leaves, spec)
        loss, _aux = M.loss_fn(params, cfg, rc, mb, kernels=kernels)
        if weight is not None:
            loss = loss * weight
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return loss.detach(), grads

    if grad_shardings is not None:
        return _sharded_train_step(rc, opt_cfg, grad_shardings, grad_fn)

    def train_step(params, opt_state, batch):
        flat, spec = pytree.tree_flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in flat]
        batch = batch_to_device(batch, opt_state["step"].device)
        n = rc.microbatches
        if n > 1:
            mbs = _microbatches(batch, n)
            gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    for p in flat]
            lsum = torch.zeros((), dtype=torch.float32, device=flat[0].device)
            for mb in mbs:
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


def _microbatches(batch: dict, n: int) -> list[dict]:
    """``batch`` split into ``n`` equal parts along its first axis."""
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"batch[{k!r}] has {v.shape[0]} rows, not a multiple "
                             f"of microbatches={n}")
    size = next(iter(batch.values())).shape[0] // n
    return [{k: v[i * size:(i + 1) * size] for k, v in batch.items()} for i in range(n)]


def data_rows(n_rows: int, mesh, axes: tuple[str, ...]) -> slice:
    """This rank's rows of ``n_rows`` split over the mesh ``axes`` (outer
    axis first, as ``batch_shardings`` places them); ``ValueError`` if they
    do not split evenly."""
    sizes, coord = SH.mesh_axis_sizes(mesh), SH.mesh_coordinate(mesh)
    idx, cnt = 0, 1
    for a in axes:
        idx, cnt = idx * sizes[a] + coord[a], cnt * sizes[a]
    if n_rows % cnt:
        raise ValueError(f"{n_rows} rows do not split over the {cnt} ranks of {axes}")
    size = n_rows // cnt
    return slice(idx * size, (idx + 1) * size)


def token_weights(mbs: list[dict], group) -> list[torch.Tensor]:
    """Each microbatch's share of its tokens (labels >= 0) that this rank
    holds, over the ranks of ``group``: one all-reduce of the counts.  A
    rank's masked-mean loss times its weight, summed over the group, is the
    whole microbatch's masked mean (1.0 when the group has one rank)."""
    import torch.distributed as dist

    local = torch.stack([(mb["labels"] >= 0).sum() for mb in mbs])
    total = local.clone()
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return list(local.float() / torch.clamp(total, min=1).float())


def sharded_grad_norm(grads: list, shardings: list, mesh) -> torch.Tensor:
    """The global norm of a gradient held in pieces: each rank sums the
    squares of the pieces it owns (those whose replicas it leads: its
    coordinate is 0 on every axis the piece's spec does not split over), in
    float32 and in leaf order, and one all-reduce adds the ranks' sums."""
    import torch.distributed as dist

    names, me = SH.mesh_axis_names(mesh), SH.mesh_coordinate(mesh)
    owned = []
    for g, sh in zip(grads, shardings):
        used = {a for e in sh.spec for a in SH._axes(e)}
        if all(me[a] == 0 for a in names if a not in used):
            owned.append(torch.sum(torch.square(g.float())))
    total = sum(owned) if owned else torch.zeros((), dtype=torch.float32,
                                                   device=grads[0].device)
    dist.all_reduce(total, op=dist.ReduceOp.SUM)
    return torch.sqrt(total)


def _sharded_train_step(rc, opt_cfg, grad_shardings, grad_fn):
    """The ZeRO-3 style step of :func:`make_train_step` (``grad_shardings``
    given)."""
    import torch.distributed as dist

    shards = pytree.tree_leaves(grad_shardings)
    mesh = shards[0].mesh
    daxes = SH.data_axes(mesh)

    def train_step(params, opt_state, batch):
        flat, spec = pytree.tree_flatten(params)
        if len(flat) != len(shards):
            raise ValueError(f"{len(flat)} parameters, {len(shards)} shardings")
        group, _members = SH.axis_group(mesh, daxes)
        leaves = [SH.gather(p.detach(), sh).requires_grad_(True)
                  for p, sh in zip(flat, shards)]
        batch = batch_to_device(batch, opt_state["step"].device)
        n = rc.microbatches
        mbs = _microbatches(batch, n)
        rows = data_rows(next(iter(mbs[0].values())).shape[0], mesh, daxes)
        mbs = [{k: v[rows] for k, v in mb.items()} for mb in mbs]
        weights = token_weights(mbs, group)
        gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in leaves]
        lsum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for mb, w in zip(mbs, weights):
            loss_i, g = grad_fn(leaves, spec, mb, w)
            for a, b in zip(gsum, g):
                a.add_(b.float())
            del g
            lsum = lsum + loss_i
        del leaves
        grads = []
        for i, sh in enumerate(shards):
            piece = SH.reduce_scatter_sum(gsum[i], sh, daxes)
            gsum[i] = None
            grads.append(piece / n if n > 1 else piece)
        dist.all_reduce(lsum, op=dist.ReduceOp.SUM, group=group)
        loss_val = lsum / n if n > 1 else lsum
        gnorm = sharded_grad_norm(grads, shards, mesh)
        lr = warmup_cosine(opt_state["step"], peak_lr=rc.learning_rate,
                           warmup_steps=rc.warmup_steps)
        params, opt_state, gnorm = adamw_update(
            pytree.tree_unflatten(grads, spec), opt_state, params, lr=lr, cfg=opt_cfg,
            decay=M.decay_mask(params), grad_norm=gnorm)
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
