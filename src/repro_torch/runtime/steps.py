"""Train / prefill / decode step builders (the port of the JAX package's
``runtime/steps.py``).  PyTorch runs eagerly, so a step is a plain closure
over the config and the fusion groups it runs through.

``make_train_step`` supports gradient accumulation (``rc.microbatches``),
the lever that keeps activation memory inside the card for the large
train cells, with float32 gradient accumulators.  The step is functional,
as the reference's is: it returns new parameters and optimizer state and
leaves its arguments as they were, unless it is made with ``donate=True``
(the reference's launcher jits it with ``donate_argnums=(0, 1)``): then it
writes them in place.  Given shardings, it is the sharded (ZeRO-3 style)
step over a device mesh: see :func:`make_train_step`.  With tracing on
(:mod:`.spans`) a step runs in its spans: the training step, each
microbatch's forward and backward, the gradient sums and AdamW; the
prefill step.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..kernels import ops
from ..models import model as M
from ..optim import AdamWConfig, adamw_update, init_opt_state, warmup_cosine
from ..parallel import sharding as SH
from . import spans


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
                    kernels: ops.FusedKernels | None = None, donate: bool = False):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics) with metrics {"loss", "grad_norm", "lr"} (float32 scalars).

    The batch is split into ``rc.microbatches`` equal parts along its first
    axis (a batch that does not divide raises ``ValueError``); each
    microbatch's gradients are added into float32 sums, which are divided
    by the count; then ``warmup_cosine`` at the state's step and
    ``adamw_update`` with the reference's decay mask (``M.decay_mask``).
    ``kernels`` defaults to ``ops.train_kernels(rc.mamba_chunk)``.
    ``donate``: the step's parameters and optimizer moments are donated,
    as the reference's launcher donates them: the update writes the new
    values into them (``adamw_update(inplace=True)``, the same bits) and
    returns them, so a step holds the parameters, the moments and the
    float32 gradient sums (16 bytes a bfloat16 parameter with float32
    moments and microbatches) and not a second copy of the state.

    ``grad_shardings`` (a tree of :class:`~repro_torch.parallel.sharding.
    NamedSharding` shaped like the parameters, from ``param_shardings``)
    makes it the sharded step, the counterpart of the reference's step
    jitted with these shardings: ``params`` and ``opt_state`` are this
    rank's pieces under them (``opt_state_shardings``) and the result is
    too.  The batch is given whole, the same on every rank; each rank
    computes its rows (split over the mesh's data axes, as
    ``batch_shardings`` splits them).  The step gathers each parameter over
    the data axes only (ZeRO-3 storage) and runs the model on the mesh
    (``sharding.use_mesh``), which computes each rank's share on the
    ``model`` axis: attention heads, MLP columns, experts, Mamba channels
    and vocabulary rows.  A parameter whose ``model`` piece does not fall on
    whole units (``sharding.model_gathered``) is gathered over ``model``
    too and computed replicated.  Each microbatch's gradients are
    reduce-scattered over the data axes into float32 sums of this rank's
    pieces, as the reference pins them to the parameters' shardings; the
    step clips by the whole gradient's norm (each piece counted once) and
    runs AdamW on the pieces.  The loss is the global masked mean (each
    rank's weighted by its share of the microbatch's tokens), and an MoE
    config's load-balance term is the whole microbatch's (its statistics
    summed over the data axes).
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
        with spans.span(spans.TRAIN_FORWARD):
            loss, _aux = M.loss_fn(params, cfg, rc, mb, kernels=kernels)
            if weight is not None:
                loss = loss * weight
        grads = torch.autograd.grad(spans.backward_span(loss), leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return loss.detach(), grads

    if grad_shardings is not None:
        return _sharded_train_step(cfg, rc, opt_cfg, grad_shardings, grad_fn, donate)

    def train_step(params, opt_state, batch):
        with spans.span(spans.TRAIN_STEP):
            flat, spec = pytree.tree_flatten(params)
            leaves = [p.detach().requires_grad_(True) for p in flat]
            batch = batch_to_device(batch, opt_state["step"].device)
            n = rc.microbatches
            if n > 1:
                mbs = _microbatches(batch, n)
                with spans.span(spans.GRAD_ACCUM):
                    gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                            for p in flat]
                    lsum = torch.zeros((), dtype=torch.float32, device=flat[0].device)
                for mb in mbs:
                    loss_i, g = grad_fn(leaves, spec, mb)
                    with spans.span(spans.GRAD_ACCUM):
                        for a, b in zip(gsum, g):
                            a.add_(b.float())
                        del g
                        lsum = lsum + loss_i
                with spans.span(spans.GRAD_ACCUM):
                    grads = [g.div_(n) for g in gsum]
                    del gsum
                    loss_val = lsum / n
            else:
                loss_val, grads = grad_fn(leaves, spec, batch)
            del leaves
            lr = warmup_cosine(opt_state["step"], peak_lr=rc.learning_rate,
                               warmup_steps=rc.warmup_steps)
            params, opt_state, gnorm = adamw_update(
                pytree.tree_unflatten(grads, spec), opt_state, params, lr=lr, cfg=opt_cfg,
                decay=M.decay_mask(params), inplace=donate)
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


def _gather_plan(cfg, shardings) -> tuple[list, list]:
    """(the axes each parameter is gathered over, the layout of the
    tensor the gather gives): the data axes, and ``model`` too for a leaf
    :func:`~repro_torch.parallel.sharding.model_gathered` marks."""
    shards = pytree.tree_leaves(shardings)
    daxes = SH.data_axes(shards[0].mesh)
    over_model = pytree.tree_leaves(SH.model_gathered(shardings, cfg))
    axes = [daxes + (SH.TP,) if g else daxes for g in over_model]
    layouts = [sh if g else SH.without(sh, (SH.TP,)) for sh, g in zip(shards, over_model)]
    return axes, layouts


def _sharded_train_step(cfg, rc, opt_cfg, grad_shardings, grad_fn, donate: bool):
    """The sharded step of :func:`make_train_step` (``grad_shardings``
    given); ``donate`` updates this rank's pieces in place."""
    import torch.distributed as dist

    shards = pytree.tree_leaves(grad_shardings)
    mesh = shards[0].mesh
    daxes = SH.data_axes(mesh)
    axes, layouts = _gather_plan(cfg, grad_shardings)

    def train_step(params, opt_state, batch):
        flat, spec = pytree.tree_flatten(params)
        if len(flat) != len(shards):
            raise ValueError(f"{len(flat)} parameters, {len(shards)} shardings")
        group, _members = SH.axis_group(mesh, daxes)
        with SH.use_mesh(mesh):
            leaves = [SH.gather(p.detach(), sh, ax, strided=True).requires_grad_(True)
                      for p, sh, ax in zip(flat, shards, axes)]
            batch = batch_to_device(batch, opt_state["step"].device)
            n = rc.microbatches
            mbs = _microbatches(batch, n)
            rows = data_rows(next(iter(mbs[0].values())).shape[0], mesh, daxes)
            mbs = [{k: v[rows] for k, v in mb.items()} for mb in mbs]
            weights = token_weights(mbs, group)
            gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in flat]
            lsum = torch.zeros((), dtype=torch.float32, device=flat[0].device)
            for mb, w in zip(mbs, weights):
                loss_i, g = grad_fn(leaves, spec, mb, w)
                for i, lay in enumerate(layouts):
                    gsum[i].add_(SH.reduce_scatter_sum(g[i], lay, daxes).float())
                    g[i] = None
                lsum = lsum + loss_i
            del leaves
        grads = [s.div_(n) if n > 1 else s for s in gsum]
        del gsum
        dist.all_reduce(lsum, op=dist.ReduceOp.SUM, group=group)
        loss_val = lsum / n if n > 1 else lsum
        gnorm = sharded_grad_norm(grads, shards, mesh)
        lr = warmup_cosine(opt_state["step"], peak_lr=rc.learning_rate,
                           warmup_steps=rc.warmup_steps)
        params, opt_state, gnorm = adamw_update(
            pytree.tree_unflatten(grads, spec), opt_state, params, lr=lr, cfg=opt_cfg,
            decay=M.decay_mask(params), grad_norm=gnorm, inplace=donate)
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


def make_prefill_step(cfg, rc, *, kernels: ops.FusedKernels = ops.KERNELS,
                      shardings=None):
    """prefill_step(params, cache, batch) -> (logits (B, 1, V), cache).

    ``shardings`` = (parameter shardings, cache shardings), from
    ``param_shardings`` / ``cache_shardings``: the sharded step, the
    counterpart of the reference's prefill jitted with them (see
    :func:`_sharded_serving`)."""

    def prefill_step(params, cache, batch):
        with spans.span(spans.PREFILL_STEP):
            return M.prefill(params, cfg, rc, batch, cache, kernels=kernels)

    if shardings is not None:
        return _sharded_serving(cfg, rc, shardings, prefill_step)
    return prefill_step


def make_decode_step(cfg, rc, *, kernels: ops.FusedKernels = ops.KERNELS,
                     shardings=None):
    """decode_step(params, cache, tokens) -> (logits (B, 1, V), cache);
    ``shardings`` as :func:`make_prefill_step`'s."""

    def decode_step(params, cache, tokens):
        return M.decode(params, cfg, rc, tokens, cache, kernels=kernels)

    if shardings is not None:
        return _sharded_serving(cfg, rc, shardings, decode_step)
    return decode_step


def _cache_keep(cfg, pshard, mesh, rows_split: bool):
    """keep(names, sharding) for ``sharding.register_cache``: the axes a
    cache piece keeps while the model computes on it, its rows on the data
    axes (when the batch is split over them) and ``model`` where the model
    computes on this rank's KV heads or Mamba channels; the model gathers
    the rest at use."""
    gathered = SH.model_gathered_paths(pshard, cfg)
    kv_split = not any(p.endswith(("attn/wk", "attn/wv")) for p in gathered)
    ch_split = not any(p.endswith("mamba/conv_w") for p in gathered)
    daxes = SH.data_axes(mesh)
    tp = SH.mesh_axis_sizes(mesh).get(SH.TP, 1)

    def keep(names, sh):
        kept = set()
        lead = SH._axes(sh.spec[0]) if len(sh.spec) else ()
        if rows_split and lead and set(lead) <= set(daxes):
            kept |= set(lead)
        name = names[-1]
        if tp > 1 and ((name in ("k", "v") and kv_split and SH._on_model(sh, 2))
                       or (name == "conv" and ch_split and SH._on_model(sh, 2))
                       or (name == "h" and ch_split and SH._on_model(sh, 1))):
            kept.add(SH.TP)
        return kept

    return keep


def _sharded_serving(cfg, rc, shardings, step):
    """``step(params, cache, inputs)`` as a rank of the mesh runs it: the
    parameters gathered over the data axes (and over ``model`` where
    ``sharding.model_gathered`` says), this rank's rows of the inputs (the
    whole batch, given on every rank; all of it with ``rc.seq_shard``), the
    cache as this rank's pieces under the cache shardings, and the model
    on the mesh, which computes its share on the ``model`` axis and gathers
    at use the cache pieces it reads whole (a KV cache whose heads do not
    split, a sequence split over the data axes), writing back only this
    rank's piece.  The logits of every row come back on every rank."""
    pshard, cshard = shardings
    shards = pytree.tree_leaves(pshard)
    mesh = shards[0].mesh
    daxes = SH.data_axes(mesh)
    axes, _layouts = _gather_plan(cfg, pshard)
    rows_split = not rc.seq_shard
    keep = _cache_keep(cfg, pshard, mesh, rows_split)
    logit_rows = SH.NamedSharding(mesh, SH.P(daxes))

    def sharded_step(params, cache, inputs):
        flat, spec = pytree.tree_flatten(params)
        if len(flat) != len(shards):
            raise ValueError(f"{len(flat)} parameters, {len(shards)} shardings")
        with SH.use_mesh(mesh, rows_on_data=rows_split):
            full = pytree.tree_unflatten(
                [SH.gather(p, sh, ax, strided=True) for p, sh, ax in zip(flat, shards, axes)],
                spec)
            if rows_split:
                if isinstance(inputs, dict):
                    rows = data_rows(next(iter(inputs.values())).shape[0], mesh, daxes)
                    inputs = {k: v[rows] for k, v in inputs.items()}
                else:
                    inputs = inputs[data_rows(inputs.shape[0], mesh, daxes)]
            SH.register_cache(cache, cshard, keep)
            logits, new_cache = step(full, cache, inputs)
            del full
        if rows_split:
            logits = SH.gather(logits, logit_rows, daxes)
        return logits, new_cache

    return sharded_step
