"""GPipe-style pipeline parallelism over a mesh's ``stage`` axis.

The port of the JAX package's ``parallel/pipeline.py``.  ``stages``
consecutive layer groups live on the ranks along ``stage``; microbatches
stream through with point-to-point hand-offs.  The schedule is the classic
GPipe fill / steady / drain loop over ``n_micro + stages - 1`` ticks: at
every tick each stage runs its layer group on the activation it received
last tick (stage 0 on the next microbatch), then sends its output to the
next stage of the ring.

Bubble fraction = (stages - 1) / ticks (:func:`bubble_fraction`); the
cross-stage traffic is ticks x one microbatch's activation.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from . import sharding as SH


def bubble_fraction(n_micro: int, stages: int) -> float:
    ticks = n_micro + stages - 1
    return (stages - 1) / ticks


def pipeline_apply(stage_fn, stacked_params, x_micro: torch.Tensor, *, mesh,
                   axis: str = "stage") -> torch.Tensor:
    """Run the GPipe schedule over the mesh's ``axis``.

    ``stage_fn(stage_params, x) -> x`` is one stage's layer group;
    ``stacked_params`` a tree whose leaves are (stages, ...), of which this
    rank uses its stage's entry; ``x_micro`` (n_micro, mb, ...) the
    microbatched input, the same on every rank.  Returns the (n_micro, mb,
    ...) outputs on every rank: the last stage's, broadcast along ``axis``.
    """
    import torch.distributed as dist

    stages = SH.mesh_axis_sizes(mesh)[axis]
    stage = SH.mesh_coordinate(mesh)[axis]
    group, members = SH.axis_group(mesh, (axis,))
    n_micro = x_micro.shape[0]
    ticks = n_micro + stages - 1
    params = pytree.tree_map(lambda p: p[stage], stacked_params)
    nxt, prv = members[(stage + 1) % stages], members[(stage - 1) % stages]
    inflight = torch.zeros_like(x_micro[0])
    outputs = torch.zeros_like(x_micro)
    for t in range(ticks):
        # Stage s holds microbatch t - s at tick t; outside that window it
        # has nothing to compute and hands on what it holds.
        busy = 0 <= t - stage < n_micro
        if busy:
            x_in = x_micro[t] if stage == 0 else inflight
            y = stage_fn(params, x_in)
            if stage == stages - 1:
                outputs[t - stage] = y
        else:
            y = inflight
        if stages > 1:
            received = torch.empty_like(y)
            ops = [dist.P2POp(dist.isend, y.contiguous(), nxt, group),
                   dist.P2POp(dist.irecv, received, prv, group)]
            for work in dist.batch_isend_irecv(ops):
                work.wait()
            inflight = received
    if stages > 1:
        dist.broadcast(outputs, src=members[stages - 1], group=group)
    return outputs
