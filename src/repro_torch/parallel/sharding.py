"""Sharding rules for every parameter, batch, cache and optimizer state of
the training stack, and the device layout of the fleet sweep's hardware
axis.

The port of the JAX package's ``parallel/sharding.py``.  The strategy is
the reference's: tensor parallelism on the ``model`` axis (attention
heads, the MLP's d_ff, the MoE expert axis, Mamba's d_inner, the
vocabulary), ZeRO-3 style storage over the data axes (``("data",)`` or
``("pod", "data")``: every weight also sharded over its largest remaining
axis), and, for batch-1 long decode, the KV cache's sequence axis over the
data axes.

A spec is a :class:`PartitionSpec`, one entry per tensor dimension: None,
an axis name, or a tuple of axis names (outer axis first, as JAX orders
them).  A :class:`NamedSharding` is (mesh, spec); the mesh is a
``DeviceMesh`` (:mod:`repro_torch.launch.mesh`) or a
:class:`~repro_torch.launch.mesh.MeshShape` (names and sizes only, enough
to compute specs).  Its :attr:`NamedSharding.placements` are the DTensor
placements the spec implies, and :func:`local_shard` / :func:`gather` /
:func:`reduce_scatter_sum` move tensors between the full and the sharded
form with the reference's index order.

The rules are keyed by the reference's parameter paths, in which each
segment's layers (and each encoder-decoder stack) are stacked on a leading
axis.  This package keeps one dict per layer, so a layer's leaf is looked
up under its stacked path and shape and the stacking entry dropped from the
spec; no spec of the reference shards a stacking axis, and the port raises
(:class:`StackedAxisSharded`) rather than guess if one ever did.

The fleet sweep's (G, H, C) hardware axis is embarrassingly parallel, so
:func:`repro_torch.core.flow.run_fleet` (``devices=``) splits it across an
ordered tuple of devices (:func:`hardware_mesh`): each device sweeps its
H-shard, and the raw planes are gathered along H on the host
(:func:`repro_torch.core.metrics.sharded_fleet_kernel`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import torch

from ..device import resolve_device
from ..launch.mesh import MeshShape

# Name of the hardware-config axis, the first field of a layout's
# fingerprint (the reference's mesh axis name).
HW_AXIS = "hardware"


def hardware_mesh(devices=None) -> tuple[torch.device, ...]:
    """The ordered devices of a hardware-axis split.

    ``devices`` may be ``None`` (every visible CUDA device), an int N
    (``cuda:0`` .. ``cuda:N-1``; more than are visible raises
    ``ValueError``), or an explicit sequence used as given — the same
    device may appear twice (``("cuda:0", "cuda:0")``: two shards on one
    card; ``("cpu", "cpu")`` in the CPU tests).  A CUDA device without
    CUDA raises ``RuntimeError``, as every entry point does.
    """
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < 1:
            raise ValueError("no CUDA device is visible; pass devices=... "
                             "explicitly (e.g. ('cpu',)) to split on the CPU")
        return tuple(torch.device("cuda", i) for i in range(n))
    if isinstance(devices, int):
        if devices < 1:
            raise ValueError(f"need >= 1 device, got {devices}")
        avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if devices > avail:
            raise ValueError(
                f"requested {devices} devices but only {avail} visible"
            )
        return tuple(torch.device("cuda", i) for i in range(devices))
    out = tuple(_checked(d) for d in devices)
    if not out:
        raise ValueError("empty device list")
    return out


def _checked(device) -> torch.device:
    """One layout entry, resolved and checked to exist."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        index = torch.cuda.current_device() if dev.index is None else dev.index
        if index >= n:
            raise ValueError(f"{str(dev)!r} requested but only {n} CUDA "
                             "devices are visible")
        dev = torch.device("cuda", index)
    return dev


def mesh_fingerprint(mesh: Sequence[torch.device]) -> tuple:
    """Hashable identity of a layout: axis name, size, and device names —
    the reference's ``(axis names, size, device ids)`` shape."""
    return (HW_AXIS, len(mesh), tuple(str(d) for d in mesh))


# ---------------------------------------------------------------------------
# Specs and shardings
# ---------------------------------------------------------------------------

def _entry(e):
    if e is None or isinstance(e, str):
        return e
    return tuple(e)


class PartitionSpec(tuple):
    """One entry per tensor dimension: None (not split), an axis name, or a
    tuple of axis names (the dimension split over their product, outer axis
    first).  ``P()`` replicates; missing trailing entries are None."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_entry(e) for e in entries))

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


P = PartitionSpec


class StackedAxisSharded(ValueError):
    """A rule of the reference would shard the axis on which it stacks a
    segment's layers, which this package's one-dict-per-layer layout does
    not have."""


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def mesh_axis_names(mesh) -> tuple[str, ...]:
    """The axis names of a ``DeviceMesh`` or a ``MeshShape``."""
    names = getattr(mesh, "axis_names", None)
    if names is None:
        names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh's dimensions need names")
    return tuple(names)


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """Axis name -> size, for a ``DeviceMesh`` or a ``MeshShape``."""
    if isinstance(mesh, MeshShape):
        return mesh.shape
    return dict(zip(mesh_axis_names(mesh), (int(s) for s in mesh.shape)))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A tensor laid out over ``mesh`` as ``spec`` says."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        """The DTensor placements: per mesh dimension ``Shard(d)`` when the
        spec splits tensor dimension d over it, else ``Replicate()``.  A
        dimension split over several mesh dimensions must name them in the
        mesh's order, the order DTensor splits in; the rules never produce
        another order on the meshes of the reference (ValueError if one
        does)."""
        try:
            from torch.distributed.tensor import Replicate, Shard
        except ImportError:  # older PyTorch
            from torch.distributed._tensor import Replicate, Shard
        names = mesh_axis_names(self.mesh)
        out = [Replicate()] * len(names)
        for d, entry in enumerate(self.spec):
            order = [names.index(a) for a in _axes(entry)]
            if order != sorted(order):
                raise ValueError(f"{self.spec}: dimension {d} is split over "
                                 f"{_axes(entry)}, not in the mesh's order {names}")
            for i in order:
                out[i] = Shard(d)
        return tuple(out)


def repair_spec(spec, shape, axis_size) -> PartitionSpec:
    """Make ``spec`` valid for ``shape``: drop axes a dim cannot host
    (indivisible / too small) and greedily re-place them on the largest
    divisible dim, as the reference does (a KV-head axis of 8 cannot host
    16-way TP, so TP migrates to the KV cache's sequence axis)."""
    out: list = [None] * len(shape)
    dropped: list = []
    used: set = set()
    for i, axis in enumerate(spec[: len(shape)]):
        if axis is None:
            continue
        axes = axis if isinstance(axis, tuple) else (axis,)
        keep = []
        size_so_far = 1
        for a in axes:
            s = axis_size(a)
            if s <= 1 or a in used:
                continue
            if shape[i] % (size_so_far * s) == 0:
                keep.append(a)
                used.add(a)
                size_so_far *= s
            else:
                dropped.append(a)
        if keep:
            out[i] = tuple(keep) if len(keep) > 1 else keep[0]
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for a in dropped:
        s = axis_size(a)
        if s <= 1 or a in used:
            continue
        used.add(a)
        for i in order:
            cur = out[i]
            cur_axes = () if cur is None else (cur if isinstance(cur, tuple) else (cur,))
            if a in cur_axes:
                continue
            total = s
            for c in cur_axes:
                total *= axis_size(c)
            if shape[i] % total == 0 and shape[i] >= total:
                out[i] = cur_axes + (a,) if cur_axes else a
                break
    return P(*out)


# (param name) -> spec builder(dp, tp), the reference's table.  Specs are
# written for the *unstacked* parameter; a leading None is added per
# stacking axis.
def _param_rules(dp, tp) -> dict[str, Any]:
    return {
        "embed": P(tp, dp),  # (V, d)
        "lm_head": P(dp, tp),  # (d, V)
        "wq": P(dp, tp),
        "wk": P(dp, tp),
        "wv": P(dp, tp),
        "wo": P(tp, dp),
        "w1": P(dp, tp),  # dense mlp (d, ff); MoE experts by path below
        "w3": P(dp, tp),
        "w2": P(tp, dp),  # (ff, d)
        "router": P(dp, None),  # (d, E)
        "moe.w1": P(tp, None, dp),  # (E, d, ff): experts on model (EP)
        "moe.w3": P(tp, None, dp),
        "moe.w2": P(tp, dp, None),  # (E, ff, d)
        "in_proj": P(dp, tp),  # mamba (d, 2*di)
        "conv_w": P(None, tp),  # (dc, di)
        "conv_b": P(tp),
        "x_proj": P(tp, None),  # (di, dr+2ds)
        "dt_proj": P(None, tp),  # (dr, di)
        "dt_bias": P(tp),
        "A_log": P(tp, None),  # (di, ds)
        "D": P(tp),
        "out_proj": P(tp, dp),  # (di, d)
        # norms and qk-norm scales: replicated
        "norm1": P(), "norm2": P(), "norm_x": P(), "final_norm": P(),
        "enc_final_norm": P(), "q_norm": P(), "k_norm": P(),
        # vgg
        "w": P(None, None, None, tp), "b": P(tp),
    }


def _spec_for_param(names: list[str], shape: tuple[int, ...], dp, tp) -> PartitionSpec:
    rules = _param_rules(dp, tp)
    leaf = names[-1]
    key = leaf
    if "moe" in names and leaf in ("w1", "w2", "w3"):
        key = f"moe.{leaf}"
    if "dense_residual" in names and leaf in ("w1", "w2", "w3"):
        key = leaf  # arctic's parallel dense MLP: plain MLP rules
    spec = rules.get(key)
    if spec is None:
        return P()
    extra = len(shape) - len(spec)  # leading Nones for stacking axes
    if extra > 0:
        spec = P(*([None] * extra), *spec)
    elif extra < 0:  # param smaller than the rule (tiny test dims): replicate
        return P()
    return spec


def data_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh_axis_names(mesh) if a in ("pod", "data"))


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    sizes = mesh_axis_sizes(mesh)
    if isinstance(axis, tuple):
        return math.prod(sizes[a] for a in axis)
    return sizes[axis]


def _validate(spec, shape: tuple[int, ...], mesh) -> PartitionSpec:
    """Repair the spec for exact divisibility; see :func:`repair_spec`."""
    sizes = mesh_axis_sizes(mesh)
    return repair_spec(tuple(spec) + (None,) * (len(shape) - len(spec)),
                       shape, lambda a: sizes[a] if a else 1)


def _shape(leaf) -> tuple[int, ...]:
    return tuple(int(s) for s in getattr(leaf, "shape", ()))


# Lists of layers that the reference stacks on a leading axis: the
# encoder-decoder's parameter stacks and its cache's per-layer entries (a
# decoder's "segments" hold one list of layers per segment).
_LAYER_LISTS = ("enc_stack", "dec_stack", "self", "xkv")


def map_layers(fn, tree):
    """``tree`` with every leaf replaced by ``fn(path, ref_path, layer,
    leaf)``: ``path`` the leaf's key path here (strings), ``ref_path`` its
    path in the reference's stacked layout, and ``layer`` (index, count) of
    its layer on the reference's stacking axis, or None for an unstacked
    leaf."""

    def walk(node, path, ref, layer):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                k = str(k)
                if layer is None and k == "segments" and isinstance(v, list):
                    out[k] = [[walk(x, path + [k, str(i), str(r)], ref + [k, str(i)],
                                    (r, len(seg))) for r, x in enumerate(seg)]
                              for i, seg in enumerate(v)]
                elif layer is None and k in _LAYER_LISTS and isinstance(v, list):
                    out[k] = [walk(x, path + [k, str(r)], ref + [k], (r, len(v)))
                              for r, x in enumerate(v)]
                else:
                    out[k] = walk(v, path + [k], ref + [k], layer)
            return out
        if isinstance(node, (list, tuple)):
            return [walk(v, path + [str(i)], ref + [str(i)], layer)
                    for i, v in enumerate(node)]
        return fn(path, ref, layer, node)

    return walk(tree, [], [], None)


def _map_stacked(fn, tree):
    """``tree`` with every leaf replaced by ``fn(names, stack, leaf)``:
    ``names`` the leaf's path in the reference's stacked layout and ``stack``
    the number of layers stacked on the reference's leading axis (0 for an
    unstacked leaf)."""
    return map_layers(lambda path, ref, layer, leaf: fn(ref, layer[1] if layer else 0, leaf),
                      tree)


def _unstacked(spec: PartitionSpec, stack: int, names: list[str]) -> PartitionSpec:
    """The per-layer spec of a leaf whose reference spec is ``spec`` (over
    the stacked shape when ``stack``)."""
    if not stack:
        return spec
    if spec and spec[0] is not None:
        raise StackedAxisSharded(
            f"{'/'.join(names)}: the rule {spec} shards the axis stacking {stack} "
            "layers; one dict per layer has no such axis")
    return P(*spec[1:])


def _leaf_sharding(mesh, rule):
    """fn(names, stack, leaf) -> NamedSharding: ``rule(names, shape, ndim)``
    gives the reference's spec over the (stacked) shape, validated here."""

    def one(names, stack, leaf):
        shape = ((stack,) if stack else ()) + _shape(leaf)
        if not shape:
            return NamedSharding(mesh, P())
        spec = _validate(rule(names, shape), shape, mesh)
        return NamedSharding(mesh, _unstacked(spec, stack, names))

    return one


def param_shardings(mesh, abstract_params, *, fsdp: bool = True):
    """A tree of :class:`NamedSharding` shaped like ``abstract_params``."""
    dp = data_axes(mesh)
    dp = dp if (fsdp and dp) else None
    tp = "model" if "model" in mesh_axis_names(mesh) else None
    return _map_stacked(_leaf_sharding(
        mesh, lambda names, shape: _spec_for_param(names, shape, dp, tp)),
        abstract_params)


def batch_shardings(mesh, batch_abstract, *, seq_shard: bool = False):
    """tokens / labels: (B, S) on (dp, None); frontend: (B, L, d).

    ``seq_shard``: the batch is too small to fill dp (batch-1 long decode),
    so the sequence axis shards over dp instead (sequence parallelism)."""
    dp = data_axes(mesh)

    def rule(names, shape):
        if seq_shard and len(shape) >= 2:
            return P(None, dp, *([None] * (len(shape) - 2)))
        return P(dp, *([None] * (len(shape) - 1)))

    return _map_stacked(_leaf_sharding(mesh, rule), batch_abstract)


def cache_shardings(mesh, cache_abstract, *, seq_shard: bool = False):
    """KV caches: (B, S, KV, hd) -> (dp, None, tp, None); with ``seq_shard``
    the sequence axis takes dp (batch-1 long-context decode).  Mamba
    states: conv (B, dc-1, di) and h (B, di, ds), di on tp, batch on dp.
    The rules run over the reference's stacked shapes (a leading layer
    axis), as it computes them."""
    dp = data_axes(mesh)
    tp = "model" if "model" in mesh_axis_names(mesh) else None

    def rule(names, shape):
        name, nd = names[-1], len(shape)
        if name in ("len", "primed"):
            return P()
        if name in ("k", "v"):  # (L, B, S, KV, hd) or (B, S, KV, hd)
            lead = [None] * (nd - 4)
            if seq_shard:
                return P(*lead, None, dp, tp, None)
            return P(*lead, dp, None, tp, None)
        if name == "conv":  # (L, B, dc-1, di)
            return P(*([None] * (nd - 3)), dp, None, tp)
        if name == "h":  # (L, B, di, ds)
            return P(*([None] * (nd - 3)), dp, tp, None)
        return P()

    return _map_stacked(_leaf_sharding(mesh, rule), cache_abstract)


def opt_state_shardings(mesh, opt_abstract, param_shardings_tree):
    """Adam's m and v mirror the parameter shardings; the step (and any
    other entry) is replicated."""
    from torch.utils import _pytree as pytree

    pleaves = pytree.tree_leaves(param_shardings_tree)
    out = {}
    for k, v in opt_abstract.items():
        if k in ("m", "v"):
            leaves, spec = pytree.tree_flatten(v)
            if len(leaves) != len(pleaves):
                raise ValueError(f"opt_state[{k!r}] has {len(leaves)} leaves, the "
                                 f"parameters {len(pleaves)}")
            out[k] = pytree.tree_unflatten(pleaves, spec)
        else:
            out[k] = replicate(mesh, v)
    return out


def replicate(mesh, tree):
    """Every leaf of ``tree`` replicated over ``mesh``."""
    from torch.utils import _pytree as pytree

    return pytree.tree_map(lambda _: NamedSharding(mesh, P()), tree)


# ---------------------------------------------------------------------------
# Full <-> sharded tensors (the placement the specs describe)
# ---------------------------------------------------------------------------


def mesh_coordinate(mesh, rank: int | None = None) -> dict[str, int]:
    """Axis name -> this rank's (or ``rank``'s) index along it."""
    names = mesh_axis_names(mesh)
    if rank is None:
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not in the mesh")
    else:
        coord = [int(c) for c in (mesh.mesh == rank).nonzero()[0]]
    return dict(zip(names, (int(c) for c in coord)))


def mesh_ranks(mesh) -> list[int]:
    """The global ranks of the mesh, row-major."""
    return [int(r) for r in mesh.mesh.flatten().tolist()]


def shard_counts(sharding: NamedSharding, ndim: int) -> list[int]:
    """How many pieces each tensor dimension is split into."""
    spec = tuple(sharding.spec) + (None,) * (ndim - len(sharding.spec))
    return [_axis_size(sharding.mesh, _axes(e) or None) for e in spec[:ndim]]


def is_split(sharding: NamedSharding) -> bool:
    """True when the spec splits some dimension over an axis of size > 1."""
    sizes = mesh_axis_sizes(sharding.mesh)
    return any(sizes[a] > 1 for e in sharding.spec for a in _axes(e))


def local_slices(sharding: NamedSharding, shape, coord: dict) -> tuple:
    """The slices of a full tensor of ``shape`` that the rank at ``coord``
    holds: along each dimension, its axes' coordinates read as one
    mixed-radix index, outer axis first (the reference's order)."""
    sizes = mesh_axis_sizes(sharding.mesh)
    spec = tuple(sharding.spec) + (None,) * (len(shape) - len(sharding.spec))
    out = []
    for d, n in enumerate(shape):
        idx, cnt = 0, 1
        for a in _axes(spec[d]):
            idx, cnt = idx * sizes[a] + coord[a], cnt * sizes[a]
        if n % cnt:
            raise ValueError(f"dimension {d} of {tuple(shape)} does not split "
                             f"{cnt} ways ({sharding.spec})")
        out.append(slice(idx * (n // cnt), (idx + 1) * (n // cnt)))
    return tuple(out)


def local_shard(x: torch.Tensor, sharding: NamedSharding, coord: dict | None = None,
                *, device=None) -> torch.Tensor:
    """The piece of the full tensor ``x`` that this rank (or the rank at
    ``coord``) holds under ``sharding``, as a tensor of its own on
    ``device`` (default: ``x``'s)."""
    coord = mesh_coordinate(sharding.mesh) if coord is None else coord
    piece = x[local_slices(sharding, x.shape, coord)]
    return piece.to(device=device or x.device, copy=True).contiguous()


def sharding_device(sharding: NamedSharding) -> torch.device:
    """The device this rank keeps its pieces on: the current CUDA device
    for a CUDA mesh, else the CPU."""
    if getattr(sharding.mesh, "device_type", "cpu") == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def place(tree, shardings):
    """This rank's pieces of the full tensors of ``tree`` under
    ``shardings`` (a tree of one structure), each on its sharding's device:
    the counterpart of ``jax.device_put(tree, shardings)``."""
    from torch.utils import _pytree as pytree

    leaves, spec = pytree.tree_flatten(tree)
    shards = pytree.tree_leaves(shardings)
    if len(leaves) != len(shards):
        raise ValueError(f"{len(leaves)} tensors, {len(shards)} shardings")
    return pytree.tree_unflatten(
        [local_shard(x, s, device=sharding_device(s)) for x, s in zip(leaves, shards)],
        spec)


def full_shape(local: torch.Tensor, sharding: NamedSharding) -> tuple[int, ...]:
    return tuple(n * c for n, c in zip(local.shape, shard_counts(sharding, local.dim())))


def gather(local: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """The full tensor from every rank's piece (``local`` is this rank's):
    an all-gather over the mesh's ranks, each piece put back where
    :func:`local_slices` took it from.  A replicated tensor is copied."""
    import torch.distributed as dist

    if not is_split(sharding):
        return local.clone()
    mesh = sharding.mesh
    ranks = mesh_ranks(mesh)
    if ranks != list(range(dist.get_world_size())):
        raise ValueError("the mesh must span the default process group, in rank order")
    pieces = [torch.empty_like(local) for _ in ranks]
    dist.all_gather(pieces, local.contiguous())
    out = torch.empty(full_shape(local, sharding), dtype=local.dtype, device=local.device)
    for r, piece in zip(ranks, pieces):
        out[local_slices(sharding, out.shape, mesh_coordinate(mesh, r))] = piece
    return out


def axis_group(mesh, axes: tuple[str, ...]):
    """(process group, its members' global ranks) of this rank's peers along
    ``axes`` (the ranks that differ from it only in those coordinates).
    Every rank of the mesh must call it with the same axes in the same
    order: each group is made by ``torch.distributed.new_group``, which all
    ranks enter.  The groups are kept on the mesh object, made once."""
    import itertools

    import torch.distributed as dist

    names = mesh_axis_names(mesh)
    groups = vars(mesh).setdefault("_repro_axis_groups", {})
    if tuple(axes) in groups:
        return groups[tuple(axes)]
    sizes = mesh_axis_sizes(mesh)
    others = [a for a in names if a not in axes]
    me = dist.get_rank()
    grid = mesh.mesh
    mine = None
    for fixed in itertools.product(*(range(sizes[a]) for a in others)):
        index = tuple(fixed[others.index(a)] if a in others else slice(None)
                      for a in names)
        ranks = sorted(int(r) for r in grid[index].flatten().tolist())
        group = dist.new_group(ranks)
        if me in ranks:
            mine = (group, ranks)
    groups[tuple(axes)] = mine
    return mine


def reduce_scatter_sum(full: torch.Tensor, sharding: NamedSharding,
                       group_axes: tuple[str, ...]) -> torch.Tensor:
    """This rank's piece (under ``sharding``) of the sum of ``full`` over
    its peers along ``group_axes``: a reduce-scatter when the peers hold
    different pieces, an all-reduce of the piece when they hold the same
    one (the spec does not split over ``group_axes``)."""
    import torch.distributed as dist

    mesh = sharding.mesh
    group, members = axis_group(mesh, group_axes)
    me = mesh_coordinate(mesh)
    mine = local_slices(sharding, full.shape, me)
    slices = [local_slices(sharding, full.shape, mesh_coordinate(mesh, r))
              for r in members]
    if all(s == mine for s in slices):
        out = full[mine].contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out
    inp = torch.cat([full[s].reshape(-1) for s in slices])
    out = torch.empty(full[mine].shape, dtype=full.dtype, device=full.device)
    rs = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    rs(out.view(-1), inp, op=dist.ReduceOp.SUM, group=group)
    return out
