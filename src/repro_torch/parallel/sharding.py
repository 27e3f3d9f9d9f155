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

import numpy as np
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


def rank_grid(mesh) -> np.ndarray:
    """The mesh's global ranks as a numpy array of its shape, made once and
    kept on the mesh object, so that code traced over fake tensors (the dry
    run's) reads the ranks without a tensor op."""
    cached = vars(mesh).get("_repro_rank_grid")
    if cached is None:
        cached = vars(mesh)["_repro_rank_grid"] = np.asarray(mesh.mesh.tolist(),
                                                            dtype=np.int64)
    return cached


def mesh_coordinate(mesh, rank: int | None = None) -> dict[str, int]:
    """Axis name -> this rank's (or ``rank``'s) index along it."""
    names = mesh_axis_names(mesh)
    if rank is None:
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not in the mesh")
    else:
        coord = np.argwhere(rank_grid(mesh) == rank)[0]
    return dict(zip(names, (int(c) for c in coord)))


def mesh_ranks(mesh) -> list[int]:
    """The global ranks of the mesh, row-major."""
    return [int(r) for r in rank_grid(mesh).flatten()]


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
    the counterpart of ``jax.device_put(tree, shardings)``.  A leaf that
    is not a tensor (a cache's length) stays as it is."""
    from torch.utils import _pytree as pytree

    leaves, spec = pytree.tree_flatten(tree)
    shards = pytree.tree_leaves(shardings)
    if len(leaves) != len(shards):
        raise ValueError(f"{len(leaves)} tensors, {len(shards)} shardings")
    return pytree.tree_unflatten(
        [local_shard(x, s, device=sharding_device(s)) if isinstance(x, torch.Tensor) else x
         for x, s in zip(leaves, shards)], spec)


def full_shape(local: torch.Tensor, sharding: NamedSharding) -> tuple[int, ...]:
    return tuple(n * c for n, c in zip(local.shape, shard_counts(sharding, local.dim())))


def without(sharding: NamedSharding, axes) -> NamedSharding:
    """``sharding`` with ``axes`` taken out of its spec: the layout of a
    tensor gathered over them."""
    out = []
    for e in sharding.spec:
        kept = tuple(a for a in _axes(e) if a not in axes)
        out.append(None if not kept else kept[0] if len(kept) == 1 else kept)
    return NamedSharding(sharding.mesh, P(*out))


def gather(local: torch.Tensor, sharding: NamedSharding, axes=None, *,
           strided: bool = False) -> torch.Tensor:
    """The tensor gathered from the pieces of this rank's peers along
    ``axes`` (default: every mesh axis, the full tensor): one all-gather of
    the pieces into a buffer in rank order, laid out as the grid of pieces
    and permuted so that each piece lands where :func:`local_slices` took it
    from (an axis the spec does not split over holds copies, of which the
    first is kept).  The result is this rank's piece under
    ``without(sharding, axes)``; within a dimension split over several axes
    the gathered ones must follow the kept ones (ValueError otherwise).
    ``strided=True`` lifts that: where a gathered axis comes first, the
    result holds the kept axes' pieces of that dimension that this rank's
    peers hold, strided over it, concatenated in the gathered axes' order
    (a set of independent channels, such as an MLP's columns, computes as
    well on them).  A tensor not split over ``axes`` comes back as it is:
    no copy and no collective."""
    import torch.distributed as dist

    mesh = sharding.mesh
    names = mesh_axis_names(mesh)
    sizes = mesh_axis_sizes(mesh)
    spec = tuple(sharding.spec) + (None,) * (local.dim() - len(sharding.spec))
    if axes is None:
        axes = names
    axes = tuple(a for a in names if a in axes)
    used = [a for e in spec for a in _axes(e) if a in axes]
    if not any(sizes[a] > 1 for a in used):
        return local
    for e in spec:
        inner = [a in axes for a in _axes(e)]
        if inner != sorted(inner) and not strided:
            raise ValueError(f"{sharding.spec}: gathering {axes} would leave the "
                             "kept pieces strided")
    local = local.contiguous()
    ag = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    if axes == names:
        ranks = mesh_ranks(mesh)
        if ranks != list(range(dist.get_world_size())):
            raise ValueError("the mesh must span the default process group, in rank order")
        group = None
    else:
        group, ranks = axis_group(mesh, axes)
    buf = torch.empty((len(ranks) * local.shape[0], *local.shape[1:]), dtype=local.dtype,
                      device=local.device)
    if group is None:
        ag(buf, local)
    else:
        ag(buf, local, group=group)
    kept = [a for a in axes if a in used]
    grid = buf.reshape(*(sizes[a] for a in axes), *local.shape)
    grid = grid[tuple(slice(None) if a in used else 0 for a in axes)]
    order = []
    for d, e in enumerate(spec):
        order += [kept.index(a) for a in _axes(e) if a in axes] + [len(kept) + d]
    counts = [math.prod(sizes[a] for a in _axes(e) if a in axes) for e in spec]
    return grid.permute(order).reshape([n * c for n, c in zip(local.shape, counts)])


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
    grid = rank_grid(mesh)
    mine = None
    for fixed in itertools.product(*(range(sizes[a]) for a in others)):
        index = tuple(fixed[others.index(a)] if a in others else slice(None)
                      for a in names)
        ranks = sorted(int(r) for r in grid[index].flatten())
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
    one (the spec does not split over ``group_axes``).  With no peers (a
    group of one rank) it is this rank's piece of ``full`` itself: no copy
    and no collective."""
    import torch.distributed as dist

    mesh = sharding.mesh
    group, members = axis_group(mesh, group_axes)
    me = mesh_coordinate(mesh)
    mine = local_slices(sharding, full.shape, me)
    if len(members) == 1:
        return full[mine]
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


# ---------------------------------------------------------------------------
# Compute on the mesh: the ambient mesh, the model axis' collectives, and
# which parameters a rank computes with as pieces
# ---------------------------------------------------------------------------

# The reference's logical axis names: the data axes (whichever the mesh
# has) and the tensor-parallel axis.
DP = ("pod", "data")
TP = "model"


@dataclasses.dataclass
class MeshContext:
    """What model code reads of the ambient mesh (:func:`use_mesh`): the
    ``model`` axis' process group, size and this rank's coordinate on it,
    the data axes' group and size, and the cache pieces to gather at use
    (:func:`cache_open`)."""

    mesh: Any
    group: Any
    size: int
    rank: int
    data_group: Any
    data_size: int
    data_rank: int = 0
    cache_axes: dict = dataclasses.field(default_factory=dict)


_AMBIENT: list = []


class use_mesh:
    """``with use_mesh(mesh):`` makes ``mesh`` the ambient mesh model code
    computes on (the counterpart of ``jax.set_mesh``): :func:`ambient`
    returns its :class:`MeshContext`.  Every rank of the mesh must enter it
    at the same point: it makes the axes' process groups
    (:func:`axis_group`) on first use.  A mesh of one rank sets nothing, so
    the model computes as on one device.  ``rows_on_data=False``: every
    rank holds the whole batch (a batch-1 long decode, its cache's sequence
    on the data axes), so the model sums nothing over the data axes.
    ``data``: the data axes whose ranks split one microbatch (default all;
    the compressed step's pods each take their own)."""

    def __init__(self, mesh, *, rows_on_data: bool = True, data=None):
        sizes = mesh_axis_sizes(mesh)
        tp = sizes.get(TP, 1)
        daxes = data_axes(mesh) if data is None else tuple(data)
        dsize = math.prod(sizes[a] for a in daxes) if rows_on_data else 1
        self.ctx = None
        if math.prod(sizes.values()) > 1:
            group = axis_group(mesh, (TP,))[0] if tp > 1 else None
            dgroup = axis_group(mesh, daxes)[0] if dsize > 1 else None
            coord = mesh_coordinate(mesh)
            rank = coord[TP] if tp > 1 else 0
            drank = 0
            for a in daxes if dsize > 1 else ():
                drank = drank * sizes[a] + coord[a]
            self.ctx = MeshContext(mesh, group, tp, rank, dgroup, dsize, drank)

    def __enter__(self):
        _AMBIENT.append(self.ctx)
        return self.ctx

    def __exit__(self, *exc):
        _AMBIENT.pop()


def ambient() -> MeshContext | None:
    """The ambient mesh's context, or None (one device, or no mesh)."""
    return _AMBIENT[-1] if _AMBIENT else None


def model_parallel() -> MeshContext | None:
    """The ambient context when its ``model`` axis has more than one rank."""
    ctx = ambient()
    return ctx if ctx is not None and ctx.size > 1 else None


def _all_reduce(x: torch.Tensor, group, op=None) -> torch.Tensor:
    import torch.distributed as dist

    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=dist.ReduceOp.SUM if op is None else op, group=group)
    return y


class _EnterModel(torch.autograd.Function):
    """Identity forward, all-reduce backward: a replicated tensor entering
    compute that each rank of the model axis does on its own piece (a
    column-parallel product)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _LeaveModel(torch.autograd.Function):
    """All-reduce forward, identity backward: the partial sums of the
    model axis' ranks made whole (after a row-parallel product)."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherModel(torch.autograd.Function):
    """All-gather forward along ``dim`` (the pieces in model-axis order),
    this rank's slice backward: for a tensor the ranks then use alike."""

    @staticmethod
    def forward(ctx, x, group, size, rank, dim):
        import torch.distributed as dist

        xt = x.movedim(dim, 0).contiguous()
        buf = torch.empty((size * xt.shape[0], *xt.shape[1:]), dtype=x.dtype, device=x.device)
        ag = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
        ag(buf, xt, group=group)
        ctx.slice = (dim, rank * x.shape[dim], x.shape[dim])
        return buf.movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        dim, start, n = ctx.slice
        return g.narrow(dim, start, n).contiguous(), None, None, None, None


class _SumData(torch.autograd.Function):
    """All-reduce forward and backward over the data axes: a statistic
    summed over the ranks' rows, each rank's loss reading the sum (the
    adjoint of a sum every rank reads is the sum of their gradients)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _GatherData(torch.autograd.Function):
    """All-gather forward over the data axes along dim 0 (the ranks' rows
    in order), and the adjoint backward: the gradients of every rank's
    loss summed, this rank's rows kept."""

    @staticmethod
    def forward(ctx, x, group, size, rank):
        import torch.distributed as dist

        x = x.contiguous()
        buf = torch.empty((size * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
        ag = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
        ag(buf, x, group=group)
        ctx.rows = (rank * x.shape[0], x.shape[0], group)
        return buf

    @staticmethod
    def backward(ctx, g):
        start, n, group = ctx.rows
        return _all_reduce(g, group).narrow(0, start, n).contiguous(), None, None, None


def gather_data(x: torch.Tensor) -> torch.Tensor:
    """Every data rank's rows of ``x`` (dim 0), in order (no-op with one
    data rank)."""
    ctx = ambient()
    if ctx is None or ctx.data_size == 1:
        return x
    return _GatherData.apply(x, ctx.data_group, ctx.data_size, ctx.data_rank)


def enter_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` entering per-rank compute on the model axis (no-op without
    one)."""
    ctx = model_parallel()
    return x if ctx is None else _EnterModel.apply(x, ctx.group)


def leave_model(x: torch.Tensor) -> torch.Tensor:
    """The sum of the model axis' partial ``x`` (no-op without one)."""
    ctx = model_parallel()
    return x if ctx is None else _LeaveModel.apply(x, ctx.group)


def gather_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The model axis' pieces of ``x`` concatenated along ``dim`` (no-op
    without one)."""
    ctx = model_parallel()
    if ctx is None:
        return x
    return _GatherModel.apply(x, ctx.group, ctx.size, ctx.rank, dim % x.dim())


def sum_data(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ambient mesh's data axes (no-op with one
    data rank)."""
    ctx = ambient()
    if ctx is None or ctx.data_size == 1:
        return x
    return _SumData.apply(x, ctx.data_group)


def all_max_model(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of ``x`` over the model axis, no gradient (a
    softmax's shift)."""
    import torch.distributed as dist

    ctx = model_parallel()
    if ctx is None:
        return x.detach()
    return _all_reduce(x.detach(), ctx.group, dist.ReduceOp.MAX)


def head_slice(n_full: int, n_local: int) -> slice:
    """This rank's slice of ``n_full`` units when it holds ``n_local`` of
    them, in model-axis order (the whole range without a model axis)."""
    ctx = model_parallel()
    if ctx is None or n_local == n_full:
        return slice(0, n_full)
    if n_local * ctx.size != n_full:
        raise ValueError(f"{n_local} of {n_full} units is not a {ctx.size}-way piece")
    return slice(ctx.rank * n_local, (ctx.rank + 1) * n_local)


# -- cache pieces gathered at use --------------------------------------------


def register_cache(tree, shardings, keep) -> None:
    """Record, in the ambient context, the cache leaves of ``tree`` whose
    pieces the model must gather before use: ``keep(names, sharding)``
    gives the axes a leaf keeps split (its rows on the data axes, its KV
    heads on ``model`` when the heads are split); the rest of its spec's
    axes are gathered by :func:`cache_open`."""
    from torch.utils import _pytree as pytree

    ctx = ambient()
    if ctx is None:
        return
    sizes = mesh_axis_sizes(ctx.mesh)
    names = pytree.tree_leaves(map_layers(lambda path, ref, layer, leaf: "/".join(ref),
                                          tree))
    for name, leaf, sh in zip(names, pytree.tree_leaves(tree),
                              pytree.tree_leaves(shardings)):
        if not isinstance(leaf, torch.Tensor):
            continue
        kept = keep(name.split("/"), sh)
        axes = tuple(a for e in sh.spec for a in _axes(e)
                     if a not in kept and sizes[a] > 1)
        if axes:
            ctx.cache_axes[id(leaf)] = (leaf, sh, axes)


def cache_registered(t: torch.Tensor) -> bool:
    """True when ``t`` is a cache piece :func:`cache_open` gathers."""
    ctx = ambient()
    entry = None if ctx is None else ctx.cache_axes.get(id(t))
    return entry is not None and entry[0] is t


def cache_open(t: torch.Tensor) -> torch.Tensor:
    """A registered cache piece gathered over the axes the model computes
    whole (a copy); any other tensor as it is."""
    ctx = ambient()
    entry = None if ctx is None else ctx.cache_axes.get(id(t))
    if entry is None or entry[0] is not t:
        return t
    return gather(t, entry[1], entry[2])


def cache_piece(t: torch.Tensor, full: torch.Tensor) -> torch.Tensor:
    """This rank's piece of ``full`` (a new value for the cache leaf ``t``,
    in the layout :func:`cache_open` gave) when ``t`` is registered, else
    ``full``."""
    if not cache_registered(t):
        return full
    _leaf, sh, axes = ambient().cache_axes[id(t)]
    kept = tuple(a for a in mesh_axis_names(sh.mesh) if a not in axes)
    return full[local_slices(without(sh, kept), full.shape,
                             mesh_coordinate(sh.mesh))].contiguous()


def cache_store(t: torch.Tensor, full: torch.Tensor) -> None:
    """Write ``full`` (what :func:`cache_open` gave for ``t``, updated)
    back into ``t``: its piece when ``t`` is registered, else the whole."""
    if full is not t:
        t.copy_(cache_piece(t, full))


# -- which parameters are computed with as pieces ----------------------------


def _on_model(sh: NamedSharding, dim: int, *, strided: bool = False) -> bool:
    """True when ``model`` (of size > 1) splits dimension ``dim`` of the
    spec and nothing else, as the outer axis of that dimension's entry
    (any axis of it with ``strided``: see :func:`gather`)."""
    if mesh_axis_sizes(sh.mesh).get(TP, 1) <= 1:
        return False
    where = [d for d, e in enumerate(sh.spec) if TP in _axes(e)]
    return where == [dim] and (strided or _axes(sh.spec[dim])[0] == TP)


def _has_model(sh: NamedSharding) -> bool:
    return (mesh_axis_sizes(sh.mesh).get(TP, 1) > 1
            and any(TP in _axes(e) for e in sh.spec))


def _module_plan(names: set, node: dict, cfg, tp: int) -> dict:
    """leaf -> gathered over ``model`` for one module's parameter dict."""

    def split_if(ok: bool) -> dict:
        return {k: (not ok) and _has_model(v) for k, v in node.items()
                if isinstance(v, NamedSharding)}

    if "wq" in names:  # attention
        heads = (cfg.n_heads % tp == 0 and _on_model(node["wq"], 1)
                 and _on_model(node["wo"], 0))
        kv = (heads and cfg.n_kv_heads % tp == 0 and _on_model(node["wk"], 1)
              and _on_model(node["wv"], 1))
        out = split_if(heads)
        for k in ("wk", "wv"):
            out[k] = (not kv) and _has_model(node[k])
        return out
    if "in_proj" in names:  # mamba: channels of d_inner
        cols = ("conv_w", "dt_proj")
        rows = ("conv_b", "x_proj", "dt_bias", "A_log", "D", "out_proj")
        ok = (cfg.d_inner % tp == 0 and all(_on_model(node[k], 1) for k in cols)
              and all(_on_model(node[k], 0) for k in rows))
        out = split_if(ok)
        # in_proj's column piece holds x- or z-channels, not a rank's both.
        out["in_proj"] = _has_model(node["in_proj"])
        return out
    if "router" in names:  # MoE: experts, else each expert's d_ff columns
        experts = [node[k] for k in ("w1", "w2", "w3") if k in node]
        ok = ((cfg.n_experts % tp == 0 and all(_on_model(s, 0) for s in experts))
              or (_on_model(node["w1"], 2, strided=True)
                  and _on_model(node["w2"], 1, strided=True)
                  and ("w3" not in node or _on_model(node["w3"], 2, strided=True))))
        return split_if(ok)
    # a dense MLP: d_ff columns of w1 / w3, rows of w2
    ok = (_on_model(node["w1"], 1, strided=True) and _on_model(node["w2"], 0, strided=True)
          and ("w3" not in node or _on_model(node["w3"], 1, strided=True)))
    return split_if(ok)


def model_gathered(shardings, cfg):
    """A tree of bools shaped like the parameter shardings: True for a
    leaf the model cannot compute with as its ``model`` piece, so the step
    gathers it over ``model`` too and computes it replicated.  A module
    computes on pieces when its pieces fall on whole units: attention heads
    (and KV heads, each q head's group whole), MLP columns, experts, Mamba
    channels; the embedding and the head on whole vocabulary rows.  MLP
    columns (an MoE's experts' too, when the experts do not split) may be
    strided pieces (``gather(strided=True)``).  Mamba's ``in_proj`` is
    always gathered: its column piece holds a rank's x- or z-channels, not
    both."""
    tp = 1
    from torch.utils import _pytree as pytree

    for sh in pytree.tree_leaves(shardings):
        tp = mesh_axis_sizes(sh.mesh).get(TP, 1)
        break

    def walk(node):
        if isinstance(node, NamedSharding):
            return _has_model(node)
        if isinstance(node, list):
            return [walk(v) for v in node]
        names = set(node)
        leafy = {k for k, v in node.items() if isinstance(v, NamedSharding)}
        if tp > 1 and ({"wq", "in_proj", "router"} & leafy
                       or {"w1", "w2"} <= leafy):
            plan = _module_plan(names, node, cfg, tp)
            return {k: (plan[k] if k in plan else walk(v)) for k, v in node.items()}
        out = {}
        for k, v in node.items():
            if k == "embed" and isinstance(v, NamedSharding):
                out[k] = _has_model(v) and not _on_model(v, 0)
            elif k == "lm_head" and isinstance(v, NamedSharding):
                out[k] = _has_model(v) and not _on_model(v, 1)
            else:
                out[k] = walk(v)
        return out

    return walk(shardings)


def model_gathered_paths(shardings, cfg) -> list[str]:
    """The paths (``/``-joined, one entry per layer) of the leaves
    :func:`model_gathered` marks."""
    flags = model_gathered(shardings, cfg)
    out = []
    map_layers(lambda path, ref, layer, leaf: out.append("/".join(path)) if leaf else None,
               flags)
    return out
