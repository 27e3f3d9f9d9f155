"""Cost walker over an aten FX graph (the counterpart of the JAX package's
``core/hlo_cost.py``, which walks XLA's optimized HLO text).

PyTorch has no HLO: a step is traced with ``make_fx`` over fake tensors
(:func:`cost_of`) into a ``torch.fx.GraphModule`` of aten ops, each node
carrying its output's shape and dtype (``meta["val"]``), and this module
walks that graph.  ``make_fx`` unrolls Python loops (layers, microbatches,
chunks) and records a checkpointed region's recompute where the backward
runs it, so no trip count is needed: every launch the step makes is a node.

It accumulates, as the reference does:

* ``dot_flops`` -- 2 x output elements x contracted size for ``mm``,
  ``bmm``, ``addmm``, ``baddbmm``, ``linear`` and ``convolution`` (and
  ``convolution_backward``, one such product per gradient it computes);
* ``elem_flops`` -- one per output element of each fusible node;
* ``bytes`` -- device-memory traffic under a **fusion-group model that is
  the paper's Eq. (1) applied to the aten graph**: a chain of contiguous
  fusible nodes (pointwise ops, reductions, dtype converts; views are free
  and edges run through them) is one group, billed at its inputs plus its
  outputs only; non-fusible nodes are billed alone: a dot at its operands
  plus its output, a slicing / indexing node (``index``, ``gather``,
  ``embedding``) at 2x its output (its readers do not bill it again), a
  scatter (``index_put``, ``scatter``, a ``copy_`` into a view) at 3x the
  region it writes, anything else at its operands plus its output;
* ``bytes_lo`` -- dots, slices, scatters, copies, collectives and kernels
  only: the fusion-optimistic bound, with every elementwise chain fused
  into a neighbour's epilogue;
* ``coll`` -- per collective kind, the output bytes of every c10d or
  functional-collective node (``dist.all_gather`` and its kin appear in a
  ``make_fx`` trace under a process group, the fake one of the dry run
  included);
* each hand-written kernel's marker node (:data:`repro_torch.kernels.ops.
  MARKERS`) as one fusion group, billed by
  :func:`repro_torch.core.roofline.kernel_cost`.

Creation ops (``empty``, ``zeros``, ``full``, ...) are free, and reading
their output costs nothing (the reference's constants and iotas); a graph
input is read at its size.  :func:`live_bytes` gives the peak of live
tensor bytes over the graph's order (the counterpart of XLA's
``memory_analysis()``).
"""
from __future__ import annotations

import dataclasses
import operator
from collections import defaultdict

import torch
from torch import fx
from torch.utils import _pytree as pytree

from ..kernels import fused_mlp, ops
from .roofline import kernel_cost


@dataclasses.dataclass
class Cost:
    """Accumulated FLOP/byte/collective totals of an aten graph."""

    dot_flops: float = 0.0
    elem_flops: float = 0.0
    bytes: float = 0.0  # Eq.(1) fusion-group model (upper bound)
    bytes_lo: float = 0.0  # dots/slices/copies/collectives/kernels only
    # (fusion-optimistic lower bound: elementwise fused into epilogues)
    coll: dict = dataclasses.field(default_factory=lambda: defaultdict(float))
    coll_count: float = 0.0


# Creation ops: no traffic, and free to read (the reference's _FREE).
_CREATE = {
    "empty", "empty_like", "empty_strided", "zeros", "zeros_like", "ones",
    "ones_like", "full", "full_like", "new_empty", "new_zeros", "new_ones",
    "new_full", "new_empty_strided", "arange", "scalar_tensor",
    "lift_fresh_copy", "_local_scalar_dense", "sym_size", "sym_numel",
    "sym_stride", "sym_storage_offset", "wait_tensor", "barrier",
}
# Views that the op schema does not mark as aliasing.
_VIEWS = {"_unsafe_view", "_reshape_alias", "lift_fresh"}
_DOTS = {"mm", "bmm", "addmm", "baddbmm", "linear", "convolution",
         "convolution_backward", "addbmm", "dot", "mv", "addmv"}
# Slice-type: traffic ~ 2x output (sliced read + write); readers don't re-bill.
_SLICY = {"index", "gather", "index_select", "embedding", "take", "masked_select"}
# Scatter-type: ~3x the written region (read-modify-write); the region's
# source argument.
_SCATTERY = {
    "index_put": 2, "index_put_": 2, "_index_put_impl_": 2, "scatter": 3,
    "scatter_": 3, "scatter_add": 3, "scatter_add_": 3, "scatter_reduce": 3,
    "scatter_reduce_": 3, "index_add": 3, "index_add_": 3, "index_copy": 3,
    "index_copy_": 3, "slice_scatter": 1, "select_scatter": 1,
    "as_strided_scatter": 1, "embedding_dense_backward": 0, "masked_scatter": 2,
    "masked_scatter_": 2,
}
_COPIES = {"clone", "copy", "copy_", "_to_copy", "contiguous", "_copy_from"}
# Reductions the op tags do not mark.
_REDUCTIONS = {
    "_softmax", "_log_softmax", "_softmax_backward_data",
    "_log_softmax_backward_data", "native_layer_norm",
    "native_layer_norm_backward", "native_group_norm",
    "native_group_norm_backward", "var_mean", "_fused_rms_norm",
}
_C10D = {
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all", "send": "collective-permute",
    "recv_": "collective-permute", "broadcast_": "broadcast", "broadcast": "broadcast",
}


def tensor_bytes(val) -> int:
    """Bytes of every tensor in a node's ``meta["val"]`` (a tensor, or a
    tuple / list of them)."""
    return sum(t.numel() * t.element_size() for t in pytree.tree_leaves(val)
               if isinstance(t, torch.Tensor))


def _val(n: fx.Node):
    return n.meta.get("val")


def _name(n: fx.Node) -> str:
    return n.target.__name__.split(".")[0]


def _operands(n: fx.Node) -> list[fx.Node]:
    return [a for a in pytree.tree_leaves((n.args, n.kwargs)) if isinstance(a, fx.Node)]


def _arg(n: fx.Node, i: int, name: str):
    return n.args[i] if len(n.args) > i else n.kwargs.get(name)


def kind(n: fx.Node) -> str:
    """The walker's class of a node: ``placeholder``, ``output``, ``free``,
    ``view``, ``kernel``, ``collective``, ``dot``, ``slice``, ``scatter``,
    ``copy``, ``fusible`` or ``other``."""
    if n.op in ("placeholder", "output"):
        return n.op
    if n.op != "call_function":
        return "free"
    if n.target is operator.getitem:
        return "view"
    if not isinstance(n.target, torch._ops.OpOverload):
        return "free"
    if n.target in ops.MARKERS:
        return "kernel"
    ns, name = n.target.namespace, _name(n)
    if ns in ("c10d", "_c10d_functional", "c10d_functional"):
        return "collective" if name in _C10D else "free"
    if ns != "aten":
        return "other"
    if name in _CREATE:
        return "free"
    if getattr(n.target, "is_view", False) or name in _VIEWS:
        return "view"
    if name in _DOTS:
        return "dot"
    if name in _SLICY:
        return "slice"
    if name in _SCATTERY:
        return "scatter"
    if name == "copy_":
        dst = n.args[0]
        return "scatter" if isinstance(dst, fx.Node) and kind(dst) == "view" else "copy"
    if name == "_to_copy":
        src = _val(n.args[0])
        return "fusible" if src is not None and src.dtype != _val(n).dtype else "copy"
    if name in _COPIES:
        return "copy"
    if (torch.Tag.pointwise in n.target.tags or torch.Tag.reduction in n.target.tags
            or name in _REDUCTIONS):
        return "fusible"
    return "other"


def _dot_flops(n: fx.Node) -> float:
    name, out = _name(n), _val(n)
    if name == "convolution":
        w = _val(n.args[1])
        return 2.0 * out.numel() * w.numel() // w.shape[0]
    if name == "convolution_backward":
        w = _val(n.args[2])
        mask = _arg(n, 10, "output_mask") or (True, True, True)
        per = 2.0 * _val(n.args[0]).numel() * w.numel() // w.shape[0]
        return per * (int(mask[0]) + int(mask[1]))
    if name in ("addmm", "baddbmm", "addbmm", "addmv"):
        k = _val(n.args[1]).shape[-1]
    else:
        k = _val(n.args[0]).shape[-1]
    return 2.0 * out.numel() * k


def _kernel(n: fx.Node):
    """(kernel_cost of the marker node's launch, whether its FLOPs are
    tensor-core products)."""
    name = ops.MARKERS[n.target]
    v = [_val(a) if isinstance(a, fx.Node) else a for a in n.args]
    if name in ("flash_attention", "flash_attention_bwd"):
        q, k = v[0], v[1]
        mask = dict(causal=v[-3], window=v[-2], chunk=v[-1])
        if name == "flash_attention":
            mask = dict(causal=v[3], window=v[4], chunk=v[5], lse=v[6])
        return kernel_cost(name, q=tuple(q.shape), kv=tuple(k.shape),
                           itemsize=q.element_size(), **mask), True
    if name == "fused_mlp":
        x, w1, _, _, act = v
        return kernel_cost(name, x=(x.numel() // x.shape[-1], x.shape[-1]),
                           ff=w1.shape[1], gated=act in fused_mlp.GATED,
                           itemsize=x.element_size()), True
    if name == "selective_scan":
        return kernel_cost(name, x=tuple(v[0].shape), h0=v[3] is not None,
                           final_state=v[4]), False
    x, w, _, pool = v
    return kernel_cost(name, x=tuple(x.shape), cout=w.shape[-1], pool=pool,
                       itemsize=x.element_size()), True


def module_cost(gm: fx.GraphModule) -> Cost:
    """The cost of a traced graph (see the module docstring)."""
    nodes = list(gm.graph.nodes)
    kinds = {n: kind(n) for n in nodes}
    root, eff = {}, {}
    for n in nodes:
        own = tensor_bytes(_val(n))
        if kinds[n] == "view" and n.args and isinstance(n.args[0], fx.Node):
            src = n.args[0]
            root[n], eff[n] = root[src], min(own, eff[src])
        else:
            root[n], eff[n] = n, own

    fusible = {n for n in nodes if kinds[n] == "fusible"}
    parent: dict = {}

    def find(x):
        while parent.get(x, x) is not x:
            parent[x] = parent.get(parent[x], parent[x])
            x = parent[x]
        return x

    consumers: dict = defaultdict(list)
    outputs = set()
    for n in nodes:
        if kinds[n] == "view":
            continue
        for o in _operands(n):
            r = root[o]
            if n.op == "output":
                outputs.add(r)
                continue
            consumers[r].append(n)
            if n in fusible and r in fusible and find(r) is not find(n):
                parent[find(r)] = find(n)

    cost = Cost()
    group_in: dict = defaultdict(dict)
    group_out: dict = defaultdict(float)

    def reads(n):
        """Bytes ``n`` reads: its operands through their views, except
        free (created) and slice outputs, billed where they were made."""
        return sum(float(eff[o]) for o in _operands(n)
                   if kinds[root[o]] not in ("free", "slice"))

    for n in nodes:
        k = kinds[n]
        if k in ("placeholder", "output", "free", "view"):
            continue
        out_b = float(tensor_bytes(_val(n)))
        if k == "fusible":
            gid = find(n)
            gin = group_in[gid]
            for o in _operands(n):
                r = root[o]
                if kinds[r] in ("free", "slice") or (r in fusible and find(r) is gid):
                    continue
                gin[r] = max(gin.get(r, 0.0), float(eff[o]))
            cost.elem_flops += sum(t.numel() for t in pytree.tree_leaves(_val(n))
                                   if isinstance(t, torch.Tensor))
            if n in outputs or any(c not in fusible or find(c) is not gid
                                   for c in consumers[n]):
                group_out[gid] += out_b
            continue
        if k == "kernel":
            kc, on_dots = _kernel(n)
            if on_dots:
                cost.dot_flops += kc.flops
            else:
                cost.elem_flops += kc.flops
            cost.bytes += kc.bytes
            cost.bytes_lo += kc.bytes
            continue
        if k == "slice":
            cost.bytes += 2.0 * out_b
            cost.bytes_lo += 2.0 * out_b
            continue
        if k == "scatter":
            src = n.args[1] if _name(n) == "copy_" else _arg(n, _SCATTERY[_name(n)], "")
            touched = float(eff[src]) if isinstance(src, fx.Node) else out_b
            cost.bytes += 3.0 * touched
            cost.bytes_lo += 3.0 * touched
            continue
        traffic = out_b + reads(n)
        cost.bytes += traffic
        if k == "dot":
            cost.dot_flops += _dot_flops(n)
            cost.bytes_lo += traffic
        elif k == "copy":
            cost.bytes_lo += traffic
        elif k == "collective":
            cost.coll[_C10D[_name(n)]] += out_b
            cost.coll_count += 1
            cost.bytes_lo += traffic
    for gid, gin in group_in.items():
        cost.bytes += sum(gin.values()) + group_out.get(gid, 0.0)
    return cost


def live_bytes(gm: fx.GraphModule) -> dict:
    """Bytes of the graph's tensors by storage: the inputs'
    (``argument_size_in_bytes``), the outputs' (``output_size_in_bytes``),
    and the peak over the graph's order of the storages alive at once, with
    every storage alive from the node that makes it to its last reader
    (inputs and outputs throughout: the caller holds them)
    (``peak_live_bytes``), and that peak without the inputs
    (``peak_intermediate_bytes``)."""
    def storages(val):
        """(key, bytes) of each storage of ``val``'s tensors; the graph keeps
        every value alive, so a storage's address is its key."""
        for t in pytree.tree_leaves(val):
            if isinstance(t, torch.Tensor):
                s = t.untyped_storage()
                yield s._cdata, s.nbytes()

    nodes = list(gm.graph.nodes)
    first, last, size = {}, {}, {}
    args, outs = set(), set()
    for i, n in enumerate(nodes):
        vals = [_val(n)] + [_val(o) for o in _operands(n)]
        for val in vals:
            for key, nb in storages(val):
                first.setdefault(key, i)
                last[key] = i
                size[key] = nb
        if n.op == "placeholder":
            args.update(k for k, _ in storages(_val(n)))
        if n.op == "output":
            for o in _operands(n):
                outs.update(k for k, _ in storages(_val(o)))
    end = len(nodes) - 1
    for key in args | outs:
        last[key] = end
    delta = [0] * (len(nodes) + 1)
    delta_mid = [0] * (len(nodes) + 1)
    for key, nb in size.items():
        delta[first[key]] += nb
        delta[last[key] + 1] -= nb
        if key not in args:
            delta_mid[first[key]] += nb
            delta_mid[last[key] + 1] -= nb
    peak = peak_mid = live = live_mid = 0
    for d, dm in zip(delta, delta_mid):
        live += d
        live_mid += dm
        peak, peak_mid = max(peak, live), max(peak_mid, live_mid)
    return {"argument_size_in_bytes": sum(size[k] for k in args),
            "output_size_in_bytes": sum(size[k] for k in outs - args),
            "peak_live_bytes": peak, "peak_intermediate_bytes": peak_mid}


def trace(fn, *args) -> fx.GraphModule:
    """``make_fx`` of ``fn(*args)``: fake inputs trace in their own mode;
    real ones are turned into fake tensors first (nothing runs).  A
    constant the traced code makes (``torch.tensor(math.pi)``) is taken
    into the mode."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx

    leaves = [t for t in pytree.tree_leaves(args) if isinstance(t, torch.Tensor)]
    fakes = [t for t in leaves if isinstance(t, FakeTensor)]
    mode = fakes[0].fake_mode if fakes else FakeTensorMode()
    if not fakes:
        args = pytree.tree_map_only(torch.Tensor, mode.from_tensor, args)
    allowed, mode.allow_non_fake_inputs = mode.allow_non_fake_inputs, True
    try:
        with mode:
            return make_fx(fn)(*args)
    finally:
        mode.allow_non_fake_inputs = allowed


def cost_of(fn, *args) -> Cost:
    """The :class:`Cost` of ``fn(*args)``, traced over fake tensors."""
    return module_cost(trace(fn, *args))
