"""Tracing frontend — PyTorch models to :class:`repro_torch.core.ir.GraphIR`.

The port of the JAX package's ``core/frontend.py``.  :func:`trace` runs
``torch.fx.experimental.proxy_tensor.make_fx`` on a model's forward pass
over ``device="meta"`` tensors (nothing is materialised, so arctic-480b
traces at full width on any host) and lowers the aten-level graph onto the
paper's layer abstraction; each node's ``meta["val"]`` carries its shape.

* ``aten.convolution``  -> ``conv`` nodes (``groups`` maps to
  :class:`LayerSpec` ``groups``).  A ``constant_pad_nd`` feeding a conv or
  a pool is looked through: the models pad XLA's asymmetric ``SAME``
  explicitly (PyTorch's ``padding=`` is symmetric), and the node's frame is
  the unpadded one;
* ``mm`` / ``addmm`` / ``bmm`` / ``linear`` -> ``matmul`` nodes (``fc``
  when ``M == 1``).  Both operands activations -> ``actmul`` with the batch
  folded into the contraction; two views of one dataflow source (MoE's
  combine einsum) fold; an activation against a *stacked* weight (MoE's
  ``(E, d, ff)`` experts) expands into ``E`` branch nodes whose producer is
  a tuple of node ids.  A weight ``expand``-ed across the batch (stride 0)
  is one plain product;
* the ``repro_torch::traced_selective_scan`` marker op -> one ``scan`` node
  whose carry words become ``state_words``; its frame is the stacked
  per-chunk outputs ``(n_chunks, B, chunk, d_inner)``, as the reference's
  ``lax.scan`` gives it;
* ``max_pool2d_with_indices`` / ``avg_pool2d`` -> ``pool`` nodes (or, with
  ``fold_pool=True`` and a window equal to its stride, absorbed into the
  producing conv's ``pool_after``); ``mean`` / ``sum`` / ``amax`` over
  dims (1, 2) of a square NHWC tensor -> a global ``pool``;
* everything else (``getitem`` of a tuple-valued op included) folds into
  its single dataflow source, or joins two or more into an ``elementwise``
  node.  An operand's words are its own, size-1 axes unbroadcast, as the
  reference's rank-promoted operands are.

Scalars in ``node.args`` play the role of jaxpr literals; a graph-input
placeholder is its own dataflow source.  The canonical builders at the
bottom trace the port's models and rename nodes to the hand-builder names;
the tests hold every graph node-and-edge equal to the reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Sequence

import torch
from torch import fx
from torch.utils import _pytree as pytree

from ..kernels import ops, ref
from .errors import GraphValidationError, UnsupportedOpError
from .ir import (
    RESNET18_STAGE_PLAN,
    VGG16_CONV_PLAN,
    EdgeSpec,
    GraphIR,
    LayerSpec,
    NetworkIR,
)

aten = torch.ops.aten


# ---------------------------------------------------------------------------
# The scan marker: one graph node for the selective scan
# ---------------------------------------------------------------------------


@torch.library.custom_op("repro_torch::traced_selective_scan", mutates_args=())
def traced_selective_scan(dA: torch.Tensor, dBx: torch.Tensor, C: torch.Tensor,
                          h0: torch.Tensor, chunk: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The selective scan as one op, for tracing: ``(ys (S // chunk, B,
    chunk, di), h_last (B, di, ds))``, the stacked per-chunk outputs and
    the final carry of the reference's chunk-recurrent ``lax.scan``.  The
    body is the plain sequential scan."""
    B, S, di, _ = dA.shape
    y, h = ref.selective_scan_ref(dA, dBx, C, h0)
    ys = y.reshape(B, S // chunk, chunk, di).transpose(0, 1).contiguous()
    return ys, h.clone()


@traced_selective_scan.register_fake
def _(dA, dBx, C, h0, chunk):
    B, S, di, ds = dA.shape
    return dA.new_empty((S // chunk, B, chunk, di)), h0.new_empty((B, di, ds))


_SCAN_OP = torch.ops.repro_torch.traced_selective_scan.default


def marker_scan(chunk: int) -> Callable:
    """A ``scan(dA, dBx, C, h0)`` for ``ssm.mamba_block`` that records the
    recurrence as one marker node, over chunks of ``chunk`` steps (the
    whole sequence when ``chunk`` does not divide it, as the reference's
    ``selective_scan_chunked``).  The carry is always an argument, zeros
    built here when ``h0`` is ``None``, so its words are the node's
    ``state_words``.  Used by the frontend only; the model's path keeps
    ``ops.KERNELS.ssm_scan``."""
    def scan(dA, dBx, C, h0=None):
        B, S, di, ds = dA.shape
        if h0 is None:
            h0 = torch.zeros((B, di, ds), dtype=torch.float32, device=dA.device)
        ys, h = traced_selective_scan(dA, dBx, C, h0, chunk if S % chunk == 0 else S)
        return ys.transpose(0, 1).reshape(B, S, di), h

    return scan


# ---------------------------------------------------------------------------
# Lowering
# ---------------------------------------------------------------------------

_CONV_OPS = (aten.convolution.default,)
_DOT_OPS = (aten.mm.default, aten.bmm.default, aten.addmm.default,
            aten.linear.default)
_REDUCE_WINDOW_OPS = (aten.max_pool2d_with_indices.default,
                      aten.max_pool2d.default, aten.avg_pool2d.default)
_SPATIAL_REDUCE_OPS = (aten.mean.dim, aten.sum.dim_IntList, aten.amax.default,
                       aten.amin.default)


def _val(n: fx.Node):
    return n.meta["val"]


def _shape(n: fx.Node) -> tuple[int, ...]:
    return tuple(int(s) for s in _val(n).shape)


def _words(n: fx.Node) -> int:
    """Word count of a traced tensor (the paper uses one word per element);
    0 for a tuple-valued op, which only ``getitem`` reads."""
    if not isinstance(_val(n), torch.Tensor):
        return 0
    return int(math.prod(_shape(n)))


def _chw(shape: tuple[int, ...]) -> tuple[int, int, int]:
    """(channels, h, w) of an activation tensor: channels-last, leading
    size-1 batch axis dropped, remaining axes flattened into (h, w)."""
    if len(shape) > 2 and shape[0] == 1:
        shape = shape[1:]
    if not shape:
        return 1, 1, 1
    c = shape[-1]
    spatial = shape[:-1]
    if not spatial:
        return c, 1, 1
    if len(spatial) == 1:
        return c, int(spatial[0]), 1
    return c, int(spatial[0]), int(math.prod(spatial[1:]))


def _bound(node: fx.Node) -> dict[str, Any]:
    """The aten op's arguments by schema name, defaults filled in."""
    out = {}
    for i, a in enumerate(node.target._schema.arguments):
        if i < len(node.args):
            out[a.name] = node.args[i]
        elif a.name in node.kwargs:
            out[a.name] = node.kwargs[a.name]
        elif a.has_default_value():
            out[a.name] = a.default_value
    return out


@dataclasses.dataclass
class _PendingNode:
    spec: LayerSpec
    inputs: dict[int, int]  # producer node id -> words read from it


class _Tracer:
    """``producer`` maps every activation node to the *dataflow source* it
    descends from: an ``int`` node id, a tuple of branch ids, or — for
    values read straight off a graph input — the input placeholder itself,
    so two different inputs stay two different sources (and two views of
    one input stay one).  ``act_in`` entries are ``(node, source, words)``."""

    def __init__(self, *, name: str, fold_pool: bool):
        self.name = name
        self.fold_pool = fold_pool
        self.nodes: list[_PendingNode] = []
        self.producer: dict[Any, Any] = {}  # activation node -> source

    # ---- helpers -----------------------------------------------------------
    def _act_inputs(self, node: fx.Node) -> list[tuple[Any, Any, int]]:
        args = pytree.tree_leaves((node.args, node.kwargs))
        return [(a, self.producer[a], _words(a)) for a in args
                if isinstance(a, fx.Node) and a in self.producer]

    def _add_node(self, spec: LayerSpec, act_in) -> int:
        node = _PendingNode(spec=spec, inputs={})
        for _v, p, words in act_in:
            if isinstance(p, tuple):
                # Branch fan-in (expert stacks): the consumed tensor is the
                # concatenation of the branch outputs — one edge per branch,
                # words split evenly across the members.
                w = max(1, words // len(p))
                for member in p:
                    node.inputs[member] = max(node.inputs.get(member, 0), w)
                continue
            if not isinstance(p, int):
                continue  # graph-input operand: no producer node to fuse with
            node.inputs[p] = max(node.inputs.get(p, 0), words)
        self.nodes.append(node)
        return len(self.nodes) - 1

    def _ext_words(self, act_in) -> int:
        """Words of operands read straight off a graph input — DRAM traffic
        in every grouping (deduped per input: two views of one input are
        one read)."""
        by_src: dict[Any, int] = {}
        for _v, p, words in act_in:
            if not isinstance(p, (int, tuple)):
                by_src[p] = max(by_src.get(p, 0), words)
        return sum(by_src.values())

    def _check_geometry(self, spec: LayerSpec, chw, *, what: str) -> None:
        if (spec.n_out, spec.h_out, spec.w_out) != tuple(chw):
            c, h, w = chw
            raise UnsupportedOpError(
                f"{self.name}: traced {what} {spec.name} derives "
                f"{spec.n_out}x{spec.h_out}x{spec.w_out} but the graph "
                f"produces {c}x{h}x{w} — only SAME-padding geometry "
                f"(out = in // stride) is representable"
            )

    @staticmethod
    def _unpadded(v: fx.Node) -> fx.Node:
        """The tensor a spatial ``constant_pad_nd`` pads (the models' explicit
        SAME padding), else ``v``."""
        if v.target is aten.constant_pad_nd.default:
            pad = list(v.args[1])
            if len(pad) <= 2 * (len(_shape(v)) - 2) and all(p >= 0 for p in pad):
                return v.args[0]
        return v

    def _batch_one(self, shape) -> None:
        if shape[0] != 1:
            raise UnsupportedOpError(f"{self.name}: trace with batch size 1")

    # ---- op lowering -------------------------------------------------------
    def eqn_conv(self, node: fx.Node, act_in) -> None:
        a = _bound(node)
        lhs, rhs = a["input"], a["weight"]
        if rhs in self.producer:
            raise UnsupportedOpError(
                f"{self.name}: conv with an activation kernel operand is "
                "not supported (use a matmul for activation products)"
            )
        if a["transposed"]:
            raise UnsupportedOpError(f"{self.name}: transposed convolutions unsupported")
        if any(int(d) != 1 for d in a["dilation"]):
            raise UnsupportedOpError(f"{self.name}: dilated convolutions unsupported")
        lhs = self._unpadded(lhs)
        lshape, rshape = _shape(lhs), _shape(rhs)
        self._batch_one(lshape)
        n_in = lshape[1]
        h_in, w_in = (list(lshape[2:]) + [1])[:2]
        n_out = rshape[0]
        kh, kw = (list(rshape[2:]) + [1])[:2]
        strides = tuple(int(s) for s in a["stride"])
        if len(set(strides)) != 1:
            raise UnsupportedOpError(f"{self.name}: anisotropic conv strides unsupported")
        spec = LayerSpec(
            f"conv{len(self.nodes)}", "conv", n_in, n_out, h_in, w_in,
            kh, kw, strides[0], groups=int(a["groups"]),
        )
        oh, ow = (list(_shape(node)[2:]) + [1])[:2]
        if (spec.h_out, spec.w_out) != (oh, ow):
            raise UnsupportedOpError(
                f"{self.name}: conv {spec.name} derives {spec.h_out}x{spec.w_out} "
                f"but the graph produces {oh}x{ow} — only SAME-padding geometry "
                "(out = in // stride) is representable"
            )
        self.producer[node] = self._add_node(
            spec, [(lhs, self.producer[lhs], _words(lhs))])

    def eqn_dot(self, node: fx.Node, act_in) -> None:
        t = node.target
        a = _bound(node)
        if t is aten.linear.default:
            lhs, rhs, bias = a["input"], a["weight"], a.get("bias")
            K = _shape(rhs)[1]
            B, k, l_free, r_free = 1, K, _words(lhs) // K, _shape(rhs)[0]
        else:
            if t is aten.addmm.default:
                lhs, rhs, bias = a["mat1"], a["mat2"], a["self"]
            else:
                lhs, rhs, bias = a["self"], a["mat2"], None
            lshape, rshape = _shape(lhs), _shape(rhs)
            B = lshape[0] if t is aten.bmm.default else 1
            k, l_free, r_free = lshape[-1], lshape[-2], rshape[-1]
        if bias is not None and bias in self.producer:
            raise UnsupportedOpError(
                f"{self.name}: {t} with an activation bias is not supported")
        out = node
        lhs_is_act = lhs in self.producer
        if len(act_in) == 1 and B > 1:
            weight = rhs if lhs_is_act else lhs
            if _val(weight).stride()[0] == 0:
                # A weight expanded across the batch: one plain product
                # whose rows span the batch.
                if lhs_is_act:
                    l_free *= B
                else:
                    r_free *= B
                B = 1
        if len(act_in) == 2:
            if self.producer[lhs] == self.producer[rhs] and isinstance(
                self.producer[lhs], (int, tuple)
            ):
                # Both operands are views of ONE dataflow source (MoE's
                # combine-weights einsum: dispatch one-hots x gates, both
                # derived from the router) — a rearrangement, not a compute
                # node.
                self.producer[out] = self.producer[lhs]
                return
            # Attention-style activation product: the batch axes (heads)
            # fold into the contraction/output so one node prices them all.
            kind, k, m, n = "actmul", B * k, l_free, B * r_free
        elif B > 1:
            # One activation against a stacked weight tensor (MoE expert
            # einsums, (E, d, ff)): E independent matmuls — expand into B
            # branch nodes so each expert's routed capacity words become a
            # real edge.  The out producer is the tuple of branch ids.
            av = lhs if lhs_is_act else rhs
            m = l_free if lhs_is_act else r_free
            n = r_free if lhs_is_act else l_free
            kind = "fc" if m == 1 else "matmul"
            if _words(out) != B * m * n:
                raise UnsupportedOpError(
                    f"{self.name}: batched product output has "
                    f"{_words(out)} words, expected {B}*{m}*{n}"
                )
            p_act = self.producer[av]
            if isinstance(p_act, tuple) and len(p_act) != B:
                raise UnsupportedOpError(
                    f"{self.name}: {len(p_act)}-branch operand into a "
                    f"{B}-batched product"
                )
            branch_words = max(1, _words(av) // B)
            ext = 0 if isinstance(p_act, (int, tuple)) else branch_words
            ids = []
            for b in range(B):
                spec = LayerSpec(
                    f"{kind}{len(self.nodes)}", kind, k, n, m, 1,
                    ext_in_words=ext,
                )
                pending = _PendingNode(spec=spec, inputs={})
                if isinstance(p_act, tuple):
                    pending.inputs[p_act[b]] = branch_words  # branch b feeds b
                elif isinstance(p_act, int):
                    pending.inputs[p_act] = branch_words  # fan-out (dispatch)
                self.nodes.append(pending)
                ids.append(len(self.nodes) - 1)
            self.producer[out] = tuple(ids)
            return
        else:
            m, n = (l_free, r_free) if lhs_is_act else (r_free, l_free)
            kind = "fc" if m == 1 else "matmul"
        # A graph-input operand of a non-source node (e.g. actmul of a
        # projected query against the raw input) has no edge to fuse over:
        # its words stream from DRAM in every grouping.  Source nodes
        # already count all operands via in_words.
        has_edge = any(isinstance(p, (int, tuple)) for _, p, _ in act_in)
        ext = self._ext_words(act_in) if has_edge else 0
        spec = LayerSpec(
            f"{kind}{len(self.nodes)}", kind, k, n, m, 1, ext_in_words=ext
        )
        if _words(out) != m * n:
            raise UnsupportedOpError(
                f"{self.name}: product output has {_words(out)} words, "
                f"expected {m}*{n}"
            )
        self.producer[out] = self._add_node(spec, act_in)

    def eqn_reduce_window(self, node: fx.Node, act_in) -> None:
        a = _bound(node)
        v = self._unpadded(a["self"])
        shape = _shape(v)
        if len(shape) != 4:
            raise UnsupportedOpError(
                f"{self.name}: pooling expects NCHW with a spatial window, "
                f"got shape {shape}"
            )
        self._batch_one(shape)
        kh, kw = (list(a["kernel_size"]) * 2)[:2]
        strides = list(a["stride"]) or [kh, kw]
        sh, sw = (strides * 2)[:2]
        if sh != sw:
            raise UnsupportedOpError(f"{self.name}: anisotropic pool strides unsupported")
        c, h_in, w_in = shape[1], shape[2], shape[3]
        out = _val(node)
        out = out[0] if isinstance(out, (tuple, list)) else out
        out_chw = (int(out.shape[1]), int(out.shape[2]), int(out.shape[3]))
        p_id = self.producer[v]
        if (
            self.fold_pool
            and isinstance(p_id, int)
            and self.nodes[p_id].spec.kind == "conv"
            and self.nodes[p_id].spec.pool_after == 1
            and (kh, kw) == (sh, sw)
            and self._use_count[v] == 1
        ):
            # Absorb into the producing conv's inline pool unit (Fig. 1).
            spec = dataclasses.replace(self.nodes[p_id].spec, pool_after=sh)
            self._check_geometry(spec, out_chw, what="absorbed pool")
            self.nodes[p_id].spec = spec
            self.producer[node] = p_id
            return
        spec = LayerSpec(
            f"pool{len(self.nodes)}", "pool", c, c, h_in, w_in, kh, kw, sh
        )
        self._check_geometry(spec, out_chw, what="pool")
        self.producer[node] = self._add_node(spec, [(v, p_id, _words(v))])

    def eqn_spatial_reduce(self, node: fx.Node, act_in) -> bool:
        """Global spatial reduction (``x.mean((1, 2))`` over NHWC) -> pool
        node.  Returns False when the reduction is not spatial-pool shaped
        (the caller then raises: folding a shape-changing reduction would
        break the producer-frame / edge-words consistency)."""
        v = node.args[0]
        shape = _shape(v)
        if shape[1] != shape[2]:
            return False
        self._batch_one(shape)
        c, hw = shape[3], shape[1]
        spec = LayerSpec(
            f"pool{len(self.nodes)}", "pool", c, c, hw, hw, hw, hw, hw
        )
        self.producer[node] = self._add_node(spec, [(v, self.producer[v], _words(v))])
        return True

    def eqn_scan(self, node: fx.Node, act_in) -> None:
        """The scan marker -> one recurrent ``scan`` node.  The carry's words
        become ``state_words`` (an initial state built as zeros inside the
        traced fn is a constant, not an activation, but still occupies the
        SRAM).  The node frame is the stacked per-chunk outputs, so edge
        words stay consistent with consumers."""
        state = _words(node.args[3])
        c, h, w = _chw(tuple(int(s) for s in _val(node)[0].shape))
        has_edge = any(isinstance(p, (int, tuple)) for _, p, _ in act_in)
        ext = self._ext_words(act_in) if has_edge else 0
        spec = LayerSpec(
            f"scan{len(self.nodes)}", "scan", c, c, h, w,
            ext_in_words=ext, state_words=state,
        )
        self.producer[node] = self._add_node(spec, act_in)

    def eqn_default(self, node: fx.Node, act_in) -> None:
        """Fold, or join >= 2 distinct sources into an ``elementwise`` node
        (the graph input counts as a source, so a residual add of the raw
        input still surfaces as a join).  Operands read straight from the
        graph input have no producer edge to fuse over, so their words
        become the join's ``ext_in_words``.  An op over >= 2 equal-length
        *tuple* producers (the expert-branch gate: silu(w1_e) * w3_e) stays
        branched — one ``elementwise`` node per member, pairwise — so the
        expert fan-out topology survives until a real combine joins it."""
        distinct = {p for _, p, _ in act_in}
        if len(distinct) >= 2:
            c, h, w = _chw(_shape(node))
            if all(isinstance(p, tuple) for p in distinct) and (
                len({len(p) for p in distinct}) == 1
            ):
                branches = sorted(distinct)
                nb = len(branches[0])
                total = _words(node)
                bw = max(1, total // nb)
                hb = max(1, bw // c)
                ids = []
                for b in range(nb):
                    spec = LayerSpec(
                        f"gate{len(self.nodes)}", "elementwise", c, c, hb, 1
                    )
                    pending = _PendingNode(spec=spec, inputs={})
                    for t in branches:
                        pending.inputs[t[b]] = max(pending.inputs.get(t[b], 0), bw)
                    self.nodes.append(pending)
                    ids.append(len(self.nodes) - 1)
                self.producer[node] = tuple(ids)
                return
            ext = self._ext_words(act_in)
            if not any(isinstance(p, (int, tuple)) for p in distinct):
                # All operands are raw inputs: the node is a *source* and
                # already reads in_words (one frame) — ext carries only the
                # frames beyond that.
                ext = max(0, ext - c * h * w)
            spec = LayerSpec(
                f"join{len(self.nodes)}", "elementwise", c, c, h, w,
                ext_in_words=int(ext),
            )
            self.producer[node] = self._add_node(spec, act_in)
            return
        self.producer[node] = distinct.pop() if distinct else None

    # ---- the lowering loop ------------------------------------------------
    def run(self, graph: fx.Graph) -> GraphIR:
        self._use_count: dict[Any, int] = {}
        for node in graph.nodes:
            for a in pytree.tree_leaves((node.args, node.kwargs)):
                if isinstance(a, fx.Node):
                    self._use_count[a] = self._use_count.get(a, 0) + 1
        for node in graph.nodes:
            if node.op != "call_function":
                continue
            act_in = self._act_inputs(node)
            if not act_in:
                continue  # weights/constants only: nothing reaches the IR
            t = node.target
            if t in _CONV_OPS:
                self.eqn_conv(node, act_in)
            elif t in _DOT_OPS:
                self.eqn_dot(node, act_in)
            elif t in _REDUCE_WINDOW_OPS:
                self.eqn_reduce_window(node, act_in)
            elif t in _SPATIAL_REDUCE_OPS:
                # Only an NHWC reduction over *both* spatial axes is
                # pool-shaped; everything else (softmax / rmsnorm statistics
                # over the channel axis, MoE routing sums over arbitrary
                # axes) is a normalisation-style statistic that folds or
                # joins like any elementwise op.
                shape = _shape(node.args[0])
                dims = node.args[1] if len(node.args) > 1 else None
                axes = tuple(sorted(int(d) % max(len(shape), 1) for d in dims or ()))
                if len(shape) == 4 and axes == (1, 2):
                    if not self.eqn_spatial_reduce(node, act_in):
                        # A rectangular global reduction would emit a pool
                        # whose SAME-geometry frame disagrees with the
                        # traced output — refuse.
                        raise UnsupportedOpError(
                            f"{self.name}: {t} over dims {tuple(dims)} on "
                            f"shape {shape} is not representable (only "
                            "square NHWC global spatial reductions map to "
                            "pool nodes)"
                        )
                else:
                    self.eqn_default(node, act_in)
            elif t is _SCAN_OP:
                self.eqn_scan(node, act_in)
            else:
                self.eqn_default(node, act_in)
        if not self.nodes:
            raise UnsupportedOpError(f"{self.name}: no layers traced")
        edges = tuple(
            EdgeSpec(src, dst, words)
            for dst, node in enumerate(self.nodes)
            for src, words in sorted(node.inputs.items())
        )
        return GraphIR(self.name, tuple(n.spec for n in self.nodes), edges)


def _to_meta(tree):
    return pytree.tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta")
        if isinstance(t, torch.Tensor) else t, tree)


def trace(
    fn: Callable,
    *args,
    name: str = "traced",
    activation_argnums: Sequence[int] | None = None,
    fold_pool: bool = False,
    names: Sequence[str] | None = None,
) -> GraphIR:
    """Trace ``fn(*args)`` into a :class:`GraphIR`.

    ``args`` are pytrees of tensors; they are traced as ``device="meta"``
    tensors of the same shapes and dtypes (weights are never materialised).
    ``activation_argnums`` marks which arguments are activation inputs
    (default: the last one, matching ``forward(params, x)``); activations
    must be traced with batch size 1.  ``fold_pool`` absorbs a window ==
    stride pooling into its producing conv's ``pool_after`` when the pooled
    tensor has no other consumer.  ``names`` optionally renames the nodes
    (length-checked).

    Example — a gated MLP, weights as meta tensors only::

        >>> import torch
        >>> from repro_torch.core import frontend as F
        >>> from repro_torch.kernels import ref
        >>> from repro_torch.models import layers as L
        >>> meta = lambda *s: torch.empty(s, device="meta")
        >>> params = {"w1": meta(256, 1024), "w3": meta(256, 1024),
        ...           "w2": meta(1024, 256)}
        >>> g = F.trace(lambda p, x: L.mlp_block(p, x, "swiglu",
        ...                                      fused=ref.fused_mlp_ref),
        ...             params, meta(128, 256), name="mlp")
        >>> [n.kind for n in g.nodes]
        ['matmul', 'matmul', 'elementwise', 'matmul']
        >>> g.n_edges  # w1 -> gate, w3 -> gate, gate -> w2
        3

    Failures are typed: anything the layer abstraction cannot represent
    raises :class:`repro_torch.core.errors.UnsupportedOpError` (a subclass
    of ``ValueError``), never a raw ``KeyError``/``IndexError``.
    """
    from torch.fx.experimental.proxy_tensor import make_fx

    if not args:
        raise UnsupportedOpError("trace() needs at least one example argument")
    nums = (
        {len(args) - 1}
        if activation_argnums is None
        else {a % len(args) for a in activation_argnums}
    )
    args = _to_meta(args)
    try:
        gm = make_fx(lambda *a: fn(*a), tracing_mode="real")(*args)
    except (UnsupportedOpError, GraphValidationError):
        raise
    except Exception as e:
        # PyTorch itself rejected the function (rank/shape errors surface
        # as raw RuntimeError/IndexError/TypeError while *building* the
        # graph) — the trace boundary converts them to the typed taxonomy.
        raise UnsupportedOpError(
            f"{name}: fn is not traceable to an FX graph "
            f"({type(e).__name__}: {e})"
        ) from e
    tr = _Tracer(name=name, fold_pool=fold_pool)
    placeholders = iter(n for n in gm.graph.nodes if n.op == "placeholder")
    for i, arg in enumerate(args):
        for _ in pytree.tree_leaves(arg):
            ph = next(placeholders)
            if i in nums:
                tr.producer[ph] = ph  # each input is its own source
    # Lowering must fail *typed*: an unlowerable graph is an
    # UnsupportedOpError and a lowered-but-invalid IR a
    # GraphValidationError — never a raw KeyError/IndexError from a
    # degenerate op the lowering rules did not anticipate.
    try:
        g = tr.run(gm.graph)
    except (GraphValidationError, UnsupportedOpError):
        raise
    except (KeyError, IndexError, AttributeError, TypeError,
            ZeroDivisionError, AssertionError) as e:
        raise UnsupportedOpError(
            f"{name}: graph is not lowerable to the layer abstraction "
            f"({type(e).__name__}: {e})"
        ) from e
    if names is not None:
        g = rename_nodes(g, names)
    return g


def rename_nodes(g: GraphIR, names: Sequence[str]) -> GraphIR:
    """Rename every node (length-checked) — traced graphs get the
    historical hand-builder names this way."""
    if len(names) != len(g.nodes):
        raise UnsupportedOpError(
            f"{g.name}: {len(names)} names for {len(g.nodes)} nodes "
            f"(traced: {[n.name for n in g.nodes]})"
        )
    nodes = tuple(
        dataclasses.replace(n, name=nm) for n, nm in zip(g.nodes, names)
    )
    return GraphIR(g.name, nodes, g.edges)


def to_chain(g: GraphIR, name: str | None = None) -> NetworkIR:
    """Collapse a chain-shaped trace back to the legacy :class:`NetworkIR`."""
    if not g.is_chain:
        raise UnsupportedOpError(f"{g.name} is not a chain ({g.n_edges} edges)")
    return NetworkIR(name or g.name, g.nodes)


# ---------------------------------------------------------------------------
# Canonical model builders
# ---------------------------------------------------------------------------


def _meta(*shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def vgg16_network(
    *, pool_mode: str = "separate", include_fc: bool = False
) -> NetworkIR:
    """VGG-16 traced from :mod:`repro_torch.models.vgg` (the paper's
    Sec. III workload) — ``pool_mode="absorbed"`` folds each 2x2 pool into
    its conv."""
    from ..models import vgg

    if pool_mode not in ("separate", "absorbed"):
        raise UnsupportedOpError(pool_mode)
    g = trace(
        vgg.forward,
        vgg.param_specs(),
        _meta(1, 224, 224, 3),
        name="vgg16",
        fold_pool=(pool_mode == "absorbed"),
    )
    names: list[str] = []
    for lname, _n_in, _n_out, _hw, pooled in VGG16_CONV_PLAN:
        names.append(lname)
        if pooled and pool_mode == "separate":
            names.append(f"pool{lname[4]}")
    n_feature = len(names)
    names += ["fc6", "fc7", "fc8"]
    net = to_chain(rename_nodes(g, names), "vgg16")
    if not include_fc:
        net = NetworkIR("vgg16", net.layers[:n_feature])
    return net


def resnet18_graph(*, input_hw: int = 224) -> GraphIR:
    """ResNet-18 traced from :mod:`repro_torch.models.resnet` — the skip
    adds come out as real join nodes with two incoming edges."""
    from ..models import resnet

    g = trace(
        resnet.forward,
        resnet.param_specs(),
        _meta(1, input_hw, input_hw, 3),
        name="resnet18",
    )
    names = ["conv1", "pool1"]
    c_in = 64
    for stage, n_blocks, c_out, stride0 in RESNET18_STAGE_PLAN:
        for b in range(n_blocks):
            stride = stride0 if b == 0 else 1
            cin_blk = c_in if b == 0 else c_out
            tag = f"s{stage}b{b}"
            names += [f"{tag}.conv_a", f"{tag}.conv_b"]
            if stride != 1 or cin_blk != c_out:
                names.append(f"{tag}.downsample")
            names.append(f"{tag}.add")
        c_in = c_out
    names += ["avgpool", "fc"]
    return rename_nodes(g, names)


def mobilenet_graph(
    *, input_hw: int = 112, plan: tuple | None = None
) -> GraphIR:
    """MobileNet-style inverted-residual stack traced from
    :mod:`repro_torch.models.mobilenet` — depthwise convs carry ``groups``
    and stride-1 blocks contribute skip joins."""
    from ..models import mobilenet

    plan = mobilenet.MOBILENET_PLAN if plan is None else plan
    g = trace(
        lambda p, x: mobilenet.forward(p, x, plan=plan),
        mobilenet.param_specs(plan=plan),
        _meta(1, input_hw, input_hw, 3),
        name="mobilenet",
    )
    names = ["stem"]
    for i, (c_in, c_out, stride, expand) in enumerate(plan):
        if expand != 1:
            names.append(f"b{i}.expand")
        names += [f"b{i}.dw", f"b{i}.project"]
        if stride == 1 and c_in == c_out:
            names.append(f"b{i}.add")
    return rename_nodes(g, names)


def mlp_block_graph(
    *,
    d_model: int = 256,
    d_ff: int = 1024,
    seq_len: int = 128,
    act: str = "swiglu",
    name: str = "mlp",
) -> GraphIR:
    """One transformer MLP block traced from
    :func:`repro_torch.models.layers.mlp_block` (through its plain fusion
    group) — gated activations (swiglu/geglu) fan the input out to two
    projections and join them in an elementwise product."""
    from ..models import layers as L

    params = {"w1": _meta(d_model, d_ff), "w2": _meta(d_ff, d_model)}
    gated = act in L.GATED_ACTS
    if gated:
        params["w3"] = _meta(d_model, d_ff)
    g = trace(
        lambda p, x: L.mlp_block(p, x, act, fused=ref.fused_mlp_ref),
        params,
        _meta(seq_len, d_model),
        name=name,
    )
    names = (
        [f"{name}.w1", f"{name}.w3", f"{name}.gate", f"{name}.w2"]
        if gated
        else [f"{name}.w1", f"{name}.w2"]
    )
    return rename_nodes(g, names)


# ---------------------------------------------------------------------------
# Config-zoo builders: trace the real production-shape model blocks
# ---------------------------------------------------------------------------


def _zoo_seq_len(cfg, seq_len: int) -> int:
    """Clamp/validate a trace sequence length against the config's MoE
    group-limited routing (tokens must tile into routing groups)."""
    if cfg.n_experts > 1:
        sg = min(cfg.moe_group_size, seq_len)
        if seq_len % sg:
            raise UnsupportedOpError(
                f"{cfg.name}: seq_len {seq_len} does not tile into MoE "
                f"routing groups of {sg}"
            )
    return seq_len


def _trace_kernels(scan_chunk: int) -> ops.FusedKernels:
    """The fusion groups a trace runs through: the plain versions, and the
    scan marker in place of the scan."""
    return dataclasses.replace(ops.PLAIN, ssm_scan=marker_scan(scan_chunk))


def transformer_graph(cfg, *, seq_len: int = 512,
                      n_sublayers: int | None = None,
                      name: str | None = None) -> GraphIR:
    """One superblock (``cfg.pattern_period`` sublayers) of the config's
    decoder trunk, traced from the port's
    :func:`~repro_torch.models.transformer.block_forward`.

    Attention sublayers lower to the actmul pair (QK^T -> folded softmax ->
    PV) with the O(S^2) score matrix as an explicit edge; mamba sublayers
    contribute a recurrent ``scan`` node carrying ``d_inner x d_state``
    ``state_words``; MoE sublayers expand into router + E expert branches +
    combine.  ``n_sublayers`` overrides the traced depth."""
    from ..configs.base import RunConfig
    from ..models import transformer as T

    count = cfg.pattern_period if n_sublayers is None else n_sublayers
    kinds = cfg.sublayer_kinds(0, count)
    seq_len = _zoo_seq_len(cfg, seq_len)
    params = T.sublayer_param_specs(cfg, kinds)
    rc = RunConfig()
    kernels = _trace_kernels(rc.mamba_chunk)
    return trace(
        lambda p, x: T.block_forward(p, x, cfg, kinds, rc=rc,
                                     attn_impl="reference", kernels=kernels),
        params,
        _meta(1, seq_len, cfg.d_model),
        name=name or f"{cfg.name}.block",
    )


def mamba_graph(cfg, *, seq_len: int = 512, chunks: int = 1,
                name: str | None = None) -> GraphIR:
    """One mamba mixer block traced from
    :func:`repro_torch.models.ssm.mamba_block`.

    ``chunks > 1`` splits the sequence and threads the SSM cache between
    the calls — the ``(d_inner, d_state)`` carry hand-off and the
    ``(conv-1)``-token convolution tail both surface as real edges, so the
    fusion search sees the chunk boundary as a cut point."""
    from ..models import ssm as SSM

    if "mamba" not in cfg.layer_pattern:
        raise UnsupportedOpError(f"{cfg.name}: no mamba sublayers in pattern")
    if chunks < 1 or seq_len % chunks:
        raise UnsupportedOpError(
            f"{cfg.name}: seq_len {seq_len} does not split into "
            f"{chunks} chunks"
        )
    params = SSM.mamba_param_specs(cfg)
    step = seq_len // chunks
    scan = marker_scan(step)

    def fn(p, x):
        if chunks == 1:
            return SSM.mamba_block(p, x, cfg, scan=scan)[0]
        cache = {
            "conv": torch.zeros((1, cfg.ssm_conv - 1, cfg.d_inner),
                                dtype=x.dtype, device=x.device),
            "h": torch.zeros((1, cfg.d_inner, cfg.ssm_state),
                             dtype=torch.float32, device=x.device),
        }
        outs = []
        for i in range(chunks):
            y, cache = SSM.mamba_block(p, x[:, i * step:(i + 1) * step], cfg,
                                       cache, scan=scan)
            outs.append(y)
        return torch.cat(outs, dim=1)

    return trace(
        fn, params, _meta(1, seq_len, cfg.d_model),
        name=name or f"{cfg.name}.mamba",
    )


def moe_block_graph(cfg, *, seq_len: int = 512,
                    name: str | None = None) -> GraphIR:
    """One MoE FFN traced from :func:`repro_torch.models.moe.moe_block`: a
    router ``matmul``, a dispatch ``actmul`` whose routed one-hots descend
    from the router, ``E`` expert branches whose incoming edges carry the
    routed capacity words, and a combine ``actmul`` joining the branches
    against the router's combine weights (arctic's parallel dense-residual
    MLP appears alongside)."""
    from ..models import moe as MOE

    if cfg.n_experts <= 1:
        raise UnsupportedOpError(f"{cfg.name}: config has no MoE layers")
    seq_len = _zoo_seq_len(cfg, seq_len)
    params = MOE.moe_param_specs(cfg)
    return trace(
        lambda p, x: MOE.moe_block(p, x, cfg, mlp=ref.fused_mlp_ref)[0],
        params,
        _meta(1, seq_len, cfg.d_model),
        name=name or f"{cfg.name}.moe",
    )
