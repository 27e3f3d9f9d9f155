"""Layer/graph intermediate representation for the pre-RTL evaluator.

The paper (Yang & Chang, ISOCC'21) evaluates networks as chains of layers,
each a convolution with ``N*Nih*Niw`` input frames, ``N*Nkh*Nkw*M`` filter
kernels and ``M*Noh*Now`` output frames (Sec. II-B).  This module defines that
layer abstraction plus two network representations:

* :class:`NetworkIR` — the paper's original *chain* of layers.
* :class:`GraphIR`   — a DAG of layer nodes joined by explicit tensor edges.
  A chain is the special case where edge ``i`` connects node ``i`` to node
  ``i+1``; :func:`as_graph` performs that embedding losslessly.

Fusion groups on a graph are described by a boolean vector over *edges*: a
cut edge crosses a group boundary (its tensor round-trips through DRAM), an
uncut edge stays inside a group (its tensor lives in on-chip SRAM).  For a
residual basic block the cut space looks like::

        in ──e0──> conv_a ──e1──> conv_b ──e2──> add ──e4──> out
         │                                        ^
         └────────────────e3 (skip)───────────────┘

  cutting {e0,e1,e2,e3,e4}  = layer-by-layer (every tensor hits DRAM);
  cutting {e0,e4} only      = the whole block is one fusion group — the
  skip tensor e3 *and* both conv intermediates stay in SRAM, a grouping a
  chain IR cannot even express (e3 is a second consumer of ``in``'s output).
  A valid group must be weakly connected and convex (no dataflow may leave
  the group and re-enter), which on the quotient graph means acyclicity —
  see :mod:`repro_torch.core.fusion`.

:func:`vgg16_ir` builds the paper's own Sec. III workload directly from
:data:`VGG16_CONV_PLAN`; :func:`transformer_block_ir` and :func:`lm_ir`
build the transformer chains the planner prices; :func:`resnet18_ir`
(residual DAG), :func:`residual_block_ir` and :func:`encoder_decoder_ir`
(cross-attention DAG) build the graphs the DAG search runs on.  Everything
here is plain Python + numpy feature extraction; the batched metric sweep
lives in :mod:`repro_torch.core.metrics`.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Iterable, Sequence

import numpy as np

from .errors import GraphValidationError, UnsupportedOpError

# Layer kinds.  "conv" and "fc" carry weights; "pool" is weightless; "matmul"
# covers transformer projections (weights) and "actmul" covers activation x
# activation products (attention QK^T / PV) whose "weights" are activations
# and therefore count as input traffic, not weight traffic.  "scan" is a
# recurrent node (SSM selective scan): weightless like elementwise, but its
# ``state_words`` carry occupies SRAM in every grouping.
KINDS = ("conv", "pool", "fc", "matmul", "actmul", "elementwise", "scan")

# Integer-valued LayerSpec fields and the floor each must satisfy.  NaN,
# inf, floats and negative word counts are all rejected here — the
# feature-matrix columns derive from these fields, so validating them at
# construction is what makes every downstream feature word finite and
# non-negative.
_LAYER_INT_FIELDS = (
    ("n_in", 1), ("n_out", 1), ("h_in", 1), ("w_in", 1),
    ("kh", 1), ("kw", 1), ("stride", 1), ("pool_after", 1),
    ("flops_per_mac", 1), ("groups", 1), ("ext_in_words", 0),
    ("state_words", 0),
)


def _as_valid_int(value, *, floor: int, what: str) -> int:
    """``value`` as a plain int, or :class:`GraphValidationError` naming the
    offending field — floats (including NaN/inf), bools and anything below
    ``floor`` are corrupt feature words, not layer geometry."""
    if isinstance(value, bool) or not isinstance(value, (int, np.integer)):
        raise GraphValidationError(
            f"{what} = {value!r} is not an integer word count"
        )
    if value < floor:
        raise GraphValidationError(f"{what} = {int(value)} is below {floor}")
    return int(value)


def validate_layer(l: "LayerSpec") -> None:
    """Check every :class:`LayerSpec` invariant, raising
    :class:`GraphValidationError` naming the offending field.  Runs at
    construction (``__post_init__``) and again from
    :meth:`GraphIR.validate` so graphs corrupted *after* construction are
    still caught."""
    if l.kind not in KINDS:
        raise GraphValidationError(
            f"{l.name}: unknown layer kind {l.kind!r} (expected one of {KINDS})"
        )
    for field, floor in _LAYER_INT_FIELDS:
        _as_valid_int(getattr(l, field), floor=floor,
                      what=f"{l.name}: {field}")
    if l.n_in % l.groups or l.n_out % l.groups:
        raise GraphValidationError(
            f"{l.name}: groups={l.groups} must divide "
            f"n_in={l.n_in} and n_out={l.n_out}"
        )


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer in the paper's notation.

    ``n_in``/``n_out`` are N / M (input / output channels); ``h_in``/``w_in``
    are Nih/Niw; ``kh``/``kw`` are Nkh/Nkw; ``h_out``/``w_out`` are Noh/Now.
    ``pool_after`` > 1 means a pooling stage is *absorbed* into this layer's
    write-out path (the DLA's inline ReLU/BN/pool functional unit, Fig. 1).
    ``groups`` > 1 is a grouped convolution: each output channel contracts
    only ``n_in / groups`` input channels.  ``ext_in_words`` > 0 is
    activation traffic streamed from DRAM *regardless of grouping*.
    ``state_words`` > 0 is a recurrent carry that lives in SRAM for the
    node's whole execution, in *every* grouping.
    """

    name: str
    kind: str
    n_in: int
    n_out: int
    h_in: int
    w_in: int
    kh: int = 1
    kw: int = 1
    stride: int = 1
    pool_after: int = 1
    flops_per_mac: int = 2
    groups: int = 1
    ext_in_words: int = 0
    state_words: int = 0

    def __post_init__(self):
        validate_layer(self)

    # ---- derived geometry (SAME padding; stride then absorbed pool) --------
    @property
    def h_out(self) -> int:
        """Output height: SAME-padding stride then the absorbed pool."""
        return max(1, self.h_in // self.stride // self.pool_after)

    @property
    def w_out(self) -> int:
        """Output width: SAME-padding stride then the absorbed pool."""
        base = self.w_in // self.stride
        return max(1, base // self.pool_after)

    # ---- paper quantities (in words; the paper uses one word per element) --
    @property
    def contracted_channels(self) -> int:
        """Input channels each output channel contracts (N / groups)."""
        return self.n_in // self.groups

    @property
    def weight_words(self) -> int:
        """(N/groups)*Nkh*Nkw*M for weighted layers; 0 for pool/actmul/elementwise."""
        if self.kind in ("conv", "fc", "matmul"):
            return self.contracted_channels * self.kh * self.kw * self.n_out
        return 0

    @property
    def in_words(self) -> int:
        """N*Nih*Niw (+ the second operand for activation-activation products)."""
        base = self.n_in * self.h_in * self.w_in
        if self.kind == "actmul":
            base += self.n_in * self.kh * self.kw * self.n_out
        return base

    @property
    def out_words(self) -> int:
        """M*Noh*Now after the absorbed pool (what hits DRAM on write-out)."""
        return self.n_out * self.h_out * self.w_out

    @property
    def out_words_prepool(self) -> int:
        """M*Noh*Now before the absorbed pool (the on-chip intermediate)."""
        return self.n_out * (self.h_in // self.stride) * (self.w_in // self.stride)

    @property
    def macs(self) -> int:
        """MAC count of the layer (zero for weightless kinds)."""
        if self.kind in ("pool", "elementwise", "scan"):
            return 0
        return (
            self.contracted_channels
            * self.kh
            * self.kw
            * self.n_out
            * (self.h_in // self.stride)
            * (self.w_in // self.stride)
        )

    @property
    def flops(self) -> int:
        """FLOPs at 2 per MAC."""
        return self.macs * self.flops_per_mac

    def describe(self) -> str:
        """One-line geometry/kernel/weight/MAC summary."""
        grp = f" g={self.groups}" if self.groups > 1 else ""
        return (
            f"{self.name:12s} {self.kind:5s} N={self.n_in:5d} M={self.n_out:5d} "
            f"in={self.h_in}x{self.w_in} k={self.kh}x{self.kw}/{self.stride}{grp} "
            f"pool={self.pool_after} W={self.weight_words} MACs={self.macs}"
        )


def _feature_row(l: LayerSpec) -> list[float]:
    """One feature vector (order = ``NetworkIR.FEATURES``).

    The ``n_in`` column carries the *contracted* channels (N / groups) — the
    input-parallel extent the PE array actually tiles.
    """
    return [
        l.weight_words,
        l.in_words,
        l.out_words,
        l.out_words_prepool,
        l.macs,
        1.0 if l.kind == "pool" else 0.0,
        l.kh,
        l.kw,
        l.contracted_channels,
        l.n_out,
        (l.h_in // l.stride) * (l.w_in // l.stride),
        l.ext_in_words,
        l.state_words,
    ]


@dataclasses.dataclass(frozen=True)
class NetworkIR:
    """A chain of layers (the unit the fusion search partitions)."""

    name: str
    layers: tuple[LayerSpec, ...]

    def __post_init__(self):
        if not self.layers:
            raise ValueError("empty network")

    def __len__(self) -> int:
        return len(self.layers)

    def __iter__(self):
        return iter(self.layers)

    @property
    def total_macs(self) -> int:
        """Network-total MAC count."""
        return sum(l.macs for l in self.layers)

    @property
    def total_weight_words(self) -> int:
        """Network-total weight words (read once per inference, Eq. (1))."""
        return sum(l.weight_words for l in self.layers)

    # ---- feature matrix for the batched metric sweep -----------------------
    FEATURES = (
        "weight_words",
        "in_words",
        "out_words",
        "out_words_prepool",
        "macs",
        "is_pool",
        "kh",
        "kw",
        "n_in",
        "n_out",
        "pixels_out",
        "ext_in_words",
        "state_words",
    )

    def feature_matrix(self) -> np.ndarray:
        """(L, F) float64 matrix consumed by :mod:`repro_torch.core.metrics`."""
        return np.asarray([_feature_row(l) for l in self.layers], dtype=np.float64)

    def pool_boundary_cuts(self) -> np.ndarray:
        """The paper's VGG-16 grouping: cut after every pooling stage.

        Returns a boolean cut vector of length L-1 (cut[i] == True means a
        group boundary between layer i and layer i+1).
        """
        L = len(self.layers)
        cuts = np.zeros(L - 1, dtype=bool)
        for i, l in enumerate(self.layers[:-1]):
            if l.kind == "pool" or l.pool_after > 1:
                cuts[i] = True
        return cuts


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------

VGG16_CONV_PLAN = (
    # (name, n_in, n_out, spatial, pool_after_this_layer)
    ("conv1_1", 3, 64, 224, False),
    ("conv1_2", 64, 64, 224, True),
    ("conv2_1", 64, 128, 112, False),
    ("conv2_2", 128, 128, 112, True),
    ("conv3_1", 128, 256, 56, False),
    ("conv3_2", 256, 256, 56, False),
    ("conv3_3", 256, 256, 56, True),
    ("conv4_1", 256, 512, 28, False),
    ("conv4_2", 512, 512, 28, False),
    ("conv4_3", 512, 512, 28, True),
    ("conv5_1", 512, 512, 14, False),
    ("conv5_2", 512, 512, 14, False),
    ("conv5_3", 512, 512, 14, True),
)


@functools.lru_cache(maxsize=None)
def vgg16_ir(*, pool_mode: str = "separate", include_fc: bool = False) -> NetworkIR:
    """VGG-16 feature extractor as used in the paper's Sec. III experiment,
    built layer by layer from :data:`VGG16_CONV_PLAN` (224x224 input).

    pool_mode:
      * ``"separate"``  — pooling layers are standalone layers (the naive
        layer-by-layer execution round-trips them through DRAM; fusion absorbs
        them into the group).  This is the accounting that reproduces the
        paper's 55.6 % bandwidth-reduction number.
      * ``"absorbed"``  — pooling runs inside the producing conv's functional
        unit even in layer-by-layer mode (no standalone pool layers).

    ``include_fc`` appends the three fully-connected classifier layers.
    """
    if pool_mode not in ("separate", "absorbed"):
        raise UnsupportedOpError(pool_mode)
    layers = []
    for name, n_in, n_out, hw, pooled in VGG16_CONV_PLAN:
        if pooled and pool_mode == "absorbed":
            layers.append(
                LayerSpec(name, "conv", n_in, n_out, hw, hw, 3, 3, 1, pool_after=2)
            )
        else:
            layers.append(LayerSpec(name, "conv", n_in, n_out, hw, hw, 3, 3, 1))
            if pooled:
                layers.append(
                    LayerSpec(f"pool{name[4]}", "pool", n_out, n_out, hw, hw, 2, 2, 2)
                )
    if include_fc:
        layers.append(LayerSpec("fc6", "fc", 512 * 7 * 7, 4096, 1, 1))
        layers.append(LayerSpec("fc7", "fc", 4096, 4096, 1, 1))
        layers.append(LayerSpec("fc8", "fc", 4096, 1000, 1, 1))
    return NetworkIR("vgg16", tuple(layers))


def transformer_block_ir(
    *,
    name: str,
    d_model: int,
    n_heads: int,
    n_kv_heads: int,
    d_ff: int,
    seq_len: int,
    ffn_act: str = "swiglu",
    n_experts: int = 0,
    top_k: int = 1,
) -> NetworkIR:
    """One transformer block as a layer chain for the evaluator.

    Matmuls become 1x1 convolutions over ``seq_len`` pixels (h_in=seq, w_in=1)
    with channels = feature dims.  Attention's QK^T and PV products are
    ``actmul`` layers (both operands are activations).  For MoE blocks the MLP
    matmuls carry the *active* expert weights (top_k experts worth of compute;
    weight traffic scales with the experts actually streamed from DRAM).

    The head width is ``d_model // n_heads``, as the reference builds it,
    even where the config's ``head_dim`` differs (qwen3: 64 here, 128 in the
    model): the planner's bandwidth verdicts must stay bit-identical to the
    reference's.
    """
    hd = d_model // n_heads
    kv_dim = n_kv_heads * hd
    layers = [
        LayerSpec(f"{name}.q", "matmul", d_model, d_model, seq_len, 1),
        LayerSpec(f"{name}.kv", "matmul", d_model, 2 * kv_dim, seq_len, 1),
        # QK^T: contraction over head_dim, output seq x seq per head.
        LayerSpec(f"{name}.qk", "actmul", d_model, n_heads * seq_len, seq_len, 1),
        # PV: contraction over seq, output seq x d_model.
        LayerSpec(f"{name}.pv", "actmul", n_heads * seq_len, d_model, seq_len, 1),
        LayerSpec(f"{name}.o", "matmul", d_model, d_model, seq_len, 1),
    ]
    mult = 2 if ffn_act == "swiglu" else 1  # gate + up projections
    k = max(1, top_k)
    if n_experts > 1:
        layers.append(
            LayerSpec(f"{name}.moe_w1", "matmul", d_model, mult * d_ff * k, seq_len, 1)
        )
        layers.append(
            LayerSpec(f"{name}.moe_w2", "matmul", d_ff * k, d_model, seq_len, 1)
        )
    else:
        layers.append(LayerSpec(f"{name}.w1", "matmul", d_model, mult * d_ff, seq_len, 1))
        layers.append(LayerSpec(f"{name}.w2", "matmul", d_ff, d_model, seq_len, 1))
    return NetworkIR(name, tuple(layers))


def lm_ir(
    *,
    name: str,
    n_layers: int,
    d_model: int,
    n_heads: int,
    n_kv_heads: int,
    d_ff: int,
    seq_len: int,
    n_experts: int = 0,
    top_k: int = 1,
    repeat: int = 1,
) -> NetworkIR:
    """A (possibly truncated) LM as one chain; ``repeat`` caps emitted blocks.

    The evaluator's fusion search is per-chain; transformer LMs are periodic,
    so evaluating ``repeat`` blocks and scaling by ``n_layers / repeat`` is
    exact for periodic stacks.
    """
    blocks = []
    for b in range(min(repeat, n_layers)):
        blk = transformer_block_ir(
            name=f"{name}.b{b}",
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv_heads,
            d_ff=d_ff,
            seq_len=seq_len,
            n_experts=n_experts,
            top_k=top_k,
        )
        blocks.extend(blk.layers)
    return NetworkIR(name, tuple(blocks))


def chain_ir(name: str, layers: Iterable[LayerSpec]) -> NetworkIR:
    """Build a chain ``NetworkIR`` from an iterable of layers."""
    return NetworkIR(name, tuple(layers))


# ---------------------------------------------------------------------------
# Graph IR — DAG of layer nodes with explicit tensor edges
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EdgeSpec:
    """A tensor flowing from node ``src`` to node ``dst``.

    ``words`` is the tensor's word count as *read by the consumer*: if the
    edge is cut the consumer streams ``words`` from DRAM; if the edge is
    internal the tensor occupies ``words`` of on-chip frame SRAM instead.
    For chain embeddings this is the consumer layer's ``in_words`` so chain
    metrics stay bit-identical.
    """

    src: int
    dst: int
    words: int

    def __post_init__(self):
        validate_edge(self)


def validate_edge(e: "EdgeSpec", n_nodes: int | None = None) -> None:
    """Check one :class:`EdgeSpec`, raising :class:`GraphValidationError`
    naming the edge.  ``src < dst`` is the IR's acyclicity invariant (node
    ids are topological); ``n_nodes`` additionally range-checks the
    endpoints against a graph."""
    tag = f"edge ({e.src}->{e.dst})"
    _as_valid_int(e.src, floor=0, what=f"{tag} src")
    _as_valid_int(e.dst, floor=0, what=f"{tag} dst")
    if e.dst <= e.src:
        raise GraphValidationError(
            f"{tag} must be topological (src < dst); a dst <= src edge "
            "would make the graph cyclic"
        )
    _as_valid_int(e.words, floor=1, what=f"{tag} words")
    if n_nodes is not None and e.dst >= n_nodes:
        raise GraphValidationError(f"{tag} out of range (L={n_nodes})")


@dataclasses.dataclass(frozen=True)
class GraphIR:
    """A DAG of layers (the unit the edge-cut fusion search partitions).

    Nodes are :class:`LayerSpec` in topological order; every edge satisfies
    ``src < dst`` and edges are stored sorted by ``(src, dst)``.  Nodes with
    no incoming edge read their input frame from DRAM unconditionally;
    nodes with no outgoing edge write their output frame unconditionally.
    """

    name: str
    nodes: tuple[LayerSpec, ...]
    edges: tuple[EdgeSpec, ...]

    def __post_init__(self):
        self.validate()
        object.__setattr__(
            self, "edges", tuple(sorted(self.edges, key=lambda e: (e.src, e.dst)))
        )

    def validate(self) -> "GraphIR":
        """Re-check every IR invariant — node fields finite/positive, edge
        endpoints in range, topological (acyclic) edges, no duplicates —
        raising :class:`GraphValidationError` naming the offending node or
        edge.  Returns ``self`` so call sites can chain."""
        if not self.nodes:
            raise GraphValidationError(f"{self.name}: empty graph")
        for i, n in enumerate(self.nodes):
            if not isinstance(n, LayerSpec):
                raise GraphValidationError(
                    f"{self.name}: node {i} is {type(n).__name__}, "
                    "not a LayerSpec"
                )
            validate_layer(n)
        L = len(self.nodes)
        seen = set()
        for e in self.edges:
            if not isinstance(e, EdgeSpec):
                raise GraphValidationError(
                    f"{self.name}: edge {e!r} is not an EdgeSpec"
                )
            validate_edge(e, L)
            if (e.src, e.dst) in seen:
                raise GraphValidationError(
                    f"duplicate edge ({e.src}->{e.dst})"
                )
            seen.add((e.src, e.dst))
        return self

    def __len__(self) -> int:
        return len(self.nodes)

    @property
    def n_nodes(self) -> int:
        """Node count (alias of ``len(graph)``)."""
        return len(self.nodes)

    @property
    def n_edges(self) -> int:
        """Edge count — the grouping space is the 2^n_edges cut vectors."""
        return len(self.edges)

    @property
    def is_chain(self) -> bool:
        """True iff the graph is exactly the chain embedding (edge i: i->i+1)."""
        return len(self.edges) == len(self.nodes) - 1 and all(
            e.src == i and e.dst == i + 1 for i, e in enumerate(self.edges)
        )

    @property
    def total_macs(self) -> int:
        """Graph-total MAC count."""
        return sum(n.macs for n in self.nodes)

    @property
    def total_weight_words(self) -> int:
        """Graph-total weight words (read once per inference, Eq. (1))."""
        return sum(n.weight_words for n in self.nodes)

    # ---- numpy views for the metric sweep ----------------------------------
    FEATURES = NetworkIR.FEATURES

    def node_features(self) -> np.ndarray:
        """(L, F) float64 matrix (same columns as ``NetworkIR.feature_matrix``)."""
        return np.asarray([_feature_row(n) for n in self.nodes], dtype=np.float64)

    def edge_arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(src, dst, words) arrays of shape (E,): int64, int64, float64."""
        src = np.asarray([e.src for e in self.edges], dtype=np.int64)
        dst = np.asarray([e.dst for e in self.edges], dtype=np.int64)
        words = np.asarray([e.words for e in self.edges], dtype=np.float64)
        return src, dst, words

    @property
    def in_degree(self) -> np.ndarray:
        """(L,) incoming-edge count per node."""
        deg = np.zeros(len(self.nodes), dtype=np.int64)
        for e in self.edges:
            deg[e.dst] += 1
        return deg

    @property
    def out_degree(self) -> np.ndarray:
        """(L,) outgoing-edge count per node."""
        deg = np.zeros(len(self.nodes), dtype=np.int64)
        for e in self.edges:
            deg[e.src] += 1
        return deg

    @property
    def source_mask(self) -> np.ndarray:
        """(L,) bool — nodes reading their input frame from DRAM."""
        return self.in_degree == 0

    @property
    def sink_mask(self) -> np.ndarray:
        """(L,) bool — nodes whose output always writes to DRAM."""
        return self.out_degree == 0

    def successors(self, i: int) -> list[int]:
        """Consumer node ids of node ``i``."""
        return [e.dst for e in self.edges if e.src == i]

    def predecessors(self, i: int) -> list[int]:
        """Producer node ids of node ``i``."""
        return [e.src for e in self.edges if e.dst == i]

    def pool_boundary_cuts(self) -> np.ndarray:
        """The paper's Sec. III policy lifted to edges: cut every edge whose
        producer ends a pooling stage (standalone pool layer or absorbed
        pool), then repaired to a *valid* partition.  On a chain embedding
        this equals ``NetworkIR.pool_boundary_cuts``."""
        cuts = np.zeros(len(self.edges), dtype=bool)
        for k, e in enumerate(self.edges):
            p = self.nodes[e.src]
            if p.kind == "pool" or p.pool_after > 1:
                cuts[k] = True
        return _repair_partition_cuts(len(self.nodes), self.edges, cuts)

    def describe(self) -> str:
        """Multi-line dump: one row per node with its producer ids."""
        lines = [f"graph {self.name}: {len(self.nodes)} nodes, {len(self.edges)} edges"]
        for i, n in enumerate(self.nodes):
            preds = self.predecessors(i)
            tag = f" <- {preds}" if preds else " <- (DRAM)"
            lines.append(f"  [{i:3d}] {n.describe()}{tag}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Shape buckets — zero-padded views for the bucketed evaluator
# ---------------------------------------------------------------------------


def bucket_size(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor) — the shape-bucket rounding
    :mod:`repro_torch.core.flow` pads the sweep's arguments to."""
    n = max(int(n), int(floor), 1)
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class PaddedGraph:
    """Zero-padded numpy views of a :class:`GraphIR` for bucketed evaluation.

    Padded node rows carry all-zero features with ``node_mask`` False and
    ``src_mask``/``sink_mask`` False; padded edges point ``0 -> 0`` with
    ``words == 0`` and ``edge_mask`` False.  The masked sweep
    (:func:`repro_torch.core.metrics.evaluate_batch_graph`) makes such rows
    exactly inert in Eq. (1)-(4), so padded results are bit-identical to the
    unpadded path.
    """

    feat: np.ndarray  # (L_b, F) — rows >= n_nodes are all-zero
    esrc: np.ndarray  # (E_b,) int64 — entries >= n_edges are 0
    edst: np.ndarray  # (E_b,) int64 — entries >= n_edges are 0
    ewords: np.ndarray  # (E_b,) float64 — entries >= n_edges are 0.0
    src_mask: np.ndarray  # (L_b,) bool — False on padded rows
    sink_mask: np.ndarray  # (L_b,) bool — False on padded rows
    node_mask: np.ndarray  # (L_b,) bool — True exactly on real nodes
    edge_mask: np.ndarray  # (E_b,) bool — True exactly on real edges
    n_nodes: int  # real node count (L)
    n_edges: int  # real edge count (E)

    @property
    def n_nodes_padded(self) -> int:
        """Bucket node count L_pad (>= n_nodes)."""
        return self.feat.shape[0]

    @property
    def n_edges_padded(self) -> int:
        """Bucket edge count E_pad (>= n_edges)."""
        return self.esrc.shape[0]


def pad_graph(
    g: GraphIR, *, n_nodes: int | None = None, n_edges: int | None = None
) -> PaddedGraph:
    """Zero-pad ``g``'s evaluator arrays to bucket sizes.

    ``n_nodes``/``n_edges`` are the target (padded) sizes and must be >= the
    real counts; they default to the next power of two
    (:func:`bucket_size`).
    """
    L, E = g.n_nodes, g.n_edges
    L_b = bucket_size(L) if n_nodes is None else int(n_nodes)
    E_b = bucket_size(E) if n_edges is None else int(n_edges)
    if L_b < L or E_b < E:
        raise ValueError(
            f"bucket ({L_b}, {E_b}) smaller than graph ({L}, {E})"
        )
    feat = g.node_features()
    esrc, edst, ewords = g.edge_arrays()
    feat_p = np.zeros((L_b, feat.shape[1]), dtype=feat.dtype)
    feat_p[:L] = feat
    esrc_p = np.zeros(E_b, dtype=np.int64)
    esrc_p[:E] = esrc
    edst_p = np.zeros(E_b, dtype=np.int64)
    edst_p[:E] = edst
    ewords_p = np.zeros(E_b, dtype=np.float64)
    ewords_p[:E] = ewords

    def _pad_mask(m: np.ndarray, n: int) -> np.ndarray:
        out = np.zeros(n, dtype=bool)
        out[: m.shape[0]] = m
        return out

    node_mask = np.zeros(L_b, dtype=bool)
    node_mask[:L] = True
    edge_mask = np.zeros(E_b, dtype=bool)
    edge_mask[:E] = True
    return PaddedGraph(
        feat=feat_p,
        esrc=esrc_p,
        edst=edst_p,
        ewords=ewords_p,
        src_mask=_pad_mask(g.source_mask, L_b),
        sink_mask=_pad_mask(g.sink_mask, L_b),
        node_mask=node_mask,
        edge_mask=edge_mask,
        n_nodes=L,
        n_edges=E,
    )


def pad_cuts_batch(
    cuts_batch: np.ndarray, n_edges: int, n_rows: int | None = None
) -> np.ndarray:
    """Pad a (C, E) cut batch to ``(n_rows, n_edges)`` with False.

    Padded edge columns are ignored by the masked sweep (``edge_mask``);
    padded candidate rows evaluate to well-defined but meaningless metrics
    and must be sliced off by the caller (``out[:, :C]``) before any
    feasibility test or argmin.
    """
    cuts = np.atleast_2d(np.asarray(cuts_batch, dtype=bool))
    C, E = cuts.shape
    C_b = C if n_rows is None else int(n_rows)
    if n_edges < E or C_b < C:
        raise ValueError(
            f"pad target ({C_b}, {n_edges}) smaller than batch ({C}, {E})"
        )
    out = np.zeros((C_b, n_edges), dtype=bool)
    out[:C, :E] = cuts
    return out


# ---------------------------------------------------------------------------
# Component labels and quotient graphs (shared by the fusion search)
# ---------------------------------------------------------------------------


def uncut_component_labels(
    n_nodes: int, edges: tuple[EdgeSpec, ...], cuts: np.ndarray
) -> np.ndarray:
    """(L,) group labels: connected components of the uncut subgraph,
    relabelled to consecutive ints in order of first node appearance."""
    cuts = np.asarray(cuts, dtype=bool)
    parent = list(range(n_nodes))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for k, e in enumerate(edges):
        if not cuts[k]:
            ra, rb = find(e.src), find(e.dst)
            if ra != rb:
                parent[rb] = ra
    remap: dict[int, int] = {}
    out = np.empty(n_nodes, dtype=np.int64)
    for i in range(n_nodes):
        r = find(i)
        if r not in remap:
            remap[r] = len(remap)
        out[i] = remap[r]
    return out


def _min_label_reps_batch(
    n_nodes: int,
    esrc: np.ndarray,
    edst: np.ndarray,
    cuts_batch: np.ndarray,
) -> np.ndarray:
    """(C, L) component representatives (min node index per component) of the
    uncut subgraph, for a whole batch of cut vectors at once.

    Min-label propagation: every node starts labelled with its own index;
    each sweep relaxes every uncut edge to the min of its endpoint labels,
    then pointer-jumps (``lab <- lab[lab]``) until a full sweep changes
    nothing.
    """
    cuts_batch = np.asarray(cuts_batch, dtype=bool)
    C = cuts_batch.shape[0]
    dtype = np.int16 if n_nodes < 2**15 else np.int64
    lab = np.repeat(np.arange(n_nodes, dtype=dtype)[None, :], max(C, 1), axis=0)
    E = len(esrc)
    if E == 0 or C == 0:
        return lab[:C]
    uncut = ~cuts_batch

    def relax(k: int) -> None:
        u = uncut[:, k]
        ls = lab[:, esrc[k]]
        ld = lab[:, edst[k]]
        m = np.minimum(ls, ld)
        lab[:, esrc[k]] = np.where(u, m, ls)
        lab[:, edst[k]] = np.where(u, m, ld)

    while True:
        prev = lab.copy()
        for k in range(E):  # forward: minima flow with the edge order ...
            relax(k)
        for k in range(E - 1, -1, -1):  # ... and backward, against it
            relax(k)
        lab = np.take_along_axis(lab, lab, axis=1)
        if np.array_equal(lab, prev):
            return lab


def canonicalize_labels_batch(labels: np.ndarray) -> np.ndarray:
    """Relabel every row of a (C, L) label batch to consecutive ints in order
    of first appearance — the canonical form :func:`uncut_component_labels`
    returns (and the dedup key the merge searches use)."""
    labels = np.atleast_2d(np.asarray(labels))
    C, L = labels.shape
    if L == 0 or C == 0:
        return labels.astype(np.int16)
    rows = np.arange(C)
    first = np.full((C, L), L, dtype=np.int16)  # first[c, v]: first col of v
    for i in range(L - 1, -1, -1):
        first[rows, labels[:, i]] = i
    fp = np.take_along_axis(first, labels.astype(np.int64), axis=1)
    is_first = fp == np.arange(L, dtype=np.int16)[None, :]
    rank = np.cumsum(is_first, axis=1, dtype=np.int16)
    return np.take_along_axis(rank, fp.astype(np.int64), axis=1) - 1


def uncut_component_labels_batch(
    n_nodes: int, edges: tuple[EdgeSpec, ...], cuts_batch: np.ndarray
) -> np.ndarray:
    """Batched :func:`uncut_component_labels`: (C, E) cut batch -> (C, L)
    canonical group labels, with no per-candidate Python (lock-step with the
    scalar union-find, asserted in tests)."""
    cuts_batch = np.atleast_2d(np.asarray(cuts_batch, dtype=bool))
    esrc = np.asarray([e.src for e in edges], dtype=np.int64)
    edst = np.asarray([e.dst for e in edges], dtype=np.int64)
    return canonicalize_labels_batch(
        _min_label_reps_batch(n_nodes, esrc, edst, cuts_batch)
    )


def quotient_acyclic_batch(
    n_nodes: int,
    esrc: np.ndarray,
    edst: np.ndarray,
    labels: np.ndarray,
) -> np.ndarray:
    """(C,) bool — is each row's group-contracted (quotient) graph acyclic?

    Vectorised Kahn peeling: repeatedly remove every group with no incoming
    arc from a still-alive group; a row is acyclic iff all groups die.
    ``labels`` may be representatives or canonical labels — any values in
    [0, n_nodes).
    """
    labels = np.atleast_2d(np.asarray(labels))
    C = labels.shape[0]
    out = np.ones(C, dtype=bool)
    E = len(esrc)
    if E == 0 or C == 0:
        return out
    lab_s = labels[:, esrc]  # (C, E) group of each arc tail
    lab_d = labels[:, edst]
    cross = lab_s != lab_d
    ids = np.flatnonzero(cross.any(axis=1))  # rows with >= 1 quotient arc
    if ids.size == 0:
        return out
    lab_s, lab_d, cross = lab_s[ids], lab_d[ids], cross[ids]
    alive = np.zeros((ids.size, n_nodes), dtype=bool)
    np.put_along_axis(alive, labels[ids].astype(np.int64), True, axis=1)
    while ids.size:
        rows = np.arange(ids.size)
        in_any = np.zeros((ids.size, n_nodes), dtype=bool)
        for k in range(E):
            act = cross[:, k] & alive[rows, lab_s[:, k]]
            in_any[rows, lab_d[:, k]] |= act
        removable = alive & ~in_any
        progressed = removable.any(axis=1)
        alive &= ~removable
        alive_left = alive.any(axis=1)
        out[ids[alive_left & ~progressed]] = False  # stuck -> cyclic
        keep = alive_left & progressed
        if not keep.any():
            return out
        ids, alive = ids[keep], alive[keep]
        lab_s, lab_d, cross = lab_s[keep], lab_d[keep], cross[keep]
    return out


def scc_labels(n: int, arcs: set[tuple[int, int]]) -> list[int]:
    """Strongly-connected-component id per vertex (iterative Kosaraju)."""
    adj: list[list[int]] = [[] for _ in range(n)]
    radj: list[list[int]] = [[] for _ in range(n)]
    for a, b in arcs:
        adj[a].append(b)
        radj[b].append(a)
    order: list[int] = []
    seen = [False] * n
    for s in range(n):
        if seen[s]:
            continue
        seen[s] = True
        stack = [(s, 0)]
        while stack:
            u, i = stack[-1]
            if i < len(adj[u]):
                stack[-1] = (u, i + 1)
                v = adj[u][i]
                if not seen[v]:
                    seen[v] = True
                    stack.append((v, 0))
            else:
                order.append(u)
                stack.pop()
    comp = [-1] * n
    c = 0
    for s in reversed(order):
        if comp[s] != -1:
            continue
        comp[s] = c
        stack2 = [s]
        while stack2:
            u = stack2.pop()
            for v in radj[u]:
                if comp[v] == -1:
                    comp[v] = c
                    stack2.append(v)
        c += 1
    return comp


# ---------------------------------------------------------------------------
# Topological elimination orders and frontier width (for the frontier DP)
# ---------------------------------------------------------------------------
#
# The frontier-state fusion DP (:func:`repro_torch.core.fusion.frontier_dp_min_bw`)
# sweeps nodes in a topological order; its state space is governed by the
# *frontier width* — the largest number of already-processed nodes that still
# have an edge into the unprocessed suffix at any point of the sweep.  Any
# topological order yields the same optimum (cost accounting is
# order-independent); a narrower order just keeps the DP small, so the
# search picks the better of the natural node order and a greedy
# width-minimising order.


def topo_frontier_sets(
    g: GraphIR, order: Sequence[int] | None = None
) -> list[list[int]]:
    """Frontier after each step of a topological sweep.

    ``out[t]`` lists (ascending node ids) the nodes among ``order[: t + 1]``
    that still have >= 1 edge to a node outside that prefix — exactly the
    nodes whose pending out-edges the frontier DP has yet to decide.  The
    last entry is always empty.  ``order`` defaults to the natural node
    order (topological by construction: every edge has ``src < dst``) and
    must itself be topological.
    """
    L = len(g.nodes)
    order = list(range(L)) if order is None else [int(i) for i in order]
    if sorted(order) != list(range(L)):
        raise ValueError("order must be a permutation of the node ids")
    pos = [0] * L
    for t, v in enumerate(order):
        pos[v] = t
    succs: list[list[int]] = [[] for _ in range(L)]
    for e in g.edges:
        if pos[e.src] >= pos[e.dst]:
            raise ValueError(
                f"order is not topological: edge {e.src}->{e.dst}"
            )
        succs[e.src].append(e.dst)
    out: list[list[int]] = []
    for t in range(L):
        frontier = [
            u
            for u in sorted(order[: t + 1])
            if any(pos[w] > t for w in succs[u])
        ]
        out.append(frontier)
    return out


def topo_frontier_width(g: GraphIR, order: Sequence[int] | None = None) -> int:
    """Largest frontier of a topological sweep (0 for a single node)."""
    return max((len(f) for f in topo_frontier_sets(g, order)), default=0)


def min_width_topo_order(g: GraphIR) -> list[int]:
    """Greedy width-minimising topological order.

    At each step, among the ready nodes (all predecessors processed), pick
    the one whose processing leaves the smallest frontier, tie-broken by
    node id — deterministic, and never worse than fanning out breadth-first.
    A heuristic (minimum-width elimination ordering is NP-hard); callers
    compare its width against the natural order and keep the narrower.
    """
    L = len(g.nodes)
    succs: list[list[int]] = [[] for _ in range(L)]
    n_pred = [0] * L
    for e in g.edges:
        succs[e.src].append(e.dst)
        n_pred[e.dst] += 1
    ready = sorted(i for i in range(L) if n_pred[i] == 0)
    pending_out = [len(s) for s in succs]  # edges into the unprocessed suffix
    frontier: set[int] = set()
    order: list[int] = []
    preds: list[list[int]] = [[] for _ in range(L)]
    for e in g.edges:
        preds[e.dst].append(e.src)

    def width_after(v: int) -> int:
        w = len(frontier) + (1 if pending_out[v] else 0)
        for u in preds[v]:
            if pending_out[u] == 1:  # (u, v) was u's last pending edge
                w -= 1
        return w

    while ready:
        v = min(ready, key=lambda u: (width_after(u), u))
        ready.remove(v)
        order.append(v)
        for u in preds[v]:
            pending_out[u] -= 1
            if pending_out[u] == 0:
                frontier.discard(u)
        if pending_out[v]:
            frontier.add(v)
        for w in succs[v]:
            n_pred[w] -= 1
            if n_pred[w] == 0:
                ready.append(w)
    return order


def _repair_partition_cuts(
    n_nodes: int, edges: tuple[EdgeSpec, ...], cuts: np.ndarray
) -> np.ndarray:
    """Round an arbitrary per-edge cut policy to the nearest valid partition.

    Groups become the connected components of the uncut subgraph (fixes cut
    edges that are internal via another path), then any directed cycle among
    groups is contracted (fixes non-convex groups; the condensation of the
    quotient graph is acyclic by construction).
    """
    labels = uncut_component_labels(n_nodes, edges, cuts)
    arcs = {
        (int(labels[e.src]), int(labels[e.dst]))
        for e in edges
        if labels[e.src] != labels[e.dst]
    }
    comp = scc_labels(int(labels.max()) + 1, arcs)
    final = [comp[labels[i]] for i in range(n_nodes)]
    return np.asarray(
        [final[e.src] != final[e.dst] for e in edges], dtype=bool
    )


def as_graph(ir: "NetworkIR | GraphIR") -> GraphIR:
    """Embed a chain as a GraphIR (identity on GraphIR inputs).

    Chain edge ``i`` connects node ``i`` to node ``i+1`` and carries the
    consumer's ``in_words`` so that edge-cut metrics reproduce the chain
    metrics bit-for-bit (cut edge k  <=>  group boundary after layer k).
    """
    if isinstance(ir, GraphIR):
        return ir
    edges = tuple(
        EdgeSpec(i, i + 1, ir.layers[i + 1].in_words)
        for i in range(len(ir.layers) - 1)
    )
    return GraphIR(ir.name, tuple(ir.layers), edges)


def graph_ir(
    name: str,
    nodes: Sequence[LayerSpec],
    edges: Iterable[tuple[int, int] | tuple[int, int, int] | EdgeSpec],
) -> GraphIR:
    """Build a GraphIR; 2-tuple edges default to the producer's out_words."""
    nodes = tuple(nodes)
    specs = []
    for e in edges:
        if isinstance(e, EdgeSpec):
            specs.append(e)
        elif len(e) == 2:
            specs.append(EdgeSpec(e[0], e[1], nodes[e[0]].out_words))
        else:
            specs.append(EdgeSpec(e[0], e[1], e[2]))
    return GraphIR(name, nodes, tuple(specs))


# ---------------------------------------------------------------------------
# DAG builders
# ---------------------------------------------------------------------------

RESNET18_STAGE_PLAN = (
    # (stage, n_blocks, channels, first_block_stride)
    (1, 2, 64, 1),
    (2, 2, 128, 2),
    (3, 2, 256, 2),
    (4, 2, 512, 2),
)

@functools.lru_cache(maxsize=None)
def resnet18_ir(*, input_hw: int = 224) -> GraphIR:
    """ResNet-18 as a residual DAG (He et al., 2016; ImageNet geometry).

    Built node by node from :data:`RESNET18_STAGE_PLAN`: a 7x7/2 stem conv
    and a 3x3/2 max-pool, eight basic blocks, global average pooling and
    the 1000-way classifier.  Each basic block is ``conv3x3 -> conv3x3 ->
    add`` with a skip edge from the block input to the add node; stride-2
    blocks project the skip through a 1x1 conv.  The skip edges are exactly
    what a chain cannot represent: fusing a whole block keeps the skip
    tensor on-chip, which the edge-cut metrics reward with one saved
    store+load pair.
    """
    nodes: list[LayerSpec] = []
    edges: list[EdgeSpec] = []

    def add_node(spec: LayerSpec) -> int:
        nodes.append(spec)
        return len(nodes) - 1

    def connect(src: int, dst: int) -> None:
        edges.append(EdgeSpec(src, dst, nodes[src].out_words))

    conv1 = add_node(LayerSpec("conv1", "conv", 3, 64, input_hw, input_hw, 7, 7, 2))
    pool1 = add_node(
        LayerSpec("pool1", "pool", 64, 64, input_hw // 2, input_hw // 2, 3, 3, 2)
    )
    connect(conv1, pool1)
    cur, c_in, hw = pool1, 64, input_hw // 4
    for stage, n_blocks, c_out, stride0 in RESNET18_STAGE_PLAN:
        for b in range(n_blocks):
            stride = stride0 if b == 0 else 1
            cin_blk = c_in if b == 0 else c_out
            tag = f"s{stage}b{b}"
            ca = add_node(LayerSpec(
                f"{tag}.conv_a", "conv", cin_blk, c_out, hw, hw, 3, 3, stride))
            connect(cur, ca)
            hw_out = hw // stride
            cb = add_node(LayerSpec(
                f"{tag}.conv_b", "conv", c_out, c_out, hw_out, hw_out, 3, 3, 1))
            connect(ca, cb)
            skip = cur
            if stride != 1 or cin_blk != c_out:
                skip = add_node(LayerSpec(
                    f"{tag}.downsample", "conv", cin_blk, c_out, hw, hw, 1, 1, stride))
                connect(cur, skip)
            add = add_node(LayerSpec(
                f"{tag}.add", "elementwise", c_out, c_out, hw_out, hw_out))
            connect(cb, add)
            connect(skip, add)
            cur, hw = add, hw_out
        c_in = c_out
    gap = add_node(LayerSpec("avgpool", "pool", 512, 512, hw, hw, hw, hw, hw))
    connect(cur, gap)
    fc = add_node(LayerSpec("fc", "fc", 512, 1000, 1, 1))
    connect(gap, fc)
    return GraphIR("resnet18", tuple(nodes), tuple(edges))


def residual_block_ir(
    *, channels: int = 128, hw: int = 28, name: str = "resblock"
) -> GraphIR:
    """One ResNet basic block (identity skip) — the minimal DAG exhibiting a
    fusion group the chain IR cannot express (see the module docstring)."""
    nodes = (
        LayerSpec(f"{name}.in", "conv", channels, channels, hw, hw, 1, 1, 1),
        LayerSpec(f"{name}.conv_a", "conv", channels, channels, hw, hw, 3, 3, 1),
        LayerSpec(f"{name}.conv_b", "conv", channels, channels, hw, hw, 3, 3, 1),
        LayerSpec(f"{name}.add", "elementwise", channels, channels, hw, hw),
    )
    edges = (
        EdgeSpec(0, 1, nodes[0].out_words),
        EdgeSpec(1, 2, nodes[1].out_words),
        EdgeSpec(2, 3, nodes[2].out_words),
        EdgeSpec(0, 3, nodes[0].out_words),  # skip
    )
    return GraphIR(name, nodes, edges)


def encoder_decoder_ir(
    *,
    name: str = "encdec",
    d_model: int = 512,
    n_heads: int = 8,
    d_ff: int = 2048,
    seq_enc: int = 512,
    seq_dec: int = 128,
) -> GraphIR:
    """One encoder layer + one decoder layer with cross-attention.

    The encoder output ("memory") fans out to the decoder's cross-attention
    K/V projection — a long-range branch the chain IR cannot express.  If
    the memory edge is left uncut, the encoder output never round-trips
    through DRAM between the encoder and the decoder's cross-attention.
    """
    nodes: list[LayerSpec] = []
    edges: list[EdgeSpec] = []

    def add_node(spec: LayerSpec) -> int:
        nodes.append(spec)
        return len(nodes) - 1

    def connect(src: int, dst: int, words: int | None = None):
        edges.append(EdgeSpec(src, dst, nodes[src].out_words if words is None else words))

    def attn_chain(prefix: str, seq: int, prev: int | None) -> int:
        q = add_node(LayerSpec(f"{prefix}.q", "matmul", d_model, d_model, seq, 1))
        if prev is not None:
            connect(prev, q)
        kv = add_node(LayerSpec(f"{prefix}.kv", "matmul", d_model, 2 * d_model, seq, 1))
        if prev is not None:
            connect(prev, kv)
        qk = add_node(
            LayerSpec(f"{prefix}.qk", "actmul", d_model, n_heads * seq, seq, 1)
        )
        connect(q, qk)
        connect(kv, qk)
        pv = add_node(
            LayerSpec(f"{prefix}.pv", "actmul", n_heads * seq, d_model, seq, 1)
        )
        connect(qk, pv)
        connect(kv, pv)
        o = add_node(LayerSpec(f"{prefix}.o", "matmul", d_model, d_model, seq, 1))
        connect(pv, o)
        return o

    def ffn(prefix: str, seq: int, prev: int) -> int:
        w1 = add_node(LayerSpec(f"{prefix}.w1", "matmul", d_model, d_ff, seq, 1))
        connect(prev, w1)
        w2 = add_node(LayerSpec(f"{prefix}.w2", "matmul", d_ff, d_model, seq, 1))
        connect(w1, w2)
        return w2

    # Encoder layer: self-attention + FFN; w2 output is the memory.
    enc_o = attn_chain(f"{name}.enc.self", seq_enc, None)
    memory = ffn(f"{name}.enc", seq_enc, enc_o)

    # Decoder layer: self-attention over seq_dec ...
    dec_o = attn_chain(f"{name}.dec.self", seq_dec, None)
    # ... then cross-attention: Q from the decoder, K/V from the encoder memory.
    xq = add_node(LayerSpec(f"{name}.dec.xq", "matmul", d_model, d_model, seq_dec, 1))
    connect(dec_o, xq)
    xkv = add_node(LayerSpec(f"{name}.dec.xkv", "matmul", d_model, 2 * d_model, seq_enc, 1))
    connect(memory, xkv)  # the cross-link branch
    xqk = add_node(
        LayerSpec(f"{name}.dec.xqk", "actmul", d_model, n_heads * seq_enc, seq_dec, 1)
    )
    connect(xq, xqk)
    connect(xkv, xqk)
    xpv = add_node(
        LayerSpec(f"{name}.dec.xpv", "actmul", n_heads * seq_enc, d_model, seq_dec, 1)
    )
    connect(xqk, xpv)
    connect(xkv, xpv)
    xo = add_node(LayerSpec(f"{name}.dec.xo", "matmul", d_model, d_model, seq_dec, 1))
    connect(xpv, xo)
    ffn(f"{name}.dec", seq_dec, xo)
    return GraphIR(name, tuple(nodes), tuple(edges))
