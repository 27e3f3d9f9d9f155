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
uncut edge stays inside a group (its tensor lives in on-chip SRAM).  A valid
group must be weakly connected and convex (no dataflow may leave the group
and re-enter), which on the quotient graph means acyclicity — see
:mod:`repro_torch.core.fusion`.

:func:`vgg16_ir` builds the paper's own Sec. III workload directly from
:data:`VGG16_CONV_PLAN`.  Everything here is plain Python + numpy feature
extraction; the batched metric sweep lives in :mod:`repro_torch.core.metrics`.
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
