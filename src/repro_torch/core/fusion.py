"""Layer-fusion grouping search over chains and DAGs.

The grouping space over an L-layer *chain* is the 2^(L-1) set of cut
vectors; over a general DAG it is the set of *valid* edge-cut vectors: the
uncut edges must induce groups that are weakly connected (automatic — a
group is a connected component of the uncut subgraph), **consistent**
(every cut edge actually crosses two different groups) and **convex** (no
dataflow may leave a group and re-enter it; equivalently the quotient graph
obtained by contracting every group is acyclic).

Every step of the search runs as a *batched array program* over (C, E) cut
batches — there is no per-candidate Python on any search path:

* component labelling  — min-label propagation + pointer jumping over the
  whole batch (:func:`repro_torch.core.ir.uncut_component_labels_batch`);
* validity             — batched consistency + vectorised Kahn peeling of
  the quotient graphs (:func:`is_valid_cuts_batch`);
* buffer feasibility   — incidence-matrix segment sums/maxes over
  ``F_OUT_PRE`` and internal incoming edge words
  (:func:`graph_max_intermediate_batch`);
* cost                 — batched Eq. (1) bandwidth
  (:func:`repro_torch.core.metrics.bandwidth_batch_graph`), plus an
  O(degree) incremental bandwidth delta for greedy merging.

The scalar functions (``is_valid_cuts``, ``graph_max_intermediate``,
``bandwidth_ref``, the ``_*_scalar`` search variants) are kept as the
oracles; tests assert the batched versions match them bit-for-bit.

This is numpy search code on the host, as in the reference package; the
hardware x grouping sweep that scores its output runs on the device
(:mod:`repro_torch.core.metrics`).

Strategies, all returning cut vectors compatible with
:mod:`repro_torch.core.metrics`:

* ``enumerate_cuts`` / ``enumerate_valid_edge_cuts`` — full enumeration as
  a chunked masked pipeline (the paper's predefined-set sweep; chains up to
  2^20 vectors, DAGs up to ``MAX_EXHAUSTIVE_EDGES`` = 22 edges).
* ``pool boundary cuts``  — the paper's Sec. III policy (via
  ``GraphIR.pool_boundary_cuts``).
* ``optimal_cuts_dp``     — O(L^2) chain-partition DP.  Valid because Eq. (1)
  decomposes over groups (weights are grouping-independent; each group
  contributes in_first + out_last), and latency & energy are affine in the
  same per-group quantity, so one DP minimises all three simultaneously;
  buffer feasibility is a per-group predicate.
* ``frontier_dp_min_bw``   — exact frontier-state DP for general DAGs: a
  topological sweep whose states are keyed by the open-group membership,
  paid-write flags, and quotient-reachability closure of the *frontier*
  (processed nodes with pending out-edges), with dominance pruning and a
  branch-and-bound lower bound.  Scales with the DAG's frontier width
  instead of 2^E — bit-identical minima to brute force, at ResNet-18 scale
  (2^38 patterns) in milliseconds.  See the section comment above it.
* ``greedy_merge_cuts`` / ``beam_merge_cuts`` — bottom-up group merging for
  general DAGs (bandwidth is monotone non-increasing under a valid merge,
  so merging is the natural move; the SRAM budget and convexity are what
  make the problem non-trivial).  Each round expands the whole frontier
  into one (M, E) cut batch, dedups it against every previously seen
  canonical label state, and scores it with one batched validity /
  feasibility / bandwidth pass.
* ``optimal_cuts`` — dispatch: chain DP fast path, frontier DP (exact, up
  to a frontier-width cap), exhaustive enumeration for small-but-wide
  DAGs, beam search only for large-and-wide ones; results carry ``engine``
  provenance so callers can tell certified optima from heuristics.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Iterator

import numpy as np

from . import metrics as M
from .errors import InfeasibleBudgetError, SearchDeclined
from .ir import (
    GraphIR,
    NetworkIR,
    _min_label_reps_batch,
    as_graph,
    canonicalize_labels_batch,
    min_width_topo_order,
    quotient_acyclic_batch,
    scc_labels,
    topo_frontier_sets,
    topo_frontier_width,
    uncut_component_labels,
)

MAX_EXHAUSTIVE_LAYERS = 21  # 2^20 cut vectors ~ 1M candidates (vectorised)
# DAG enumeration is a chunked masked array pipeline (batch labelling + Kahn
# peeling), so its cap is within striking distance of the chain cap.
MAX_EXHAUSTIVE_EDGES = 22
# Rows per chunk of the enumeration pipeline — bounds peak memory at
# ~chunk x L for the label/peeling intermediates.
ENUM_CHUNK_ROWS = 1 << 17
# Below this many bit patterns the per-pattern scalar filter beats the
# batched pipeline's cold setup, so tiny graphs take the scalar path.
SMALL_ENUM_PATTERNS = 64
# Frontier-DP caps: beyond this frontier width (or live-state count) the
# exact DP abandons the attempt and `optimal_cuts` falls back to beam
# search.  Real network DAGs are narrow (ResNet-18: 2, encoder-decoder: 3);
# the caps only trip on adversarially dense random graphs.
FRONTIER_DP_MAX_WIDTH = 12
FRONTIER_DP_MAX_STATES = 1 << 17


class FrontierTooWide(SearchDeclined):
    """Raised by :func:`frontier_dp_min_bw` when the frontier width or the
    live state count exceeds its caps; :func:`optimal_cuts` absorbs it and
    falls back to exhaustive enumeration (small graphs) or beam search.
    A :class:`repro_torch.core.errors.SearchDeclined`, so callers that pin
    the exact engine get the typed decline instead of a bare
    ``ValueError``."""


def enumerate_cuts(n_layers: int) -> np.ndarray:
    """All 2^(L-1) chain cut vectors, shape (C, L-1), dtype bool."""
    ncuts = n_layers - 1
    if n_layers > MAX_EXHAUSTIVE_LAYERS:
        raise ValueError(
            f"{n_layers} layers -> 2^{ncuts} groupings; use optimal_cuts_dp"
        )
    if ncuts == 0:
        return np.zeros((1, 0), dtype=bool)
    idx = np.arange(2**ncuts, dtype=np.int64)
    bits = (idx[:, None] >> np.arange(ncuts)[None, :]) & 1
    return bits.astype(bool)


def cuts_from_groups(groups: list[list[int]], n_layers: int) -> np.ndarray:
    """Chain cut vector (L-1,) of explicit consecutive layer groups."""
    cuts = np.zeros(n_layers - 1, dtype=bool)
    pos = 0
    for g in groups[:-1]:
        pos += len(g)
        cuts[pos - 1] = True
    return cuts


def layer_by_layer_cuts(n_cuts_or_graph) -> np.ndarray:
    """All-cut vector: every layer its own group.  Accepts a GraphIR (one
    entry per edge) or the chain layer count (L-1 entries)."""
    if isinstance(n_cuts_or_graph, GraphIR):
        return np.ones(n_cuts_or_graph.n_edges, dtype=bool)
    return np.ones(n_cuts_or_graph - 1, dtype=bool)


# ---------------------------------------------------------------------------
# Cut validity — scalar oracles
# ---------------------------------------------------------------------------


def cut_group_labels(g: GraphIR, cuts: np.ndarray) -> np.ndarray:
    """(L,) group labels: connected components of the uncut subgraph,
    relabelled to consecutive ints in order of first node appearance."""
    return uncut_component_labels(len(g.nodes), g.edges, cuts)


def groups_from_labels(labels: np.ndarray) -> list[list[int]]:
    """Component labels (node -> group id) to explicit member lists."""
    groups: list[list[int]] = [[] for _ in range(int(labels.max()) + 1)]
    for i, lab in enumerate(labels):
        groups[int(lab)].append(i)
    return groups


def _quotient_is_dag(g: GraphIR, labels: np.ndarray) -> bool:
    """Convexity <=> the group-contracted graph is acyclic (every strongly
    connected component of the quotient is a singleton)."""
    n = int(labels.max()) + 1
    arcs = {
        (int(labels[e.src]), int(labels[e.dst]))
        for e in g.edges
        if labels[e.src] != labels[e.dst]
    }
    return len(set(scc_labels(n, arcs))) == n


def is_valid_cuts(g: GraphIR, cuts: np.ndarray) -> bool:
    """A cut vector is valid iff every cut edge crosses two different groups
    (consistency) and every group is convex (quotient graph acyclic).
    On a chain every cut vector is valid.  Scalar oracle for
    :func:`is_valid_cuts_batch`."""
    cuts = np.asarray(cuts, dtype=bool)
    labels = cut_group_labels(g, cuts)
    for k, e in enumerate(g.edges):
        if cuts[k] and labels[e.src] == labels[e.dst]:
            return False  # cut edge internal to a group via another path
    return _quotient_is_dag(g, labels)


def cuts_from_labels(g: GraphIR, labels: np.ndarray) -> np.ndarray:
    """(E,) cut vector: an edge is cut iff its endpoints have different labels."""
    labels = np.asarray(labels)
    return np.asarray(
        [labels[e.src] != labels[e.dst] for e in g.edges], dtype=bool
    )


# ---------------------------------------------------------------------------
# Cut validity — batched kernels
# ---------------------------------------------------------------------------


def is_valid_cuts_batch(
    g: GraphIR, cuts_batch: np.ndarray, *, labels: np.ndarray | None = None
) -> np.ndarray:
    """(C,) bool — batched :func:`is_valid_cuts` with no per-candidate Python.

    Consistency is one masked comparison over the (C, E) batch; convexity is
    vectorised Kahn peeling of the quotient graphs (only the consistent rows
    are peeled).  ``labels`` may pass in precomputed component
    representatives to avoid relabelling.
    """
    ga = M.graph_arrays(g)
    cuts_batch = np.atleast_2d(np.asarray(cuts_batch, dtype=bool))
    C = cuts_batch.shape[0]
    if g.is_chain or g.n_edges == 0:
        return np.ones(C, dtype=bool)
    if labels is None:
        labels = _min_label_reps_batch(len(g.nodes), ga.esrc, ga.edst, cuts_batch)
    lab_s = labels[:, ga.esrc]
    lab_d = labels[:, ga.edst]
    ok = ~np.any(cuts_batch & (lab_s == lab_d), axis=1)  # consistency
    idx = np.flatnonzero(ok)
    if idx.size:
        ok[idx] = quotient_acyclic_batch(
            len(g.nodes), ga.esrc, ga.edst, labels[idx]
        )
    return ok


def _bit_chunks(n_bits: int, chunk_rows: int) -> Iterator[np.ndarray]:
    """Yield the 2^n bit patterns (little-endian, ascending) in row chunks."""
    total = 1 << n_bits
    shifts = np.arange(n_bits)[None, :]
    for lo in range(0, total, chunk_rows):
        idx = np.arange(lo, min(lo + chunk_rows, total), dtype=np.int64)
        yield ((idx[:, None] >> shifts) & 1).astype(bool)


@functools.lru_cache(maxsize=8)
def enumerate_valid_edge_cuts(
    g: GraphIR, *, chunk_rows: int = ENUM_CHUNK_ROWS
) -> np.ndarray:
    """All valid edge-cut vectors, shape (C, E), dtype bool (read-only).

    Chains short-circuit to :func:`enumerate_cuts` (every vector is valid);
    tiny DAGs (at most ``SMALL_ENUM_PATTERNS`` bit patterns) run the
    per-pattern scalar filter; larger DAGs push the 2^E bit patterns through
    the batched validity pipeline in chunks of ``chunk_rows``, in ascending
    pattern order either way.  The result is memoised per graph and returned
    read-only so a caller cannot poison the cache.
    """
    if g.is_chain:
        out = enumerate_cuts(len(g.nodes))
    else:
        E = g.n_edges
        if E > MAX_EXHAUSTIVE_EDGES:
            raise ValueError(f"{E} edges -> 2^{E} cut patterns")
        if E == 0:
            out = np.zeros((1, 0), dtype=bool)
        elif (1 << E) <= SMALL_ENUM_PATTERNS:
            out = _enumerate_valid_edge_cuts_scalar(g)
        else:
            out = np.concatenate(
                [
                    bits[is_valid_cuts_batch(g, bits)]
                    for bits in _bit_chunks(E, chunk_rows)
                ],
                axis=0,
            )
    out.setflags(write=False)
    return out


def _enumerate_valid_edge_cuts_scalar(g: GraphIR) -> np.ndarray:
    """The per-pattern filter — the enumeration oracle for tiny DAGs."""
    if g.is_chain:
        return enumerate_cuts(len(g.nodes))
    E = g.n_edges
    if E > MAX_EXHAUSTIVE_EDGES:
        raise ValueError(f"{E} edges -> 2^{E} cut patterns")
    if E == 0:
        return np.zeros((1, 0), dtype=bool)
    idx = np.arange(2**E, dtype=np.int64)
    bits = ((idx[:, None] >> np.arange(E)[None, :]) & 1).astype(bool)
    keep = [c for c in bits if is_valid_cuts(g, c)]
    return np.stack(keep)


# ---------------------------------------------------------------------------
# Buffer feasibility
# ---------------------------------------------------------------------------


def group_max_intermediate(feat: np.ndarray, cuts: np.ndarray) -> float:
    """Largest on-chip intermediate implied by a *chain* grouping (words):
    an internal producer holds its **pre-pool** frame (the inline pool only
    reduces the DRAM write-out path) and its fused consumer holds the full
    input operand.  A node's recurrent ``state_words`` carry occupies SRAM
    in every grouping, on top of any fused input it holds."""
    cuts = np.asarray(cuts, dtype=bool)
    in_term = np.where(cuts, 0.0, feat[1:, M.F_IN]) + feat[1:, M.F_STATE]
    out_term = np.where(cuts, 0.0, feat[:-1, M.F_OUT_PRE])
    held = np.maximum(in_term, out_term)
    return float(max(held.max(initial=0.0), float(feat[0, M.F_STATE])))


def graph_max_intermediate(g: GraphIR, cuts: np.ndarray) -> float:
    """Largest on-chip tensor implied by an edge-cut grouping: the max over
    (a) pre-pool frames of nodes with >= 1 fused consumer and (b) summed
    internal incoming tensors of any node plus its recurrent carry.  Scalar
    oracle for :func:`graph_max_intermediate_batch`."""
    cuts = np.asarray(cuts, dtype=bool)
    feat = g.node_features()
    internal_in = np.zeros(len(g.nodes))
    internal_out = np.zeros(len(g.nodes), dtype=bool)
    for k, e in enumerate(g.edges):
        if not cuts[k]:
            internal_in[e.dst] += e.words
            internal_out[e.src] = True
    need = np.where(internal_out, feat[:, M.F_OUT_PRE], 0.0)
    # A recurrent carry is held for the node's whole execution, whether or
    # not its inputs are fused.
    in_term = internal_in + feat[:, M.F_STATE]
    return float(max(need.max(initial=0.0), in_term.max(initial=0.0)))


def graph_max_intermediate_batch(g: GraphIR, cuts_batch: np.ndarray) -> np.ndarray:
    """(C,) batched :func:`graph_max_intermediate` — segment sums/maxes via
    the cached edge incidence matrices (exact: integer-valued words)."""
    ga = M.graph_arrays(g)
    cuts = np.atleast_2d(np.asarray(cuts_batch, dtype=bool))
    unc = (~cuts).astype(np.float64)
    internal_in = unc @ ga.win_dst  # (C, L) summed internal incoming words
    internal_in += ga.feat[None, :, M.F_STATE]  # carry held in every grouping
    has_internal_out = (unc @ ga.inc_src) > 0.0
    need = np.where(has_internal_out, ga.feat[None, :, M.F_OUT_PRE], 0.0)
    return np.maximum(
        need.max(axis=1, initial=0.0), internal_in.max(axis=1, initial=0.0)
    )


def graph_feasible_mask_batch(
    g: GraphIR, cuts_batch: np.ndarray, sram_budget_words: float
) -> np.ndarray:
    """(C,) bool — buffer feasibility of a cut batch under an SRAM budget,
    the prefilter of :func:`repro_torch.core.flow.run_flow`."""
    return graph_max_intermediate_batch(g, cuts_batch) <= sram_budget_words


def padded_max_intermediate_batch(pg, cuts_batch: np.ndarray) -> np.ndarray:
    """(C,) masked :func:`graph_max_intermediate_batch` over a
    :class:`repro_torch.core.ir.PaddedGraph` — padded edges are neither internal
    nor cut, so the result is bit-identical to the unpadded kernel on the
    real rows (locked in tests).  The fleet prefilter scores cut batches
    already padded to the fleet's edge bucket without unpadding them."""
    cuts = np.atleast_2d(np.asarray(cuts_batch, dtype=bool))
    E_b, L_b = pg.esrc.shape[0], pg.feat.shape[0]
    unc = ((~cuts) & pg.edge_mask[None, :]).astype(np.float64)
    inc_src = np.zeros((E_b, L_b))
    inc_src[np.arange(E_b)[pg.edge_mask], pg.esrc[pg.edge_mask]] = 1.0
    win_dst = np.zeros((E_b, L_b))
    win_dst[np.arange(E_b), pg.edst] = pg.ewords  # padded rows: 0 words at 0
    internal_in = unc @ win_dst  # (C, L_b) summed internal incoming words
    internal_in += pg.feat[None, :, M.F_STATE]  # padded rows: state 0, inert
    has_internal_out = (unc @ inc_src) > 0.0
    need = np.where(has_internal_out, pg.feat[None, :, M.F_OUT_PRE], 0.0)
    return np.maximum(
        need.max(axis=1, initial=0.0), internal_in.max(axis=1, initial=0.0)
    )


def padded_feasible_mask_batch(
    pg, cuts_batch: np.ndarray, sram_budget_words: float
) -> np.ndarray:
    """(C,) bool — padded-graph analog of :func:`graph_feasible_mask_batch`,
    the SRAM prefilter of a multi-graph (padded) sweep."""
    return padded_max_intermediate_batch(pg, cuts_batch) <= sram_budget_words


def buffer_feasible(feat: np.ndarray, cuts: np.ndarray, sram_budget_words: float) -> bool:
    """Chain grouping fits the budget (scalar oracle)."""
    return group_max_intermediate(feat, cuts) <= sram_budget_words


def feasible_mask_batch(
    feat: np.ndarray, cuts_batch: np.ndarray, sram_budget_words: float
) -> np.ndarray:
    """(C,) bool — vectorised chain buffer feasibility for a batch of groupings."""
    cuts_batch = np.atleast_2d(np.asarray(cuts_batch, dtype=bool))
    in_term = (
        np.where(cuts_batch, 0.0, feat[None, 1:, M.F_IN])
        + feat[None, 1:, M.F_STATE]
    )
    out_term = np.where(cuts_batch, 0.0, feat[None, :-1, M.F_OUT_PRE])
    inter = np.maximum(in_term, out_term).max(axis=1, initial=0.0)
    inter = np.maximum(inter, float(feat[0, M.F_STATE]))
    return inter <= sram_budget_words


# ---------------------------------------------------------------------------
# Search
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DPResult:
    """A grouping-search answer: cut vector, Eq. (1) group cost, and
    engine provenance (see ``exact``)."""

    cuts: np.ndarray
    group_cost_words: float  # Eq. (1) minus the grouping-independent weights
    n_groups: int
    # Which engine produced the answer and whether the result carries an
    # optimality guarantee.
    engine: str = ""

    @property
    def exact(self) -> bool:
        """True when the engine certifies a global optimum."""
        return self.engine in ("chain_dp", "frontier_dp", "exhaustive")


def optimal_cuts_dp(
    ir: NetworkIR | GraphIR,
    *,
    sram_budget_words: float = float("inf"),
    max_group_len: int | None = None,
) -> DPResult:
    """Min-bandwidth grouping via chain-partition DP (also min latency/energy).

    dp[j] = min cost of partitioning layers [0..j]; a group [i..j] is feasible
    iff every internal intermediate pre-pool frame fits the SRAM budget and
    the group length is within ``max_group_len``.  Requires a chain.
    """
    g = as_graph(ir)
    if not g.is_chain:
        raise ValueError("optimal_cuts_dp requires a chain; use optimal_cuts")
    feat = g.node_features()
    L = feat.shape[0]
    # A group starting at layer i>0 reads its cut incoming edge's words (==
    # in_words for NetworkIR embeddings, but not for hand-built chain graphs).
    _, _, ewords = g.edge_arrays()
    ins = np.concatenate([feat[:1, M.F_IN], ewords])
    outs = feat[:, M.F_OUT]
    pre = feat[:, M.F_OUT_PRE]
    state = feat[:, M.F_STATE]
    # A recurrent carry occupies SRAM in *every* grouping — if any node's
    # state alone exceeds the budget, no partition is feasible.
    if state.max(initial=0.0) > sram_budget_words:
        raise InfeasibleBudgetError(
            "no feasible grouping under the SRAM budget: a recurrent "
            "state carry alone exceeds it",
            min_feasible_budget_words=float(state.max()),
        )
    INF = float("inf")
    dp = np.full(L + 1, INF)
    back = np.full(L + 1, -1, dtype=np.int64)
    dp[0] = 0.0
    for j in range(1, L + 1):  # dp index: first j layers
        max_inter = 0.0
        lo = 0 if max_group_len is None else max(0, j - max_group_len)
        # iterate group starts i (0-based layer index) from j-1 down to lo
        for i in range(j - 1, lo - 1, -1):
            # group = layers [i .. j-1]; fusing edge i holds both the
            # producer's pre-pool frame and the edge's words (plus the
            # consumer's recurrent carry) on chip.
            if i < j - 1:
                max_inter = max(max_inter, pre[i], ewords[i] + state[i + 1])
            if max_inter > sram_budget_words:
                break  # growing the group further only increases max_inter
            cost = dp[i] + ins[i] + outs[j - 1]
            if cost < dp[j]:
                dp[j] = cost
                back[j] = i
    if not np.isfinite(dp[L]):
        raise InfeasibleBudgetError(
            "no feasible grouping under the SRAM budget"
        )
    # Reconstruct groups.
    bounds = []
    j = L
    while j > 0:
        bounds.append((back[j], j))
        j = back[j]
    bounds.reverse()
    groups = [list(range(i, j)) for i, j in bounds]
    cuts = cuts_from_groups(groups, L)
    return DPResult(cuts=cuts, group_cost_words=float(dp[L]),
                    n_groups=len(groups), engine="chain_dp")


def _graph_cost(g: GraphIR, cuts: np.ndarray) -> float:
    """Grouping-dependent part of Eq. (1) (bandwidth minus weight streaming)."""
    return M.bandwidth_ref(g, cuts) - float(g.total_weight_words)


def _graph_cost_batch(g: GraphIR, cuts_batch: np.ndarray) -> np.ndarray:
    """(C,) batched :func:`_graph_cost` (exact: integer-valued words)."""
    return M.bandwidth_batch_graph(g, cuts_batch) - float(g.total_weight_words)


def _max_group_size_batch(labels: np.ndarray) -> np.ndarray:
    """(C,) largest group cardinality per row of a (C, L) label batch."""
    C, L = labels.shape
    rows = np.arange(C)
    cnt = np.zeros((C, L), dtype=np.int16)
    for i in range(L):
        cnt[rows, labels[:, i]] += 1
    return cnt.max(axis=1)


@functools.lru_cache(maxsize=8)
def _exhaustive_tables(g: GraphIR) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-graph (valid cuts, max intermediate, group cost) — every column
    the exhaustive search filters or ranks on, none of which depends on the
    SRAM budget, so repeated searches over the same graph reduce to a mask
    + argmin over these tables."""
    cuts_all = enumerate_valid_edge_cuts(g)
    return (
        cuts_all,
        graph_max_intermediate_batch(g, cuts_all),
        _graph_cost_batch(g, cuts_all),
    )


def brute_force_min_bw(
    ir: NetworkIR | GraphIR,
    *,
    sram_budget_words: float = float("inf"),
    max_group_len: int | None = None,
) -> DPResult:
    """Exhaustive min-bandwidth grouping over valid edge cuts.

    One masked array pipeline over the cached per-graph tables: (batched
    enumeration -> batched feasibility -> batched Eq. (1) cost) once per
    graph, then a feasibility mask + first-min argmin per call, in
    ascending pattern order — bit-identical to the scalar per-candidate
    loop (``_brute_force_min_bw_scalar``, kept as the test oracle).
    """
    g = as_graph(ir)
    cuts_all, max_int, costs_all = _exhaustive_tables(g)
    feas = max_int <= sram_budget_words
    if max_group_len is not None and feas.any():
        ga = M.graph_arrays(g)
        rows = np.flatnonzero(feas)
        labels = _min_label_reps_batch(
            len(g.nodes), ga.esrc, ga.edst, cuts_all[rows]
        )
        feas = feas.copy()
        feas[rows] = _max_group_size_batch(labels) <= max_group_len
    costs = np.where(feas, costs_all, np.inf)
    j = int(np.argmin(costs))  # first min == the scalar loop's strict-< scan
    if not np.isfinite(costs[j]):
        raise InfeasibleBudgetError(
            "no feasible grouping under the SRAM budget",
            min_feasible_budget_words=float(max_int.min()),
        )
    best_cuts = cuts_all[j].copy()
    n_groups = int(cut_group_labels(g, best_cuts).max()) + 1
    return DPResult(
        cuts=best_cuts, group_cost_words=float(costs[j]), n_groups=n_groups,
        engine="exhaustive",
    )


def _brute_force_min_bw_scalar(
    ir: NetworkIR | GraphIR,
    *,
    sram_budget_words: float = float("inf"),
    max_group_len: int | None = None,
) -> DPResult:
    """The per-candidate brute force — the test oracle of :func:`brute_force_min_bw`."""
    g = as_graph(ir)
    best_cost, best_cuts, best_groups = float("inf"), None, 0
    for cuts in _enumerate_valid_edge_cuts_scalar(g):
        if graph_max_intermediate(g, cuts) > sram_budget_words:
            continue
        labels = cut_group_labels(g, cuts)
        if max_group_len is not None and any(
            len(grp) > max_group_len for grp in groups_from_labels(labels)
        ):
            continue
        cost = _graph_cost(g, cuts)
        if cost < best_cost:
            best_cost, best_cuts = cost, cuts
            best_groups = int(labels.max()) + 1
    if best_cuts is None:
        raise InfeasibleBudgetError(
            "no feasible grouping under the SRAM budget"
        )
    return DPResult(cuts=best_cuts, group_cost_words=best_cost,
                    n_groups=best_groups, engine="exhaustive_scalar")


# ---------------------------------------------------------------------------
# Frontier-state DP — exact search beyond the 2^E enumeration wall
# ---------------------------------------------------------------------------
#
# Flat enumeration scores all 2^E cut patterns, so it dies at
# MAX_EXHAUSTIVE_EDGES = 22 (ResNet-18 has 38).  But the *future* of a
# partial grouping only depends on the partition of the **frontier** — the
# already-processed nodes that still have an edge into the unprocessed
# suffix — not on how the closed part of the graph was grouped.  Sweeping
# nodes in topological order and folding every partial grouping into its
# frontier signature turns the 2^E search into a DP whose state count is
# governed by the frontier *width* (3 on ResNet-18, 4 on the
# encoder-decoder), the same structural move LoopTree makes for the
# fused-loop design space.
#
# A state signature is exactly the information the future can observe:
#
# * the open-group membership of each frontier node (canonical labels);
# * one "paid" bit per frontier node — whether its output frame write has
#   already been charged (a node's out_words is charged once, at its first
#   cut out-edge), so future cut edges know their marginal cost;
# * the transitive reachability closure among open groups (as per-group
#   bitmasks), which is what incremental convexity checking needs: a new
#   arc A -> g closes a quotient cycle iff g already reaches A, and merging
#   two open groups is legal iff neither reaches the other (a path of
#   length >= 1 would either internalise a cut edge or close a cycle).
#   Paths through *closed* groups are composed into the closure before the
#   closed group's row/column is dropped — a closed group's arc set is
#   final (all of its nodes' edges are decided), so the projection is
#   lossless.
#
# Buffer feasibility needs no state at all: graph_max_intermediate is a max
# of per-node terms, each of which is decided exactly once (a node's
# internal-input sum when its in-edges are decided; a producer's pre-pool
# frame at its first uncut out-edge), so every term is checked against the
# budget the moment it is determined.
#
# Two states with identical signatures therefore have *identical* feasible
# completions with identical future cost deltas — keeping only the cheapest
# accumulated cost per signature (dominance) is lossless, and the DP's
# minimum is bit-identical to brute force (all words are integer-valued
# float64).  On top of dominance, a branch-and-bound prune drops states
# whose accumulated cost plus an admissible remaining lower bound (the
# unconditional sink writes of the unprocessed suffix, plus the cheapest
# cut-word set any over-budget node is forced to pay; every other edge's
# best case is uncut = free) already exceeds a greedy incumbent.
#
# Transition scoring is batched through the prefix-decomposable tables of
# :func:`repro_torch.core.metrics.graph_prefix_tables`: each step scores the
# whole (states x 2^in_degree) grid of cut/no-cut extensions with numpy
# (cut words, first-cut write charges, feasibility, bound) and only the
# surviving transitions pay the per-candidate structural update.


@dataclasses.dataclass
class _DPState:
    """One live frontier state (signature fields + accumulators)."""

    labels: tuple[int, ...]  # group id per frontier node (canonical)
    paid: int  # bitmask over frontier positions: out_words charged
    reach: tuple[int, ...]  # per group: bitmask of groups it reaches
    acc: float  # accumulated grouping-dependent words
    cuts: np.ndarray  # (E,) decisions so far (undecided = False)


def _forced_cut_words_min(words: np.ndarray, budget: float) -> float:
    """Cheapest cut-word total that brings a node's uncut incoming sum
    within the SRAM budget — the admissible per-node bound the DP's
    branch-and-bound charges for over-budget joins (in-degrees are tiny, so
    enumerating the 2^d subsets is cheaper than a knapsack)."""
    d = len(words)
    total = float(words.sum())
    if total <= budget:
        return 0.0
    if d == 0:
        return float("inf")  # a state-only over-budget node: infeasible
    bits = ((np.arange(1 << d)[:, None] >> np.arange(d)) & 1).astype(bool)
    cutw = bits @ words
    ok = (total - cutw) <= budget
    if not ok.any():  # even all-cut leaves the node over budget
        return float("inf")
    return float(cutw[ok].min())


def frontier_dp_min_bw(
    ir: NetworkIR | GraphIR,
    *,
    sram_budget_words: float = float("inf"),
    max_width: int | None = FRONTIER_DP_MAX_WIDTH,
    max_states: int = FRONTIER_DP_MAX_STATES,
    order: "list[int] | None" = None,
) -> DPResult:
    """Exact min-bandwidth grouping via frontier-state DP (see the section
    comment above for the state design and correctness argument).

    Returns the same minimum ``group_cost_words`` as
    :func:`brute_force_min_bw` (bit-identical: integer-valued words) on any
    graph both can handle, but scales with the DAG's frontier width instead
    of 2^E — ResNet-18's 38-edge space (2^38 patterns) solves exactly in
    milliseconds.  Ties may resolve to a different (equally optimal) cut
    vector than brute force's first-pattern rule.  Raises
    :class:`FrontierTooWide` beyond ``max_width``/``max_states`` so
    :func:`optimal_cuts` can fall back to beam search.
    """
    g = as_graph(ir)
    ga = M.graph_arrays(g)
    pt = M.graph_prefix_tables(g)
    L, E = len(g.nodes), g.n_edges
    budget = float(sram_budget_words)
    finite = np.isfinite(budget)

    if order is None:
        order = list(range(L))
        alt = min_width_topo_order(g)
        if topo_frontier_width(g, alt) < topo_frontier_width(g, order):
            order = alt
    frontiers = topo_frontier_sets(g, order)
    width = max((len(f) for f in frontiers), default=0)
    if max_width is not None and width > max_width:
        raise FrontierTooWide(
            f"frontier width {width} exceeds the DP cap {max_width}"
        )

    # Admissible remaining-cost lower bounds, as suffixes of the sweep:
    # unconditional sink writes + budget-forced cut-word minima.
    node_lb = pt.sink_charge.copy()
    if finite:
        for v in range(L):
            # the node's recurrent carry shrinks the budget its uncut
            # incoming sum must fit within
            node_lb[v] += _forced_cut_words_min(
                pt.in_words[v], budget - float(pt.state_words[v])
            )
    suffix_lb = np.zeros(L + 1)
    suffix_lb[:L] = np.cumsum(node_lb[order][::-1])[::-1]

    # Greedy incumbent for the branch-and-bound prune (always feasible:
    # greedy starts from the always-valid, zero-footprint all-cut state).
    incumbent = greedy_merge_cuts(g, sram_budget_words=budget).group_cost_words
    const0 = pt.const_words

    states: "dict[tuple, _DPState]" = {
        ((), 0, ()): _DPState((), 0, (), 0.0, np.zeros(E, dtype=bool))
    }
    for t, v in enumerate(order):
        frontier = frontiers[t - 1] if t else []
        pos_of = {u: i for i, u in enumerate(frontier)}
        ks = pt.in_edges[v]
        srcs = pt.in_srcs[v]
        w = pt.in_words[v]
        d = len(ks)
        src_pos = np.asarray([pos_of[int(u)] for u in srcs], dtype=np.int64)

        bits = ((np.arange(1 << d)[:, None] >> np.arange(d)) & 1).astype(bool)
        cutw = bits @ w if d else np.zeros(1)
        feas_p = np.ones(1 << d, dtype=bool)
        if finite:
            # v's uncut incoming sum plus its recurrent carry must fit
            # (applies even at d == 0: a state-only node can be infeasible)
            feas_p &= (
                float(w.sum()) - cutw + float(pt.state_words[v])
            ) <= budget
        if finite and d:
            # an uncut out-edge pins the producer's pre-pool frame on chip
            ok_uncut = pt.prepool_words[srcs] <= budget
            feas_p &= (bits | ok_uncut[None, :]).all(axis=1)

        state_list = list(states.values())
        accs = np.asarray([s.acc for s in state_list])
        if d:
            paid_mat = (
                np.asarray([s.paid for s in state_list])[:, None]
                >> src_pos[None, :]
            ) & 1
            first_cut = bits[None, :, :] & ~paid_mat[:, None, :].astype(bool)
            extra = first_cut @ pt.out_words[srcs]  # (S, P) write charges
        else:
            extra = np.zeros((len(state_list), 1))
        delta = cutw[None, :] + extra + float(pt.sink_charge[v])
        keep = feas_p[None, :] & (
            accs[:, None] + delta + const0 + suffix_lb[t + 1] <= incumbent
        )

        new_frontier = frontiers[t]
        new_states: "dict[tuple, _DPState]" = {}
        for si in range(len(state_list)):
            if not keep[si].any():
                continue
            st = state_list[si]
            lab, reach = st.labels, st.reach
            G = len(reach)
            for p in np.flatnonzero(keep[si]):
                cut_i = [i for i in range(d) if bits[p, i]]
                uncut_i = [i for i in range(d) if not bits[p, i]]
                Sg = {lab[src_pos[i]] for i in uncut_i}
                Sg_mask = 0
                for a in Sg:
                    Sg_mask |= 1 << a
                # merging two open groups with any path between them would
                # internalise a cut edge or close a quotient cycle
                if any(reach[a] & (Sg_mask & ~(1 << a)) for a in Sg):
                    continue
                out_new = 0
                for a in Sg:
                    out_new |= reach[a]
                A_set = {lab[src_pos[i]] for i in cut_i}
                # a cut edge from a group being merged into v's group would
                # be internal (consistency); an arc A -> g_new with
                # g_new ~> A closes a cycle (convexity)
                if any(a in Sg or (out_new >> a) & 1 for a in A_set):
                    continue

                # --- structural update: merge, add arcs, keep the closure
                gid = G  # temporary id of v's (possibly merged) group
                reach2 = list(reach) + [out_new]
                for X in range(G):
                    if X in Sg:
                        continue
                    r = reach2[X]
                    if r & Sg_mask:  # X reached a merged member
                        reach2[X] = (r & ~Sg_mask) | (1 << gid) | out_new
                add_mask = (1 << gid) | out_new
                for A in A_set:
                    for X in range(G):
                        if X in Sg:
                            continue
                        if X == A or (reach2[X] >> A) & 1:
                            reach2[X] |= add_mask

                # --- project onto the new frontier: close groups with no
                # frontier nodes, relabel canonically, remap the closure
                raw = []
                for u in new_frontier:
                    if u == v:
                        raw.append(gid)
                    else:
                        a = lab[pos_of[u]]
                        raw.append(gid if a in Sg else a)
                remap: dict[int, int] = {}
                labs_new = []
                for a in raw:
                    if a not in remap:
                        remap[a] = len(remap)
                    labs_new.append(remap[a])
                reach_new = [0] * len(remap)
                for a_old, a_new in remap.items():
                    r = reach2[a_old]
                    rr = 0
                    for b_old, b_new in remap.items():
                        if (r >> b_old) & 1:
                            rr |= 1 << b_new
                    reach_new[a_new] = rr

                newly_paid = {int(srcs[i]) for i in cut_i}
                paid_new = 0
                for j, u in enumerate(new_frontier):
                    if u == v:
                        continue
                    if (st.paid >> pos_of[u]) & 1 or u in newly_paid:
                        paid_new |= 1 << j

                sig = (tuple(labs_new), paid_new, tuple(reach_new))
                acc_new = st.acc + float(delta[si, p])
                cur = new_states.get(sig)
                if cur is None or acc_new < cur.acc:
                    cuts_new = st.cuts.copy()
                    if cut_i:
                        cuts_new[ks[cut_i]] = True
                    new_states[sig] = _DPState(
                        tuple(labs_new), paid_new, tuple(reach_new),
                        acc_new, cuts_new,
                    )
        if not new_states:
            raise InfeasibleBudgetError(
            "no feasible grouping under the SRAM budget"
        )
        if len(new_states) > max_states:
            raise FrontierTooWide(
                f"{len(new_states)} live states exceed the DP cap {max_states}"
            )
        states = new_states

    best = min(states.values(), key=lambda s: s.acc)
    labels = cut_group_labels(g, best.cuts)
    return DPResult(
        cuts=best.cuts,
        group_cost_words=const0 + best.acc,
        n_groups=int(labels.max()) + 1,
        engine="frontier_dp",
    )


@functools.lru_cache(maxsize=32)
def _frontier_dp_cached(g: GraphIR, sram_budget_words: float) -> "DPResult | None":
    """Per-(graph, budget) memo for the dispatch path: repeated searches in
    a flow/fleet are a cache hit, mirroring the `_exhaustive_tables` memo
    the enumeration path enjoys.  Callers get a fresh ``cuts`` copy.
    A :class:`FrontierTooWide` decline is memoised as ``None`` (lru_cache
    does not cache exceptions), so a too-wide graph pays the failed DP
    attempt once, not on every dispatch."""
    try:
        return frontier_dp_min_bw(g, sram_budget_words=sram_budget_words)
    except FrontierTooWide:
        return None


# ---------------------------------------------------------------------------
# Merge search (greedy / beam) — batched engine
# ---------------------------------------------------------------------------


def _merge_pairs(
    esrc: np.ndarray, edst: np.ndarray, labels: np.ndarray
) -> list[tuple[int, int]]:
    """Ordered distinct cross-group (a, b) pairs in edge order — the scalar
    ``_merge_moves`` generation order, so tie-breaking stays bit-identical."""
    la = labels[esrc]
    lb = labels[edst]
    pairs: list[tuple[int, int]] = []
    tried: set[tuple[int, int]] = set()
    for k in range(len(esrc)):
        a, b = int(la[k]), int(lb[k])
        if a == b or (a, b) in tried:
            continue
        tried.add((a, b))
        pairs.append((a, b))
    return pairs


def _merged_label_batch(
    labels: np.ndarray, pairs: list[tuple[int, int]]
) -> np.ndarray:
    """(M, L) label rows: row m relabels group ``pairs[m][1]`` to
    ``pairs[m][0]`` (one single-merge child per candidate pair)."""
    a = np.asarray([p[0] for p in pairs], dtype=labels.dtype)
    b = np.asarray([p[1] for p in pairs], dtype=labels.dtype)
    return np.where(labels[None, :] == b[:, None], a[:, None], labels[None, :])


def _valid_merge_pairs(
    ga: M.GraphArrays, labels: np.ndarray
) -> list[tuple[int, int]]:
    """The convexity-preserving subset of :func:`_merge_pairs`, in order.

    A merge of groups ``a`` and ``b`` (joined by >= 1 arc a->b of the
    current acyclic quotient) closes a cycle iff the quotient has a path
    a ~> b of length >= 2 (the cycle then runs ab -> ... -> ab; conversely
    any cycle of the merged quotient must pass through the merged node and
    lifts to such a path — a b ~> a path would already be a cycle).  The
    reachability matrix of one state's quotient is shared by all of its
    candidate moves: log2(L) boolean matrix squarings replace a Kahn peel
    per move.
    """
    la = labels[ga.esrc]
    lb = labels[ga.edst]
    pairs = _merge_pairs(ga.esrc, ga.edst, labels)
    if not pairs:
        return pairs
    L = len(labels)
    adj = np.zeros((L, L))
    cross = la != lb
    adj[la[cross], lb[cross]] = 1.0
    reach = adj.copy()
    hops = 1
    while hops < L:  # reach: paths of length in [1, 2*hops] each squaring
        reach = np.minimum(reach + reach @ reach, 1.0)
        hops *= 2
    two_plus = adj @ reach  # > 0 iff a path of length >= 2 exists
    return [p for p in pairs if two_plus[p[0], p[1]] == 0.0]


def merge_bandwidth_delta(
    g: GraphIR, labels: np.ndarray, a: int, b: int
) -> float:
    """Exact Eq. (1) bandwidth change from merging groups ``a`` and ``b``.

    Every a<->b edge stops round-tripping DRAM (its consumer read-back
    disappears), and a producer of such an edge also stops writing its
    output frame iff it is not a sink and none of its remaining out-edges
    leave the merged group.  O(boundary degree) per move — the incremental
    fast path of :func:`greedy_merge_cuts` (lock-step with
    ``bandwidth_ref`` differences, asserted in tests; exact because all
    words are integer-valued).
    """
    ga = M.graph_arrays(g)
    la = labels[ga.esrc]
    lb = labels[ga.edst]
    cross = ((la == a) & (lb == b)) | ((la == b) & (lb == a))
    ks = np.flatnonzero(cross)
    delta = -float(ga.ewords[ks].sum())
    for i in np.unique(ga.esrc[ks]):
        if ga.sink_mask[i]:
            continue  # sinks always write their output frame
        gd = lb[ga.out_edges[i]]
        if not np.any((gd != a) & (gd != b)):
            delta -= float(ga.feat[i, M.F_OUT])
    return delta


def _expand_frontier(
    g: GraphIR,
    frontier: list[tuple[float, np.ndarray]],
    sram_budget_words: float,
    seen: set[bytes],
) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """One batched expansion round over the whole frontier.

    Generates every valid single-merge child of every frontier state as one
    (M, L) label batch (frontier order, then edge order — the scalar
    expansion order), dedups it against ``seen`` (all previously scored
    canonical states, within and across rounds), then runs ONE batched
    feasibility + bandwidth pass.  Returns (labels, cuts, costs) for the
    surviving children in first-occurrence order, or None if there are
    none.  Consistency holds by construction (child cuts are derived from
    labels); convexity is filtered per state by :func:`_valid_merge_pairs`.
    """
    ga = M.graph_arrays(g)
    rows = []
    for _, labels in frontier:
        pairs = _valid_merge_pairs(ga, labels)
        if pairs:
            rows.append(_merged_label_batch(labels, pairs))
    if not rows:
        return None
    merged = np.concatenate(rows, axis=0) if len(rows) > 1 else rows[0]
    keys = canonicalize_labels_batch(merged)
    fresh = []
    for i in range(merged.shape[0]):
        key = keys[i].tobytes()
        if key not in seen:
            seen.add(key)
            fresh.append(i)
    if not fresh:
        return None
    cand = merged[fresh]
    cuts = cand[:, ga.esrc] != cand[:, ga.edst]
    ok = graph_feasible_mask_batch(g, cuts, sram_budget_words)
    if not ok.any():
        return None
    cand, cuts = cand[ok], cuts[ok]
    return cand, cuts, _graph_cost_batch(g, cuts)


def greedy_merge_cuts(
    ir: NetworkIR | GraphIR,
    *,
    sram_budget_words: float = float("inf"),
) -> DPResult:
    """Greedy bottom-up merging: start layer-by-layer, repeatedly apply the
    single group merge with the best bandwidth until none improves.

    Each round scores all candidate merges at once: convexity comes from
    one reachability closure of the quotient (:func:`_valid_merge_pairs`),
    feasibility from one batched pass, and costs from the O(degree)
    incremental :func:`merge_bandwidth_delta` fast path (exact, so the
    trajectory is bit-identical to the scalar rescore-everything
    implementation)."""
    g = as_graph(ir)
    ga = M.graph_arrays(g)
    labels = np.arange(len(g.nodes))
    cost = float(
        _graph_cost_batch(g, (labels[ga.esrc] != labels[ga.edst])[None, :])[0]
    )
    while True:
        pairs = _valid_merge_pairs(ga, labels)
        if not pairs:
            break
        merged = _merged_label_batch(labels, pairs)
        cuts = merged[:, ga.esrc] != merged[:, ga.edst]
        ok = graph_feasible_mask_batch(g, cuts, sram_budget_words)
        if not ok.any():
            break
        deltas = np.asarray(
            [
                merge_bandwidth_delta(g, labels, a, b) if o else np.inf
                for (a, b), o in zip(pairs, ok)
            ]
        )
        j = int(np.argmin(deltas))
        if deltas[j] >= 0.0:
            break
        cost, labels = cost + float(deltas[j]), merged[j]
    labels = cut_group_labels(g, cuts_from_labels(g, labels))
    return DPResult(
        cuts=cuts_from_labels(g, labels),
        group_cost_words=cost,
        n_groups=int(labels.max()) + 1,
        engine="greedy",
    )


def beam_merge_cuts(
    ir: NetworkIR | GraphIR,
    *,
    beam_width: int = 32,
    sram_budget_words: float = float("inf"),
) -> DPResult:
    """Beam search over merge sequences (greedy with ``beam_width`` frontier
    states).  Keeps the best state ever visited, so it can only improve on
    :func:`greedy_merge_cuts` for the same width >= 1.

    Every round expands the whole frontier into one (M, E) cut batch scored
    by a single batched validity/feasibility/bandwidth pass, and dedups the
    children against every canonical label state already scored — a state
    reached by two merge orders is expanded once, not once per path.  (With
    single-merge moves the group count drops by one per round, so the dedup
    only ever fires within a round; keeping the ``seen`` set across rounds
    makes that invariant explicit and guards any future move type that
    could revisit a partition.)"""
    g = as_graph(ir)
    ga = M.graph_arrays(g)
    start = np.arange(len(g.nodes))
    start_cost = float(
        _graph_cost_batch(g, (start[ga.esrc] != start[ga.edst])[None, :])[0]
    )
    frontier: list[tuple[float, np.ndarray]] = [(start_cost, start)]
    best_cost, best_labels = start_cost, start
    seen: set[bytes] = {canonicalize_labels_batch(start[None, :])[0].tobytes()}
    while frontier:
        expanded = _expand_frontier(g, frontier, sram_budget_words, seen)
        if expanded is None:
            break
        cand, _, costs = expanded
        order = np.argsort(costs, kind="stable")[:beam_width]
        frontier = [(float(costs[o]), cand[o]) for o in order]
        if costs[order[0]] < best_cost:
            best_cost, best_labels = float(costs[order[0]]), cand[order[0]]
    labels = cut_group_labels(g, cuts_from_labels(g, best_labels))
    return DPResult(
        cuts=cuts_from_labels(g, labels),
        group_cost_words=best_cost,
        n_groups=int(labels.max()) + 1,
        engine="beam",
    )


# ---------------------------------------------------------------------------
# Merge search — the scalar implementations (the oracles)
# ---------------------------------------------------------------------------


def _merge_moves(
    g: GraphIR, labels: np.ndarray, sram_budget_words: float
) -> list[tuple[float, np.ndarray]]:
    """All valid, feasible single merges from ``labels`` as (cost, labels)."""
    moves = []
    tried: set[tuple[int, int]] = set()
    for e in g.edges:
        a, b = int(labels[e.src]), int(labels[e.dst])
        if a == b or (a, b) in tried:
            continue
        tried.add((a, b))
        merged = np.where(labels == b, a, labels)
        cuts = cuts_from_labels(g, merged)
        if not _quotient_is_dag(g, merged):
            continue  # merge would make a group non-convex
        if graph_max_intermediate(g, cuts) > sram_budget_words:
            continue
        moves.append((_graph_cost(g, cuts), merged))
    return moves


def _greedy_merge_cuts_scalar(
    ir: NetworkIR | GraphIR,
    *,
    sram_budget_words: float = float("inf"),
) -> DPResult:
    g = as_graph(ir)
    labels = np.arange(len(g.nodes))
    cost = _graph_cost(g, cuts_from_labels(g, labels))
    while True:
        moves = _merge_moves(g, labels, sram_budget_words)
        if not moves:
            break
        best_cost, best_labels = min(moves, key=lambda m: m[0])
        if best_cost >= cost:
            break
        cost, labels = best_cost, best_labels
    labels = cut_group_labels(g, cuts_from_labels(g, labels))
    return DPResult(
        cuts=cuts_from_labels(g, labels),
        group_cost_words=cost,
        n_groups=int(labels.max()) + 1,
        engine="greedy_scalar",
    )


def _beam_merge_cuts_scalar(
    ir: NetworkIR | GraphIR,
    *,
    beam_width: int = 32,
    sram_budget_words: float = float("inf"),
) -> DPResult:
    g = as_graph(ir)
    start = np.arange(len(g.nodes))
    start_cost = _graph_cost(g, cuts_from_labels(g, start))
    frontier: list[tuple[float, np.ndarray]] = [(start_cost, start)]
    best_cost, best_labels = start_cost, start
    while frontier:
        candidates: dict[tuple[int, ...], tuple[float, np.ndarray]] = {}
        for cost, labels in frontier:
            for mc, ml in _merge_moves(g, labels, sram_budget_words):
                key = tuple(cut_group_labels(g, cuts_from_labels(g, ml)))
                if key not in candidates or mc < candidates[key][0]:
                    candidates[key] = (mc, ml)
        if not candidates:
            break
        ranked = sorted(candidates.values(), key=lambda m: m[0])
        frontier = ranked[:beam_width]
        if ranked[0][0] < best_cost:
            best_cost, best_labels = ranked[0]
    labels = cut_group_labels(g, cuts_from_labels(g, best_labels))
    return DPResult(
        cuts=cuts_from_labels(g, labels),
        group_cost_words=best_cost,
        n_groups=int(labels.max()) + 1,
        engine="beam_scalar",
    )


def optimal_cuts(
    ir: NetworkIR | GraphIR,
    *,
    sram_budget_words: float = float("inf"),
    beam_width: int = 32,
) -> DPResult:
    """Grouping search dispatch: chain DP fast path; frontier-state DP for
    general DAGs (exact at any edge count, up to a frontier-width cap —
    ResNet-18's 2^38 space included); when the DAG is too wide for the DP,
    small graphs keep their certified optimum via exhaustive enumeration
    and only large-and-wide graphs fall back to beam merge.  The returned
    :class:`DPResult` carries ``engine`` provenance ("chain_dp" /
    "frontier_dp" / "exhaustive" / "beam") and ``exact`` so callers can
    tell a certified optimum from a heuristic answer."""
    g = as_graph(ir)
    if g.is_chain:
        return optimal_cuts_dp(g, sram_budget_words=sram_budget_words)
    res = _frontier_dp_cached(g, float(sram_budget_words))
    if res is not None:
        return dataclasses.replace(res, cuts=res.cuts.copy())
    if (
        g.n_edges <= MAX_EXHAUSTIVE_EDGES
        and len(g.nodes) <= MAX_EXHAUSTIVE_LAYERS
    ):
        return brute_force_min_bw(g, sram_budget_words=sram_budget_words)
    return beam_merge_cuts(
        g, beam_width=beam_width, sram_budget_words=sram_budget_words
    )
