"""Layer-fusion grouping search — the chain half.

The grouping space over an L-layer *chain* is the 2^(L-1) set of cut
vectors; over a general DAG it is the set of *valid* edge-cut vectors: the
uncut edges must induce groups that are weakly connected (automatic — a
group is a connected component of the uncut subgraph), **consistent**
(every cut edge actually crosses two different groups) and **convex** (the
quotient graph obtained by contracting every group is acyclic).

This module carries what the paper's VGG-16 flow needs: enumeration (the
paper's exhaustive sweep; chains up to 2^20 vectors, small DAGs through the
batched validity pipeline), the pool-boundary policy (via
``GraphIR.pool_boundary_cuts``), buffer feasibility, and the O(L^2)
chain-partition DP.  It is numpy search code on the host; the hardware x
grouping sweep that scores its output runs on the device
(:mod:`repro_torch.core.metrics`).

``optimal_cuts`` dispatches chains to the DP and declines DAGs with
:class:`~repro_torch.core.errors.SearchDeclined`: the frontier-state DP,
brute force, greedy and beam searches for general DAGs are not part of this
package yet.
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
    quotient_acyclic_batch,
    scc_labels,
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


def optimal_cuts(
    ir: NetworkIR | GraphIR,
    *,
    sram_budget_words: float = float("inf"),
) -> DPResult:
    """Grouping search dispatch: the chain DP for chains.  A general DAG
    raises :class:`SearchDeclined` — its exact frontier-state DP and the
    exhaustive/beam fallbacks are not part of this package yet."""
    g = as_graph(ir)
    if g.is_chain:
        return optimal_cuts_dp(g, sram_budget_words=sram_budget_words)
    raise SearchDeclined(
        f"{g.name}: optimal_cuts on a non-chain DAG needs the frontier-state "
        "DP, which the port has not taken over yet; pass an explicit cut "
        "batch or groupings='exhaustive' instead"
    )
