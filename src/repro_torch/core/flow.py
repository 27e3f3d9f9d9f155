"""The paper's optimisation flow (Sec. II-C), on graph IRs, swept on the GPU.

For each (hardware configuration x fusion grouping) candidate, estimate the
four metrics, reject candidates violating the user constraints, and return
the feasible candidate with minimum energy.  The cross-product is evaluated
by the batched float64 sweep of :mod:`repro_torch.core.metrics` on the
device; the raw plane comes back to the host, where energy is composed and
the argmin taken.  Groupings are boolean cut vectors over the graph's
edges; chains (``NetworkIR``) are embedded losslessly via
:func:`~repro_torch.core.ir.as_graph`.

Argument shapes are rounded up to power-of-two *shape buckets* and swept
through the masked path (padded rows exactly inert), as in the reference
evaluator, so padded and unpadded sweeps stay interchangeable.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device
from . import fusion
from . import metrics as M
from .arch import Constraints, DLAConfig, default_config_space
from .errors import (
    InfeasibleBudgetError,
    InfeasibleConstraintsError,
    PoisonedResultError,
)
from .ir import (
    GraphIR,
    NetworkIR,
    as_graph,
    bucket_size,
    pad_cuts_batch,
    pad_graph,
)

# Shape-bucket floors: (L, E, C) are rounded up to the next power of two, but
# never below these.  The padded rows are exactly inert (masked sweep), so
# bucketing never changes a metric.
NODE_BUCKET_FLOOR = 32
EDGE_BUCKET_FLOOR = 64
CUT_BUCKET_FLOOR = 4


@dataclasses.dataclass(frozen=True)
class FlowResult:
    """One graph's sweep outcome: the argmin (hw, cuts, metrics), the
    candidate/feasibility accounting, timing split, and provenance."""

    best_hw: DLAConfig
    best_cuts: np.ndarray
    best_metrics: M.Metrics
    group_sizes: tuple[int, ...]
    n_candidates: int
    n_feasible: int
    n_pruned: int  # groupings dropped by the SRAM prefilter before the sweep
    compile_seconds: float  # device set-up: staging the inputs on the device
    sweep_seconds: float  # the sweep on the device + the raw plane to host
    candidates_per_second: float
    # Provenance of the grouping candidates: "exhaustive" / "pool" /
    # "explicit", or — for groupings="search"/"dp" — the engine that
    # produced the search optimum ("chain_dp").
    search_engine: str = ""
    # (architecture x fusion plan) Pareto front over the feasible sweep,
    # populated when the flow is asked for it (``pareto=True``).
    pareto: "ParetoFront | None" = None
    # Cells the finite guard excluded (None when the sweep was clean).
    quarantine: "QuarantineReport | None" = None

    def describe(self) -> str:
        """One-line summary: best hw, group sizes, and the four metrics."""
        return (
            f"best={self.best_hw.describe()} groups={list(self.group_sizes)} "
            f"BW={self.best_metrics.bandwidth_words/1e6:.2f}M words "
            f"lat={self.best_metrics.latency_cycles/1e6:.2f}M cyc "
            f"E={self.best_metrics.energy_nj/1e6:.2f} mJ "
            f"A={self.best_metrics.area_um2/1e6:.2f} mm^2 "
            f"({self.n_feasible}/{self.n_candidates} feasible, "
            f"{self.n_pruned} pruned, "
            f"{self.candidates_per_second:,.0f} cand/s, "
            f"set-up {self.compile_seconds*1e3:.0f} ms, "
            f"groupings={self.search_engine})"
        )


# Sweep accounting.  The reference evaluator caches compiled XLA
# executables per argument-shape signature; eager torch compiles nothing,
# so there is nothing to cache: every sweep stages its inputs on the device
# anew.  The stats keep the reference's keys with that meaning — ``misses``
# counts sweeps run (each stages its inputs), ``hits``/``evictions`` and the
# cache ``size``/``entries`` stay zero/empty.
_SWEEP_CACHE_STATS = {"hits": 0, "misses": 0, "evictions": 0}
_SWEEP_CACHE_LOCK = threading.Lock()


def sweep_cache_stats() -> dict:
    """Sweep accounting: {size, hits, misses, evictions, entries}, the
    reference evaluator's keys.  No executable is cached here: ``misses``
    counts the sweeps run since the last :func:`clear_sweep_cache`; the
    other counters stay 0 and ``entries`` empty."""
    with _SWEEP_CACHE_LOCK:
        return dict(_SWEEP_CACHE_STATS, size=0, entries=[])


def clear_sweep_cache() -> None:
    """Zero the sweep accounting."""
    with _SWEEP_CACHE_LOCK:
        for k in _SWEEP_CACHE_STATS:
            _SWEEP_CACHE_STATS[k] = 0


def _run_sweep(args, device: torch.device) -> tuple[np.ndarray, float, float]:
    """(raw plane, set-up seconds, sweep seconds) of one device sweep.

    Set-up stages the numpy arguments on the device; the sweep evaluates
    the raw (H, C, 5) plane there and copies it back to the host (the copy
    waits for the device, so the timing ends when the work has)."""
    with _SWEEP_CACHE_LOCK:
        _SWEEP_CACHE_STATS["misses"] += 1
    t0 = time.perf_counter()
    tensors = M.sweep_tensors(args, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    raw = M._evaluate_batch_graph(*tensors).cpu().numpy()
    return raw, t1 - t0, time.perf_counter() - t1


def _metrics_from_row(row: np.ndarray) -> M.Metrics:
    return M.Metrics(
        bandwidth_words=float(row[0]),
        latency_cycles=float(row[1]),
        energy_nj=float(row[2]),
        area_um2=float(row[3]),
    )


# ---------------------------------------------------------------------------
# Poison quarantine — the finite guard over raw sweep planes
# ---------------------------------------------------------------------------

# Column names of the raw (…, 5) sweep rows, for quarantine provenance.
RAW_COLUMNS = (
    "bandwidth_words",
    "latency_cycles",
    "sram_accesses",
    "pb_accesses",
    "area_um2",
)


@dataclasses.dataclass(frozen=True)
class QuarantinedCell:
    """Provenance of one poisoned sweep cell: which (graph, hw, cut)
    candidate was excluded, which raw column tripped the finite guard,
    the offending value, and why (``nan``/``inf``/``negative``/
    ``overflow`` — overflow meaning above 2^53, where integer word
    counts stop being exact in f64)."""

    graph: int
    hw: int
    cut: int
    column: str
    value: float
    reason: str


@dataclasses.dataclass(frozen=True)
class QuarantineReport:
    """Every cell the finite guard excluded from one sweep's selection.

    Quarantined cells can never win the argmin or enter a Pareto front;
    only a graph whose ENTIRE candidate set is poisoned raises
    :class:`~repro_torch.core.errors.PoisonedResultError`.
    """

    cells: tuple[QuarantinedCell, ...]

    @property
    def n_cells(self) -> int:
        """Number of quarantined (graph, hw, cut) cells."""
        return len(self.cells)

    def describe(self, limit: int = 8) -> str:
        """Multi-line summary: cell count plus the first ``limit`` cells."""
        lines = [f"quarantined {self.n_cells} poisoned cells"]
        for cell in self.cells[:limit]:
            lines.append(
                f"  (g={cell.graph}, h={cell.hw}, c={cell.cut}) "
                f"{cell.column}={cell.value!r} [{cell.reason}]"
            )
        if self.n_cells > limit:
            lines.append(f"  ... {self.n_cells - limit} more")
        return "\n".join(lines)


def _poison_reason(v: float) -> str:
    """Finite-guard verdict for one offending raw value."""
    if np.isnan(v):
        return "nan"
    if np.isinf(v):
        return "inf"
    if v < 0.0:
        return "negative"
    return "overflow"


def _quarantine_cells(
    raw: np.ndarray,  # (H, C, 5) one graph's raw plane, real rows only
    poison: np.ndarray,  # (H, C) bool, from metrics.poison_mask
    *,
    graph: int,
) -> tuple[QuarantinedCell, ...]:
    """Provenance records for one graph's poisoned cells, naming the first
    offending raw column of each."""
    cells = []
    for h, c in np.argwhere(poison):
        row = raw[h, c]
        bad = ~np.isfinite(row) | (row < 0.0) | (row > M.MAX_EXACT_WORDS)
        k = int(np.flatnonzero(bad)[0])
        v = float(row[k])
        cells.append(
            QuarantinedCell(
                graph=int(graph), hw=int(h), cut=int(c),
                column=RAW_COLUMNS[k], value=v, reason=_poison_reason(v),
            )
        )
    return tuple(cells)


@dataclasses.dataclass(frozen=True)
class ParetoFront:
    """Non-dominated (architecture x fusion plan) points of one workload's
    feasible sweep, minimising (bandwidth, latency, energy, area) jointly.
    Points are sorted by (energy, bandwidth, latency, area, h, c);
    exact-duplicate metric rows keep their lowest-index representative
    (:func:`repro_torch.core.metrics.pareto_front_mask`)."""

    metrics: np.ndarray  # (P, 4) [bw, lat, energy, area]
    hw_indices: np.ndarray  # (P,) into the sweep's config_space
    cut_indices: np.ndarray  # (P,) into the surviving cut batch
    configs: tuple[DLAConfig, ...]  # (P,) the actual design points
    cuts: np.ndarray  # (P, E) the fusion plan of each point
    n_feasible: int  # candidates the front was extracted from
    search_engine: str = ""  # grouping provenance, as FlowResult

    @property
    def size(self) -> int:
        """Number of non-dominated points on the front."""
        return int(self.metrics.shape[0])

    def describe(self, limit: int = 8) -> str:
        """Multi-line summary: front size plus the first ``limit`` rows."""
        lines = [
            f"pareto front: {self.size} of {self.n_feasible} feasible "
            f"(groupings={self.search_engine})"
        ]
        for i in range(min(self.size, limit)):
            bw, lat, e, a = self.metrics[i]
            lines.append(
                f"  {self.configs[i].describe():40s} "
                f"BW={bw/1e6:7.2f}M lat={lat/1e6:7.2f}M "
                f"E={e/1e6:6.2f}mJ A={a/1e6:5.2f}mm^2"
            )
        if self.size > limit:
            lines.append(f"  ... {self.size - limit} more")
        return "\n".join(lines)


def _pareto_front(
    out: np.ndarray,  # (H, C, 4) real candidate rows
    feasible: np.ndarray,  # (H, C) bool
    cuts_batch: np.ndarray,  # (C, E)
    config_space: Sequence[DLAConfig],
    search_engine: str,
) -> ParetoFront:
    """Extract the feasible sweep's Pareto front in deterministic order."""
    idx = np.argwhere(feasible)  # (N, 2) in (h, c) lexicographic order
    rows = out[feasible]  # row-major: matches idx order
    keep = M.pareto_front_mask(rows)
    sel_rows, sel_idx = rows[keep], idx[keep]
    order = np.lexsort(
        (
            sel_idx[:, 1],
            sel_idx[:, 0],
            sel_rows[:, 3],
            sel_rows[:, 1],
            sel_rows[:, 0],
            sel_rows[:, 2],
        )
    )
    sel_rows, sel_idx = sel_rows[order], sel_idx[order]
    return ParetoFront(
        metrics=sel_rows,
        hw_indices=sel_idx[:, 0],
        cut_indices=sel_idx[:, 1],
        configs=tuple(config_space[h] for h in sel_idx[:, 0]),
        cuts=cuts_batch[sel_idx[:, 1]],
        n_feasible=int(rows.shape[0]),
        search_engine=search_engine,
    )


def _best_flow_result(
    out: np.ndarray,  # (H, C, 4) — real candidate rows only, padding sliced
    cuts_batch: np.ndarray,  # (C, E) — real cut rows, real edge columns
    g: GraphIR,
    config_space: Sequence[DLAConfig],
    constraints: Constraints,
    *,
    n_pruned: int,
    compile_seconds: float,
    sweep_seconds: float,
    candidates_per_second: float,
    search_engine: str = "",
    err_prefix: str = "",
    pareto: bool = False,
    poison: np.ndarray | None = None,
    quarantine: "QuarantineReport | None" = None,
) -> FlowResult:
    """Constraint filter + min-energy argmin over one graph's sweep output.

    Tie-breaking is deterministic: among equal-energy feasible candidates
    the winner is the lexicographic minimum of (bandwidth, latency, area,
    h, c).  ``poison`` is the finite guard's (H, C) quarantine mask:
    poisoned cells are excluded from feasibility before any selection.  A
    fully-poisoned candidate set raises :class:`PoisonedResultError` with
    the ``quarantine`` provenance.
    """
    limits = constraints.as_row()  # (4,)
    feasible = np.all(out <= limits[None, None, :], axis=-1)  # (H, C)
    if poison is not None:
        if poison.all():
            raise PoisonedResultError(
                f"{err_prefix}all {poison.size} candidates were poisoned "
                "(NaN/Inf/negative/overflowed cost rows) — nothing is left "
                "to select from",
                quarantined=(
                    quarantine.cells if quarantine is not None else ()
                ),
            )
        feasible &= ~poison
    n_feas = int(feasible.sum())
    if n_feas == 0:
        raise InfeasibleConstraintsError(
            f"{err_prefix}no candidate meets the constraints"
        )
    energy = np.where(feasible, out[:, :, 2], np.inf)
    ties = np.argwhere(energy == energy.min())  # (h, c) lexicographic order
    if len(ties) > 1:
        rows = out[ties[:, 0], ties[:, 1]]  # (k, 4)
        order = np.lexsort(
            (ties[:, 1], ties[:, 0], rows[:, 3], rows[:, 1], rows[:, 0])
        )
        ties = ties[order[:1]]
    h, c = ties[0]
    labels = fusion.cut_group_labels(g, cuts_batch[c])
    sizes = tuple(len(grp) for grp in fusion.groups_from_labels(labels))
    return FlowResult(
        best_hw=config_space[h],
        best_cuts=cuts_batch[c],
        best_metrics=_metrics_from_row(out[h, c]),
        group_sizes=sizes,
        n_candidates=out.shape[0] * out.shape[1],
        n_feasible=n_feas,
        n_pruned=n_pruned,
        compile_seconds=compile_seconds,
        sweep_seconds=sweep_seconds,
        candidates_per_second=candidates_per_second,
        search_engine=search_engine,
        pareto=(
            _pareto_front(out, feasible, cuts_batch, config_space,
                          search_engine)
            if pareto
            else None
        ),
        quarantine=quarantine,
    )


def groupings_batch(
    g: GraphIR,
    groupings: str | np.ndarray,
    *,
    sram_budget_words: float = float("inf"),
    with_provenance: bool = False,
) -> np.ndarray | tuple[np.ndarray, str]:
    """Resolve a groupings spec to a (C, E) boolean cut batch.

    ``"exhaustive"`` — all valid edge cuts (2^(L-1) on a chain);
    ``"pool"``       — the paper's pool-boundary policy + layer-by-layer;
    ``"search"``/``"dp"`` — the chain DP optimum + layer-by-layer + pool
    boundaries (a DAG raises
    :class:`~repro_torch.core.errors.SearchDeclined`);
    or an explicit (C, E) bool array.  ``sram_budget_words`` is threaded
    into the search so a budget-constrained flow searches under the budget
    its prefilter enforces.  With ``with_provenance`` the batch comes back
    paired with the grouping provenance string.
    """

    def _ret(batch: np.ndarray, provenance: str):
        return (batch, provenance) if with_provenance else batch

    if not isinstance(groupings, str):
        return _ret(
            np.atleast_2d(np.asarray(groupings, dtype=bool)), "explicit"
        )
    if groupings == "exhaustive":
        try:
            return _ret(fusion.enumerate_valid_edge_cuts(g), "exhaustive")
        except ValueError as e:
            raise ValueError(
                f"{g.name}: {e}; pass groupings='search' for large graphs"
            ) from None
    if groupings == "pool":
        # dedupe: where the pool policy degenerates to layer-by-layer the
        # duplicate row must not be scored twice.
        return _ret(
            np.unique(
                np.stack(
                    [g.pool_boundary_cuts(), fusion.layer_by_layer_cuts(g)]
                ),
                axis=0,
            ),
            "pool",
        )
    if groupings in ("dp", "search"):
        best = fusion.optimal_cuts(g, sram_budget_words=sram_budget_words)
        rows = [
            best.cuts,
            fusion.layer_by_layer_cuts(g),
            g.pool_boundary_cuts(),
        ]
        return _ret(np.unique(np.stack(rows), axis=0), best.engine)
    raise ValueError(groupings)


def sweep_args(
    g: GraphIR,
    cuts_batch: np.ndarray,
    config_space: Sequence[DLAConfig],
    *,
    bucket: bool = True,
) -> tuple:
    """The numpy argument list of the sweep
    (:func:`repro_torch.core.metrics.evaluate_batch_graph`) for ``g``'s
    ``(C, E)`` cut batch on ``config_space``.

    With ``bucket`` the graph is zero-padded to its shape bucket and the cut
    batch to ``bucket_size(C)`` rows (padded rows come last, to be sliced
    off), and the node/edge masks are appended.  Raises
    :class:`~repro_torch.core.errors.GraphValidationError` if a feature or
    edge word is not an exactly-representable integer float64, on which the
    sweep's bit-identity to the oracles rests.
    """
    hw_rows = np.stack([c.as_row() for c in config_space])
    area_consts = M.area_consts_of_space(config_space)
    if bucket:
        pg = pad_graph(
            g,
            n_nodes=bucket_size(g.n_nodes, NODE_BUCKET_FLOOR),
            n_edges=bucket_size(g.n_edges, EDGE_BUCKET_FLOOR),
        )
        C = cuts_batch.shape[0]
        args = (
            pg.feat, pg.esrc, pg.edst, pg.ewords, pg.src_mask, pg.sink_mask,
            pad_cuts_batch(
                cuts_batch, pg.n_edges_padded, bucket_size(C, CUT_BUCKET_FLOOR)
            ),
            hw_rows, area_consts, pg.node_mask, pg.edge_mask,
        )
    else:
        esrc, edst, ewords = g.edge_arrays()
        args = (
            g.node_features(), esrc, edst, ewords, g.source_mask,
            g.sink_mask, cuts_batch, hw_rows, area_consts,
        )
    M.assert_exact_f64(args[0], what=f"{g.name} feature table")
    M.assert_exact_f64(args[3], what=f"{g.name} edge words")
    return args


def run_flow(
    ir: NetworkIR | GraphIR,
    *,
    config_space: Sequence[DLAConfig] | None = None,
    constraints: Constraints = Constraints(),
    groupings: str | np.ndarray = "exhaustive",
    sram_budget_words: float = float("inf"),
    bucket: bool = True,
    pareto: bool = False,
    device: "str | torch.device" = "cuda",
) -> FlowResult:
    """Sweep (hw x grouping) on ``device``, filter by constraints, return
    the min-energy point.

    ``groupings`` is resolved by :func:`groupings_batch`.  A finite
    ``sram_budget_words`` drops buffer-infeasible groupings *before* the
    sweep via the batched prefilter
    (:func:`repro_torch.core.fusion.graph_feasible_mask_batch`).

    With ``bucket=True`` (the default) the ``(L, E, C)`` signature is
    rounded up to power-of-two shape buckets and swept through the masked
    path — bit-identical metrics (padded rows are exactly inert and sliced
    off before the argmin).  ``bucket=False`` sweeps the exact shapes.

    ``compile_seconds`` reports the device set-up paid by this call
    (staging the inputs on the device); ``sweep_seconds`` /
    ``candidates_per_second`` the sweep itself, including the copy of the
    raw plane back to the host.  ``pareto=True`` additionally extracts the
    feasible sweep's Pareto front into ``FlowResult.pareto``.

    ``device`` defaults to ``"cuda"`` and raises without CUDA; pass
    ``device="cpu"`` to sweep on the CPU.
    """
    dev = resolve_device(device)
    if config_space is None:
        config_space = default_config_space()
    g = as_graph(ir)
    cuts_batch, provenance = groupings_batch(
        g, groupings, sram_budget_words=sram_budget_words,
        with_provenance=True,
    )

    n_pruned = 0
    if np.isfinite(sram_budget_words):
        max_int = fusion.graph_max_intermediate_batch(g, cuts_batch)
        keep = max_int <= sram_budget_words
        n_pruned = int(cuts_batch.shape[0] - keep.sum())
        if not keep.any():
            # Never return a silently-empty sweep: report the smallest
            # budget under which at least one offered grouping survives.
            raise InfeasibleBudgetError(
                f"{g.name}: no grouping fits the SRAM budget "
                f"({sram_budget_words:.0f} words; the cheapest offered "
                f"grouping needs {max_int.min():.0f})",
                min_feasible_budget_words=float(max_int.min()),
            )
        cuts_batch = cuts_batch[keep]
    C = cuts_batch.shape[0]

    hw_rows = np.stack([c.as_row() for c in config_space])
    args = sweep_args(g, cuts_batch, config_space, bucket=bucket)
    # raw (H, C_b, 5) rows -> (H, C, 4) metrics, padded candidate rows
    # sliced off before feasibility/argmin
    raw, compile_seconds, sweep_seconds = _run_sweep(args, dev)
    out = M.compose_metrics(raw, hw_rows)[:, :C]
    # Finite guard: quarantine poisoned raw cells before any selection.
    poison = M.poison_mask(raw)[:, :C]
    quarantine = None
    if poison.any():
        quarantine = QuarantineReport(
            cells=_quarantine_cells(raw[:, :C], poison, graph=0)
        )
    else:
        poison = None
    n_cand = out.shape[0] * C
    return _best_flow_result(
        out, cuts_batch, g, config_space, constraints,
        n_pruned=n_pruned,
        compile_seconds=compile_seconds,
        sweep_seconds=sweep_seconds,
        candidates_per_second=n_cand / max(sweep_seconds, 1e-9),
        search_engine=provenance,
        pareto=pareto,
        poison=poison,
        quarantine=quarantine,
    )


@dataclasses.dataclass(frozen=True)
class FusionComparison:
    """Layer-by-layer vs fused metrics for one (network, hw) — the paper's
    headline Sec. III numbers."""

    lbl: M.Metrics
    fused: M.Metrics
    bw_reduction: float
    latency_reduction: float
    energy_reduction: float

    def describe(self) -> str:
        """Three-line lbl -> fused table with percentage reductions."""
        return (
            f"BW  {self.lbl.bandwidth_words/1e6:8.2f}M -> {self.fused.bandwidth_words/1e6:8.2f}M  (-{self.bw_reduction*100:5.1f}%)\n"
            f"lat {self.lbl.latency_cycles/1e6:8.2f}M -> {self.fused.latency_cycles/1e6:8.2f}M  (-{self.latency_reduction*100:5.1f}%)\n"
            f"E   {self.lbl.energy_nj/1e6:8.2f}mJ-> {self.fused.energy_nj/1e6:8.2f}mJ (-{self.energy_reduction*100:5.1f}%)"
        )


def compare_fusion(
    ir: NetworkIR | GraphIR,
    hw: DLAConfig,
    fused_cuts: np.ndarray | None = None,
) -> FusionComparison:
    """Evaluate the paper's fused-vs-layer-by-layer comparison on ``ir``
    with the scalar oracles (two candidates need no device sweep)."""
    g = as_graph(ir)
    if fused_cuts is None:
        fused_cuts = g.pool_boundary_cuts()
    lbl_cuts = fusion.layer_by_layer_cuts(g)
    lbl = M.evaluate_ref(g, lbl_cuts, hw)
    fus = M.evaluate_ref(g, fused_cuts, hw)
    return FusionComparison(
        lbl=lbl,
        fused=fus,
        bw_reduction=1.0 - fus.bandwidth_words / lbl.bandwidth_words,
        latency_reduction=1.0 - fus.latency_cycles / lbl.latency_cycles,
        energy_reduction=1.0 - fus.energy_nj / lbl.energy_nj,
    )
