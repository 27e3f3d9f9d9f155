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
:func:`run_fleet` stacks many padded graphs along a leading axis and
sweeps the whole ``(G, H, C)`` cross-product — the entire model fleet —
at once, optionally split over several devices, in resumable chunks.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..parallel.sharding import hardware_mesh
from . import fusion
from . import metrics as M
from .arch import Constraints, DLAConfig, default_config_space
from .errors import (
    InfeasibleBudgetError,
    InfeasibleConstraintsError,
    PoisonedResultError,
    RetryPolicy,
    TransientFailure,
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
# executables per argument-shape signature and device layout; eager torch
# compiles nothing, so there is nothing to cache: every sweep stages its
# inputs on the device anew.  The stats keep the reference's keys with that
# meaning — ``misses`` counts sweeps run (each stages its inputs; a chunked
# fleet sweep counts one per chunk computed), ``hits``/``evictions`` and
# the cache ``size``/``entries`` stay zero/empty, for every layout.
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


def _run_fleet_sweep(args, mesh) -> tuple[np.ndarray, float, float]:
    """(raw (G, H, C, 5) plane, set-up seconds, sweep seconds) of one fleet
    sweep over the device layout ``mesh``: set-up stages every shard's
    inputs on its device; the sweep runs every shard and gathers the planes
    on the host (:func:`repro_torch.core.metrics.run_staged_fleet`)."""
    with _SWEEP_CACHE_LOCK:
        _SWEEP_CACHE_STATS["misses"] += 1
    t0 = time.perf_counter()
    staged = M.stage_fleet(args, mesh)
    for dev in dict.fromkeys(mesh):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    raw = M.run_staged_fleet(staged)
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
    ``"search"``/``"dp"`` — the grouping search optimum (chain DP fast path,
    frontier DP — exact even on ResNet-scale DAGs — or beam fallback) +
    layer-by-layer + pool boundaries;
    or an explicit (C, E) bool array.  ``sram_budget_words`` is threaded
    into the search strategies so a budget-constrained flow searches under
    the same budget its prefilter enforces (a budget-blind optimum would
    just be pruned afterwards).  With ``with_provenance`` the batch comes
    back paired with the grouping provenance string (for "search"/"dp"
    the engine that produced the optimum, see
    :attr:`repro_torch.core.fusion.DPResult.engine`).
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
class FleetResult:
    """One multi-graph sweep: per-graph best points + the shared set-up."""

    results: tuple[FlowResult, ...]  # one FlowResult per input graph
    n_graphs: int
    n_candidates: int  # real (graph, hw, cut) triples across the fleet
    compile_seconds: float  # device set-up: staging the fleet's inputs
    sweep_seconds: float  # the (G, H, C) sweep + the raw plane to host
    candidates_per_second: float
    # Device layout the sweep ran on: 1 for the single-device sweep, else
    # the number of devices the hardware axis was split over.
    device_count: int = 1
    # Fleet-wide finite-guard report (None when every raw cell was clean).
    quarantine: "QuarantineReport | None" = None
    # Salvage/resume accounting: chunks actually computed this call vs
    # restored from a sweep checkpoint (1/0 for an unchunked sweep), chunk
    # indices the straggler detector flagged, and whether a sick layout was
    # degraded to the single-device sweep mid-call.
    chunks_computed: int = 1
    chunks_restored: int = 0
    straggler_chunks: tuple[int, ...] = ()
    mesh_degraded: bool = False

    def describe(self) -> str:
        """One-line summary of the fleet sweep (incl. layout, if split)."""
        mesh = (
            f", {self.device_count}-device hardware mesh"
            if self.device_count > 1
            else ""
        )
        if self.mesh_degraded:
            mesh = ", mesh degraded to single-device"
        salvage = (
            f", {self.chunks_restored} chunks restored"
            if self.chunks_restored
            else ""
        )
        lines = [
            f"fleet of {self.n_graphs}: {self.n_candidates} candidates in "
            f"{self.sweep_seconds*1e3:.2f} ms "
            f"({self.candidates_per_second:,.0f} cand/s, set-up "
            f"{self.compile_seconds*1e3:.0f} ms{mesh}{salvage})"
        ]
        lines += [f"  {r.describe()}" for r in self.results]
        return "\n".join(lines)


def run_fleet(
    irs: Sequence[NetworkIR | GraphIR],
    *,
    config_space: Sequence[DLAConfig] | None = None,
    constraints: Constraints = Constraints(),
    groupings: str | np.ndarray | Sequence[np.ndarray] = "search",
    sram_budget_words: float = float("inf"),
    devices=None,
    pareto: bool = False,
    hw_chunk: int | None = None,
    abort_check=None,
    retry_policy: RetryPolicy | None = None,
    checkpoint_dir=None,
    hooks=None,
    device: "str | torch.device" = "cuda",
) -> FleetResult:
    """Sweep many graphs' (hw x grouping) cross-products in one fleet sweep.

    Every graph is zero-padded to the fleet-wide ``(L, E, C)`` bucket
    (power-of-two, same floors as :func:`run_flow`), stacked along a new
    leading axis, and swept into one raw (G, H, C, 5) plane
    (:func:`repro_torch.core.metrics._evaluate_fleet_graph`).  Per-graph
    metrics are bit-identical to :func:`run_flow` (padded rows are exactly
    inert and sliced off before feasibility/argmin).

    ``groupings`` / ``sram_budget_words`` / ``constraints`` apply to every
    graph — except that ``groupings`` may also be a *sequence* of explicit
    per-graph cut batches (one (C_i, E_i) bool array per input graph), the
    form the planning service uses to sweep a micro-batch of requests
    whose deadline ladders resolved to different engines.  The SRAM
    prefilter runs per graph on the padded cut rows.  ``results[i]`` is
    graph ``i``'s :class:`FlowResult`; the set-up is reported fleet-level
    (per-graph ``compile_seconds`` is 0), and per-graph ``sweep_seconds``
    / ``candidates_per_second`` describe the one shared sweep.

    ``device`` (default ``"cuda"``, raising without CUDA; ``"cpu"`` on
    the CPU) is the single device of the sweep.  ``devices`` overrides it
    and splits the hardware axis over a device layout
    (:func:`repro_torch.parallel.sharding.hardware_mesh`): an int takes
    ``cuda:0`` .. ``cuda:N-1``, a device sequence is used as given (the
    same card may appear twice).  H is padded to a device-count multiple
    with copies of config 0 — inert rows sliced off before metrics
    composition — each device sweeps its H-shard, and the shards' raw
    planes are gathered along H on the host; the per-graph argmin/Pareto
    then run exactly as on one device, so split results are
    **bit-identical** at any device count.  No executable is compiled or
    cached for any layout (``sweep_cache_stats()["entries"]`` stays
    empty); ``compile_seconds`` is the set-up time.

    ``pareto=True`` extracts each workload's feasible-sweep Pareto front
    over (bandwidth, latency, energy, area) into ``results[i].pareto``.

    ``hw_chunk`` splits the sweep into resumable slices of the hardware
    axis, reassembled before metrics composition; every raw row is an
    exact per-candidate float64 quantity, so the chunked sweep is
    **bit-identical** to the unchunked one.  ``abort_check`` (a zero-arg
    callable) is invoked before the sweep and between chunks; raising from
    it abandons the remaining chunks — the planning service's cooperative
    cancellation and deadline enforcement.  A chunk ends when its plane is
    on the host, so a cancel acts within one chunk.  ``hw_chunk`` cannot
    be combined with ``devices``.

    Fault tolerance (all off by default):

    * ``retry_policy`` (:class:`repro_torch.core.errors.RetryPolicy`)
      retries each chunk's set-up + sweep on non-evaluator failures with
      exponential backoff; exhaustion raises a typed
      :class:`~repro_torch.core.errors.TransientFailure`.  On the
      ``devices=`` path exhaustion instead *degrades*: the sweep falls
      back down :func:`repro_torch.runtime.elastic.sweep_degradation_ladder`
      to the layout's first device alone — bit-identical results, only
      slower (``FleetResult.mesh_degraded``).  Without a policy a failure
      propagates raw.  Nothing ever moves to the CPU.
    * ``checkpoint_dir`` (requires ``hw_chunk``) persists every completed
      chunk's raw plane (:class:`repro_torch.checkpoint.SweepCheckpoint`);
      a killed sweep re-run with the same arguments restores completed
      chunks and recomputes only the missing ones
      (``chunks_restored``/``chunks_computed``), bit-identically.  The
      argument arrays and the log are the JAX reference's, so a sweep log
      written by either package resumes in the other.
    * Per-chunk wall times, net of set-up, feed a running-median
      straggler detector; flagged chunk indices are reported in
      ``FleetResult.straggler_chunks``.
    * ``hooks`` is a duck-typed fault seam (``before_chunk_compute(i,
      device_count=...)`` may raise; ``poison_plane(plane, h0)`` may
      corrupt a raw plane, ``h0`` the chunk's global hardware offset) used
      by :class:`repro_torch.testing.faults.FaultInjector`; every raw plane
      then passes the finite guard, so poisoned cells are quarantined with
      global (g, h, c) provenance (``FleetResult.quarantine``) and can
      never win the argmin or enter a Pareto front.
    """
    if not irs:
        raise ValueError("empty fleet")
    if hw_chunk is not None:
        if devices is not None:
            raise ValueError(
                "hw_chunk cannot be combined with devices: the sharded "
                "program already splits the hardware axis across the mesh"
            )
        if hw_chunk <= 0:
            raise ValueError(f"hw_chunk must be positive, got {hw_chunk}")
    if checkpoint_dir is not None and hw_chunk is None:
        raise ValueError(
            "checkpoint_dir requires hw_chunk: completed hardware-axis "
            "chunks are the checkpoint grain"
        )
    # The device layout: one device, or the hardware-axis split.
    mesh = (resolve_device(device),) if devices is None else hardware_mesh(devices)
    if config_space is None:
        config_space = default_config_space()
    graphs = [as_graph(ir) for ir in irs]

    if isinstance(groupings, (list, tuple)):
        if len(groupings) != len(graphs):
            raise ValueError(
                f"{len(groupings)} grouping specs for {len(graphs)} graphs"
            )
        specs = list(groupings)
    else:
        specs = [groupings] * len(graphs)

    # Per-graph grouping resolution + SRAM prefilter (padded-E cut rows).
    edge_bucket = bucket_size(
        max(g.n_edges for g in graphs), EDGE_BUCKET_FLOOR
    )
    node_bucket = bucket_size(
        max(g.n_nodes for g in graphs), NODE_BUCKET_FLOOR
    )
    padded = [pad_graph(g, n_nodes=node_bucket, n_edges=edge_bucket)
              for g in graphs]
    cuts: list[np.ndarray] = []
    pruned: list[int] = []
    provenances: list[str] = []
    for g, pg, spec in zip(graphs, padded, specs):
        cb, provenance = groupings_batch(
            g, spec, sram_budget_words=sram_budget_words,
            with_provenance=True,
        )
        cb = pad_cuts_batch(cb, edge_bucket)
        provenances.append(provenance)
        n_pruned = 0
        if np.isfinite(sram_budget_words):
            max_int = fusion.padded_max_intermediate_batch(pg, cb)
            keep = max_int <= sram_budget_words
            n_pruned = int(cb.shape[0] - keep.sum())
            if not keep.any():
                raise InfeasibleBudgetError(
                    f"{g.name}: no grouping fits the SRAM budget "
                    f"({sram_budget_words:.0f} words; the cheapest offered "
                    f"grouping needs {max_int.min():.0f})",
                    min_feasible_budget_words=float(max_int.min()),
                )
            cb = cb[keep]
        cuts.append(cb)
        pruned.append(n_pruned)
    counts = [cb.shape[0] for cb in cuts]
    cut_bucket = bucket_size(max(counts), CUT_BUCKET_FLOOR)
    cuts = [pad_cuts_batch(cb, edge_bucket, cut_bucket) for cb in cuts]

    hw_rows = np.stack([c.as_row() for c in config_space])
    area_consts = M.area_consts_of_space(config_space)
    H = hw_rows.shape[0]

    # A split pads H to a device-count multiple (padded rows are copies of
    # config 0 — valid arithmetic, sliced off below before composition).
    hw_swept = hw_rows
    D = len(mesh)
    H_padded = -(-H // D) * D
    if H_padded > H:
        hw_swept = np.concatenate(
            [hw_rows, np.repeat(hw_rows[:1], H_padded - H, axis=0)]
        )

    args = (
        np.stack([pg.feat for pg in padded]),
        np.stack([pg.esrc for pg in padded]),
        np.stack([pg.edst for pg in padded]),
        np.stack([pg.ewords for pg in padded]),
        np.stack([pg.src_mask for pg in padded]),
        np.stack([pg.sink_mask for pg in padded]),
        np.stack(cuts),
        hw_swept,
        area_consts,
        np.stack([pg.node_mask for pg in padded]),
        np.stack([pg.edge_mask for pg in padded]),
    )
    M.assert_exact_f64(args[0], what="fleet feature table")
    M.assert_exact_f64(args[3], what="fleet edge words")
    if abort_check is not None:
        abort_check()

    hook_before = (
        getattr(hooks, "before_chunk_compute", None)
        if hooks is not None else None
    )
    hook_poison = (
        getattr(hooks, "poison_plane", None) if hooks is not None else None
    )

    def _compute(chunk_index, c_args, c_mesh, h0, d_count):
        """One chunk's set-up + sweep, under the retry policy + hooks."""

        def attempt():
            if hook_before is not None:
                hook_before(chunk_index, device_count=d_count)
            return _run_fleet_sweep(c_args, c_mesh)

        if retry_policy is None:
            plane, dt_c, dt_s = attempt()
        else:
            plane, dt_c, dt_s = retry_policy.call(
                attempt, describe=f"hw chunk {chunk_index}"
            )
        if hook_poison is not None:
            plane = hook_poison(plane, h0)
        return plane, dt_c, dt_s

    mesh_degraded = False
    chunks_restored = 0
    straggler_chunks: tuple[int, ...] = ()
    if hw_chunk is None:
        chunks_computed = 1
        try:
            raw, compile_seconds, sweep_seconds = _compute(
                0, args, mesh, 0, D
            )
        except TransientFailure:
            from ..runtime.elastic import sweep_degradation_ladder

            ladder = sweep_degradation_ladder(devices)[1:]
            if not ladder:
                raise
            # The layout is sick (the sweep kept failing through the retry
            # budget): degrade to the ladder's single-device rung, the
            # layout's first device.  No raw row depends on another, so
            # the salvaged result is bit-identical to the split sweep.
            mesh_degraded = True
            args = args[:7] + (hw_rows,) + args[8:]
            raw, compile_seconds, sweep_seconds = _compute(
                0, args, mesh[:1], 0, 1
            )
    else:
        # Resumable chunked sweep: one sweep per <=hw_chunk-row slice of
        # the config space, abort_check between slices.  With
        # ``checkpoint_dir`` every completed plane is durable before the
        # loop advances, so a kill at ANY boundary resumes with
        # exactly-once recomputation.
        from ..runtime.fault_tolerance import StragglerDetector

        restored: dict[int, np.ndarray] = {}
        ckpt = None
        if checkpoint_dir is not None:
            from ..checkpoint import SweepCheckpoint, sweep_fingerprint

            ckpt = SweepCheckpoint(checkpoint_dir)
            restored = ckpt.load(sweep_fingerprint(args, hw_chunk))
        detector = StragglerDetector(min_deadline_s=0.0)
        compile_seconds = sweep_seconds = 0.0
        chunks_computed = 0
        stragglers: list[int] = []
        planes = []
        for ci, h0 in enumerate(range(0, H, hw_chunk)):
            if abort_check is not None and h0:
                abort_check()
            plane = restored.get(h0)
            if plane is not None:
                planes.append(plane)
                chunks_restored += 1
                continue
            chunk_args = (
                args[:7] + (hw_rows[h0:h0 + hw_chunk],) + args[8:]
            )
            t_chunk = time.perf_counter()
            plane, dt_c, dt_s = _compute(
                ci, chunk_args, mesh, h0, D
            )
            # Straggler detection on wall time net of set-up; the
            # detector needs 5 samples before it flags.
            dt_wall = time.perf_counter() - t_chunk - dt_c
            if detector.is_straggler(dt_wall):
                stragglers.append(ci)
            detector.observe(dt_wall)
            if ckpt is not None:
                ckpt.append_chunk(h0, plane)
            planes.append(plane)
            chunks_computed += 1
            compile_seconds += dt_c
            sweep_seconds += dt_s
        straggler_chunks = tuple(stragglers)
        raw = np.concatenate(planes, axis=1)
    out = M.compose_metrics(raw[:, :H], hw_rows)  # (G, H, C_b, 4)
    # Finite guard over the whole fleet's raw plane: poisoned cells are
    # quarantined per graph before any argmin/Pareto selection.
    poison_all = M.poison_mask(raw[:, :H])  # (G, H, C_b)
    any_poison = bool(poison_all.any())
    fleet_cells: list[QuarantinedCell] = []
    n_cand = H * sum(counts)
    fleet_cps = n_cand / max(sweep_seconds, 1e-9)
    results = []
    for gi, g in enumerate(graphs):
        C = counts[gi]
        g_poison = None
        g_quar = None
        if any_poison:
            pm = poison_all[gi, :, :C]
            if pm.any():
                cells = _quarantine_cells(raw[gi, :H, :C], pm, graph=gi)
                g_quar = QuarantineReport(cells=cells)
                fleet_cells.extend(cells)
                g_poison = pm
        results.append(
            _best_flow_result(
                out[gi, :, :C],  # padded candidate rows sliced off
                cuts[gi][:C, : g.n_edges],
                g, config_space, constraints,
                n_pruned=pruned[gi],
                compile_seconds=0.0,  # the one fleet set-up, see FleetResult
                sweep_seconds=sweep_seconds,
                candidates_per_second=fleet_cps,  # the shared sweep's rate
                search_engine=provenances[gi],
                err_prefix=f"{g.name}: ",
                pareto=pareto,
                poison=g_poison,
                quarantine=g_quar,
            )
        )
    return FleetResult(
        results=tuple(results),
        n_graphs=len(graphs),
        n_candidates=n_cand,
        compile_seconds=compile_seconds,
        sweep_seconds=sweep_seconds,
        candidates_per_second=fleet_cps,
        device_count=1 if mesh_degraded else D,
        quarantine=(
            QuarantineReport(cells=tuple(fleet_cells))
            if fleet_cells
            else None
        ),
        chunks_computed=chunks_computed,
        chunks_restored=chunks_restored,
        straggler_chunks=straggler_chunks,
        mesh_degraded=mesh_degraded,
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
