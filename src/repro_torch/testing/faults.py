"""Fault-injection harness for the planning service.

Two halves:

* **Corrupt-graph builders** — clones of a valid :class:`GraphIR` with one
  invariant broken (a cycle-inducing edge, negative words, NaN features,
  dangling endpoints, duplicate edges).  ``GraphIR.__post_init__``
  validates at construction, so corruption is applied *after* the fact via
  ``object.__new__``/``object.__setattr__`` — exactly what a
  deserialisation bug or a buggy graph transform would produce.  The
  service's admission re-validation (:meth:`GraphIR.validate`) must catch
  every one of them with a typed :class:`GraphValidationError`.

* **FaultInjector** — a duck-typed hook object for
  :class:`repro_torch.core.service.PlanningService` and
  :func:`repro_torch.core.flow.run_fleet`: transient sweep failures (to
  exercise retry-with-backoff), search stalls (to exercise
  :class:`DeadlineExceeded`), eviction storms (to prove correctness is
  cache-independent; the port caches no executable, so a storm only
  zeroes the sweep accounting), shard failures, sick device layouts and
  poisoned cells.

:func:`chaos_requests` composes both into a reproducible mixed request
stream for the chaos tests and the service phase of ``chip_smoke.py``.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Iterator

import numpy as np

from ..core import flow, frontend
from ..core.arch import Constraints
from ..core.ir import EdgeSpec, GraphIR
from ..core.service import PlanRequest


# ---------------------------------------------------------------------------
# corrupt-graph builders
# ---------------------------------------------------------------------------


def _raw_clone(g: GraphIR, *, nodes=None, edges=None, name=None) -> GraphIR:
    """Clone ``g`` WITHOUT running ``__post_init__`` validation — the
    vehicle for building deliberately-invalid graphs."""
    bad = object.__new__(GraphIR)
    object.__setattr__(bad, "name", g.name if name is None else name)
    object.__setattr__(bad, "nodes", g.nodes if nodes is None else tuple(nodes))
    object.__setattr__(bad, "edges", g.edges if edges is None else tuple(edges))
    return bad


def _raw_edge(src: int, dst: int, words) -> EdgeSpec:
    e = object.__new__(EdgeSpec)
    object.__setattr__(e, "src", src)
    object.__setattr__(e, "dst", dst)
    object.__setattr__(e, "words", words)
    return e


def corrupt_graph_cyclic(g: GraphIR) -> GraphIR:
    """Add a back edge (dst <= src), breaking the topological/acyclicity
    invariant."""
    return _raw_clone(
        g, edges=g.edges + (_raw_edge(g.n_nodes - 1, 0, 64),),
        name=f"{g.name}/cyclic",
    )


def corrupt_graph_negative_words(g: GraphIR) -> GraphIR:
    """Flip one edge's word count negative."""
    e0 = g.edges[0]
    return _raw_clone(
        g, edges=(_raw_edge(e0.src, e0.dst, -abs(e0.words)),) + g.edges[1:],
        name=f"{g.name}/negwords",
    )


def corrupt_graph_nan_feature(g: GraphIR) -> GraphIR:
    """Poison one layer's channel count with NaN (a float, not an int —
    doubly invalid)."""
    n0 = g.nodes[0]
    poisoned = object.__new__(type(n0))
    for f in dataclasses.fields(n0):
        object.__setattr__(poisoned, f.name, getattr(n0, f.name))
    object.__setattr__(poisoned, "n_out", float("nan"))
    return _raw_clone(
        g, nodes=(poisoned,) + g.nodes[1:], name=f"{g.name}/nan",
    )


def corrupt_graph_dangling(g: GraphIR) -> GraphIR:
    """Add an edge whose dst points past the last node."""
    return _raw_clone(
        g, edges=g.edges + (_raw_edge(0, g.n_nodes + 3, 64),),
        name=f"{g.name}/dangling",
    )


def corrupt_graph_duplicate_edge(g: GraphIR) -> GraphIR:
    """Duplicate the first edge."""
    e0 = g.edges[0]
    return _raw_clone(
        g, edges=g.edges + (_raw_edge(e0.src, e0.dst, e0.words),),
        name=f"{g.name}/dup",
    )


CORRUPTIONS = (
    corrupt_graph_cyclic,
    corrupt_graph_negative_words,
    corrupt_graph_nan_feature,
    corrupt_graph_dangling,
    corrupt_graph_duplicate_edge,
)


# ---------------------------------------------------------------------------
# fault injector (duck-typed PlanningService hooks)
# ---------------------------------------------------------------------------


class InjectedTransient(RuntimeError):
    """The injected stand-in for a transient sweep failure (a failed
    launch, a race).  Deliberately NOT an EvaluatorError: the
    service must classify it as retryable."""


class InjectedShardFailure(RuntimeError):
    """The injected stand-in for a shard/chunk compute failure (a sick
    device, a collective timeout).  Also NOT an EvaluatorError: the
    per-chunk :class:`repro_torch.core.errors.RetryPolicy` must classify it as
    retryable and salvage the sweep."""


class FaultInjector:
    """Configurable fault hooks for :class:`PlanningService`.

    ``transient_sweeps``      — the first N ``before_sweep`` calls raise
                                :class:`InjectedTransient` (retry path);
    ``transient_every``       — additionally every k-th sweep raises once
                                (0 = off), so faults recur under load;
    ``stall_every``/``stall_seconds`` — every k-th ``before_search`` call
                                sleeps, simulating a stalled search so
                                tight deadlines trip DeadlineExceeded;
    ``evict_every``           — every k-th tick clears the sweep
                                accounting (an eviction storm; no
                                executable is cached here): plans must be
                                bit-identical with or without it;
    ``chunk_stall_seconds``   — every ``before_chunk`` call (the chunked
                                sweep's between-chunk preemption point)
                                sleeps, stretching the sweep so the
                                cancellation tests can land a cancel
                                mid-flight and measure how fast the next
                                chunk boundary honours it;
    ``corrupt_audit_every``   — every k-th shadow audit perturbs the
                                oracle's energy by +1 nJ (0 = off), so
                                the AuditMismatch path is exercisable
                                without a real evaluator bug;
    ``shard_fail_chunks``     — the first N ``before_chunk_compute``
                                calls raise :class:`InjectedShardFailure`
                                (chunk-salvage retry path);
    ``shard_fail_every``      — additionally every k-th chunk compute
                                raises once (0 = off);
    ``mesh_fail_sweeps``      — the first N chunk computes *on a multi-
                                device mesh* raise, driving the sweep
                                down the single-device degradation rung;
    ``poison_cell``           — a ``(g, h, c)`` triple whose raw cost row
                                ``poison_plane`` overwrites with
                                ``poison_value`` (quarantine path);
    ``poison_value``          — what to write there (default NaN).
    """

    def __init__(
        self,
        *,
        transient_sweeps: int = 0,
        transient_every: int = 0,
        stall_every: int = 0,
        stall_seconds: float = 0.0,
        evict_every: int = 0,
        chunk_stall_seconds: float = 0.0,
        corrupt_audit_every: int = 0,
        shard_fail_chunks: int = 0,
        shard_fail_every: int = 0,
        mesh_fail_sweeps: int = 0,
        poison_cell: tuple | None = None,
        poison_value: float = float("nan"),
        sleep=time.sleep,
    ):
        self.transient_sweeps = int(transient_sweeps)
        self.transient_every = int(transient_every)
        self.stall_every = int(stall_every)
        self.stall_seconds = float(stall_seconds)
        self.evict_every = int(evict_every)
        self.chunk_stall_seconds = float(chunk_stall_seconds)
        self.corrupt_audit_every = int(corrupt_audit_every)
        self.shard_fail_chunks = int(shard_fail_chunks)
        self.shard_fail_every = int(shard_fail_every)
        self.mesh_fail_sweeps = int(mesh_fail_sweeps)
        self.poison_cell = (
            None if poison_cell is None else tuple(int(v) for v in poison_cell)
        )
        self.poison_value = float(poison_value)
        self.sleep = sleep
        self.counts = collections.Counter()

    # -- PlanningService hook points ------------------------------------

    def on_tick(self, n: int) -> None:
        self.counts["ticks"] += 1
        if self.evict_every and n % self.evict_every == 0:
            self.counts["evict_storms"] += 1
            flow.clear_sweep_cache()

    def before_search(self, adm) -> None:
        self.counts["searches"] += 1
        if self.stall_every and self.counts["searches"] % self.stall_every == 0:
            self.counts["stalls"] += 1
            self.sleep(self.stall_seconds)

    def before_sweep(self, group_size: int) -> None:
        self.counts["sweeps"] += 1
        if self.transient_sweeps > 0:
            self.transient_sweeps -= 1
            self.counts["injected_transients"] += 1
            raise InjectedTransient("injected transient sweep failure")
        if self.transient_every and (
            self.counts["sweeps"] % self.transient_every == 0
        ):
            self.counts["injected_transients"] += 1
            raise InjectedTransient("injected periodic sweep failure")

    def before_chunk(self) -> None:
        self.counts["chunks"] += 1
        if self.chunk_stall_seconds > 0:
            self.sleep(self.chunk_stall_seconds)

    def before_chunk_compute(self, chunk_index: int, *,
                             device_count: int = 1) -> None:
        """run_fleet's per-chunk compute hook: raise here to simulate a
        shard failure (retried by the chunk RetryPolicy) or a sick mesh
        (``device_count > 1`` — drives the degradation ladder)."""
        self.counts["chunk_computes"] += 1
        if self.mesh_fail_sweeps > 0 and device_count > 1:
            self.mesh_fail_sweeps -= 1
            self.counts["injected_mesh_failures"] += 1
            raise InjectedShardFailure(
                f"injected mesh failure (devices={device_count})"
            )
        if self.shard_fail_chunks > 0:
            self.shard_fail_chunks -= 1
            self.counts["injected_shard_failures"] += 1
            raise InjectedShardFailure(
                f"injected shard failure at chunk {chunk_index}"
            )
        if self.shard_fail_every and (
            self.counts["chunk_computes"] % self.shard_fail_every == 0
        ):
            self.counts["injected_shard_failures"] += 1
            raise InjectedShardFailure(
                f"injected periodic shard failure at chunk {chunk_index}"
            )

    def poison_plane(self, plane, h0: int):
        """run_fleet's raw-plane hook: overwrite ``poison_cell``'s cost
        row with ``poison_value`` when that cell lives in this chunk —
        the finite guard must quarantine it before any selection."""
        if self.poison_cell is None:
            return plane
        g, h, c = self.poison_cell
        if h0 <= h < h0 + plane.shape[1]:
            plane = np.array(plane, copy=True)
            plane[g, h - h0, c, :] = self.poison_value
            self.counts["poisoned_cells"] += 1
        return plane

    def corrupt_audit(self, metrics):
        self.counts["audits_seen"] += 1
        if self.corrupt_audit_every and (
            self.counts["audits_seen"] % self.corrupt_audit_every == 0
        ):
            self.counts["audits_corrupted"] += 1
            return dataclasses.replace(
                metrics, energy_nj=metrics.energy_nj + 1.0
            )
        return metrics


# ---------------------------------------------------------------------------
# chaos request stream
# ---------------------------------------------------------------------------


def _valid_graphs() -> list[GraphIR]:
    """Small, fast-to-search workloads spanning chain and DAG searches."""
    from ..core.ir import as_graph, encoder_decoder_ir, residual_block_ir

    return [
        as_graph(frontend.mlp_block_graph()),
        as_graph(residual_block_ir()),
        as_graph(encoder_decoder_ir()),
    ]


def chaos_requests(
    n: int, *, seed: int = 0, faulty_fraction: float = 0.4
) -> Iterator[tuple[str, PlanRequest]]:
    """Yield ``n`` labelled requests mixing valid and hostile inputs.

    Labels: ``valid``, ``valid-budget`` (tight-but-feasible budget),
    ``corrupt:<builder>``, ``nan-budget``, ``negative-budget``,
    ``zero-deadline``, ``tight-deadline``, ``impossible-constraints``.
    Deterministic per ``seed``; roughly ``faulty_fraction`` of the stream
    is hostile."""
    rng = np.random.default_rng(seed)
    graphs = _valid_graphs()
    hostile = (
        ["corrupt:" + c.__name__ for c in CORRUPTIONS]
        + ["nan-budget", "negative-budget", "zero-deadline",
           "tight-deadline", "impossible-constraints"]
    )
    for _ in range(n):
        g = graphs[int(rng.integers(len(graphs)))]
        if rng.random() >= faulty_fraction:
            if rng.random() < 0.5:
                yield "valid", PlanRequest(graph=g)
            else:
                yield "valid-budget", PlanRequest(
                    graph=g, sram_budget_words=float(rng.integers(1e5, 4e6))
                )
            continue
        kind = hostile[int(rng.integers(len(hostile)))]
        if kind.startswith("corrupt:"):
            builder = CORRUPTIONS[
                ["corrupt:" + c.__name__ for c in CORRUPTIONS].index(kind)
            ]
            yield kind, PlanRequest(graph=builder(g))
        elif kind == "nan-budget":
            yield kind, PlanRequest(graph=g, sram_budget_words=float("nan"))
        elif kind == "negative-budget":
            yield kind, PlanRequest(graph=g, sram_budget_words=-64.0)
        elif kind == "zero-deadline":
            yield kind, PlanRequest(graph=g, deadline_seconds=0.0)
        elif kind == "tight-deadline":
            yield kind, PlanRequest(graph=g, deadline_seconds=1e-4)
        else:  # impossible-constraints: nothing can cost < 1 word of BW
            yield kind, PlanRequest(
                graph=g,
                constraints=Constraints(
                    max_bandwidth_words=0.5,
                    max_latency_cycles=1.0,
                    max_energy_nj=1.0,
                    max_area_um2=1.0,
                ),
            )
