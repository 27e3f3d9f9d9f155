"""Deadline-aware planning service over the fleet evaluator.

:func:`repro_torch.core.flow.run_fleet` is a batch engine: hand it a list of
graphs and it sweeps the whole (graph x hardware x grouping) cross-product
at once on the device.  This module wraps it as a *service*: callers submit
``(graph, config space, SRAM budget, deadline)`` requests one at a time and
always get a typed :class:`PlanResponse` back — a valid plan or a typed
rejection from :mod:`repro_torch.core.errors`, never a raw exception and never a
silently wrong answer.

The serving moves, in the order a request meets them:

1. **Admission** (:meth:`PlanningService.submit`): the graph is
   re-validated (:meth:`repro_torch.core.ir.GraphIR.validate` — corrupt objects
   that dodged ``__post_init__`` are caught here), the budget/deadline
   checked for NaN/negative values, and the config space checked for
   shared area constants.  A full queue sheds the request with
   :class:`~repro_torch.core.errors.ServiceOverloaded` instead of growing
   unboundedly.
2. **Plan cache**: admitted requests first consult a bounded LRU keyed on
   ``(graph, budget, constraints, config space)`` — :class:`GraphIR` is a
   frozen, hashable dataclass, so the graph itself is the key.  Only
   *non-degraded* responses are cached (a degraded plan must not shadow
   the exact plan a later, slacker deadline could afford).
3. **Degradation ladder** (:meth:`PlanningService.tick`): each request's
   grouping search runs at the highest rung its remaining deadline
   affords, estimated by per-rung EWMAs of observed search cost::

       exact   flow.groupings_batch(g, "search")   certified when the
                                                   engine is exact
       beam    fusion.beam_merge_cuts              heuristic, >= greedy
       greedy  fusion.greedy_merge_cuts            heuristic
       lbl     fusion.layer_by_layer_cuts          always feasible

   The exact rung resolves through the same ``groupings_batch`` call
   :func:`~repro_torch.core.flow.run_fleet` uses offline, so a non-degraded
   service plan is **bit-identical** to the offline answer.  Every response
   stamps the engine provenance,
   ``exact``/``degraded`` flags, and a monotone ``quality_bound``: the
   rung's achieved group cost over the fully-fused lower bound
   (cutting an edge only ever adds a DRAM round-trip, so the all-uncut
   cost is admissible); the ratio is >= 1 and non-decreasing down the
   ladder.
4. **Micro-batched sweep**: the tick coalesces resolved requests by
   ``(budget, constraints, config space)`` and evaluates each group as ONE
   ``run_fleet`` sweep with per-graph explicit cut batches — one staging
   of the inputs for the whole group.  A group member
   whose request is individually infeasible falls back to a singleton
   sweep so it cannot poison its neighbours.
5. **Retry with backoff**: non-evaluator exceptions from the sweep
   (a failed launch, injected faults) are retried up to
   ``max_retries`` with exponential backoff; exhaustion returns a
   :class:`~repro_torch.core.errors.TransientFailure` response.  Typed
   evaluator errors are *not* retried — they are deterministic verdicts.

6. **Write-ahead journal** (:mod:`repro_torch.core.journal`): with a
   ``journal_dir`` every admission, tick boundary, response, and
   cancellation is fsync'd to the WAL *before* the in-memory state
   changes, and :meth:`PlanningService.recover` replays snapshot + WAL
   back to the exact pre-crash state — already-served responses are
   restored bit-identically and only in-flight requests re-run.
7. **Cooperative cancellation** (:meth:`PlanningService.cancel`): a
   cancelled request still queued is answered with
   :class:`~repro_torch.core.errors.RequestCancelled` at the next tick; one
   inside a sweep stops at the next ``hw_chunk`` boundary of the chunked
   fleet sweep — never mid-sweep.  Deadlines are enforced at the same
   chunk granularity.
8. **Circuit breaker**: ``breaker_threshold`` consecutive
   ``TransientFailure`` verdicts trip the breaker OPEN — the ladder is
   forced to its "lbl" floor (cheap, always-feasible plans) for
   ``breaker_cooldown_seconds``, then a HALF_OPEN probe runs at full
   quality and a success re-closes it (:class:`BreakerState`).
9. **Bucket-affinity batching**: the tick's micro-batch is formed from
   the FIFO head plus queued requests sharing its ``(node bucket, edge
   bucket, budget, constraints, config space)`` affinity key, so one tick
   sweeps one group across heterogeneous traffic; the head is always
   served, so no key can starve.
10. **Shadow audit**: a counter-based sample of served plans
    (``shadow_audit_rate``) is re-scored against the scalar oracle
    (:func:`repro_torch.core.metrics.evaluate_ref`); any divergence replaces
    the answer with a typed
    :class:`~repro_torch.core.errors.AuditMismatch` — the fast path is never
    allowed to be silently wrong.

:class:`AsyncPlanningService` wraps all of the above in a worker thread
behind a ``concurrent.futures`` interface with heartbeat/watchdog
liveness and drain-on-shutdown.

Every sweep runs on the service's ``device`` (default ``"cuda"``, raising
without CUDA; ``device="cpu"`` on the CPU), resolved to an explicit
``torch.device`` at construction so a worker thread never depends on the
current CUDA device.  Nothing moves to the CPU on its own.

Fault injection: a duck-typed ``faults`` object (see
:mod:`repro_torch.testing.faults`) may define ``on_tick(n)``,
``before_search(request)``, ``before_sweep(group_size)`` and
``before_chunk()`` hooks, called at the matching points.
"""
from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import enum
import os
import queue as queue_mod
import threading
import time
from typing import Callable, Sequence

import numpy as np
import torch

from ..device import resolve_device
from . import flow, fusion
from . import journal as journal_mod
from .arch import Constraints, DLAConfig, default_config_space
from .errors import (
    AuditMismatch,
    ConfigValidationError,
    DeadlineExceeded,
    EvaluatorError,
    GraphValidationError,
    RequestCancelled,
    RetryPolicy,
    ServiceOverloaded,
    TransientFailure,
)
from .ir import GraphIR, NetworkIR, as_graph, bucket_size

# Degradation ladder, most expensive / highest quality first.
RUNGS = ("exact", "beam", "greedy", "lbl")

# Fraction of the remaining deadline a rung's estimated cost may consume;
# the slack absorbs the sweep + bookkeeping that follow the search.
_RUNG_SAFETY = 0.8

# EWMA smoothing for per-rung search-cost estimates (higher = faster
# adaptation to the current workload mix).
_EWMA_ALPHA = 0.3


class BreakerState(enum.Enum):
    """Circuit-breaker states (the classic three-state machine).

    CLOSED: normal service.  OPEN: ``breaker_threshold`` consecutive
    ``TransientFailure`` verdicts tripped the breaker — the deadline
    ladder is pinned to its "lbl" floor until the cooldown elapses.
    HALF_OPEN: cooldown elapsed; the next request probes at full quality,
    success re-closes, failure re-opens.
    """

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"


class _SweepAborted(EvaluatorError):
    """Internal: the chunked sweep's abort check fired (a group member was
    cancelled or ran out of deadline).  Never escapes the service — the
    tick converts it into per-request RequestCancelled/DeadlineExceeded
    responses and re-sweeps the survivors."""


@dataclasses.dataclass(frozen=True)
class PlanRequest:
    """One planning query: find the min-energy (hardware x fusion plan)
    point for ``graph`` under ``sram_budget_words``, within
    ``deadline_seconds`` of submission.  ``config_space``/``constraints``
    default to the service-wide ones."""

    graph: NetworkIR | GraphIR
    sram_budget_words: float = float("inf")
    deadline_seconds: float = float("inf")
    constraints: Constraints | None = None
    config_space: tuple[DLAConfig, ...] | None = None


@dataclasses.dataclass(frozen=True)
class PlanResponse:
    """The service's answer — exactly one of ``plan``/``error`` is set.

    ``engine`` is the grouping-search provenance ("chain_dp",
    "frontier_dp", "exhaustive", "beam", "greedy", "lbl"); ``exact`` says
    the grouping is a certified optimum, ``degraded`` that the deadline
    ladder picked a rung below exact.  ``quality_bound`` is the rung's
    achieved group cost over the fully-fused admissible lower bound
    (>= 1.0, monotone non-decreasing down the ladder; NaN on errors).
    """

    request_id: int
    ok: bool
    plan: flow.FlowResult | None = None
    error: EvaluatorError | None = None
    engine: str = ""
    rung: str = ""
    exact: bool = False
    degraded: bool = False
    quality_bound: float = float("nan")
    from_cache: bool = False
    latency_seconds: float = 0.0

    @property
    def error_type(self) -> str:
        """Class name of the typed rejection, "" on success."""
        return type(self.error).__name__ if self.error is not None else ""


@dataclasses.dataclass
class _Admitted:
    """Internal queue entry: a validated request plus submission state."""

    request_id: int
    g: GraphIR
    budget: float
    deadline: float  # absolute clock() value, inf when unconstrained
    constraints: Constraints
    config_space: tuple[DLAConfig, ...]
    submitted_at: float
    cache_key: tuple


@dataclasses.dataclass
class _Resolved:
    """A queue entry whose grouping search ran: ready to sweep."""

    adm: _Admitted
    cuts: np.ndarray  # (C, E) explicit batch for run_fleet
    engine: str
    rung: str
    exact: bool
    quality_bound: float


def _lower_bound_cost(g: GraphIR) -> float:
    """Fully-fused group cost — admissible: cutting an edge only adds a
    DRAM round-trip, so no grouping costs less."""
    return fusion._graph_cost(g, np.zeros(g.n_edges, dtype=bool))


class PlanningService:
    """Deadline-aware, micro-batching front end over ``run_fleet``.

    Synchronous by design: ``submit()`` enqueues (or answers immediately
    from cache / with a typed rejection) and ``tick()`` drains one
    micro-batch; ``plan()`` is the one-shot convenience.  All shared
    state is touched from the caller's thread — the thread-safety story
    is the sweep accounting's lock (:mod:`repro_torch.core.flow`) and the
    plan cache's, not this class.
    """

    def __init__(
        self,
        *,
        config_space: Sequence[DLAConfig] | None = None,
        constraints: Constraints = Constraints(),
        max_queue_depth: int = 256,
        max_batch: int = 16,
        plan_cache_capacity: int = 512,
        max_retries: int = 3,
        backoff_seconds: float = 0.05,
        retry_policy: RetryPolicy | None = None,
        checkpoint_dir=None,
        faults=None,
        clock: Callable[[], float] = time.monotonic,
        journal_dir=None,
        journal_fsync: bool = True,
        snapshot_every: int = 64,
        hw_chunk: int | None = None,
        affinity_batching: bool = True,
        breaker_threshold: int = 0,
        breaker_cooldown_seconds: float = 1.0,
        shadow_audit_rate: float = 0.0,
        device: "str | torch.device" = "cuda",
    ):
        """Service-wide defaults: design space, constraints, queue/batch/
        cache bounds, retry policy, fault hooks, and the clock (injectable
        for deterministic tests).

        ``journal_dir`` enables the write-ahead log (``journal_fsync``
        trades durability for test speed; a snapshot compacts the WAL
        every ``snapshot_every`` records).  ``hw_chunk`` splits every
        sweep into resumable hardware-axis chunks so cancellation and
        deadlines act between chunks.  ``affinity_batching`` groups the
        tick's micro-batch by shape-bucket affinity.  A positive
        ``breaker_threshold`` arms the circuit breaker;
        ``shadow_audit_rate`` (0..1) re-scores that fraction of served
        plans against the scalar oracle.

        ``retry_policy`` overrides the :class:`RetryPolicy` built from
        ``max_retries``/``backoff_seconds``; the ONE policy governs both
        request-level retries and the sweep's per-chunk salvage.
        ``checkpoint_dir`` (requires ``hw_chunk``) persists completed
        sweep chunks so a killed sweep resumes without recomputing them —
        pair it with ``journal_dir`` and :meth:`recover`.

        ``device`` is where every sweep runs; it defaults to ``"cuda"``
        and raises without CUDA — pass ``device="cpu"`` for the CPU."""
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.config_space = tuple(
            config_space if config_space is not None else default_config_space()
        )
        self.constraints = constraints
        self.max_queue_depth = int(max_queue_depth)
        self.max_batch = int(max_batch)
        self.max_retries = int(max_retries)
        self.backoff_seconds = float(backoff_seconds)
        self.retry_policy = (
            retry_policy
            if retry_policy is not None
            else RetryPolicy(
                max_retries=self.max_retries,
                backoff_seconds=self.backoff_seconds,
            )
        )
        self.faults = faults
        self.clock = clock
        self.hw_chunk = None if hw_chunk is None else int(hw_chunk)
        if checkpoint_dir is not None and self.hw_chunk is None:
            raise ValueError(
                "checkpoint_dir requires hw_chunk: completed hardware-axis "
                "chunks are the checkpoint grain"
            )
        self.checkpoint_dir = checkpoint_dir
        self.affinity_batching = bool(affinity_batching)

        self._queue: collections.deque[_Admitted] = collections.deque()
        self._responses: dict[int, PlanResponse] = {}
        # Every rid ever answered — outlives collect()'s pop so a late
        # cancel() of an already-served request stays a no-op.
        self._done: set[int] = set()
        self._next_id = 0
        self._ticks = 0
        # Cooperative-cancellation flags.  A plain set: adds/discards are
        # atomic under the GIL, and the async transport's caller thread
        # must be able to flag a cancel while the worker is mid-sweep so
        # the chunk-boundary abort check sees it immediately.
        self._cancelled: set[int] = set()

        self._plan_cache: "collections.OrderedDict[tuple, PlanResponse]" = (
            collections.OrderedDict()
        )
        self.plan_cache_capacity = int(plan_cache_capacity)
        self._cache_stats = {"hits": 0, "misses": 0, "evictions": 0}
        # The async transport reads stats from the caller thread while the
        # worker mutates the LRU, and an unguarded move_to_end/popitem interleave
        # can corrupt the OrderedDict.
        self._plan_cache_lock = threading.Lock()

        # Per-rung EWMA of observed grouping-search seconds, and one for
        # the shared sweep.  Zero-initialised: the first request always
        # tries the exact rung, and real costs take over from there.
        self._rung_ewma = {r: 0.0 for r in RUNGS}
        self._sweep_ewma = 0.0

        self._counters = collections.Counter()

        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_seconds = float(breaker_cooldown_seconds)
        self._breaker_state = BreakerState.CLOSED
        self._breaker_failures = 0
        self._breaker_open_until = 0.0

        self.shadow_audit_rate = float(shadow_audit_rate)
        self._audit_counter = 0

        self._journal: journal_mod.Journal | None = None
        if journal_dir is not None:
            self._journal = journal_mod.Journal(
                journal_dir, fsync=journal_fsync,
                snapshot_every=snapshot_every,
            )

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    def submit(self, request: PlanRequest) -> int:
        """Validate and enqueue one request; returns its request id.

        Invalid requests are *answered*, not raised: the typed rejection
        is recorded immediately and the id returned as usual.  Past the
        queue-depth bound the answer is a ``ServiceOverloaded`` rejection;
        a plan-cache hit is answered immediately without queueing.

        Example — enqueue a batch, then process it with :meth:`tick`::

            >>> from repro_torch.core.service import PlanningService, PlanRequest
            >>> from repro_torch.core.ir import residual_block_ir
            >>> svc = PlanningService(device="cpu")
            >>> rids = [svc.submit(PlanRequest(graph=residual_block_ir(),
            ...                                sram_budget_words=2e6))
            ...         for _ in range(3)]
            >>> svc.queue_depth
            3
            >>> svc.tick()
            3
            >>> svc.collect(rids[0]).ok
            True
        """
        rid = self._next_id
        self._next_id += 1
        self._counters["submitted"] += 1
        t0 = self.clock()
        try:
            adm = self._admit(rid, request, t0)
        except EvaluatorError as e:
            self._reject(rid, e, t0)
            return rid
        except Exception as e:  # malformed request objects, duck-typed junk
            self._reject(
                rid,
                GraphValidationError(
                    f"malformed request ({type(e).__name__}: {e})"
                ),
                t0,
            )
            return rid

        cached = self._cache_get(adm.cache_key)
        if cached is not None:
            resp = dataclasses.replace(
                cached,
                request_id=rid,
                from_cache=True,
                latency_seconds=self.clock() - t0,
            )
            self._record_response(resp)
            self._counters["cache_hits"] += 1
            return rid

        if len(self._queue) >= self.max_queue_depth:
            self._counters["shed"] += 1
            self._reject(
                rid,
                ServiceOverloaded(
                    f"queue depth {len(self._queue)} at capacity "
                    f"{self.max_queue_depth}"
                ),
                t0,
            )
            return rid

        # WAL: the admission is durable BEFORE the queue sees it — a crash
        # after this append re-runs the request, a crash before it means
        # the caller never got an id worth recovering.
        if self._journal is not None:
            self._journal.append("admit", journal_mod.enc_request(adm))
        self._queue.append(adm)
        return rid

    def _admit(self, rid: int, request: PlanRequest, t0: float) -> _Admitted:
        """Validate every field of a request; raises typed errors."""
        if not isinstance(request.graph, (GraphIR, NetworkIR)):
            raise GraphValidationError(
                f"request graph must be GraphIR or NetworkIR, "
                f"got {type(request.graph).__name__}"
            )
        g = as_graph(request.graph)
        g.validate()  # corrupt objects that dodged __post_init__

        budget = float(request.sram_budget_words)
        if np.isnan(budget) or budget <= 0:
            raise GraphValidationError(
                f"sram_budget_words must be positive, got {budget}"
            )

        deadline_s = float(request.deadline_seconds)
        if np.isnan(deadline_s) or deadline_s < 0:
            raise DeadlineExceeded(
                f"deadline_seconds must be non-negative, got {deadline_s}"
            )

        constraints = (
            request.constraints
            if request.constraints is not None
            else self.constraints
        )
        if request.config_space is not None:
            space = tuple(request.config_space)
            if not space or not all(
                isinstance(c, DLAConfig) for c in space
            ):
                raise ConfigValidationError(
                    "config_space must be a non-empty sequence of DLAConfig"
                )
        else:
            space = self.config_space
        # area_consts_of_space raises ConfigValidationError on a space
        # mixing area calibrations — reject at admission, not mid-sweep.
        from . import metrics as M

        M.area_consts_of_space(space)

        return _Admitted(
            request_id=rid,
            g=g,
            budget=budget,
            deadline=t0 + deadline_s if np.isfinite(deadline_s) else float("inf"),
            constraints=constraints,
            config_space=space,
            submitted_at=t0,
            cache_key=(
                g,
                budget,
                constraints.as_row().tobytes(),
                space,
            ),
        )

    def _record_response(self, resp: PlanResponse) -> None:
        """Journal (when enabled) then publish one response — the WAL is
        always at least as advanced as the state a crash destroys."""
        if self._journal is not None:
            self._journal.append("response", journal_mod.enc_response(resp))
        self._responses[resp.request_id] = resp
        self._done.add(resp.request_id)

    def _reject(self, rid: int, err: EvaluatorError, t0: float) -> None:
        self._counters[f"err:{type(err).__name__}"] += 1
        if isinstance(err, TransientFailure):
            self._breaker_on_failure()
        self._record_response(PlanResponse(
            request_id=rid,
            ok=False,
            error=err,
            latency_seconds=self.clock() - t0,
        ))

    # ------------------------------------------------------------------
    # plan cache (bounded LRU, same idiom as flow._COMPILED_SWEEPS)
    # ------------------------------------------------------------------

    def _cache_get(self, key: tuple) -> PlanResponse | None:
        with self._plan_cache_lock:
            resp = self._plan_cache.get(key)
            if resp is not None:
                self._plan_cache.move_to_end(key)
                self._cache_stats["hits"] += 1
            else:
                self._cache_stats["misses"] += 1
            return resp

    def _cache_put(self, key: tuple, resp: PlanResponse) -> None:
        with self._plan_cache_lock:
            while len(self._plan_cache) >= self.plan_cache_capacity:
                self._plan_cache.popitem(last=False)
                self._cache_stats["evictions"] += 1
            self._plan_cache[key] = resp

    def plan_cache_stats(self) -> dict:
        """Plan-cache accounting — same shape as
        :func:`repro_torch.core.flow.sweep_cache_stats`: {hits, misses,
        evictions, size, entries}, where ``entries`` lists each cached
        plan's {graph, budget, engine} in LRU order.  Snapshotted under
        the cache lock, so concurrent readers never see a half-updated
        accounting."""
        with self._plan_cache_lock:
            return dict(
                self._cache_stats,
                size=len(self._plan_cache),
                entries=[
                    {
                        "graph": key[0].name,
                        "budget": float(key[1]),
                        "engine": resp.engine,
                    }
                    for key, resp in self._plan_cache.items()
                ],
            )

    # ------------------------------------------------------------------
    # degradation ladder
    # ------------------------------------------------------------------

    def _breaker_on_failure(self) -> None:
        """A TransientFailure verdict: count it, trip OPEN at threshold
        (a HALF_OPEN probe failure re-opens immediately)."""
        if not self.breaker_threshold:
            return
        self._breaker_failures += 1
        if (
            self._breaker_state is BreakerState.HALF_OPEN
            or self._breaker_failures >= self.breaker_threshold
        ):
            if self._breaker_state is not BreakerState.OPEN:
                self._counters["breaker_trips"] += 1
            self._breaker_state = BreakerState.OPEN
            self._breaker_open_until = (
                self.clock() + self.breaker_cooldown_seconds
            )

    def _breaker_on_success(self) -> None:
        """A served plan: reset the failure streak; a successful HALF_OPEN
        probe re-closes the breaker.  Successes while OPEN do *not* close
        it — the floor rung succeeding says nothing about the tripped
        fast path."""
        if not self.breaker_threshold:
            return
        if self._breaker_state is BreakerState.OPEN:
            return
        if self._breaker_state is BreakerState.HALF_OPEN:
            self._counters["breaker_closes"] += 1
        self._breaker_state = BreakerState.CLOSED
        self._breaker_failures = 0

    @property
    def breaker_state(self) -> BreakerState:
        """Current circuit-breaker state (CLOSED when disarmed)."""
        return self._breaker_state

    def _pick_rung(self, remaining: float) -> str:
        """Highest rung whose estimated search+sweep cost fits the
        remaining deadline (with safety margin).  Falls through to "lbl"
        as the best-effort floor.  An OPEN breaker pins the ladder to
        "lbl" until its cooldown elapses, then HALF_OPEN lets one probe
        through at full quality."""
        if self.breaker_threshold and self._breaker_state is BreakerState.OPEN:
            if self.clock() >= self._breaker_open_until:
                self._breaker_state = BreakerState.HALF_OPEN
            else:
                return "lbl"
        if not np.isfinite(remaining):
            return "exact"
        allowance = remaining * _RUNG_SAFETY - self._sweep_ewma
        for rung in RUNGS[:-1]:
            if self._rung_ewma[rung] <= allowance:
                return rung
        return "lbl"

    def _resolve(self, adm: _Admitted) -> _Resolved:
        """Run the grouping search at the deadline-selected rung.

        Raises :class:`DeadlineExceeded` when the deadline expired before
        (or during — e.g. a stalled search) the resolution, and
        :class:`RequestCancelled` when the request was cancelled while
        queued."""
        if adm.request_id in self._cancelled:
            self._cancelled.discard(adm.request_id)
            raise RequestCancelled("cancelled while queued")
        now = self.clock()
        if now > adm.deadline:
            raise DeadlineExceeded(
                f"deadline expired {now - adm.deadline:.3f}s before the "
                "grouping search started"
            )
        rung = self._pick_rung(adm.deadline - now)

        if self.faults is not None and hasattr(self.faults, "before_search"):
            self.faults.before_search(adm)

        g, budget = adm.g, adm.budget
        t0 = self.clock()
        lbl = fusion.layer_by_layer_cuts(g)
        if rung == "exact":
            # The SAME resolution run_fleet(groupings="search") performs
            # offline — this is what makes non-degraded service plans
            # bit-identical to the batch answer.
            cuts, engine = flow.groupings_batch(
                g, "search", sram_budget_words=budget, with_provenance=True
            )
            # Re-resolving for the achieved cost is near-free: the
            # frontier DP memoises per (graph, budget), and the chain
            # DP / exhaustive paths are tiny at service graph sizes.
            best = fusion.optimal_cuts(g, sram_budget_words=budget)
            achieved = best.group_cost_words
            exact = best.exact
        else:
            if rung == "beam":
                res = fusion.beam_merge_cuts(g, sram_budget_words=budget)
            elif rung == "greedy":
                res = fusion.greedy_merge_cuts(g, sram_budget_words=budget)
            else:  # lbl — always buffer-minimal, the feasibility floor
                res = fusion.DPResult(
                    cuts=lbl,
                    group_cost_words=fusion._graph_cost(g, lbl),
                    n_groups=g.n_nodes,
                    engine="lbl",
                )
            # The lbl row rides along so the SRAM prefilter can never
            # reject the whole batch when *any* grouping is feasible.
            cuts = np.unique(np.stack([res.cuts, lbl]), axis=0)
            engine, achieved, exact = res.engine, res.group_cost_words, False
        dt = self.clock() - t0
        self._rung_ewma[rung] += _EWMA_ALPHA * (dt - self._rung_ewma[rung])

        now = self.clock()
        if now > adm.deadline:
            raise DeadlineExceeded(
                f"grouping search ({rung}) overran the deadline by "
                f"{now - adm.deadline:.3f}s"
            )
        return _Resolved(
            adm=adm,
            cuts=cuts,
            engine=engine,
            rung=rung,
            exact=exact,
            quality_bound=achieved / _lower_bound_cost(g),
        )

    # ------------------------------------------------------------------
    # micro-batched sweep
    # ------------------------------------------------------------------

    def _with_retries(self, fn: Callable[[], flow.FleetResult]):
        """Request-level face of the shared :class:`RetryPolicy`: typed
        evaluator errors are deterministic verdicts and propagate
        immediately; anything else is retried with backoff, counted in
        ``transient_retries``, and exhausts into a typed
        :class:`TransientFailure`."""

        def count(attempt: int, exc: BaseException) -> None:
            self._counters["transient_retries"] += 1

        return self.retry_policy.call(fn, describe="sweep", on_retry=count)

    def _group_abort_check(self, group: list[_Resolved]) -> Callable[[], None]:
        """The chunked sweep's between-chunk preemption point: raises
        :class:`_SweepAborted` when any group member was cancelled or ran
        out of deadline — the sweep stops at the chunk boundary, never
        mid-sweep."""

        def check() -> None:
            if self.faults is not None and hasattr(
                self.faults, "before_chunk"
            ):
                self.faults.before_chunk()
            now = self.clock()
            for r in group:
                if r.adm.request_id in self._cancelled or now > r.adm.deadline:
                    raise _SweepAborted("abort at sweep-chunk boundary")

        return check

    def _maybe_audit(self, adm: _Admitted, resp: PlanResponse) -> PlanResponse:
        """Shadow audit: every ``1/shadow_audit_rate``-th served plan is
        re-scored by the scalar oracle; a divergent answer is replaced
        with a typed :class:`AuditMismatch` rejection (fail loudly, never
        serve a silently wrong plan)."""
        if self.shadow_audit_rate <= 0 or resp.plan is None:
            return resp
        self._audit_counter += 1
        period = max(1, int(round(1.0 / self.shadow_audit_rate)))
        if self._audit_counter % period:
            return resp
        from . import metrics as M

        self._counters["audits"] += 1
        plan = resp.plan
        ref = M.evaluate_ref(adm.g, plan.best_cuts, plan.best_hw)
        if self.faults is not None and hasattr(self.faults, "corrupt_audit"):
            ref = self.faults.corrupt_audit(ref)
        if ref != plan.best_metrics:
            self._counters["audit_mismatches"] += 1
            self._counters["err:AuditMismatch"] += 1
            return dataclasses.replace(
                resp,
                ok=False,
                plan=None,
                error=AuditMismatch(
                    f"request {adm.request_id}: sweep said "
                    f"{plan.best_metrics}, scalar oracle says {ref}"
                ),
                quality_bound=float("nan"),
            )
        return resp

    def _sweep_group(self, group: list[_Resolved]) -> None:
        """One run_fleet program for a (budget, constraints, space) group;
        on a group-level typed failure, falls back to singleton sweeps so
        one infeasible request cannot poison its neighbours.  With
        ``hw_chunk`` the program runs in resumable hardware-axis chunks; a
        cancellation/deadline abort answers the affected members and
        re-sweeps the survivors."""
        adm0 = group[0].adm

        def run() -> flow.FleetResult:
            if self.faults is not None and hasattr(
                self.faults, "before_sweep"
            ):
                self.faults.before_sweep(len(group))
            return flow.run_fleet(
                [r.adm.g for r in group],
                config_space=adm0.config_space,
                constraints=adm0.constraints,
                groupings=[r.cuts for r in group],
                sram_budget_words=adm0.budget,
                hw_chunk=self.hw_chunk,
                abort_check=(
                    self._group_abort_check(group)
                    if self.hw_chunk is not None
                    else None
                ),
                retry_policy=self.retry_policy,
                checkpoint_dir=self.checkpoint_dir,
                hooks=self.faults,
                device=self.device,
            )

        t0 = self.clock()
        try:
            fleet = self._with_retries(run)
        except _SweepAborted:
            survivors: list[_Resolved] = []
            now = self.clock()
            for r in group:
                rid = r.adm.request_id
                if rid in self._cancelled:
                    self._cancelled.discard(rid)
                    self._counters["cancelled_in_sweep"] += 1
                    self._reject(
                        rid,
                        RequestCancelled(
                            "cancelled mid-sweep; stopped at the chunk "
                            "boundary"
                        ),
                        r.adm.submitted_at,
                    )
                elif now > r.adm.deadline:
                    self._reject(
                        rid,
                        DeadlineExceeded(
                            f"deadline expired mid-sweep "
                            f"({now - r.adm.deadline:.3f}s past)"
                        ),
                        r.adm.submitted_at,
                    )
                else:
                    survivors.append(r)
            if survivors:
                self._sweep_group(survivors)
            return
        except EvaluatorError as e:
            if len(group) == 1:
                self._reject(group[0].adm.request_id, e, group[0].adm.submitted_at)
                return
            for r in group:  # isolate: re-sweep each request alone
                self._sweep_group([r])
            return
        self._sweep_ewma += _EWMA_ALPHA * (
            (self.clock() - t0) - self._sweep_ewma
        )

        for r, fr in zip(group, fleet.results):
            adm = r.adm
            resp = PlanResponse(
                request_id=adm.request_id,
                ok=True,
                # run_fleet reports the explicit batch as "explicit";
                # restore the ladder's true provenance.
                plan=dataclasses.replace(fr, search_engine=r.engine),
                engine=r.engine,
                rung=r.rung,
                exact=r.exact,
                degraded=r.rung != "exact",
                quality_bound=r.quality_bound,
                latency_seconds=self.clock() - adm.submitted_at,
            )
            resp = self._maybe_audit(adm, resp)
            self._record_response(resp)
            if not resp.ok:
                continue
            self._breaker_on_success()
            self._counters["completed"] += 1
            if resp.degraded:
                self._counters["degraded"] += 1
            else:
                self._cache_put(adm.cache_key, resp)

    def tick(self) -> int:
        """Process one micro-batch; returns how many responses were
        produced.  Never raises for a request's failure — every outcome
        becomes a typed response.

        One tick dequeues up to ``max_batch`` admitted requests, resolves
        each one's grouping through the deadline ladder, groups the
        resolutions by (budget, constraints, config space), and answers
        each group with ONE coalesced :func:`repro_torch.core.flow.run_fleet`
        sweep (per-graph explicit cut batches through the shared shape
        buckets).  Deadlines that expire mid-tick become
        ``DeadlineExceeded`` responses; transient sweep failures retry
        with backoff before a ``TransientFailure`` verdict.

        Example — an event loop calling tick until a request resolves::

            >>> from repro_torch.core.service import PlanningService, PlanRequest
            >>> from repro_torch.core.ir import resnet18_ir
            >>> svc = PlanningService(device="cpu")
            >>> rid = svc.submit(PlanRequest(graph=resnet18_ir(),
            ...                              deadline_seconds=0.5))
            >>> resp = None
            >>> while resp is None:          # doctest: +SKIP
            ...     _ = svc.tick()
            ...     resp = svc.collect(rid)  # pops once answered

        (Offline callers can use :meth:`plan` — submit + drain + collect
        in one call — instead of running the loop themselves.)
        """
        self._ticks += 1
        if self.faults is not None and hasattr(self.faults, "on_tick"):
            self.faults.on_tick(self._ticks)

        batch = self._take_batch()
        if not batch:
            return 0
        # WAL: the tick boundary is durable before any member is resolved,
        # so recovery can tell "queued" from "was inside a tick" (both
        # re-run, but the distinction is visible to the kill-point tests).
        if self._journal is not None:
            self._journal.append(
                "tick",
                {
                    "tick": self._ticks,
                    "rids": [a.request_id for a in batch],
                },
            )

        groups: dict[tuple, list[_Resolved]] = collections.OrderedDict()
        produced = 0
        for adm in batch:
            try:
                r = self._resolve(adm)
            except EvaluatorError as e:
                self._reject(adm.request_id, e, adm.submitted_at)
                produced += 1
                continue
            except Exception as e:
                self._reject(
                    adm.request_id,
                    TransientFailure(
                        f"grouping search failed "
                        f"({type(e).__name__}: {e})",
                        cause=e,
                        attempts=1,
                    ),
                    adm.submitted_at,
                )
                produced += 1
                continue
            key = (
                adm.budget,
                adm.constraints.as_row().tobytes(),
                adm.config_space,
            )
            groups.setdefault(key, []).append(r)

        for group in groups.values():
            self._sweep_group(group)
            produced += len(group)
        if self._journal is not None:
            self._journal.maybe_snapshot(self._snapshot_payload)
        return produced

    def _take_batch(self) -> list[_Admitted]:
        """Form one micro-batch.  Plain FIFO without affinity; with it,
        the FIFO head (always served — no starvation) plus queued requests
        sharing its shape-bucket/budget/constraints/space affinity key, so
        the whole batch sweeps as ONE fleet even under heterogeneous
        traffic."""
        batch: list[_Admitted] = []
        if not self._queue:
            return batch
        batch.append(self._queue.popleft())
        if not self.affinity_batching:
            while self._queue and len(batch) < self.max_batch:
                batch.append(self._queue.popleft())
            return batch
        key = self._affinity_key(batch[0])
        kept: collections.deque[_Admitted] = collections.deque()
        while self._queue and len(batch) < self.max_batch:
            adm = self._queue.popleft()
            if self._affinity_key(adm) == key:
                batch.append(adm)
            else:
                kept.append(adm)
        kept.extend(self._queue)  # unexamined tail, original order
        self._queue = kept
        if len(batch) > 1:
            self._counters["affinity_batched"] += len(batch) - 1
        return batch

    def _affinity_key(self, adm: _Admitted) -> tuple:
        """Requests with equal keys share a sweep group: same (L, E)
        shape bucket, budget, constraints, and
        config space (the C bucket depends on ladder output, so it cannot
        be part of the admission-time key)."""
        return (
            bucket_size(adm.g.n_nodes, flow.NODE_BUCKET_FLOOR),
            bucket_size(adm.g.n_edges, flow.EDGE_BUCKET_FLOOR),
            adm.budget,
            adm.constraints.as_row().tobytes(),
            adm.config_space,
        )

    # ------------------------------------------------------------------
    # retrieval / convenience
    # ------------------------------------------------------------------

    def cancel(self, request_id: int) -> bool:
        """Request cooperative cancellation of ``request_id``.

        Returns False when the request is unknown or already answered
        (the answer stands — cancellation never un-serves a plan).
        Otherwise the cancellation flag is set (and journaled) and the
        request is answered with
        :class:`~repro_torch.core.errors.RequestCancelled`: at its next tick if
        still queued, or at the next ``hw_chunk`` boundary if its sweep is
        already running.  Safe to call from any thread — this is the
        async transport's mid-flight cancel path.
        """
        if request_id in self._done or request_id >= self._next_id:
            return False
        self._cancelled.add(request_id)
        if self._journal is not None:
            self._journal.append("cancel", {"rid": int(request_id)})
        self._counters["cancel_requested"] += 1
        return True

    def collect(self, request_id: int) -> PlanResponse | None:
        """Pop the response for ``request_id`` (None while pending)."""
        return self._responses.pop(request_id, None)

    def drain(self, max_ticks: int = 10_000) -> None:
        """Tick until the queue is empty."""
        while self._queue and max_ticks > 0:
            self.tick()
            max_ticks -= 1

    def plan(self, request: PlanRequest) -> PlanResponse:
        """One-shot convenience: submit, drain, collect."""
        rid = self.submit(request)
        self.drain()
        resp = self.collect(rid)
        assert resp is not None  # drain() guarantees an answer
        return resp

    @property
    def queue_depth(self) -> int:
        """Requests admitted but not yet answered by a tick."""
        return len(self._queue)

    def stats(self) -> dict:
        """Service accounting: counters, plan-cache and sweep-accounting
        stats, ladder EWMAs, breaker state, and the journal's last durable
        sequence number (0 without a journal)."""
        return {
            "counters": dict(self._counters),
            "queue_depth": len(self._queue),
            "ticks": self._ticks,
            "plan_cache": self.plan_cache_stats(),
            "sweep_cache": flow.sweep_cache_stats(),
            "rung_ewma_seconds": dict(self._rung_ewma),
            "sweep_ewma_seconds": self._sweep_ewma,
            "breaker": self._breaker_state.value,
            "journal_seq": (
                self._journal.seq if self._journal is not None else 0
            ),
        }

    def close(self) -> None:
        """Flush and close the journal (no-op without one)."""
        if self._journal is not None:
            self._journal.close()

    # ------------------------------------------------------------------
    # crash recovery
    # ------------------------------------------------------------------

    def _snapshot_payload(self) -> dict:
        """Full durable state at the current WAL position: everything
        :meth:`recover` needs without replaying records the snapshot
        supersedes."""
        return {
            "next_id": self._next_id,
            "ticks": self._ticks,
            "queue": [journal_mod.enc_request(a) for a in self._queue],
            "responses": {
                str(rid): journal_mod.enc_response(r)
                for rid, r in self._responses.items()
            },
            "cancelled": sorted(self._cancelled),
            "done": sorted(self._done),
            "counters": dict(self._counters),
        }

    @classmethod
    def recover(
        cls,
        journal_dir,
        *,
        journal_fsync: bool = True,
        snapshot_every: int = 64,
        **service_kwargs,
    ) -> "PlanningService":
        """Rebuild a service from its journal after a crash.

        Replays the newest snapshot plus the WAL tail: every journaled
        response is restored **bit-identically** (the journal's hex-float/
        raw-bytes codecs), and every request with a durable admission but
        no response — queued at the crash, or inside an in-flight tick —
        is re-enqueued so the next :meth:`drain` answers it exactly once.
        A request cancelled before the crash is answered with
        ``RequestCancelled`` immediately.  Deadlines restart with the
        budget the request had at admission (monotonic clocks do not
        survive a process).  The journal stays attached, so the recovered
        service keeps appending to the same WAL — recovery composes with
        itself (kill the recovered process, recover again).

        ``service_kwargs`` are the normal constructor arguments (config
        space, ladder/batch bounds, ``device``, ...); they must match the crashed
        service's for re-runs to be bit-identical.
        """
        state, records = journal_mod.load(journal_dir)
        svc = cls(**service_kwargs)

        pending: "collections.OrderedDict[int, dict]" = (
            collections.OrderedDict()
        )
        cancelled: set[int] = set()
        if state is not None:
            svc._next_id = int(state["next_id"])
            svc._ticks = int(state["ticks"])
            svc._responses = {
                int(rid): journal_mod.dec_response(r)
                for rid, r in state["responses"].items()
            }
            svc._done = set(
                int(r) for r in state.get("done", ())
            ) | set(svc._responses)
            svc._counters = collections.Counter(
                {k: int(v) for k, v in state["counters"].items()}
            )
            for d in state["queue"]:
                q = journal_mod.dec_request(d)
                pending[q["rid"]] = q
            cancelled = set(int(r) for r in state.get("cancelled", ()))

        for rec in records:
            rtype, payload = rec["type"], rec["payload"]
            if rtype == "admit":
                q = journal_mod.dec_request(payload)
                pending[q["rid"]] = q
                svc._next_id = max(svc._next_id, q["rid"] + 1)
            elif rtype == "response":
                resp = journal_mod.dec_response(payload)
                pending.pop(resp.request_id, None)
                cancelled.discard(resp.request_id)
                svc._responses[resp.request_id] = resp
                svc._done.add(resp.request_id)
                svc._next_id = max(svc._next_id, resp.request_id + 1)
            elif rtype == "cancel":
                cancelled.add(int(payload["rid"]))
            elif rtype == "tick":
                # An in-flight tick: its unanswered members stay pending
                # and re-run below — "exactly once" across the crash.
                svc._ticks = max(svc._ticks, int(payload["tick"]))

        # Reattach AFTER replay: replayed records must not be re-appended,
        # while everything the recovered service does next is journaled as
        # usual (the Journal resumes at the last durable sequence number).
        svc._journal = journal_mod.Journal(
            journal_dir, fsync=journal_fsync, snapshot_every=snapshot_every
        )

        now = svc.clock()
        for rid, q in pending.items():  # admission (= rid) order
            if rid in cancelled:
                svc._reject(
                    rid,
                    RequestCancelled("cancelled before the crash"),
                    now,
                )
                continue
            budget_s = q["deadline_budget"]
            svc._queue.append(
                _Admitted(
                    request_id=rid,
                    g=q["graph"],
                    budget=q["budget"],
                    deadline=(
                        now + budget_s
                        if np.isfinite(budget_s)
                        else float("inf")
                    ),
                    constraints=q["constraints"],
                    config_space=q["config_space"],
                    submitted_at=now,
                    cache_key=(
                        q["graph"],
                        q["budget"],
                        q["constraints"].as_row().tobytes(),
                        q["config_space"],
                    ),
                )
            )
            svc._counters["recovered"] += 1
        return svc


class AsyncPlanningService:
    """Asynchronous transport over :class:`PlanningService`.

    One daemon worker thread owns the inner (single-threaded) service:
    callers hand requests to a thread-safe inbox and get a
    ``concurrent.futures.Future`` back immediately; the worker admits,
    ticks, and resolves each future with the typed
    :class:`PlanResponse`.  The division of labour is strict — only the
    worker touches the inner service's queue/responses/journal — except
    for the two operations designed to act mid-tick from any thread:
    cooperative cancellation (:meth:`cancel` flags the request so the
    running sweep stops at its next ``hw_chunk`` boundary) and the
    lock-guarded stats readers.

    Liveness: the worker rewrites ``heartbeat_path`` every loop (to a
    temporary file, then ``os.replace``, so a reader never sees a
    truncated file), and a watchdog thread
    (armed by ``watchdog_seconds``) calls ``on_stall(age_seconds)`` when
    the heartbeat goes stale — a stalled sweep is *observable* without
    killing it.  The watchdog never touches CUDA; the worker sweeps on the
    inner service's explicit device.

    Shutdown is graceful by default: :meth:`shutdown` (or leaving the
    ``with`` block) drains the queue so every accepted future resolves,
    then closes the journal; ``drain=False`` instead cancels everything
    still pending (each future resolves with ``RequestCancelled``).  Used
    as a context manager the transport is Ctrl-C-safe: a
    ``KeyboardInterrupt`` unwinds through ``__exit__``, which still
    drains before the process exits.

    Example::

        >>> from repro_torch.core.service import AsyncPlanningService, PlanRequest
        >>> from repro_torch.core.ir import residual_block_ir
        >>> with AsyncPlanningService(device="cpu") as svc:
        ...     fut = svc.submit(PlanRequest(graph=residual_block_ir(),
        ...                                  sram_budget_words=2e6))
        ...     resp = fut.result(timeout=120)
        >>> resp.ok
        True
    """

    def __init__(
        self,
        service: PlanningService | None = None,
        *,
        poll_seconds: float = 0.005,
        heartbeat_path=None,
        watchdog_seconds: float = 0.0,
        on_stall: Callable[[float], None] | None = None,
        **service_kwargs,
    ):
        """Wrap ``service`` (or construct one from ``service_kwargs``) and
        start the worker.  ``poll_seconds`` bounds the idle-loop latency;
        ``heartbeat_path``/``watchdog_seconds``/``on_stall`` arm the
        liveness machinery."""
        if service is not None and service_kwargs:
            raise ValueError(
                "pass either a ready service or constructor kwargs, not both"
            )
        self.service = (
            service if service is not None else PlanningService(**service_kwargs)
        )
        self.poll_seconds = float(poll_seconds)
        self.heartbeat_path = heartbeat_path
        self.watchdog_seconds = float(watchdog_seconds)
        self.on_stall = on_stall

        self._inbox: "queue_mod.Queue" = queue_mod.Queue()
        self._futures: dict[int, concurrent.futures.Future] = {}
        self._futures_lock = threading.Lock()
        self._stop = threading.Event()
        self._drain_on_stop = True
        self._last_beat = time.monotonic()
        self._stalls = 0

        self._thread = threading.Thread(
            target=self._run, name="planning-service-worker", daemon=True
        )
        self._thread.start()
        self._watchdog: threading.Thread | None = None
        if self.watchdog_seconds > 0:
            self._watchdog = threading.Thread(
                target=self._watch, name="planning-service-watchdog",
                daemon=True,
            )
            self._watchdog.start()

    # -- caller-side API ------------------------------------------------

    def submit(self, request: PlanRequest) -> concurrent.futures.Future:
        """Enqueue one request; returns a Future resolving to its
        :class:`PlanResponse`.  The future grows a ``request_id``
        attribute once the worker admits it (needed only for debugging —
        :meth:`cancel` takes the future itself)."""
        if self._stop.is_set():
            raise RuntimeError("service is shut down")
        fut: concurrent.futures.Future = concurrent.futures.Future()
        fut.request_id = None
        fut.cancel_requested = False
        self._inbox.put((request, fut))
        return fut

    def cancel(self, fut: concurrent.futures.Future) -> bool:
        """Request cooperative cancellation of a submitted future.

        Effective at any stage: before admission (the worker cancels it
        on arrival), queued (answered at its next tick), or mid-sweep
        (the running chunked sweep aborts at its next chunk boundary).
        The future still *resolves* — with a ``RequestCancelled``
        response — unless the answer had already been served."""
        fut.cancel_requested = True
        rid = getattr(fut, "request_id", None)
        if rid is not None:
            return self.service.cancel(rid)
        return True

    def plan(self, request: PlanRequest, timeout: float | None = None):
        """Synchronous convenience: submit + wait."""
        return self.submit(request).result(timeout=timeout)

    def shutdown(self, *, drain: bool = True, timeout: float | None = None):
        """Stop the worker.  ``drain=True`` answers everything accepted
        first; ``drain=False`` cancels pending requests (their futures
        resolve with ``RequestCancelled``).  Idempotent."""
        self._drain_on_stop = drain
        self._stop.set()
        self._thread.join(timeout)

    def __enter__(self) -> "AsyncPlanningService":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # Drain even when unwinding from KeyboardInterrupt: accepted
        # requests are answered (and journaled) before the process dies.
        self.shutdown(drain=True)

    def stats(self) -> dict:
        """Inner-service stats plus transport accounting."""
        with self._futures_lock:
            inflight = len(self._futures)
        return dict(
            self.service.stats(),
            transport={
                "inflight": inflight,
                "inbox": self._inbox.qsize(),
                "stalls": self._stalls,
                "heartbeat_age_seconds": time.monotonic() - self._last_beat,
            },
        )

    # -- worker side ----------------------------------------------------

    def _beat(self) -> None:
        self._last_beat = time.monotonic()
        if self.heartbeat_path is not None:
            # Atomic: write a temporary file, then rename it over the
            # heartbeat, so a concurrent reader sees the old or the new
            # contents, never an empty or half-written file.
            tmp = f"{self.heartbeat_path}.{os.getpid()}.tmp"
            try:
                with open(tmp, "w") as f:
                    f.write(f"{os.getpid()} {time.time():.3f}\n")
                os.replace(tmp, self.heartbeat_path)
            except OSError:  # liveness reporting must never kill serving
                pass

    def _watch(self) -> None:
        interval = max(self.watchdog_seconds / 4, 0.001)
        while not self._stop.wait(interval):
            age = time.monotonic() - self._last_beat
            if age > self.watchdog_seconds:
                self._stalls += 1
                if self.on_stall is not None:
                    try:
                        self.on_stall(age)
                    except Exception:
                        pass

    def _ingest(self, block: bool) -> None:
        """Move every waiting submission from the inbox into the inner
        service (optionally blocking ``poll_seconds`` for the first)."""
        items = []
        if block:
            try:
                items.append(self._inbox.get(timeout=self.poll_seconds))
            except queue_mod.Empty:
                return
        while True:
            try:
                items.append(self._inbox.get_nowait())
            except queue_mod.Empty:
                break
        for request, fut in items:
            rid = self.service.submit(request)
            fut.request_id = rid
            with self._futures_lock:
                self._futures[rid] = fut
            if fut.cancel_requested:
                self.service.cancel(rid)

    def _deliver(self) -> None:
        with self._futures_lock:
            rids = list(self._futures)
        for rid in rids:
            resp = self.service.collect(rid)
            if resp is not None:
                with self._futures_lock:
                    fut = self._futures.pop(rid)
                if not fut.done():
                    fut.set_result(resp)

    def _run(self) -> None:
        svc = self.service
        while True:
            self._beat()
            self._ingest(block=not self._stop.is_set())
            if svc.queue_depth:
                svc.tick()
            self._deliver()
            if self._stop.is_set() and self._inbox.empty():
                if not self._drain_on_stop:
                    with self._futures_lock:
                        rids = list(self._futures)
                    for rid in rids:
                        svc.cancel(rid)
                while svc.queue_depth:
                    self._beat()
                    svc.tick()
                self._deliver()
                break
        svc.close()
