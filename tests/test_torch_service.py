"""The port's planning service, fault injector and async transport, against
the JAX package's, on the CPU (``device="cpu"``).

* one request stream — paced requests with deadlines interleaved with the
  chaos stream, under injected transient sweep failures and eviction
  storms — goes through both services with the same stepping clock, so
  the deadline ladder decides alike: every request gets the same typed
  response from both (timing fields aside), and every exact-rung plan is
  bit-identical to an offline ``run_fleet`` of either package;
* the reference's service contract (tests/test_service.py,
  tests/test_faults.py, tests/test_async_service.py) holds in the port:
  admission, overload, micro-batching, isolation, retries, the breaker,
  the shadow audit, affinity batching, async drain / cancel / heartbeat,
  and 100 % typed responses in the chaos streams.
"""
import collections
import dataclasses
import threading
import time

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.core import arch as RA  # noqa: E402
from repro.core import flow as RF  # noqa: E402
from repro.core import ir as RI  # noqa: E402
from repro.core import journal as RJ  # noqa: E402
from repro.core import service as RS  # noqa: E402
from repro.testing import faults as RFa  # noqa: E402
from repro_torch.core import arch as TA  # noqa: E402
from repro_torch.core import flow, fusion, service  # noqa: E402
from repro_torch.core import frontend  # noqa: E402
from repro_torch.core import ir as TI  # noqa: E402
from repro_torch.core import journal as J  # noqa: E402
from repro_torch.core.arch import (  # noqa: E402
    Constraints,
    DLAConfig,
    default_config_space,
    paper_config_space,
)
from repro_torch.core.errors import (  # noqa: E402
    ConfigValidationError,
    DeadlineExceeded,
    EvaluatorError,
    GraphValidationError,
    InfeasibleBudgetError,
    InfeasibleConstraintsError,
    ServiceOverloaded,
    TransientFailure,
)
from repro_torch.core.ir import (  # noqa: E402
    as_graph,
    encoder_decoder_ir,
    residual_block_ir,
    resnet18_ir,
)
from repro_torch.core.service import (  # noqa: E402
    AsyncPlanningService,
    BreakerState,
    PlanRequest,
    PlanningService,
)
from repro_torch.testing import faults as F  # noqa: E402

SPACE = tuple(paper_config_space())
MLP = as_graph(frontend.mlp_block_graph())
RES = as_graph(residual_block_ir())
DEADLINE_S = 0.06  # the paced stream's deadline (chip_smoke.py's service phase)
BUDGETS = [float("inf"), 4e6, 1e6]


def _graphs():
    return [MLP, RES, as_graph(encoder_decoder_ir())]


def _service(**kw):
    kw.setdefault("config_space", SPACE)
    kw.setdefault("backoff_seconds", 0.0)
    kw.setdefault("device", "cpu")
    return PlanningService(**kw)


def _metrics(m) -> tuple:
    return (m.bandwidth_words, m.latency_cycles, m.energy_nj, m.area_um2)


def _same_plan(plan, ref) -> bool:
    return (np.array_equal(plan.best_cuts, ref.best_cuts)
            and _metrics(plan.best_metrics) == _metrics(ref.best_metrics)
            and np.array_equal(plan.best_hw.as_row(), ref.best_hw.as_row()))


class StepClock:
    """Injectable clock that advances a fixed step on every read, so two
    services making the same calls see the same times."""

    def __init__(self, step: float = 0.0, t: float = 1_000.0):
        self.t, self.step = t, step

    def __call__(self) -> float:
        self.t += self.step
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _wait_until(pred, timeout=30.0, interval=0.005):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


# ---------------------------------------------------------------------------
# one stream through both services
# ---------------------------------------------------------------------------


def _stream(S, I, Fa, n=48):
    """Paced requests (four graphs, three budgets, DEADLINE_S) interleaved
    with the chaos stream, labelled."""
    chaos = list(Fa.chaos_requests(n // 2, seed=5))
    graphs = Fa._valid_graphs() + [I.resnet18_ir()]
    out = []
    for i in range(n):
        out.append(("paced", S.PlanRequest(graph=graphs[i % 4],
                                           sram_budget_words=BUDGETS[i % 3],
                                           deadline_seconds=DEADLINE_S)))
        if i % 2:
            out.append(chaos[i // 2])
    return out


def _drive(S, I, Fa, A):
    svc = S.PlanningService(
        config_space=A.default_config_space(),
        constraints=A.Constraints(*[float("inf")] * 4), backoff_seconds=0.0,
        clock=StepClock(0.001), max_batch=16,
        faults=Fa.FaultInjector(transient_every=3, evict_every=5),
        **({"device": "cpu"} if S is service else {}))
    # Seeded ladder estimates: the exact rung looks slow until observed
    # searches pull its estimate down, so the deadline picks lower rungs.
    svc._rung_ewma.update(exact=0.045, beam=0.03, greedy=0.015)
    requests, rids = _stream(S, I, Fa), []
    for i, (_, req) in enumerate(requests):
        rids.append(svc.submit(req))
        if i % 4 == 3:
            svc.tick()
    svc.drain()
    return requests, [svc.collect(rid) for rid in rids], svc


def _answer(enc) -> dict:
    enc.pop("latency_seconds")
    if enc["plan"] is not None:
        for k in ("compile_seconds", "sweep_seconds", "candidates_per_second"):
            enc["plan"].pop(k)
    return enc


@pytest.fixture(scope="module")
def both_streams():
    return _drive(RS, RI, RFa, RA), _drive(service, TI, F, TA)


def test_one_stream_gets_the_same_typed_response_from_both_services(both_streams):
    (_, want, rsvc), (requests, got, tsvc) = both_streams
    assert len(got) == len(want) == len(requests) == 72
    for w, g in zip(want, got):
        assert g is not None and (g.ok or isinstance(g.error, EvaluatorError))
        assert _answer(J.enc_response(g)) == _answer(RJ.enc_response(w))
    outcomes = collections.Counter(g.rung if g.ok else g.error_type for g in got)
    # the stream really exercised the ladder and the typed rejections
    assert {"exact", "beam", "lbl", "DeadlineExceeded", "GraphValidationError",
            "InfeasibleConstraintsError"} <= set(outcomes)
    assert tsvc.faults.counts == rsvc.faults.counts
    assert tsvc.faults.counts["injected_transients"] > 0
    for k in ("completed", "degraded", "transient_retries", "cache_hits"):
        assert tsvc.stats()["counters"].get(k, 0) == rsvc.stats()["counters"].get(k, 0)


def test_exact_rung_plans_equal_an_offline_fleet_of_either_package(both_streams):
    _, (requests, got, _) = both_streams
    loose_t, loose_r = Constraints(*[float("inf")] * 4), RA.Constraints(*[float("inf")] * 4)
    seen = {}
    for (_, req), resp in zip(requests, got):
        if not (resp.ok and resp.rung == "exact"):
            continue
        key = (req.graph, req.sram_budget_words)
        if key not in seen:
            port = flow.run_fleet([req.graph], constraints=loose_t, groupings="search",
                                  sram_budget_words=req.sram_budget_words,
                                  device="cpu").results[0]
            ref = RF.run_fleet([RJ.dec_graph(J.enc_graph(as_graph(req.graph)))],
                               constraints=loose_r, groupings="search",
                               sram_budget_words=req.sram_budget_words).results[0]
            seen[key] = (port, ref)
        port, ref = seen[key]
        assert _same_plan(resp.plan, port) and _same_plan(resp.plan, ref)
    assert len(seen) >= 6


# ---------------------------------------------------------------------------
# bit-identity + provenance (tests/test_service.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("budget", [float("inf"), 2e6])
def test_plan_matches_offline_fleet_verdict(budget):
    svc = _service()
    for g in _graphs():
        try:
            ref = flow.run_fleet([g], config_space=SPACE, groupings="search",
                                 sram_budget_words=budget, device="cpu").results[0]
        except InfeasibleConstraintsError:
            ref = None
        resp = svc.plan(PlanRequest(graph=g, sram_budget_words=budget))
        if ref is None:
            assert not resp.ok and isinstance(resp.error, InfeasibleConstraintsError)
            continue
        assert resp.ok and not resp.degraded
        assert _same_plan(resp.plan, ref)
        assert resp.engine == ref.search_engine == resp.plan.search_engine
        assert resp.exact == (resp.engine in ("chain_dp", "frontier_dp", "exhaustive"))


def test_plan_cache_returns_identical_plan():
    svc = _service()
    first = svc.plan(PlanRequest(graph=MLP))
    again = svc.plan(PlanRequest(graph=MLP))
    assert not first.from_cache and again.from_cache
    assert _same_plan(again.plan, first.plan)
    stats = svc.plan_cache_stats()
    assert stats["hits"] == 1 and stats["size"] == 1


def test_degraded_plans_are_not_cached():
    svc = _service()
    svc._rung_ewma.update(exact=1e6, beam=1e6, greedy=0.0)
    r = svc.plan(PlanRequest(graph=RES, deadline_seconds=30.0))
    assert r.ok and r.degraded and r.rung == "greedy"
    assert svc.plan_cache_stats()["size"] == 0
    svc._rung_ewma["exact"] = 0.0
    r2 = svc.plan(PlanRequest(graph=RES, deadline_seconds=30.0))
    assert r2.ok and not r2.degraded and not r2.from_cache


def test_quality_bound_monotone_down_the_ladder():
    bounds = {}
    for rung in service.RUNGS:
        svc = _service()
        for r in service.RUNGS:
            svc._rung_ewma[r] = 0.0 if r == rung else 1e6
        deadline = float("inf") if rung == "exact" else 30.0
        resp = svc.plan(PlanRequest(graph=RES, deadline_seconds=deadline))
        assert resp.ok and resp.rung == rung and resp.quality_bound >= 1.0
        bounds[rung] = resp.quality_bound
    assert bounds["exact"] <= bounds["beam"] <= bounds["greedy"] <= bounds["lbl"]


def test_ladder_rung_selection_tracks_remaining_deadline():
    svc = _service()
    svc._rung_ewma.update(exact=10.0, beam=1.0, greedy=0.1, lbl=0.0)
    picks = [svc._pick_rung(x) for x in (float("inf"), 100.0, 5.0, 0.5, 0.01)]
    assert picks == ["exact", "exact", "beam", "greedy", "lbl"]
    assert service.RUNGS == RS.RUNGS


def test_zero_deadline_is_typed_deadline_exceeded():
    r = _service().plan(PlanRequest(graph=MLP, deadline_seconds=0.0))
    assert not r.ok and isinstance(r.error, DeadlineExceeded)
    assert isinstance(r.error, TimeoutError)


# ---------------------------------------------------------------------------
# admission
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["not-a-graph", "nan", "negative", "zero",
                                  "mixed-area", "empty-space"])
def test_admission_rejects_bad_requests_typed(case):
    mixed = (DLAConfig("hsiao", 4, 4, 4, 4),
             dataclasses.replace(DLAConfig("hsiao", 8, 8, 8, 8), area_per_mult_um2=1.0))
    req = {"not-a-graph": PlanRequest(graph="not a graph"),
           "nan": PlanRequest(graph=MLP, sram_budget_words=float("nan")),
           "negative": PlanRequest(graph=MLP, sram_budget_words=-1.0),
           "zero": PlanRequest(graph=MLP, sram_budget_words=0.0),
           "mixed-area": PlanRequest(graph=MLP, config_space=mixed),
           "empty-space": PlanRequest(graph=MLP, config_space=())}[case]
    r = _service().plan(req)
    want = ConfigValidationError if case in ("mixed-area", "empty-space") else (
        GraphValidationError)
    assert not r.ok and isinstance(r.error, want)


def test_queue_overload_sheds_typed():
    svc = _service(max_queue_depth=2)
    rids = [svc.submit(PlanRequest(graph=MLP, sram_budget_words=1e5 + i))
            for i in range(5)]
    shed = [rid for rid in rids if (resp := svc._responses.get(rid)) is not None
            and isinstance(resp.error, ServiceOverloaded)]
    assert len(shed) == 3
    svc.drain()
    assert all(svc.collect(rid) is not None for rid in rids)


# ---------------------------------------------------------------------------
# micro-batching, isolation, retries
# ---------------------------------------------------------------------------


def test_micro_batch_shares_one_sweep():
    flow.clear_sweep_cache()
    svc = _service(max_batch=8)
    for g in _graphs():
        svc.submit(PlanRequest(graph=g))
    assert svc.tick() == 3
    assert flow.sweep_cache_stats()["misses"] == 1  # three graphs, ONE sweep
    assert flow.sweep_cache_stats()["entries"] == []
    assert svc.stats()["counters"]["completed"] == 3


def test_infeasible_member_cannot_poison_its_batch():
    svc = _service(max_batch=8)
    rid_ok = svc.submit(PlanRequest(graph=MLP))
    rid_bad = svc.submit(PlanRequest(graph=RES, constraints=Constraints(0.5, 1.0, 1.0, 1.0)))
    svc.drain()
    assert svc.collect(rid_ok).ok
    bad = svc.collect(rid_bad)
    assert not bad.ok and isinstance(bad.error, InfeasibleConstraintsError)


class _FlakySweeps:
    """Raise on the first ``n`` before_sweep calls, then heal."""

    def __init__(self, n):
        self.n, self.calls = n, 0

    def before_sweep(self, group_size):
        self.calls += 1
        if self.calls <= self.n:
            raise RuntimeError("injected transient")


def test_transient_sweep_failures_are_retried():
    svc = _service(faults=_FlakySweeps(2), max_retries=3)
    assert svc.plan(PlanRequest(graph=MLP)).ok
    assert svc.stats()["counters"]["transient_retries"] == 2


def test_transient_exhaustion_is_typed():
    r = _service(faults=_FlakySweeps(100), max_retries=2).plan(PlanRequest(graph=MLP))
    assert not r.ok and isinstance(r.error, TransientFailure)
    assert r.error.attempts == 3 and isinstance(r.error.cause, RuntimeError)


def test_run_flow_infeasible_budget_carries_min_feasible():
    fused = np.zeros((1, MLP.n_edges), dtype=bool)
    need = fusion.graph_max_intermediate_batch(MLP, fused).min()
    with pytest.raises(InfeasibleBudgetError) as ei:
        flow.run_flow(MLP, config_space=SPACE, groupings=fused,
                      sram_budget_words=need - 1, device="cpu")
    assert ei.value.min_feasible_budget_words == pytest.approx(float(need))
    res = flow.run_flow(MLP, config_space=SPACE, groupings=fused, device="cpu",
                        sram_budget_words=ei.value.min_feasible_budget_words)
    assert res.n_feasible >= 1


def test_the_service_sweeps_on_its_explicit_device():
    svc = _service()
    assert str(svc.device) == "cpu"
    assert svc.stats()["sweep_cache"]["entries"] == []


# ---------------------------------------------------------------------------
# the fault injector (tests/test_faults.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("builder", F.CORRUPTIONS, ids=lambda b: b.__name__)
def test_corruption_caught_by_revalidation(builder):
    bad = builder(F._valid_graphs()[1])
    with pytest.raises(GraphValidationError):
        bad.validate()
    resp = _service().plan(PlanRequest(graph=bad))
    assert not resp.ok and isinstance(resp.error, GraphValidationError)
    ref = RFa.CORRUPTIONS[F.CORRUPTIONS.index(builder)](RFa._valid_graphs()[1])
    with pytest.raises(ValueError) as er:
        ref.validate()
    assert str(resp.error) == str(er.value)


def test_corruption_messages_name_the_offender():
    g = F._valid_graphs()[0]
    with pytest.raises(GraphValidationError, match="cyclic|topological"):
        F.corrupt_graph_cyclic(g).validate()
    with pytest.raises(GraphValidationError, match="words"):
        F.corrupt_graph_negative_words(g).validate()
    with pytest.raises(GraphValidationError, match="out of range"):
        F.corrupt_graph_dangling(g).validate()
    with pytest.raises(GraphValidationError, match="duplicate"):
        F.corrupt_graph_duplicate_edge(g).validate()


def test_chaos_requests_are_the_references():
    for (lt, rt), (lr, rr) in zip(F.chaos_requests(60, seed=9),
                                  RFa.chaos_requests(60, seed=9)):
        assert lt == lr and rt.graph.name == rr.graph.name
        if not lt.startswith("corrupt:"):
            assert J.enc_graph(rt.graph) == RJ.enc_graph(rr.graph)
        assert repr((rt.sram_budget_words, rt.deadline_seconds)) == repr(
            (rr.sram_budget_words, rr.deadline_seconds))
        assert (rt.constraints is None) == (rr.constraints is None)


def test_eviction_storm_only_zeroes_the_accounting():
    flow.clear_sweep_cache()
    svc = _service(faults=F.FaultInjector(evict_every=1))
    assert svc.plan(PlanRequest(graph=F._valid_graphs()[0])).ok
    assert svc.faults.counts["evict_storms"] >= 1
    assert flow.sweep_cache_stats()["entries"] == []


def test_stall_trips_deadline():
    inj = F.FaultInjector(stall_every=1, stall_seconds=0.05)
    r = _service(faults=inj).plan(PlanRequest(graph=F._valid_graphs()[0],
                                              deadline_seconds=0.02))
    assert not r.ok and isinstance(r.error, DeadlineExceeded)
    assert inj.counts["stalls"] == 1


def _chaos(n, seed, inj, **kw):
    svc = _service(faults=inj, max_batch=16, max_queue_depth=n, **kw)
    labelled = list(F.chaos_requests(n, seed=seed))
    rids = [svc.submit(req) for _, req in labelled]
    svc.drain()
    return labelled, [svc.collect(rid) for rid in rids]


def test_chaos_sweep_500_requests_all_typed():
    inj = F.FaultInjector(transient_every=11, stall_every=97, stall_seconds=0.001,
                          evict_every=7)
    labelled, resps = _chaos(500, 7, inj)
    outcomes = collections.Counter()
    audit = {}
    for (label, req), resp in zip(labelled, resps):
        assert resp is not None
        if resp.ok:
            outcomes[f"{label}:ok"] += 1
            if not resp.degraded and not resp.from_cache:
                audit.setdefault((req.graph, req.sram_budget_words), resp)
        else:
            assert isinstance(resp.error, EvaluatorError), type(resp.error).__name__
            outcomes[f"{label}:{resp.error_type}"] += 1
    assert sum(v for k, v in outcomes.items() if k.startswith("valid:")) > 0
    assert any(":GraphValidationError" in k for k in outcomes)
    assert any(":DeadlineExceeded" in k for k in outcomes)
    assert inj.counts["injected_transients"] > 0 and inj.counts["evict_storms"] > 0
    for (g, budget), resp in list(audit.items())[:12]:
        ref = flow.run_fleet([g], config_space=SPACE, groupings="search",
                             sram_budget_words=budget, device="cpu").results[0]
        assert _same_plan(resp.plan, ref)


def test_chaos_sweep_with_active_shard_faults_all_typed():
    inj = F.FaultInjector(shard_fail_every=13, transient_every=17, evict_every=11)
    _, resps = _chaos(200, 13, inj, hw_chunk=5)
    assert all(r is not None and (r.ok or isinstance(r.error, EvaluatorError))
               for r in resps)
    assert sum(r.ok for r in resps) > 0
    assert inj.counts["injected_shard_failures"] > 0 and inj.counts["chunk_computes"] > 0


# ---------------------------------------------------------------------------
# async transport, cancellation, breaker, audit (tests/test_async_service.py)
# ---------------------------------------------------------------------------


def _async(**kw):
    kw.setdefault("config_space", SPACE)
    kw.setdefault("backoff_seconds", 0.0)
    kw.setdefault("device", "cpu")
    return AsyncPlanningService(**kw)


def test_async_serves_bit_identical_to_sync():
    req = PlanRequest(graph=RES, sram_budget_words=2e6)
    want = _service().plan(req)
    with _async() as svc:
        got = svc.plan(req, timeout=120)
    assert got.ok and not got.degraded and _same_plan(got.plan, want.plan)


def test_async_drain_on_shutdown_resolves_every_future():
    svc = _async()
    futs = [svc.submit(PlanRequest(graph=[MLP, RES][i % 2])) for i in range(6)]
    svc.shutdown(drain=True, timeout=120)
    assert all(f.done() and f.result().ok for f in futs)
    with pytest.raises(RuntimeError):
        svc.submit(PlanRequest(graph=MLP))


def test_async_context_manager_drains_like_ctrl_c():
    futs = []
    with pytest.raises(KeyboardInterrupt):
        with _async() as svc:
            futs = [svc.submit(PlanRequest(graph=MLP)) for _ in range(3)]
            raise KeyboardInterrupt
    assert all(f.done() and f.result().ok for f in futs)


def test_async_shutdown_without_drain_cancels_pending():
    inj = F.FaultInjector(chunk_stall_seconds=0.05)
    svc = _async(hw_chunk=2, faults=inj)
    futs = [svc.submit(PlanRequest(graph=RES, sram_budget_words=b))
            for b in (float("inf"), 2e6, 1e6)]
    assert _wait_until(lambda: inj.counts["chunks"] >= 1)
    svc.shutdown(drain=False, timeout=120)
    assert all(f.done() for f in futs)
    assert "RequestCancelled" in {f.result().error_type for f in futs}


def test_async_heartbeat_and_watchdog_observe_a_stalled_sweep(tmp_path):
    beat = tmp_path / "heartbeat"
    ages = []
    inj = F.FaultInjector(chunk_stall_seconds=0.25)
    svc = _async(hw_chunk=2, faults=inj, heartbeat_path=beat, watchdog_seconds=0.05,
                 on_stall=ages.append)
    try:
        assert svc.plan(PlanRequest(graph=MLP), timeout=120).ok
        assert beat.exists() and int(beat.read_text().split()[0]) > 0
        assert ages and max(ages) > 0.05
        assert svc.stats()["transport"]["stalls"] >= 1
    finally:
        svc.shutdown(drain=True, timeout=120)


def test_heartbeat_is_never_seen_half_written(tmp_path):
    """The worker rewrites the heartbeat every loop through a temporary
    file and ``os.replace``: a reader polling it meanwhile always finds
    '<pid> <time>' and no temporary file is left behind."""
    beat = tmp_path / "heartbeat"
    svc = _async(heartbeat_path=beat, poll_seconds=0.0005)
    bad, reads = [], 0
    try:
        assert _wait_until(beat.exists)
        t_end = time.monotonic() + 0.5
        while time.monotonic() < t_end:
            text = beat.read_text()
            reads += 1
            parts = text.split()
            if not (text.endswith("\n") and len(parts) == 2 and int(parts[0]) > 0
                    and float(parts[1]) > 0):
                bad.append(text)
    finally:
        svc.shutdown(drain=True, timeout=120)
    assert reads > 100 and not bad
    assert sorted(p.name for p in tmp_path.iterdir()) == ["heartbeat"]


def test_cancel_queued_request_sync():
    svc = _service()
    rid = svc.submit(PlanRequest(graph=MLP))
    assert svc.cancel(rid) is True and svc.cancel(10_000) is False
    svc.drain()
    assert svc.collect(rid).error_type == "RequestCancelled"
    assert svc.cancel(rid) is False


def test_cancel_mid_sweep_stops_within_one_chunk_boundary():
    inj = F.FaultInjector(chunk_stall_seconds=0.15)
    svc = _async(hw_chunk=2, faults=inj)
    try:
        fut = svc.submit(PlanRequest(graph=RES))
        assert _wait_until(lambda: inj.counts["chunks"] >= 1)
        chunks_at_cancel = inj.counts["chunks"]
        t0 = time.monotonic()
        assert svc.cancel(fut) is True
        resp = fut.result(timeout=120)
        assert resp.error_type == "RequestCancelled"
        assert inj.counts["chunks"] <= chunks_at_cancel + 2
        assert time.monotonic() - t0 < 2.0
        assert svc.stats()["counters"]["cancelled_in_sweep"] == 1
    finally:
        svc.shutdown(drain=True, timeout=120)


def test_deadline_enforced_at_chunk_boundary():
    clock = StepClock()
    inj = F.FaultInjector()
    real_before_chunk = inj.before_chunk

    def stall_then_expire():
        real_before_chunk()
        if inj.counts["chunks"] == 2:
            clock.advance(100.0)

    inj.before_chunk = stall_then_expire
    svc = _service(hw_chunk=2, faults=inj, clock=clock)
    rid = svc.submit(PlanRequest(graph=RES, deadline_seconds=50.0))
    svc.drain()
    assert svc.collect(rid).error_type == "DeadlineExceeded"
    assert inj.counts["chunks"] == 2


def _breaker_service(inj, clock):
    return _service(max_retries=0, breaker_threshold=2, breaker_cooldown_seconds=10.0,
                    faults=inj, clock=clock)


def test_breaker_full_lifecycle():
    clock = StepClock()
    inj = F.FaultInjector(transient_sweeps=2)
    svc = _breaker_service(inj, clock)
    assert svc.breaker_state is BreakerState.CLOSED
    for _ in range(2):
        assert svc.plan(PlanRequest(graph=MLP)).error_type == "TransientFailure"
    assert svc.breaker_state is BreakerState.OPEN and svc.stats()["breaker"] == "open"
    assert svc.stats()["counters"]["breaker_trips"] == 1
    resp = svc.plan(PlanRequest(graph=MLP))
    assert resp.ok and resp.degraded and resp.rung == "lbl"
    assert svc.breaker_state is BreakerState.OPEN
    clock.advance(11.0)
    resp = svc.plan(PlanRequest(graph=RES))
    assert resp.ok and not resp.degraded and resp.rung == "exact"
    assert svc.breaker_state is BreakerState.CLOSED
    assert svc.stats()["counters"]["breaker_closes"] == 1


def test_breaker_failed_probe_reopens():
    clock = StepClock()
    inj = F.FaultInjector(transient_sweeps=2)
    svc = _breaker_service(inj, clock)
    for _ in range(2):
        svc.plan(PlanRequest(graph=MLP))
    clock.advance(11.0)
    inj.transient_sweeps = 1
    assert svc.plan(PlanRequest(graph=RES)).error_type == "TransientFailure"
    assert svc.breaker_state is BreakerState.OPEN
    assert svc.stats()["counters"]["breaker_trips"] == 2


def test_shadow_audit_clean_run_is_silent():
    svc = _service(shadow_audit_rate=1.0)
    assert svc.plan(PlanRequest(graph=RES, sram_budget_words=2e6)).ok
    counters = svc.stats()["counters"]
    assert counters["audits"] == 1 and counters.get("audit_mismatches", 0) == 0


def test_shadow_audit_catches_injected_divergence():
    inj = F.FaultInjector(corrupt_audit_every=1)
    svc = _service(shadow_audit_rate=1.0, faults=inj)
    resp = svc.plan(PlanRequest(graph=RES, sram_budget_words=2e6))
    assert not resp.ok and resp.plan is None and resp.error_type == "AuditMismatch"
    assert svc.stats()["counters"]["audit_mismatches"] == 1
    assert inj.counts["audits_corrupted"] == 1


def test_shadow_audit_zero_mismatches_across_chaos_stream():
    svc = _service(shadow_audit_rate=0.25)
    rids = [svc.submit(req) for _, req in F.chaos_requests(24, seed=3)]
    svc.drain()
    assert all(svc.collect(rid) is not None for rid in rids)
    counters = svc.stats()["counters"]
    assert counters["audits"] >= 1 and counters.get("audit_mismatches", 0) == 0


def test_affinity_batching_groups_by_key_without_starvation():
    svc = _service(affinity_batching=True)
    rids_a, rids_b = [], []
    for _ in range(3):
        rids_a.append(svc.submit(PlanRequest(graph=MLP)))
        rids_b.append(svc.submit(PlanRequest(graph=MLP, sram_budget_words=2e6)))
    svc.tick()
    assert all(svc.collect(r) is not None for r in rids_a)
    assert all(svc._responses.get(r) is None for r in rids_b)
    assert svc.queue_depth == 3
    assert svc.stats()["counters"]["affinity_batched"] == 2
    svc.tick()
    assert all(svc.collect(r) is not None for r in rids_b)


def test_plan_cache_stats_matches_sweep_cache_shape():
    svc = _service()
    assert svc.plan(PlanRequest(graph=RES, sram_budget_words=2e6)).ok
    assert svc.plan(PlanRequest(graph=RES, sram_budget_words=2e6)).from_cache
    stats = svc.plan_cache_stats()
    assert set(stats) == set(flow.sweep_cache_stats())
    assert stats["size"] == len(stats["entries"]) == 1
    assert stats["entries"][0]["graph"] == RES.name and stats["entries"][0]["engine"]
    assert stats["hits"] == 1 and stats["evictions"] == 0


def test_plan_cache_stats_safe_under_concurrent_reads():
    svc = _service(plan_cache_capacity=4)
    stop, errors = threading.Event(), []

    def reader():
        while not stop.is_set():
            try:
                s = svc.plan_cache_stats()
                assert s["size"] == len(s["entries"]) <= 4
            except Exception as e:  # pragma: no cover - the failure mode
                errors.append(e)
                return

    t = threading.Thread(target=reader)
    t.start()
    try:
        for i in range(8):
            svc.plan(PlanRequest(graph=[MLP, RES][i % 2],
                                 sram_budget_words=float(2 ** i) * 1e4))
    finally:
        stop.set()
        t.join()
    assert not errors


def test_default_space_stream_plans_like_the_reference():
    """The card phase's workload on the default space, one request each."""
    graphs_t = F._valid_graphs() + [resnet18_ir()]
    graphs_r = RFa._valid_graphs() + [RI.resnet18_ir()]
    t = _service(config_space=default_config_space())
    r = RS.PlanningService(config_space=RA.default_config_space(), backoff_seconds=0.0)
    for gt, gr, b in zip(graphs_t, graphs_r, BUDGETS + [4e6]):
        pt = t.plan(PlanRequest(graph=gt, sram_budget_words=b))
        pr = r.plan(RS.PlanRequest(graph=gr, sram_budget_words=b))
        assert pt.ok == pr.ok and pt.error_type == pr.error_type
        if pt.ok:
            assert _same_plan(pt.plan, pr.plan) and pt.engine == pr.engine
