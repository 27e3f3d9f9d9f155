"""Fault-tolerant fleet sweeps in the port, against the JAX package's.

The reference's salvage contract (tests/test_salvage.py), run through the
port on the CPU, with every answer held bit-identical to the reference's:

* ``RetryPolicy`` and ``StragglerDetector`` behave as the reference's;
* an injected NaN/Inf/negative/overflow cell is quarantined with the same
  global (graph, hw, cut) provenance and never wins;
* chunk failures are salvaged by the retry policy; a sick device layout
  degrades to its first device bit-identically;
* a chunked sweep killed at ANY chunk boundary resumes with exactly-once
  recomputation, and the sweep log is the reference's byte for byte: the
  two packages compute the same ``sweep_fingerprint`` for the same sweep,
  and a log written by either resumes in the other.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.checkpoint import SweepCheckpoint as RCkpt  # noqa: E402
from repro.checkpoint import sweep_fingerprint as r_fingerprint  # noqa: E402
from repro.core import arch as RA  # noqa: E402
from repro.core import errors as RE  # noqa: E402
from repro.core import flow as RF  # noqa: E402
from repro.core import ir as RI  # noqa: E402
from repro.core import metrics as RM  # noqa: E402
from repro.runtime.fault_tolerance import StragglerDetector as RStraggler  # noqa: E402
from repro.testing import faults as RFa  # noqa: E402
from repro_torch.checkpoint import SweepCheckpoint, sweep_fingerprint  # noqa: E402
from repro_torch.checkpoint import checkpoint as TC  # noqa: E402
from repro_torch.core import arch as TA  # noqa: E402
from repro_torch.core import flow as TF  # noqa: E402
from repro_torch.core import ir as TI  # noqa: E402
from repro_torch.core import metrics as TM  # noqa: E402
from repro_torch.core.errors import (  # noqa: E402
    EvaluatorError,
    GraphValidationError,
    JournalCorrupt,
    PoisonedResultError,
    RetryPolicy,
    TransientFailure,
)
from repro_torch.core.service import PlanRequest, PlanningService  # noqa: E402
from repro_torch.runtime.elastic import sweep_degradation_ladder  # noqa: E402
from repro_torch.runtime.fault_tolerance import StragglerDetector  # noqa: E402
from repro_torch.testing.faults import FaultInjector, InjectedShardFailure  # noqa: E402

INF = float("inf")
GRID = dict(f1s=(2, 4), f2s=(2, 4), f3s=(2, 4), f4s=(2, 4), bus_widths=(2, 4),
            sram_splits=("unified",))
SPACE = TA.config_space_grid(**GRID)  # 48 configs -> 6 chunks of 8
RSPACE = RA.config_space_grid(**GRID)
HW_CHUNK = 8
N_CHUNKS = -(-len(SPACE) // HW_CHUNK)


def _graph(I=TI):
    return I.as_graph(I.residual_block_ir())


def _cut_batch(g):
    """Explicit (C, E) grouping batch with a known candidate order."""
    rng = np.random.default_rng(11)
    rows = [np.ones(g.n_edges, bool), np.zeros(g.n_edges, bool)]
    rows += [rng.random(g.n_edges) < 0.5 for _ in range(4)]
    return np.unique(np.stack(rows), axis=0)


def _run(g, batch, **kw):
    kw.setdefault("config_space", SPACE)
    kw.setdefault("constraints", TA.Constraints(*[INF] * 4))
    if kw.get("devices") is None:
        kw.setdefault("device", "cpu")
    return TF.run_fleet([g], groupings=[batch], **kw)


def _ref(batch, **kw):
    kw.setdefault("config_space", RSPACE)
    kw.setdefault("constraints", RA.Constraints(*[INF] * 4))
    return RF.run_fleet([_graph(RI)], groupings=[batch], **kw)


def _metrics(m) -> tuple:
    return (m.bandwidth_words, m.latency_cycles, m.energy_nj, m.area_um2)


def assert_same_fleet(a, b):
    """Bit-identity of two FleetResults' answers (either package)."""
    assert a.n_graphs == b.n_graphs and a.n_candidates == b.n_candidates
    for ra, rb in zip(a.results, b.results):
        assert np.array_equal(ra.best_hw.as_row(), rb.best_hw.as_row())
        assert np.array_equal(ra.best_cuts, rb.best_cuts)
        assert _metrics(ra.best_metrics) == _metrics(rb.best_metrics)
        assert ra.group_sizes == rb.group_sizes
        assert (ra.n_feasible, ra.n_pruned) == (rb.n_feasible, rb.n_pruned)


def _cells(q) -> list:
    return [dataclasses.astuple(c) for c in q.cells] if q is not None else []


def _winner_cell(res, batch, space):
    h = next(i for i, cfg in enumerate(space)
             if np.array_equal(cfg.as_row(), res.best_hw.as_row()))
    c = next(i for i in range(batch.shape[0])
             if np.array_equal(batch[i], res.best_cuts))
    return h, c


class _KillSwitch(Exception):
    """The simulated process kill (NOT an EvaluatorError: nothing below
    the test may absorb it)."""


def _killer(n_allowed: int):
    """abort_check that lets ``n_allowed`` boundary checks pass, then
    kills the sweep."""
    calls = {"n": 0}

    def check():
        calls["n"] += 1
        if calls["n"] > n_allowed:
            raise _KillSwitch(f"killed at boundary check {calls['n']}")

    return check


# ---------------------------------------------------------------------------
# RetryPolicy and StragglerDetector
# ---------------------------------------------------------------------------


def test_retry_policy_delay_schedule_is_the_references():
    kw = dict(max_retries=5, backoff_seconds=0.1, multiplier=2.0,
              max_backoff_seconds=0.3)
    p, r = RetryPolicy(**kw), RE.RetryPolicy(**kw)
    assert [p.delay(i) for i in range(6)] == [r.delay(i) for i in range(6)]
    assert [p.delay(i) for i in range(4)] == [0.1, 0.2, 0.3, 0.3]
    assert dataclasses.astuple(RetryPolicy()) == dataclasses.astuple(RE.RetryPolicy())


@pytest.mark.parametrize("kw", [{"max_retries": -1}, {"backoff_seconds": -0.1},
                                {"multiplier": 0.5}, {"max_backoff_seconds": -1.0}],
                         ids=lambda kw: next(iter(kw)))
def test_retry_policy_validates_knobs_like_reference(kw):
    with pytest.raises(ValueError) as ep:
        RetryPolicy(**kw)
    with pytest.raises(ValueError) as er:
        RE.RetryPolicy(**kw)
    assert str(ep.value) == str(er.value)


def test_retry_policy_retries_transients_then_succeeds():
    p = RetryPolicy(max_retries=3, backoff_seconds=0.1, multiplier=2.0)
    slept, retried, state = [], [], {"fails": 2}

    def fn():
        if state["fails"]:
            state["fails"] -= 1
            raise RuntimeError("flake")
        return "ok"

    out = p.call(fn, sleep=slept.append,
                 on_retry=lambda a, e: retried.append((a, type(e).__name__)))
    assert out == "ok"
    assert slept == [p.delay(0), p.delay(1)]
    assert retried == [(0, "RuntimeError"), (1, "RuntimeError")]


def test_retry_policy_never_retries_typed_evaluator_errors():
    p = RetryPolicy(max_retries=5, backoff_seconds=1.0)
    slept, calls = [], {"n": 0}

    def fn():
        calls["n"] += 1
        raise GraphValidationError("deterministic verdict")

    with pytest.raises(GraphValidationError):
        p.call(fn, sleep=slept.append)
    assert calls["n"] == 1 and slept == []


def test_retry_policy_exhaustion_is_typed_like_reference():
    def fn():
        raise KeyError("persistent")

    with pytest.raises(TransientFailure) as ep:
        RetryPolicy(max_retries=2, backoff_seconds=0.0).call(fn, describe="hw chunk 3")
    with pytest.raises(RE.TransientFailure) as er:
        RE.RetryPolicy(max_retries=2, backoff_seconds=0.0).call(fn, describe="hw chunk 3")
    assert str(ep.value) == str(er.value)
    assert "hw chunk 3 failed after 3 attempts" in str(ep.value)
    assert ep.value.attempts == er.value.attempts == 3
    assert isinstance(ep.value.cause, KeyError)
    assert isinstance(ep.value, EvaluatorError)


def test_straggler_detector_warms_up_then_flags_like_reference():
    d = StragglerDetector(factor=3.0, min_deadline_s=0.0, min_samples=5)
    r = RStraggler(factor=3.0, min_deadline_s=0.0, min_samples=5)
    for dt in [0.1, 0.1, 0.1, 0.1]:
        assert d.deadline() == r.deadline() == INF
        d.observe(dt)
        r.observe(dt)
    assert not d.is_straggler(100.0)
    for dt in [0.1, 0.3, 0.05, 0.2, 0.1]:
        d.observe(dt)
        r.observe(dt)
        assert d.deadline() == r.deadline()
        for probe in (0.29, 0.31, 0.61, 1.0):
            assert d.is_straggler(probe) == r.is_straggler(probe)


def test_straggler_detector_window_is_bounded():
    d = StragglerDetector(window=10)
    for i in range(100):
        d.observe(float(i))
    assert len(d._durations) == 10 and d._durations[0] == 90.0


def test_degradation_ladder_is_the_references():
    from repro.runtime.elastic import sweep_degradation_ladder as r_ladder

    for devices in (None, 1, 2, ("cpu", "cpu")):
        assert sweep_degradation_ladder(devices) == r_ladder(devices)


# ---------------------------------------------------------------------------
# the finite guard and quarantine
# ---------------------------------------------------------------------------


def test_poison_mask_flags_each_poison_kind_like_reference():
    raw = np.ones((2, 3, 5))
    raw[0, 0, 1] = np.nan
    raw[0, 2, 0] = np.inf
    raw[1, 1, 4] = -1.0
    raw[1, 2, 2] = 2.0 ** 60
    mask = TM.poison_mask(raw)
    assert mask.tolist() == [[True, False, True], [False, True, True]]
    assert np.array_equal(mask, RM.poison_mask(raw))


@pytest.mark.parametrize("bad", [np.nan, np.inf, -1.0, 1.5, float(2 ** 54)])
def test_assert_exact_f64_names_the_offender_like_reference(bad):
    TM.assert_exact_f64(np.array([0.0, 1.0, 2.0 ** 53]))
    with pytest.raises(GraphValidationError) as ep:
        TM.assert_exact_f64(np.array([1.0, bad]))
    with pytest.raises(RE.GraphValidationError) as er:
        RM.assert_exact_f64(np.array([1.0, bad]))
    assert str(ep.value) == str(er.value)


def test_poisoned_nonwinner_never_perturbs_the_argmin():
    g = _graph()
    batch = _cut_batch(g)
    clean = _run(g, batch)
    h_win, c_win = _winner_cell(clean.results[0], batch, SPACE)
    h_bad = (h_win + 1) % len(SPACE)
    faults = FaultInjector(poison_cell=(0, h_bad, c_win))
    r = _run(g, batch, hooks=faults)
    assert faults.counts["poisoned_cells"] == 1
    assert_same_fleet(dataclasses.replace(
        clean, results=(dataclasses.replace(
            clean.results[0], n_feasible=clean.results[0].n_feasible - 1),)), r)
    cell = r.quarantine.cells[0]
    assert (cell.graph, cell.hw, cell.cut, cell.reason) == (0, h_bad, c_win, "nan")
    assert cell.column in TF.RAW_COLUMNS
    assert r.results[0].quarantine.cells == r.quarantine.cells
    ref = _ref(batch, hooks=RFa.FaultInjector(poison_cell=(0, h_bad, c_win)))
    assert_same_fleet(r, ref)
    assert str(_cells(r.quarantine)) == str(_cells(ref.quarantine))


def test_poisoned_winner_is_quarantined_not_selected():
    g = _graph()
    batch = _cut_batch(g)
    clean = _run(g, batch)
    h_win, c_win = _winner_cell(clean.results[0], batch, SPACE)
    r = _run(g, batch, hooks=FaultInjector(poison_cell=(0, h_win, c_win)), pareto=True)
    assert _winner_cell(r.results[0], batch, SPACE) != (h_win, c_win)
    assert r.results[0].n_feasible == clean.results[0].n_feasible - 1
    assert "(g=0, h=" in r.quarantine.describe()
    front = r.results[0].pareto
    assert front is not None and np.isfinite(front.metrics).all()
    ref = _ref(batch, hooks=RFa.FaultInjector(poison_cell=(0, h_win, c_win)), pareto=True)
    assert_same_fleet(r, ref)
    assert np.array_equal(front.metrics, ref.results[0].pareto.metrics)
    assert np.array_equal(front.hw_indices, ref.results[0].pareto.hw_indices)


@pytest.mark.parametrize("value,reason", [(INF, "inf"), (-1.0, "negative"),
                                          (2.0 ** 60, "overflow")])
def test_quarantine_names_each_poison_reason(value, reason):
    g = _graph()
    batch = _cut_batch(g)
    r = _run(g, batch, hooks=FaultInjector(poison_cell=(0, 3, 0), poison_value=value))
    assert r.quarantine.cells[0].reason == reason
    assert r.quarantine.cells[0].value == value
    ref = _ref(batch, hooks=RFa.FaultInjector(poison_cell=(0, 3, 0), poison_value=value))
    assert str(_cells(r.quarantine)) == str(_cells(ref.quarantine))


def test_fully_poisoned_graph_raises_typed_error():
    g = _graph()
    batch = _cut_batch(g)

    class _PoisonEverything:
        def poison_plane(self, plane, h0):
            plane = np.array(plane, copy=True)
            plane[...] = np.nan
            return plane

    with pytest.raises(PoisonedResultError) as ei:
        _run(g, batch, hooks=_PoisonEverything())
    assert len(ei.value.quarantined) == len(SPACE) * batch.shape[0]
    assert isinstance(ei.value, ArithmeticError)
    assert isinstance(ei.value, EvaluatorError)


@pytest.mark.parametrize("devices", [None, ("cpu", "cpu", "cpu")], ids=["one", "split3"])
def test_quarantine_provenance_uses_global_hw_index_across_chunks(devices):
    g = _graph()
    batch = _cut_batch(g)
    h_bad = 2 * HW_CHUNK + 3  # lives in chunk 2 of the chunked sweep
    faults = FaultInjector(poison_cell=(0, h_bad, 1))
    kw = {"hw_chunk": HW_CHUNK} if devices is None else {"devices": devices}
    r = _run(g, batch, hooks=faults, **kw)
    assert faults.counts["poisoned_cells"] == 1
    assert r.quarantine.cells[0].hw == h_bad
    ref = _ref(batch, hw_chunk=HW_CHUNK,
               hooks=RFa.FaultInjector(poison_cell=(0, h_bad, 1)))
    assert str(_cells(r.quarantine)) == str(_cells(ref.quarantine))
    assert_same_fleet(r, ref)


# ---------------------------------------------------------------------------
# chunk salvage and the sick layout
# ---------------------------------------------------------------------------


def test_chunk_failures_are_salvaged_by_retry_policy():
    g = _graph()
    batch = _cut_batch(g)
    clean = _run(g, batch)
    faults = FaultInjector(shard_fail_chunks=2)
    r = _run(g, batch, hw_chunk=HW_CHUNK, hooks=faults,
             retry_policy=RetryPolicy(max_retries=3, backoff_seconds=0.0))
    assert_same_fleet(clean, r)
    assert faults.counts["injected_shard_failures"] == 2
    assert faults.counts["chunk_computes"] == N_CHUNKS + 2
    assert r.chunks_computed == N_CHUNKS


def test_chunk_retry_exhaustion_is_typed():
    g = _graph()
    batch = _cut_batch(g)
    with pytest.raises(TransientFailure) as ei:
        _run(g, batch, hw_chunk=HW_CHUNK, hooks=FaultInjector(shard_fail_chunks=100),
             retry_policy=RetryPolicy(max_retries=1, backoff_seconds=0.0))
    assert ei.value.attempts == 2
    assert isinstance(ei.value.cause, InjectedShardFailure)
    assert "hw chunk 0 failed after 2 attempts" in str(ei.value)


@pytest.mark.parametrize("devices", [None, ("cpu", "cpu")], ids=["one", "split"])
def test_without_retry_policy_shard_failures_propagate_raw(devices):
    g = _graph()
    batch = _cut_batch(g)
    kw = {"hw_chunk": HW_CHUNK} if devices is None else {"devices": devices}
    with pytest.raises(InjectedShardFailure):
        _run(g, batch, hooks=FaultInjector(shard_fail_chunks=1), **kw)


@pytest.mark.parametrize("injector", ["shard_fail_chunks", "mesh_fail_sweeps"])
def test_sick_layout_degrades_to_its_first_device_bit_identically(injector):
    g = _graph()
    batch = _cut_batch(g)
    clean = _run(g, batch)
    # Fail the split sweep through its whole retry budget (2 attempts),
    # then heal: the degraded single-device rung must answer.
    faults = FaultInjector(**{injector: 2})
    r = _run(g, batch, devices=("cpu", "cpu", "cpu"), hooks=faults,
             retry_policy=RetryPolicy(max_retries=1, backoff_seconds=0.0))
    assert r.mesh_degraded and r.device_count == 1
    assert faults.counts["chunk_computes"] == 3
    assert "degraded to single-device" in r.describe()
    assert_same_fleet(clean, r)
    ref = _ref(batch, devices=1, hooks=RFa.FaultInjector(shard_fail_chunks=2),
               retry_policy=RE.RetryPolicy(max_retries=1, backoff_seconds=0.0))
    assert ref.mesh_degraded
    assert_same_fleet(r, ref)


def test_a_layout_that_stays_sick_fails_typed():
    g = _graph()
    batch = _cut_batch(g)
    with pytest.raises(TransientFailure):
        _run(g, batch, devices=("cpu", "cpu"), hooks=FaultInjector(shard_fail_chunks=100),
             retry_policy=RetryPolicy(max_retries=1, backoff_seconds=0.0))


# ---------------------------------------------------------------------------
# SweepCheckpoint
# ---------------------------------------------------------------------------


def test_sweep_checkpoint_roundtrip_is_bit_exact(tmp_path):
    rng = np.random.default_rng(3)
    planes = {0: rng.random((2, 4, 3, 5)), 4: rng.random((2, 4, 3, 5))}
    ck = SweepCheckpoint(tmp_path)
    assert ck.load("fp") == {}
    for h0, p in planes.items():
        ck.append_chunk(h0, p)
    got = SweepCheckpoint(tmp_path).load("fp")
    assert set(got) == {0, 4}
    for h0 in planes:
        assert got[h0].dtype == planes[h0].dtype
        assert got[h0].tobytes() == planes[h0].tobytes()
    # ... and the reference's store reads the same log
    theirs = RCkpt(tmp_path).load("fp")
    assert {h0: p.tobytes() for h0, p in theirs.items()} == {
        h0: p.tobytes() for h0, p in got.items()}


def test_sweep_checkpoint_log_is_byte_identical_to_the_references(tmp_path):
    rng = np.random.default_rng(4)
    planes = [(0, rng.random((1, 8, 4, 5))), (8, rng.random((1, 8, 4, 5)))]
    for store, d in ((SweepCheckpoint, tmp_path / "port"), (RCkpt, tmp_path / "ref")):
        ck = store(d)
        ck.load("fingerprint")
        for h0, p in planes:
            ck.append_chunk(h0, p)
    assert TC.SWEEP_RECORD_TYPES == ("sweep_meta", "chunk_plane")
    assert (tmp_path / "port" / TC.SWEEP_LOG_NAME).read_bytes() == (
        tmp_path / "ref" / TC.SWEEP_LOG_NAME).read_bytes()


def test_sweep_checkpoint_requires_load_before_append(tmp_path):
    with pytest.raises(ValueError, match="load"):
        SweepCheckpoint(tmp_path).append_chunk(0, np.ones((1, 1, 1, 5)))


def test_sweep_checkpoint_discards_foreign_fingerprint(tmp_path):
    ck = SweepCheckpoint(tmp_path)
    ck.load("sweep-a")
    ck.append_chunk(0, np.ones((1, 2, 3, 5)))
    assert SweepCheckpoint(tmp_path).load("sweep-b") == {}
    assert not ck.path.exists()


def test_sweep_checkpoint_tolerates_torn_tail_only(tmp_path):
    ck = SweepCheckpoint(tmp_path)
    ck.load("fp")
    ck.append_chunk(0, np.ones((1, 1, 1, 5)))
    ck.append_chunk(1, np.full((1, 1, 1, 5), 2.0))
    raw = ck.path.read_bytes()
    ck.path.write_bytes(raw[: len(raw) - 40])
    assert list(SweepCheckpoint(tmp_path).load("fp")) == [0]
    lines = raw.split(b"\n")
    lines[1] = lines[1].replace(b'"h0": 0', b'"h0": 7')
    ck.path.write_bytes(b"\n".join(lines))
    with pytest.raises(JournalCorrupt):
        SweepCheckpoint(tmp_path).load("fp")


def test_sweep_fingerprint_binds_every_input_like_reference():
    a = (np.ones((2, 3)), np.arange(4.0), np.array([True, False]))
    fp = sweep_fingerprint(a, 8)
    assert fp == r_fingerprint(a, 8)
    assert fp == sweep_fingerprint(tuple(np.copy(x) for x in a), 8)
    assert fp != sweep_fingerprint(a, 4)
    assert fp != sweep_fingerprint((np.ones((2, 3)), np.arange(4.0) + 1, a[2]), 8)


def _log_fingerprint(directory) -> str:
    """The fingerprint a sweep log's ``sweep_meta`` header binds."""
    import json

    first = (directory / TC.SWEEP_LOG_NAME).read_text().splitlines()[0]
    return json.loads(first)["payload"]["fingerprint"]


@pytest.mark.parametrize("devices_case", ["explicit", "search", "pool-budget"])
def test_both_packages_fingerprint_the_same_sweep_alike(tmp_path, devices_case):
    """run_fleet builds the reference's argument arrays (dtypes, shapes and
    bytes), so the two logs bind the same fingerprint."""
    g_t, g_r = _graph(), _graph(RI)
    spec = {"explicit": [_cut_batch(g_t)], "search": "search",
            "pool-budget": "pool"}[devices_case]
    kw = {"sram_budget_words": 4e5} if devices_case == "pool-budget" else {}
    TF.run_fleet([g_t, TI.resnet18_ir()] if devices_case != "explicit" else [g_t],
                 config_space=SPACE, groupings=spec, hw_chunk=HW_CHUNK,
                 checkpoint_dir=tmp_path / "port", device="cpu",
                 constraints=TA.Constraints(*[INF] * 4), **kw)
    RF.run_fleet([g_r, RI.resnet18_ir()] if devices_case != "explicit" else [g_r],
                 config_space=RSPACE, groupings=spec, hw_chunk=HW_CHUNK,
                 checkpoint_dir=tmp_path / "ref",
                 constraints=RA.Constraints(*[INF] * 4), **kw)
    assert _log_fingerprint(tmp_path / "port") == _log_fingerprint(tmp_path / "ref")
    assert (tmp_path / "port" / TC.SWEEP_LOG_NAME).read_bytes() == (
        tmp_path / "ref" / TC.SWEEP_LOG_NAME).read_bytes()


# ---------------------------------------------------------------------------
# resumable checkpoints: kill at EVERY chunk boundary
# ---------------------------------------------------------------------------


def test_checkpoint_dir_requires_hw_chunk():
    with pytest.raises(ValueError, match="hw_chunk"):
        _run(_graph(), _cut_batch(_graph()), checkpoint_dir="/nonexistent")


@pytest.mark.parametrize("kill_at", range(1, N_CHUNKS))
def test_kill_at_every_chunk_boundary_resumes_bit_identically(tmp_path, kill_at):
    g = _graph()
    batch = _cut_batch(g)
    baseline = _run(g, batch, hw_chunk=HW_CHUNK)
    first = FaultInjector()
    with pytest.raises(_KillSwitch):
        _run(g, batch, hw_chunk=HW_CHUNK, checkpoint_dir=tmp_path,
             abort_check=_killer(kill_at), hooks=first)
    assert first.counts["chunk_computes"] == kill_at
    second = FaultInjector()
    r = _run(g, batch, hw_chunk=HW_CHUNK, checkpoint_dir=tmp_path, hooks=second)
    assert r.chunks_restored == kill_at
    assert r.chunks_computed == N_CHUNKS - kill_at
    assert second.counts["chunk_computes"] == N_CHUNKS - kill_at
    assert f"{kill_at} chunks restored" in r.describe()
    assert_same_fleet(baseline, r)


@pytest.mark.parametrize("kill_at", [1, 3, N_CHUNKS - 1])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_a_log_written_by_either_package_resumes_in_the_other(tmp_path, writer, kill_at):
    """Kill one package's chunked sweep at a boundary; the other resumes
    from its log, recomputes only the missing chunks, and answers as an
    unkilled run of either package."""
    g_t, g_r = _graph(), _graph(RI)
    batch = _cut_batch(g_t)
    with pytest.raises(_KillSwitch):
        if writer == "reference":
            _ref(batch, hw_chunk=HW_CHUNK, checkpoint_dir=tmp_path,
                 abort_check=_killer(kill_at))
        else:
            _run(g_t, batch, hw_chunk=HW_CHUNK, checkpoint_dir=tmp_path,
                 abort_check=_killer(kill_at))
    if writer == "reference":
        resumed = _run(g_t, batch, hw_chunk=HW_CHUNK, checkpoint_dir=tmp_path)
    else:
        resumed = _ref(batch, hw_chunk=HW_CHUNK, checkpoint_dir=tmp_path)
    assert resumed.chunks_restored == kill_at
    assert resumed.chunks_computed == N_CHUNKS - kill_at
    assert_same_fleet(resumed, _ref(batch))
    assert_same_fleet(resumed, _run(g_t, batch))


def test_completed_checkpoint_resumes_with_zero_recompute(tmp_path):
    g = _graph()
    batch = _cut_batch(g)
    baseline = _run(g, batch, hw_chunk=HW_CHUNK, checkpoint_dir=tmp_path)
    assert baseline.chunks_computed == N_CHUNKS
    again = FaultInjector()
    r = _run(g, batch, hw_chunk=HW_CHUNK, checkpoint_dir=tmp_path, hooks=again)
    assert r.chunks_restored == N_CHUNKS and r.chunks_computed == 0
    assert again.counts["chunk_computes"] == 0
    assert_same_fleet(baseline, r)


def test_checkpoint_from_different_sweep_is_never_spliced(tmp_path):
    g = _graph()
    batch = _cut_batch(g)
    _run(g, batch, hw_chunk=HW_CHUNK, checkpoint_dir=tmp_path)
    tighter = TA.Constraints(INF, INF, INF, 1e12)  # constraints are post-sweep
    r = _run(g, batch, hw_chunk=HW_CHUNK, checkpoint_dir=tmp_path, constraints=tighter)
    assert r.chunks_restored == N_CHUNKS
    smaller = _cut_batch(g)[:2]  # different sweep inputs -> new fingerprint
    r2 = _run(g, smaller, hw_chunk=HW_CHUNK, checkpoint_dir=tmp_path)
    assert r2.chunks_restored == 0 and r2.chunks_computed == N_CHUNKS
    assert_same_fleet(_run(g, smaller, hw_chunk=HW_CHUNK), r2)


# ---------------------------------------------------------------------------
# service integration: one RetryPolicy, salvage across request retries
# ---------------------------------------------------------------------------


def test_service_checkpoint_dir_requires_hw_chunk(tmp_path):
    with pytest.raises(ValueError, match="hw_chunk"):
        PlanningService(checkpoint_dir=tmp_path, device="cpu")


def test_service_retry_policy_overrides_legacy_knobs():
    p = RetryPolicy(max_retries=7, backoff_seconds=0.0)
    assert PlanningService(retry_policy=p, device="cpu").retry_policy is p
    legacy = PlanningService(max_retries=2, backoff_seconds=0.125, device="cpu")
    assert legacy.retry_policy == RetryPolicy(max_retries=2, backoff_seconds=0.125)


def test_service_salvages_completed_chunks_across_request_retries(tmp_path):
    g = _graph()

    class _MidSweepCrash:
        """Raises once from the 3rd between-chunk boundary check — after
        two chunks are durable — so the request-level retry resumes."""

        def __init__(self):
            self.chunks = 0
            self.fired = False

        def before_chunk(self):
            self.chunks += 1
            if self.chunks == 3 and not self.fired:
                self.fired = True
                raise InjectedShardFailure("mid-sweep crash")

    faults = _MidSweepCrash()
    svc = PlanningService(config_space=SPACE, hw_chunk=HW_CHUNK, checkpoint_dir=tmp_path,
                          faults=faults, backoff_seconds=0.0, device="cpu")
    resp = svc.plan(PlanRequest(graph=g))
    assert resp.ok and faults.fired
    assert svc.stats()["counters"]["transient_retries"] == 1
    ref = RF.run_fleet([_graph(RI)], config_space=RSPACE, groupings="search").results[0]
    assert _metrics(resp.plan.best_metrics) == _metrics(ref.best_metrics)
    assert np.array_equal(resp.plan.best_cuts, ref.best_cuts)
    assert np.array_equal(resp.plan.best_hw.as_row(), ref.best_hw.as_row())
