"""The port's write-ahead journal and crash recovery, against the JAX
package's.

* every codec gives the reference's JSON, byte for byte, for the same
  objects (hex floats, raw-byte arrays, graphs, configs, constraints,
  requests, plans, typed errors, responses), and decodes it back exactly;
* the WAL tolerates a torn tail but refuses interior corruption and
  sequence gaps; snapshots commit atomically, compact the WAL and verify;
* THE crash property: truncate the journal of a completed 50-request run
  at EVERY record boundary, recover, drain — the answered set is exactly
  the durably owed set, every answer bit-identical to the uninterrupted
  run's (timing fields excluded: they are observations, not answers);
* a journal written by either package recovers in the other.
"""
import dataclasses
import json
import math
import pathlib
import struct

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.core import arch as RA  # noqa: E402
from repro.core import errors as RE  # noqa: E402
from repro.core import flow as RF  # noqa: E402
from repro.core import frontend as RFr  # noqa: E402
from repro.core import ir as RI  # noqa: E402
from repro.core import journal as RJ  # noqa: E402
from repro.core import service as RS  # noqa: E402
from repro_torch.core import arch as TA  # noqa: E402
from repro_torch.core import errors as TE  # noqa: E402
from repro_torch.core import flow as TF  # noqa: E402
from repro_torch.core import frontend as TFr  # noqa: E402
from repro_torch.core import ir as TI  # noqa: E402
from repro_torch.core import journal as J  # noqa: E402
from repro_torch.core import service as TS  # noqa: E402
from repro_torch.core.service import PlanRequest, PlanningService  # noqa: E402

SPACE = tuple(TA.paper_config_space())
RSPACE = tuple(RA.paper_config_space())


def _graphs(I=TI, Fr=TFr):
    return [I.as_graph(Fr.mlp_block_graph()), I.as_graph(I.residual_block_ir())]


def _service(tmp_path, **kw):
    kw.setdefault("config_space", SPACE)
    kw.setdefault("backoff_seconds", 0.0)
    kw.setdefault("journal_fsync", False)
    kw.setdefault("snapshot_every", 0)
    kw.setdefault("device", "cpu")
    return PlanningService(journal_dir=tmp_path, **kw)


def _bits(x: float) -> bytes:
    return struct.pack("<d", float(x))


def _dump(obj) -> str:
    return json.dumps(obj, sort_keys=True)


def assert_responses_equivalent(a, b):
    """Bit-identical *answers* (either package): everything except timing."""
    assert a.request_id == b.request_id
    assert a.ok == b.ok
    assert a.error_type == b.error_type
    assert (a.engine, a.rung, a.exact, a.degraded) == (b.engine, b.rung, b.exact,
                                                       b.degraded)
    assert _bits(a.quality_bound) == _bits(b.quality_bound)
    if a.plan is None:
        assert b.plan is None
        return
    pa, pb = a.plan, b.plan
    assert np.array_equal(pa.best_hw.as_row(), pb.best_hw.as_row())
    assert np.array_equal(pa.best_cuts, pb.best_cuts)
    for f in ("bandwidth_words", "latency_cycles", "energy_nj", "area_um2"):
        assert _bits(getattr(pa.best_metrics, f)) == _bits(getattr(pb.best_metrics, f))
    assert pa.group_sizes == pb.group_sizes
    assert (pa.n_candidates, pa.n_feasible, pa.n_pruned) == (
        pb.n_candidates, pb.n_feasible, pb.n_pruned)


# ---------------------------------------------------------------------------
# codecs: the reference's JSON, byte for byte
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("x", [0.0, -0.0, 1.5, -3.25e300, 5e-324, float("inf"),
                               float("-inf"), float("nan"), 0.1, 1 / 3])
def test_float_codec_bit_exact_and_the_references(x):
    assert J.enc_float(x) == RJ.enc_float(x)
    y = J.dec_float(J.enc_float(x))
    assert math.isnan(y) if math.isnan(x) else _bits(x) == _bits(y)


@pytest.mark.parametrize("case", ["float64", "bool", "int64", "empty", "plane"])
def test_array_codec_bit_exact_and_the_references(case):
    rng = np.random.default_rng(0)
    a = {"float64": rng.standard_normal((3, 5)), "bool": np.array([True, False, True]),
         "int64": np.arange(7, dtype=np.int64).reshape(7, 1),
         "empty": np.zeros((0, 4)), "plane": rng.random((2, 3, 4, 5))}[case]
    assert _dump(J.enc_array(a)) == _dump(RJ.enc_array(a))
    b = J.dec_array(J.enc_array(a))
    assert b.dtype == a.dtype and b.shape == a.shape and a.tobytes() == b.tobytes()


def test_graph_config_constraints_codecs_are_the_references():
    for g_t, g_r in zip(_graphs() + [TI.encoder_decoder_ir()],
                        _graphs(RI, RFr) + [RI.encoder_decoder_ir()]):
        assert _dump(J.enc_graph(g_t)) == _dump(RJ.enc_graph(g_r))
        assert J.dec_graph(J.enc_graph(g_t)) == g_t
        assert J.dec_graph(RJ.enc_graph(g_r)) == g_t
    for c_t, c_r in zip(TA.config_space_grid()[::97], RA.config_space_grid()[::97]):
        assert _dump(J.enc_config(c_t)) == _dump(RJ.enc_config(c_r))
        assert J.dec_config(J.enc_config(c_t)) == c_t
    con = (1.5e6, float("inf"), 2.25e9, float("inf"))
    assert J.enc_constraints(TA.Constraints(*con)) == RJ.enc_constraints(
        RA.Constraints(*con))
    assert J.dec_constraints(J.enc_constraints(TA.Constraints(*con))) == TA.Constraints(*con)


def _admitted(S, A, g, rid, budget, deadline, space):
    return S._Admitted(request_id=rid, g=g, budget=budget, deadline=deadline,
                       constraints=A.Constraints(), config_space=space,
                       submitted_at=100.0, cache_key=())


@pytest.mark.parametrize("deadline", [float("inf"), 100.25])
def test_request_codec_is_the_references(deadline):
    t = _admitted(TS, TA, _graphs()[1], 7, 2e6, deadline, SPACE)
    r = _admitted(RS, RA, _graphs(RI, RFr)[1], 7, 2e6, deadline, RSPACE)
    assert _dump(J.enc_request(t)) == _dump(RJ.enc_request(r))
    d = J.dec_request(J.enc_request(t))
    assert (d["rid"], d["graph"], d["budget"], d["config_space"]) == (7, t.g, 2e6, SPACE)
    assert d["deadline_budget"] == (0.25 if deadline < float("inf") else deadline)


def _fixed_timing(plan):
    return dataclasses.replace(plan, compile_seconds=0.5, sweep_seconds=0.25,
                               candidates_per_second=1024.0)


@pytest.fixture(scope="module")
def plans():
    """The same sweep in both packages, timing fields pinned."""
    kw = dict(groupings="search", sram_budget_words=2e6)
    ref = RF.run_flow(RI.residual_block_ir(), config_space=list(RSPACE), **kw)
    port = TF.run_flow(TI.residual_block_ir(), config_space=list(SPACE),
                       device="cpu", **kw)
    return _fixed_timing(port), _fixed_timing(ref)


def test_plan_codec_is_the_references(plans):
    port, ref = plans
    assert _dump(J.enc_plan(port)) == _dump(RJ.enc_plan(ref))
    back = J.dec_plan(RJ.enc_plan(ref))
    assert isinstance(back, TF.FlowResult)
    assert _dump(J.enc_plan(back)) == _dump(J.enc_plan(port))
    with pytest.raises(TE.JournalCorrupt):
        J.enc_plan(dataclasses.replace(port, pareto=object()))


ERRORS = {
    "InfeasibleBudgetError": lambda E: E.InfeasibleBudgetError(
        "too small", min_feasible_budget_words=4096.0),
    "TransientFailure": lambda E: E.TransientFailure(
        "gone", cause=RuntimeError("x"), attempts=4),
    "DeadlineExceeded": lambda E: E.DeadlineExceeded("late"),
    "ServiceOverloaded": lambda E: E.ServiceOverloaded("full"),
    "RequestCancelled": lambda E: E.RequestCancelled("cancelled"),
    "AuditMismatch": lambda E: E.AuditMismatch("diverged"),
    "GraphValidationError": lambda E: E.GraphValidationError("bad graph"),
    "ConfigValidationError": lambda E: E.ConfigValidationError("bad space"),
    "InfeasibleConstraintsError": lambda E: E.InfeasibleConstraintsError("none"),
    "PoisonedResultError": lambda E: E.PoisonedResultError("all poisoned"),
    "JournalCorrupt": lambda E: E.JournalCorrupt("rot"),
    "SearchDeclined": lambda E: E.SearchDeclined("declined"),
}


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_error_codec_is_the_references_and_keeps_type_and_payload(name):
    e_t, e_r = ERRORS[name](TE), ERRORS[name](RE)
    assert _dump(J.enc_error(e_t)) == _dump(RJ.enc_error(e_r))
    d = J.dec_error(RJ.enc_error(e_r))
    assert type(d) is type(e_t) and str(d) == str(e_t)
    assert type(d).__mro__[1:][0].__name__ == type(e_r).__mro__[1:][0].__name__
    if name == "InfeasibleBudgetError":
        assert d.min_feasible_budget_words == 4096.0
    if name == "TransientFailure":
        assert d.attempts == 4


def test_unknown_error_type_decodes_to_the_root():
    d = J.dec_error({"type": "FrontierTooWide", "message": "wide", "attrs": {}})
    assert type(d) is TE.EvaluatorError and str(d) == "wide"


@pytest.mark.parametrize("kind", ["ok", "error"])
def test_response_codec_is_the_references(plans, kind):
    port, ref = plans
    common = dict(request_id=3, engine="frontier_dp", rung="exact", exact=True,
                  quality_bound=1.25, latency_seconds=0.125)
    if kind == "ok":
        t = TS.PlanResponse(ok=True, plan=port, **common)
        r = RS.PlanResponse(ok=True, plan=ref, **common)
    else:
        t = TS.PlanResponse(ok=False, error=ERRORS["TransientFailure"](TE), **common)
        r = RS.PlanResponse(ok=False, error=ERRORS["TransientFailure"](RE), **common)
    assert _dump(J.enc_response(t)) == _dump(RJ.enc_response(r))
    back = J.dec_response(RJ.enc_response(r))
    assert isinstance(back, TS.PlanResponse)
    # a decoded error keeps its type, message and attempts, not its cause
    assert _dump(J.enc_response(back)) == _dump(
        RJ.enc_response(RJ.dec_response(RJ.enc_response(r))))


def test_record_digest_is_the_references():
    payload = {"rid": 4, "x": [1, 2.5, "a"]}
    assert J.record_digest(9, "admit", payload) == RJ.record_digest(9, "admit", payload)
    assert J.RECORD_TYPES == RJ.RECORD_TYPES
    assert (J.WAL_NAME, J.SNAPSHOT_PREFIX) == (RJ.WAL_NAME, RJ.SNAPSHOT_PREFIX)


# ---------------------------------------------------------------------------
# WAL mechanics
# ---------------------------------------------------------------------------


def test_wal_append_and_load(tmp_path):
    j = J.Journal(tmp_path, fsync=False)
    j.append("admit", {"rid": 0})
    j.append("tick", {"tick": 1, "rids": [0]})
    j.append("response", {"rid": 0})
    j.close()
    state, recs = J.load(tmp_path)
    assert state is None
    assert [r["type"] for r in recs] == ["admit", "tick", "response"]
    assert [r["seq"] for r in recs] == [1, 2, 3]
    assert RJ.load(tmp_path) == (state, recs)  # the reference reads it too


def test_wal_bytes_are_the_references(tmp_path):
    for mod, d in ((J, tmp_path / "port"), (RJ, tmp_path / "ref")):
        j = mod.Journal(d, fsync=False)
        j.append("admit", {"rid": 0, "budget": J.enc_float(0.1)})
        j.append("cancel", {"rid": 0})
        j.close()
    assert (tmp_path / "port" / J.WAL_NAME).read_bytes() == (
        tmp_path / "ref" / J.WAL_NAME).read_bytes()


def test_wal_rejects_unknown_record_type(tmp_path):
    j = J.Journal(tmp_path, fsync=False)
    with pytest.raises(ValueError):
        j.append("frobnicate", {})


def test_torn_tail_is_dropped_but_interior_corruption_raises(tmp_path):
    j = J.Journal(tmp_path, fsync=False)
    for i in range(4):
        j.append("admit", {"rid": i})
    j.close()
    wal = pathlib.Path(tmp_path) / J.WAL_NAME
    lines = wal.read_text().splitlines()
    wal.write_text("\n".join(lines[:-1] + [lines[-1][: len(lines[-1]) // 2]]))
    _, recs = J.load(tmp_path)
    assert [r["payload"]["rid"] for r in recs] == [0, 1, 2]
    wal.write_text("\n".join([lines[0], lines[1][: len(lines[1]) // 2], lines[2],
                              lines[3]]))
    with pytest.raises(TE.JournalCorrupt):
        J.load(tmp_path)


def test_sequence_gap_raises(tmp_path):
    j = J.Journal(tmp_path, fsync=False)
    for i in range(3):
        j.append("admit", {"rid": i})
    j.close()
    wal = pathlib.Path(tmp_path) / J.WAL_NAME
    lines = wal.read_text().splitlines()
    wal.write_text("\n".join([lines[0], lines[2]]))
    with pytest.raises(TE.JournalCorrupt, match="sequence gap"):
        J.load(tmp_path)


def test_snapshot_compacts_and_verifies(tmp_path):
    j = J.Journal(tmp_path, fsync=False, snapshot_every=2)
    j.append("admit", {"rid": 0})
    assert not j.maybe_snapshot(lambda: {"n": 1})
    j.append("admit", {"rid": 1})
    assert j.maybe_snapshot(lambda: {"n": 2})
    j.append("admit", {"rid": 2})
    j.close()
    state, recs = J.load(tmp_path)
    assert state == {"n": 2}
    assert [r["payload"]["rid"] for r in recs] == [2]
    assert len(list(pathlib.Path(tmp_path).glob("snapshot_*.json"))) == 1
    assert J.Journal(tmp_path, fsync=False).seq == 3  # resumes at the last seq
    snap = next(pathlib.Path(tmp_path).glob("snapshot_*.json"))
    body = json.loads(snap.read_text())
    body["state"]["n"] = 999
    snap.write_text(json.dumps(body))
    with pytest.raises(TE.JournalCorrupt):
        J.load(tmp_path)


# ---------------------------------------------------------------------------
# crash recovery: every-record-boundary kill points
# ---------------------------------------------------------------------------


def _submit_stream(svc, graphs, n, request):
    rids = []
    for i in range(n):
        rids.append(svc.submit(request(graph=graphs[i % len(graphs)],
                                       sram_budget_words=[float("inf"), 2e6][(i // 2) % 2])))
        if i % 7 == 6:  # interleave ticks so tick records pepper the WAL
            svc.tick()
    svc.drain()
    return rids


def _run_uninterrupted(tmp_path, n=50, **kw):
    """A journaled n-request run; returns {rid: response}."""
    svc = _service(tmp_path, **kw)
    rids = _submit_stream(svc, _graphs(), n, PlanRequest)
    resps = {rid: svc._responses[rid] for rid in rids}
    svc.close()
    return resps


def _cut_journal(src: pathlib.Path, dst: pathlib.Path, cut: int):
    lines = (src / J.WAL_NAME).read_text().splitlines()
    dst.mkdir()
    (dst / J.WAL_NAME).write_text("".join(line + "\n" for line in lines[:cut]))
    records = [json.loads(line) for line in lines[:cut]]
    admitted = {r["payload"]["rid"] for r in records if r["type"] == "admit"}
    answered = {r["payload"]["rid"] for r in records if r["type"] == "response"}
    return admitted, answered


def test_recover_at_every_record_boundary_is_exactly_once(tmp_path):
    base = tmp_path / "base"
    expected = _run_uninterrupted(base, n=50)
    n_lines = len((base / J.WAL_NAME).read_text().splitlines())
    records = [json.loads(x) for x in (base / J.WAL_NAME).read_text().splitlines()]
    assert sum(r["type"] == "response" for r in records) == 50
    for cut in range(n_lines + 1):
        admitted, answered = _cut_journal(base, tmp_path / f"cut{cut}", cut)
        owed = admitted | answered
        svc = PlanningService.recover(tmp_path / f"cut{cut}", journal_fsync=False,
                                      snapshot_every=0, config_space=SPACE,
                                      backoff_seconds=0.0, device="cpu")
        assert svc.queue_depth == len(admitted - answered)
        svc.drain()
        got = dict(svc._responses)
        assert set(got) == owed, f"cut={cut}"
        for rid in owed:
            assert_responses_equivalent(expected[rid], got[rid])
        for rid in answered:  # replayed answers are byte-identical, timing too
            assert got[rid].latency_seconds == expected[rid].latency_seconds
        svc.close()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_a_journal_written_by_either_package_recovers_in_the_other(tmp_path, writer):
    """Run 30 requests through one package's journaled service, cut its WAL
    at every 4th record boundary, and recover with the other package: the
    answers are the uninterrupted run's, bit for bit."""
    base = tmp_path / "base"
    if writer == "reference":
        svc = RS.PlanningService(journal_dir=base, config_space=RSPACE,
                                 backoff_seconds=0.0, journal_fsync=False,
                                 snapshot_every=0)
        rids = _submit_stream(svc, _graphs(RI, RFr), 30, RS.PlanRequest)
    else:
        svc = _service(base)
        rids = _submit_stream(svc, _graphs(), 30, PlanRequest)
    expected = {rid: svc._responses[rid] for rid in rids}
    svc.close()
    n_lines = len((base / J.WAL_NAME).read_text().splitlines())
    for cut in list(range(0, n_lines, 4)) + [n_lines]:
        admitted, answered = _cut_journal(base, tmp_path / f"cut{cut}", cut)
        kw = dict(journal_fsync=False, snapshot_every=0, backoff_seconds=0.0)
        if writer == "reference":
            rec = PlanningService.recover(tmp_path / f"cut{cut}", config_space=SPACE,
                                          device="cpu", **kw)
        else:
            rec = RS.PlanningService.recover(tmp_path / f"cut{cut}",
                                             config_space=RSPACE, **kw)
        rec.drain()
        assert set(rec._responses) == admitted | answered, f"cut={cut}"
        for rid in rec._responses:
            assert_responses_equivalent(expected[rid], rec._responses[rid])
        rec.close()


def test_recover_with_snapshots_matches(tmp_path):
    base = tmp_path / "snap"
    expected = _run_uninterrupted(base, n=20, snapshot_every=9)
    assert list(base.glob("snapshot_*.json"))
    svc = PlanningService.recover(base, journal_fsync=False, config_space=SPACE,
                                  backoff_seconds=0.0, device="cpu")
    svc.drain()
    assert set(svc._responses) == set(expected)
    for rid, resp in expected.items():
        assert_responses_equivalent(resp, svc._responses[rid])
    svc.close()


def test_recovery_composes_with_itself(tmp_path):
    d = tmp_path / "j"
    svc = _service(d)
    g = _graphs()[0]
    rids = [svc.submit(PlanRequest(graph=g)) for _ in range(3)]
    svc.tick()
    r4 = svc.submit(PlanRequest(graph=_graphs()[1]))
    svc.close()
    kw = dict(journal_fsync=False, config_space=SPACE, backoff_seconds=0.0, device="cpu")
    mid = PlanningService.recover(d, **kw)
    assert mid.queue_depth == 1
    mid.close()
    fin = PlanningService.recover(d, **kw)
    assert fin.queue_depth == 1
    fin.drain()
    assert set(fin._responses) == set(rids) | {r4}
    assert fin._responses[r4].ok
    fin.close()


def test_recover_honours_precrash_cancel(tmp_path):
    d = tmp_path / "j"
    svc = _service(d)
    rid = svc.submit(PlanRequest(graph=_graphs()[0]))
    assert svc.cancel(rid)
    svc.close()
    rec = PlanningService.recover(d, journal_fsync=False, config_space=SPACE,
                                  backoff_seconds=0.0, device="cpu")
    assert rec.queue_depth == 0
    resp = rec.collect(rid)
    assert resp is not None and resp.error_type == "RequestCancelled"
    rec.close()


def test_recovered_deadline_restarts_with_admission_budget(tmp_path):
    d = tmp_path / "j"
    svc = _service(d)
    svc.submit(PlanRequest(graph=_graphs()[0], deadline_seconds=123.0))
    svc.submit(PlanRequest(graph=_graphs()[0]))
    svc.close()
    rec = PlanningService.recover(d, journal_fsync=False, config_space=SPACE,
                                  backoff_seconds=0.0, device="cpu")
    adms = list(rec._queue)
    now = rec.clock()
    assert 120.0 < adms[0].deadline - now < 124.0
    assert adms[1].deadline == float("inf")
    rec.close()
