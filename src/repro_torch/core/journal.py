"""Write-ahead log for the planning service — crash-safe request state.

The planning service (:mod:`repro_torch.core.service`) answers each admitted
request with a typed response, but before this module the answers lived
only in process memory: a crash mid-drain lost every in-flight request and
every already-served plan.  The journal makes the service's externally
visible state *durable and replayable*:

* every admission, tick boundary, response, and cancellation is appended
  to ``wal.jsonl`` as one self-verifying record (sequence number + sha256
  digest over the canonical payload, shared with the sweep checkpoint of
  :mod:`repro_torch.checkpoint`) and fsync'd before the service acts on
  it;
* every ``snapshot_every`` records the full service state is compacted
  into an atomically-committed ``snapshot_<seq>.json`` (tmp + fsync +
  rename, the checkpoint commit idiom), so replay cost stays bounded no
  matter how long the service runs;
* :func:`load` replays snapshot + WAL tail back into plain payloads,
  discarding a torn tail (a record cut mid-write by the crash) but
  refusing silently-corrupted interior records.

Encoding is **bit-exact**: floats round-trip through ``float.hex`` and
numpy arrays through base64 of their raw bytes, so a
:class:`~repro_torch.core.service.PlanResponse` decoded from the journal is
bit-identical to the object that was served before the crash — the
property :meth:`repro_torch.core.service.PlanningService.recover` and the
kill-point tests are built on.  The record layout and every codec are the
JAX reference's, byte for byte: a journal written by either package
recovers in the other.

Record types (``RECORD_TYPES``)::

    admit     {rid, request}           request passed admission validation
    tick      {tick, rids}             these requests entered a sweep tick
    response  {rid, response}          a typed response was recorded
    cancel    {rid}                    cancellation was requested

A request with an ``admit`` record but no ``response`` record is, by
definition, *in flight*: recovery re-enqueues exactly that set and re-runs
it, so every request is answered exactly once across the crash.
"""
from __future__ import annotations

import base64
import dataclasses
import hashlib
import json
import os
import pathlib
import threading

import numpy as np

from .arch import Constraints, DLAConfig
from .errors import EvaluatorError, JournalCorrupt
from .ir import EdgeSpec, GraphIR, LayerSpec

RECORD_TYPES = ("admit", "tick", "response", "cancel")

WAL_NAME = "wal.jsonl"
SNAPSHOT_PREFIX = "snapshot_"


# ---------------------------------------------------------------------------
# bit-exact scalar / array / dataclass codecs
# ---------------------------------------------------------------------------


def enc_float(x: float) -> str:
    """Lossless float encoding (``float.hex`` handles inf; nan spelled out
    because ``float.fromhex('nan')`` works but ``float('nan').hex()`` does
    too — keep the explicit spelling for readability in the log)."""
    x = float(x)
    if np.isnan(x):
        return "nan"
    return x.hex()


def dec_float(s: str) -> float:
    """Inverse of :func:`enc_float`."""
    return float.fromhex(s) if s != "nan" else float("nan")


def enc_array(a: np.ndarray) -> dict:
    """Lossless ndarray encoding: dtype + shape + base64 raw bytes."""
    a = np.ascontiguousarray(a)
    return {
        "dtype": str(a.dtype),
        "shape": list(a.shape),
        "data": base64.b64encode(a.tobytes()).decode("ascii"),
    }


def dec_array(d: dict) -> np.ndarray:
    """Inverse of :func:`enc_array`."""
    raw = base64.b64decode(d["data"])
    return np.frombuffer(raw, dtype=np.dtype(d["dtype"])).reshape(
        d["shape"]
    ).copy()


def _init_fields(obj) -> dict:
    """The init= dataclass fields of ``obj`` (derived fields recompute)."""
    return {
        f.name: getattr(obj, f.name)
        for f in dataclasses.fields(obj)
        if f.init
    }


def enc_graph(g: GraphIR) -> dict:
    """GraphIR -> plain dict (LayerSpec/EdgeSpec fields are ints/strs)."""
    return {
        "name": g.name,
        "nodes": [_init_fields(n) for n in g.nodes],
        "edges": [_init_fields(e) for e in g.edges],
    }


def dec_graph(d: dict) -> GraphIR:
    """Inverse of :func:`enc_graph`; ``__post_init__`` re-validates."""
    return GraphIR(
        name=d["name"],
        nodes=tuple(LayerSpec(**n) for n in d["nodes"]),
        edges=tuple(EdgeSpec(**e) for e in d["edges"]),
    )


def enc_config(c: DLAConfig) -> dict:
    """DLAConfig -> plain dict (floats hex-encoded for exactness)."""
    out = {}
    for name, v in _init_fields(c).items():
        out[name] = enc_float(v) if isinstance(v, float) else v
    return out


def dec_config(d: dict) -> DLAConfig:
    """Inverse of :func:`enc_config`."""
    kw = {
        k: dec_float(v) if isinstance(v, str) and k.startswith(("e_", "area"))
        else v
        for k, v in d.items()
    }
    return DLAConfig(**kw)


def enc_constraints(c: Constraints) -> list[str]:
    """Constraints -> four hex floats in metric order."""
    return [enc_float(x) for x in c.as_row()]


def dec_constraints(row: list[str]) -> Constraints:
    """Inverse of :func:`enc_constraints`."""
    return Constraints(*[dec_float(x) for x in row])


# ---------------------------------------------------------------------------
# request / response codecs (the service's durable vocabulary)
# ---------------------------------------------------------------------------


def enc_request(adm) -> dict:
    """Serialise a validated admission (service ``_Admitted``).

    The *remaining* deadline budget is stored rather than the absolute
    monotonic deadline: monotonic clocks do not survive a process, so a
    recovered request's deadline restarts from its recovery time with the
    budget it had at admission.
    """
    return {
        "rid": adm.request_id,
        "graph": enc_graph(adm.g),
        "budget": enc_float(adm.budget),
        "deadline_budget": enc_float(
            adm.deadline - adm.submitted_at
            if np.isfinite(adm.deadline)
            else float("inf")
        ),
        "constraints": enc_constraints(adm.constraints),
        "config_space": [enc_config(c) for c in adm.config_space],
    }


def dec_request(d: dict) -> dict:
    """Decode :func:`enc_request` into plain kwargs (the service rebuilds
    its internal admission entry from these)."""
    return {
        "rid": int(d["rid"]),
        "graph": dec_graph(d["graph"]),
        "budget": dec_float(d["budget"]),
        "deadline_budget": dec_float(d["deadline_budget"]),
        "constraints": dec_constraints(d["constraints"]),
        "config_space": tuple(dec_config(c) for c in d["config_space"]),
    }


def enc_metrics(m) -> list[str]:
    """Metrics -> four hex floats."""
    return [
        enc_float(m.bandwidth_words),
        enc_float(m.latency_cycles),
        enc_float(m.energy_nj),
        enc_float(m.area_um2),
    ]


def enc_plan(plan) -> dict:
    """FlowResult -> plain dict.  ``pareto`` is not journaled (the service
    never sweeps with ``pareto=True``); a plan carrying one is refused
    loudly rather than silently dropped."""
    if plan.pareto is not None:
        raise JournalCorrupt("refusing to journal a plan with a Pareto front")
    return {
        "best_hw": enc_config(plan.best_hw),
        "best_cuts": enc_array(plan.best_cuts),
        "best_metrics": enc_metrics(plan.best_metrics),
        "group_sizes": list(plan.group_sizes),
        "n_candidates": plan.n_candidates,
        "n_feasible": plan.n_feasible,
        "n_pruned": plan.n_pruned,
        "compile_seconds": enc_float(plan.compile_seconds),
        "sweep_seconds": enc_float(plan.sweep_seconds),
        "candidates_per_second": enc_float(plan.candidates_per_second),
        "search_engine": plan.search_engine,
    }


def dec_plan(d: dict):
    """Inverse of :func:`enc_plan`."""
    from . import flow, metrics as M

    bw, lat, e, a = (dec_float(x) for x in d["best_metrics"])
    return flow.FlowResult(
        best_hw=dec_config(d["best_hw"]),
        best_cuts=dec_array(d["best_cuts"]),
        best_metrics=M.Metrics(
            bandwidth_words=bw, latency_cycles=lat, energy_nj=e, area_um2=a
        ),
        group_sizes=tuple(d["group_sizes"]),
        n_candidates=int(d["n_candidates"]),
        n_feasible=int(d["n_feasible"]),
        n_pruned=int(d["n_pruned"]),
        compile_seconds=dec_float(d["compile_seconds"]),
        sweep_seconds=dec_float(d["sweep_seconds"]),
        candidates_per_second=dec_float(d["candidates_per_second"]),
        search_engine=d["search_engine"],
    )


def enc_error(err: EvaluatorError) -> dict:
    """Typed error -> {type, message, attrs}.  ``cause`` chains are kept
    as repr strings (arbitrary exceptions are not replayable objects)."""
    attrs = {}
    if hasattr(err, "min_feasible_budget_words"):
        attrs["min_feasible_budget_words"] = enc_float(
            err.min_feasible_budget_words
        )
    if hasattr(err, "attempts"):
        attrs["attempts"] = int(err.attempts)
    if getattr(err, "cause", None) is not None:
        attrs["cause_repr"] = repr(err.cause)
    return {"type": type(err).__name__, "message": str(err), "attrs": attrs}


def dec_error(d: dict) -> EvaluatorError:
    """Inverse of :func:`enc_error` — resolves the class by name from
    :mod:`repro_torch.core.errors` (falling back to the root type for classes
    defined elsewhere, e.g. ``fusion.FrontierTooWide``)."""
    from . import errors as E

    cls = getattr(E, d["type"], None)
    if cls is None or not (
        isinstance(cls, type) and issubclass(cls, EvaluatorError)
    ):
        cls = EvaluatorError
    attrs = d.get("attrs", {})
    if cls is E.InfeasibleBudgetError:
        err = cls(
            d["message"],
            min_feasible_budget_words=dec_float(
                attrs.get("min_feasible_budget_words", "nan")
            ),
        )
    elif cls is E.TransientFailure:
        err = cls(d["message"], attempts=attrs.get("attempts", 0))
    else:
        err = cls(d["message"])
    return err


def enc_response(resp) -> dict:
    """PlanResponse -> plain dict, bit-exact where it matters (plan
    contents, quality bound); timing floats ride along as-recorded."""
    return {
        "rid": resp.request_id,
        "ok": resp.ok,
        "plan": enc_plan(resp.plan) if resp.plan is not None else None,
        "error": enc_error(resp.error) if resp.error is not None else None,
        "engine": resp.engine,
        "rung": resp.rung,
        "exact": resp.exact,
        "degraded": resp.degraded,
        "quality_bound": enc_float(resp.quality_bound),
        "from_cache": resp.from_cache,
        "latency_seconds": enc_float(resp.latency_seconds),
    }


def dec_response(d: dict):
    """Inverse of :func:`enc_response`."""
    from .service import PlanResponse

    return PlanResponse(
        request_id=int(d["rid"]),
        ok=bool(d["ok"]),
        plan=dec_plan(d["plan"]) if d["plan"] is not None else None,
        error=dec_error(d["error"]) if d["error"] is not None else None,
        engine=d["engine"],
        rung=d["rung"],
        exact=bool(d["exact"]),
        degraded=bool(d["degraded"]),
        quality_bound=dec_float(d["quality_bound"]),
        from_cache=bool(d["from_cache"]),
        latency_seconds=dec_float(d["latency_seconds"]),
    )


# ---------------------------------------------------------------------------
# the write-ahead log
# ---------------------------------------------------------------------------


def record_digest(seq: int, rtype: str, payload: dict) -> str:
    """sha256 over the canonical (seq, type, payload) JSON — the same
    per-item integrity idiom as the checkpoint manifest.  Public: the
    sweep-chunk checkpoint store (:mod:`repro_torch.checkpoint`) digests its
    records through this exact function, so every durable byte in the
    system shares one verification idiom."""
    blob = json.dumps([seq, rtype, payload], sort_keys=True,
                      separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


class Journal:
    """Appender for one service's write-ahead log.

    Records are applied *after* they are durable: the service journals an
    admission before enqueueing it and a response before recording it, so
    the log is always at least as advanced as the in-memory state a crash
    destroys.  ``fsync=False`` is for tests that exercise replay logic
    without paying per-record fsync latency.
    """

    def __init__(self, journal_dir, *, fsync: bool = True,
                 snapshot_every: int = 0):
        """Open (creating if needed) the WAL in ``journal_dir``."""
        self.dir = pathlib.Path(journal_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.fsync = bool(fsync)
        self.snapshot_every = int(snapshot_every)
        self._seq = _last_seq(self.dir)
        self._since_snapshot = 0
        self._fh = open(self.dir / WAL_NAME, "a", encoding="utf-8")
        # Appends must be serialised: the async transport journals cancel
        # records from the caller thread while the worker journals
        # responses, and the (seq, write, fsync) triple is not atomic.
        self._lock = threading.Lock()

    @property
    def seq(self) -> int:
        """Sequence number of the last appended record (0 = none)."""
        return self._seq

    def append(self, rtype: str, payload: dict) -> int:
        """Durably append one record; returns its sequence number."""
        if rtype not in RECORD_TYPES:
            raise ValueError(f"unknown journal record type {rtype!r}")
        with self._lock:
            self._seq += 1
            rec = {
                "seq": self._seq,
                "type": rtype,
                "payload": payload,
                "digest": record_digest(self._seq, rtype, payload),
            }
            self._fh.write(json.dumps(rec, separators=(",", ":")) + "\n")
            self._fh.flush()
            if self.fsync:
                os.fsync(self._fh.fileno())
            self._since_snapshot += 1
            return self._seq

    def maybe_snapshot(self, state_payload_fn) -> bool:
        """Write a snapshot if ``snapshot_every`` records accumulated since
        the last one.  ``state_payload_fn`` is called only when a snapshot
        is actually due (building the payload is not free)."""
        if not self.snapshot_every:
            return False
        if self._since_snapshot < self.snapshot_every:
            return False
        self.snapshot(state_payload_fn())
        return True

    def snapshot(self, state_payload: dict) -> pathlib.Path:
        """Atomically commit a compacted state snapshot at the current
        sequence number (tmp + fsync + rename, the checkpoint idiom), then
        drop WAL records the snapshot supersedes by rewriting the WAL with
        only the tail.  A crash at any point leaves either the old state
        or the new one, never a mix."""
        with self._lock:
            return self._snapshot_locked(state_payload)

    def _snapshot_locked(self, state_payload: dict) -> pathlib.Path:
        seq = self._seq
        body = {
            "seq": seq,
            "state": state_payload,
        }
        body["digest"] = record_digest(seq, "snapshot", state_payload)
        final = self.dir / f"{SNAPSHOT_PREFIX}{seq:012d}.json"
        tmp = self.dir / f"{SNAPSHOT_PREFIX}{seq:012d}.json.tmp"
        tmp.write_text(json.dumps(body, separators=(",", ":")))
        with open(tmp, "rb") as f:
            os.fsync(f.fileno())
        tmp.rename(final)  # atomic commit
        # Compact: the WAL only needs records after the snapshot.  The
        # snapshot is already durable, so a crash mid-rewrite loses nothing
        # (replay = snapshot + whatever tail survives).
        self._fh.close()
        tail = [
            r for r in _read_wal(self.dir, allow_torn_tail=False)
            if r["seq"] > seq
        ]
        wal_tmp = self.dir / (WAL_NAME + ".tmp")
        with open(wal_tmp, "w", encoding="utf-8") as f:
            for r in tail:
                f.write(json.dumps(r, separators=(",", ":")) + "\n")
            f.flush()
            os.fsync(f.fileno())
        wal_tmp.rename(self.dir / WAL_NAME)
        for old in sorted(self.dir.glob(f"{SNAPSHOT_PREFIX}*.json"))[:-1]:
            old.unlink()
        self._fh = open(self.dir / WAL_NAME, "a", encoding="utf-8")
        self._since_snapshot = 0
        return final

    def close(self) -> None:
        """Flush and close the WAL file handle."""
        with self._lock:
            if not self._fh.closed:
                self._fh.flush()
                if self.fsync:
                    os.fsync(self._fh.fileno())
                self._fh.close()


def _read_wal(journal_dir, *, allow_torn_tail: bool) -> list[dict]:
    """Parse ``wal.jsonl`` into verified records.

    A *torn tail* — the final line truncated or digest-broken, exactly
    what a crash mid-append produces — is discarded when allowed.  A bad
    record with valid records AFTER it is not a crash artifact but real
    corruption, and raises :class:`JournalCorrupt` (never silently skip an
    interior record: the replayed state would be wrong)."""
    path = pathlib.Path(journal_dir) / WAL_NAME
    if not path.exists():
        return []
    records: list[dict] = []
    lines = path.read_text(encoding="utf-8").splitlines()
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
            ok = rec.get("digest") == record_digest(
                rec["seq"], rec["type"], rec["payload"]
            )
        except (json.JSONDecodeError, KeyError, TypeError):
            ok = False
        if not ok:
            if i == len(lines) - 1 and allow_torn_tail:
                break  # crash tore the final append — drop it
            raise JournalCorrupt(
                f"{path}: corrupt record at line {i + 1} "
                f"({len(lines) - 1 - i} valid records follow it)"
            )
        records.append(rec)
    return records


def _last_seq(journal_dir) -> int:
    """Highest durable sequence number (snapshot or WAL), 0 when empty."""
    snap = latest_snapshot(journal_dir)
    seq = snap["seq"] if snap is not None else 0
    recs = _read_wal(journal_dir, allow_torn_tail=True)
    return max([seq] + [r["seq"] for r in recs])


def latest_snapshot(journal_dir) -> dict | None:
    """The newest verified snapshot body, or None.  An unverifiable
    snapshot (torn mid-write before the atomic rename — impossible — or
    bit-rotted after) raises :class:`JournalCorrupt`."""
    path = pathlib.Path(journal_dir)
    if not path.exists():
        return None
    snaps = sorted(path.glob(f"{SNAPSHOT_PREFIX}*.json"))
    if not snaps:
        return None
    body = json.loads(snaps[-1].read_text())
    if body.get("digest") != record_digest(body["seq"], "snapshot", body["state"]):
        raise JournalCorrupt(f"{snaps[-1]}: snapshot digest mismatch")
    return body


def load(journal_dir) -> tuple[dict | None, list[dict]]:
    """Replay a journal directory: (snapshot_state | None, wal_records).

    ``wal_records`` contains only records newer than the snapshot, in
    sequence order, with the torn tail (if any) dropped.  Gaps in the
    sequence raise :class:`JournalCorrupt` — a missing interior record
    means the log cannot be trusted."""
    snap = latest_snapshot(journal_dir)
    base_seq = snap["seq"] if snap is not None else 0
    records = [
        r for r in _read_wal(journal_dir, allow_torn_tail=True)
        if r["seq"] > base_seq
    ]
    expect = base_seq
    for r in records:
        expect += 1
        if r["seq"] != expect:
            raise JournalCorrupt(
                f"journal sequence gap: expected {expect}, got {r['seq']}"
            )
    return (snap["state"] if snap is not None else None), records


# Back-compat alias for the pre-public name (tests and older callers).
_digest = record_digest
