"""Sweep-chunk checkpoints: resumable fleet sweeps.

:class:`SweepCheckpoint` persists every completed hardware-axis chunk of a
chunked fleet sweep (:func:`repro_torch.core.flow.run_fleet` with
``hw_chunk`` and ``checkpoint_dir``) through the journal's bit-exact
codecs, so a killed sweep resumes with only the missing chunks recomputed.
The log format, the record digests and :func:`sweep_fingerprint` are the
JAX reference's, byte for byte: a sweep log written by either package
resumes in the other.  The pytree checkpoints of the training stack
(``save`` / ``restore``, the async writer) wait for the training slice.
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib

import numpy as np

# ---------------------------------------------------------------------------
# Sweep-chunk checkpoints — resumable fleet co-search
# ---------------------------------------------------------------------------

# Record vocabulary of the sweep-chunk log (the JAX reference's, so a log
# written by either package resumes in the other): one `sweep_meta` header binding the
# log to a sweep fingerprint, then one `chunk_plane` per completed
# hardware-axis chunk.
SWEEP_RECORD_TYPES = ("sweep_meta", "chunk_plane")
SWEEP_LOG_NAME = "sweep_chunks.jsonl"


def sweep_fingerprint(args, hw_chunk: int) -> str:
    """sha256 over a chunked sweep's *entire* input (every argument
    array's dtype/shape/raw bytes plus the chunk size).

    Two sweeps share checkpointed chunks iff their fingerprints match, so
    a resumed co-search can never splice planes from a different fleet,
    config space, or chunking into its result.
    """
    h = hashlib.sha256()
    h.update(f"hw_chunk={int(hw_chunk)}".encode())
    for a in args:
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


class SweepCheckpoint:
    """Durable per-chunk result store for resumable fleet sweeps.

    Each completed hw-chunk's raw (G, h, C, 5) plane is appended to a
    JSONL log through the journal's bit-exact codecs
    (:func:`repro_torch.core.journal.enc_array` — dtype/shape/raw bytes, so the
    restored plane is byte-identical) with the journal's sha256 record
    digests.  A killed sweep resumes by :meth:`load`-ing the completed
    planes and recomputing only the missing chunks
    (:func:`repro_torch.core.flow.run_fleet` with ``checkpoint_dir=``).

    Crash semantics follow the WAL: a torn tail (the final record cut
    mid-append) is normal damage and silently dropped — that chunk simply
    recomputes; an *interior* record with a bad digest is refused with
    :class:`repro_torch.core.errors.JournalCorrupt`.  A log written by a
    different sweep (fingerprint mismatch) is discarded and restarted,
    never spliced.
    """

    def __init__(self, directory, *, fsync: bool = True):
        """Open (or create) the sweep-chunk log under ``directory``."""
        self.directory = pathlib.Path(directory)
        self.path = self.directory / SWEEP_LOG_NAME
        self.fsync = bool(fsync)
        self._seq = 0
        self._fingerprint: str | None = None

    def _records(self):
        """Verified records of the log; tolerates only a torn tail."""
        from ..core.errors import JournalCorrupt
        from ..core.journal import record_digest

        if not self.path.exists():
            return []
        lines = [
            ln for ln in self.path.read_bytes().split(b"\n") if ln.strip()
        ]
        records = []
        for i, ln in enumerate(lines):
            last = i == len(lines) - 1
            try:
                rec = json.loads(ln)
                ok = (
                    rec.get("type") in SWEEP_RECORD_TYPES
                    and rec.get("digest")
                    == record_digest(rec["seq"], rec["type"], rec["payload"])
                )
            except (ValueError, KeyError, TypeError):
                ok = False
                rec = None
            if not ok:
                if last:
                    break  # torn tail: that chunk just recomputes
                raise JournalCorrupt(
                    f"{self.path}: interior record {i} failed verification"
                )
            records.append(rec)
        return records

    def load(self, fingerprint: str) -> dict[int, np.ndarray]:
        """{h0 -> raw plane} of every durably completed chunk.

        Binds this store to ``fingerprint``; a log headed by a different
        fingerprint (or missing its ``sweep_meta`` header) belongs to a
        different sweep and is discarded so stale planes can never leak
        into the resumed result.
        """
        from ..core.journal import dec_array

        self._fingerprint = fingerprint
        records = self._records()
        if (
            not records
            or records[0]["type"] != "sweep_meta"
            or records[0]["payload"].get("fingerprint") != fingerprint
        ):
            if self.path.exists():
                self.path.unlink()
            self._seq = 0
            return {}
        self._seq = records[-1]["seq"] + 1
        return {
            int(rec["payload"]["h0"]): dec_array(rec["payload"]["plane"])
            for rec in records[1:]
        }

    def _append(self, rtype: str, payload: dict) -> None:
        from ..core.journal import record_digest

        self.directory.mkdir(parents=True, exist_ok=True)
        rec = {
            "seq": self._seq,
            "type": rtype,
            "payload": payload,
            "digest": record_digest(self._seq, rtype, payload),
        }
        self._seq += 1
        with open(self.path, "a", encoding="ascii") as f:
            f.write(json.dumps(rec, sort_keys=True) + "\n")
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())

    def append_chunk(self, h0: int, plane: np.ndarray) -> None:
        """Durably record one completed chunk's raw plane.

        The record is on disk (fsynced by default) before the caller
        moves on, so a kill at ANY later point never recomputes this
        chunk — the exactly-once property the kill-point tests assert.
        """
        from ..core.journal import enc_array

        if self._fingerprint is None:
            raise ValueError("call load(fingerprint) before append_chunk")
        if self._seq == 0:
            self._append("sweep_meta", {"fingerprint": self._fingerprint})
        self._append(
            "chunk_plane", {"h0": int(h0), "plane": enc_array(plane)}
        )
