"""Checkpoints: training pytrees and the fleet sweep's per-chunk store.

Training checkpoints (:func:`save` / :func:`restore`, the background
writer :class:`AsyncCheckpointer`) keep the JAX reference's on-disk layout:
``<dir>/step_<N>/arrays.npz`` (the flattened tree, '/'-joined keys: dict
keys and list indices) plus ``manifest.json`` carrying the step, each
array's sha256, shape and dtype, and the caller's ``extra``.  Writes go to
``step_<N>.tmp`` and are renamed only after the manifest is fsynced, so a
crash mid-save never corrupts the latest good step (the trainer's restart
path relies on this).  A bfloat16 tensor is stored as the reference stores
one, 2-byte records (numpy ``|V2``) with dtype ``bfloat16`` in the
manifest, so a flat dict of arrays written by either package restores in
the other.  :func:`restore` returns host numpy arrays;
:func:`device_put_like` moves them to a device as tensors, or places each
rank's pieces under a mesh's shardings.

:class:`SweepCheckpoint` persists every completed hardware-axis chunk of a
chunked fleet sweep (:func:`repro_torch.core.flow.run_fleet` with
``hw_chunk`` and ``checkpoint_dir``) through the journal's bit-exact
codecs, so a killed sweep resumes with only the missing chunks recomputed.
The log format, the record digests and :func:`sweep_fingerprint` are the
JAX reference's, byte for byte: a sweep log written by either package
resumes in the other.
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import shutil
import threading

import numpy as np
import torch

SEP = "/"
_BF16 = "bfloat16"

# ---------------------------------------------------------------------------
# Training checkpoints: pytrees of tensors
# ---------------------------------------------------------------------------


def _items(node, prefix: tuple):
    """(key path, leaf) of every leaf of a tree of dicts, lists and tuples."""
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _items(v, prefix + (str(k),))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _items(v, prefix + (str(i),))
    else:
        yield prefix, node


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as a host numpy array that owns its memory (a tensor is
    copied, so later writes to it do not reach the array); a bfloat16 tensor
    as 2-byte records (``|V2``), the bytes the reference writes for one."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf)


def _flatten(tree) -> dict[str, np.ndarray]:
    return {SEP.join(path): _to_numpy(leaf) for path, leaf in _items(tree, ())}


def _unflatten_into(like, flat: dict):
    """A tree shaped like ``like`` whose leaves are ``flat``'s entries."""

    def build(node, prefix):
        if isinstance(node, dict):
            return {k: build(v, prefix + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            out = [build(v, prefix + (str(i),)) for i, v in enumerate(node)]
            return type(node)(out) if isinstance(node, tuple) else out
        key = SEP.join(prefix)
        if key not in flat:
            raise KeyError(f"checkpoint missing {key}")
        return flat[key]

    return build(like, ())


def save(ckpt_dir, step: int, tree, *, extra: dict | None = None) -> pathlib.Path:
    """Write ``tree`` as step ``step`` under ``ckpt_dir``, atomically;
    returns the step's directory."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    flat = _flatten(tree)
    np.savez(tmp / "arrays.npz", **flat)
    manifest = {
        "step": step,
        "extra": extra or {},
        "arrays": {
            k: {
                "sha256": hashlib.sha256(v.tobytes()).hexdigest(),
                "shape": list(v.shape),
                "dtype": _BF16 if v.dtype == np.dtype("V2") else str(v.dtype),
            }
            for k, v in flat.items()
        },
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    with open(tmp / "manifest.json", "rb") as f:
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic commit
    return final


def latest_step(ckpt_dir) -> int | None:
    """The newest committed step under ``ckpt_dir``, or None."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [
        int(p.name.split("_")[1])
        for p in ckpt_dir.iterdir()
        if p.is_dir() and p.name.startswith("step_") and not p.name.endswith(".tmp")
    ]
    return max(steps) if steps else None


def restore(ckpt_dir, step: int, like=None, *, verify: bool = True):
    """Returns (tree of numpy arrays, extra).  ``like`` gives the tree's
    structure (``None``: the flat dict).  With ``verify`` every array's
    sha256 is checked against the manifest (``IOError`` on a mismatch).
    bfloat16 arrays come back as 2-byte records (``|V2``), as the
    reference's do; :func:`device_put_like` turns them into bfloat16
    tensors."""
    path = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((path / "manifest.json").read_text())
    with np.load(path / "arrays.npz") as z:
        flat = {k: z[k] for k in z.files}
    if verify:
        for k, meta in manifest["arrays"].items():
            h = hashlib.sha256(flat[k].tobytes()).hexdigest()
            if h != meta["sha256"]:
                raise IOError(f"checkpoint corruption in {k}")
    tree = flat if like is None else _unflatten_into(like, flat)
    return tree, manifest.get("extra", {})


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype == np.dtype("V2"):  # bfloat16 records
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def device_put_like(tree_np, device) -> object:
    """Host arrays (as :func:`restore` returns them) as tensors, every leaf
    in its stored dtype: on ``device``, or, given shardings (a
    :class:`~repro_torch.parallel.sharding.NamedSharding` or a tree of them
    shaped like ``tree_np``), each leaf's piece that this rank holds, on the
    sharding's device: the counterpart of the reference's re-sharding onto
    a mesh."""
    if isinstance(device, (dict, list, tuple)) or hasattr(device, "spec"):
        return _put_sharded(tree_np, device)
    if isinstance(tree_np, dict):
        return {k: device_put_like(v, device) for k, v in tree_np.items()}
    if isinstance(tree_np, (list, tuple)):
        return type(tree_np)(device_put_like(v, device) for v in tree_np)
    return _to_tensor(np.asarray(tree_np), device)


def _put_sharded(node, sharding):
    from ..parallel import sharding as SH

    if isinstance(node, dict):
        return {k: _put_sharded(v, sharding[k]) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_put_sharded(v, s) for v, s in zip(node, sharding, strict=True))
    full = _to_tensor(np.asarray(node), "cpu")
    return SH.local_shard(full, sharding, device=SH.sharding_device(sharding))


class AsyncCheckpointer:
    """Background-thread writer; ``wait()`` before reading ``last_saved``.
    :meth:`submit` copies the tree to host memory before it returns, so the
    caller may update its tensors while the write runs."""

    def __init__(self, ckpt_dir):
        self.ckpt_dir = pathlib.Path(ckpt_dir)
        self._thread: threading.Thread | None = None
        self.last_saved: int | None = None
        self._err: Exception | None = None

    def submit(self, step: int, tree, extra: dict | None = None):
        self.wait()
        host_tree = _unflatten_into(tree, _flatten(tree))  # snapshot before async

        def work():
            try:
                save(self.ckpt_dir, step, host_tree, extra=extra)
                self.last_saved = step
            except Exception as e:  # pragma: no cover - raised by wait()
                self._err = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        """Join the write in flight; raise the error it met, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err:
            err, self._err = self._err, None
            raise err


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
