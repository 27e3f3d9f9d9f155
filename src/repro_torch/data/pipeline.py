"""Synthetic token pipeline: deterministic, host-sharded, prefetched.

Counter-based RNG (Philox keyed on (seed, step, host)) makes any batch
recomputable from its step index alone — the property fault-tolerant
training needs: after restore-from-step-N the pipeline replays batch N+1
bit-identically, and straggler re-dispatch re-materialises the exact batch
without coordination.

The "language" is a deterministic mixture (Zipf-ish unigram + a repeated
motif) rather than uniform noise, so the training loss has learnable
structure for the convergence tests and examples.
"""
from __future__ import annotations

import queue
import threading

import numpy as np


def _rng(seed: int, step: int, host: int) -> np.random.Generator:
    key = (int(seed) << 96) | (int(step) << 32) | (int(host) << 16) | 0x5EED
    return np.random.Generator(np.random.Philox(key=key))


def make_batch(cfg, shape_batch: int, seq_len: int, *, seed: int = 0,
               step: int = 0, host: int = 0, n_hosts: int = 1) -> dict:
    """One global (or host-local) batch for the given model config."""
    assert shape_batch % n_hosts == 0
    B = shape_batch // n_hosts
    rng = _rng(seed, step, host)
    V = cfg.vocab_size

    # Zipf-ish unigram + motif repetition => learnable structure.
    total = seq_len + 1
    base = rng.zipf(1.3, size=(B, total)).astype(np.int64) % V
    motif_len = min(16, max(seq_len // 4, 1))
    motif = rng.integers(0, V, size=(B, 1, motif_len))
    reps = total // motif_len + 1
    motif_stream = np.tile(motif, (1, reps, 1)).reshape(B, -1)[:, :total]
    use_motif = rng.random((B, total)) < 0.5
    toks = np.where(use_motif, motif_stream, base).astype(np.int32)

    if cfg.is_encoder_decoder:
        batch = {
            "frontend": rng.standard_normal(
                (B, cfg.frontend_len, cfg.d_model), dtype=np.float32
            ),
            "tokens": toks[:, :seq_len],
            "labels": toks[:, 1 : seq_len + 1],
        }
    elif cfg.frontend:
        text = seq_len - cfg.frontend_len
        labels = np.concatenate(
            [np.full((B, cfg.frontend_len), -1, np.int32), toks[:, 1 : text + 1]],
            axis=1,
        )
        batch = {
            "frontend": rng.standard_normal(
                (B, cfg.frontend_len, cfg.d_model), dtype=np.float32
            ),
            "tokens": toks[:, :text],
            "labels": labels,
        }
    else:
        batch = {"tokens": toks[:, :seq_len], "labels": toks[:, 1 : seq_len + 1]}
    return batch


class TokenStream:
    """Iterator over steps with a background prefetch thread."""

    def __init__(self, cfg, batch: int, seq_len: int, *, seed: int = 0,
                 host: int = 0, n_hosts: int = 1, start_step: int = 0,
                 prefetch: int = 2):
        self.cfg, self.batch, self.seq_len = cfg, batch, seq_len
        self.seed, self.host, self.n_hosts = seed, host, n_hosts
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            b = make_batch(
                self.cfg, self.batch, self.seq_len, seed=self.seed,
                step=step, host=self.host, n_hosts=self.n_hosts,
            )
            while not self._stop.is_set():
                try:
                    self._q.put((step, b), timeout=0.2)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self):
        step, b = self._q.get()
        self.step = step + 1
        return step, b

    def __iter__(self):
        return self

    def batch_at(self, step: int) -> dict:
        """Random-access replay (restore / straggler re-dispatch)."""
        return make_batch(
            self.cfg, self.batch, self.seq_len, seed=self.seed, step=step,
            host=self.host, n_hosts=self.n_hosts,
        )

    def close(self):
        self._stop.set()
