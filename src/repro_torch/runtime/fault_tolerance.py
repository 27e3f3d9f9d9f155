"""Fault-tolerant training driver: restore-on-failure, straggler
mitigation, heartbeats; and the straggler detector the fleet sweep shares.

The port of the JAX package's ``runtime/fault_tolerance.py``:

* **Checkpoint/restart**: periodic async checkpoints (atomic and hashed,
  :mod:`repro_torch.checkpoint`); on any step failure the driver restores
  the latest good step and replays forward.  The counter-based data
  pipeline makes the replayed batches bit-identical.
* **Straggler mitigation**: a per-step wall-time deadline at ``k x`` the
  running median; a step breaching it is recorded and re-dispatched (same
  batch, same state).
* **Heartbeat**: a (step, time) file others can watch, written to a
  temporary file and renamed into place.

Failure injection for tests and the smoke run is a callable hook
(:func:`flaky`); a real cluster would raise from the collective layer.
The fleet sweep's chunk loop (:func:`repro_torch.core.flow.run_fleet` with
``hw_chunk``) feeds each chunk's wall time to a :class:`StragglerDetector`
and reports the chunks it flags.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import statistics
import time
from typing import Callable

import torch

from .. import checkpoint as CKPT


class StragglerDetector:
    """Running-median wall-time deadline shared by the training driver and
    the fleet sweep's chunk loop.

    ``observe(dt)`` feeds one duration; ``is_straggler(dt)`` is True when
    ``dt`` exceeds ``factor x`` the running median of the last ``window``
    observations (never below ``min_deadline_s``), once at least
    ``min_samples`` durations are in.  The detector only *flags* — what to
    do about a straggler (re-dispatch the step, record the chunk index) is
    the caller's policy.
    """

    def __init__(self, *, factor: float = 3.0, min_deadline_s: float = 0.05,
                 min_samples: int = 5, window: int = 50):
        self.factor = float(factor)
        self.min_deadline_s = float(min_deadline_s)
        self.min_samples = int(min_samples)
        self.window = int(window)
        self._durations: list[float] = []

    def deadline(self) -> float:
        """Current straggler deadline; +inf until min_samples are in."""
        if len(self._durations) < self.min_samples:
            return float("inf")
        return max(
            self.min_deadline_s,
            self.factor * statistics.median(self._durations),
        )

    def is_straggler(self, dt: float) -> bool:
        """True when ``dt`` breaches the current deadline."""
        return dt > self.deadline()

    def observe(self, dt: float) -> None:
        """Record one duration (bounded window)."""
        self._durations.append(float(dt))
        if len(self._durations) > self.window:
            self._durations.pop(0)


@dataclasses.dataclass
class TrainerReport:
    steps_run: int = 0
    failures: int = 0
    restores: int = 0
    stragglers: int = 0
    redispatches: int = 0
    last_loss: float = float("nan")
    losses: list = dataclasses.field(default_factory=list)


def _sync(x) -> None:
    """Wait until ``x`` (a tensor) has been computed on its device."""
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


class ResilientTrainer:
    """Runs ``train_step`` over the batches of ``stream`` for a number of
    steps, checkpointing every ``ckpt_every`` steps, restoring the latest
    good step after any exception a step raises (as the reference does:
    every ``Exception``), and re-dispatching a step that breaches the
    straggler deadline.  ``report`` counts what happened."""

    def __init__(
        self,
        *,
        train_step: Callable,  # (params, opt_state, batch) -> (p, o, metrics)
        stream,  # repro_torch.data.TokenStream
        ckpt_dir,
        ckpt_every: int = 10,
        straggler_factor: float = 3.0,
        min_deadline_s: float = 0.05,
        failure_hook: Callable[[int], None] | None = None,
    ):
        self.train_step = train_step
        self.stream = stream
        self.ckpt_dir = pathlib.Path(ckpt_dir)
        self.ckpt_every = ckpt_every
        self.straggler_factor = straggler_factor
        self.min_deadline_s = min_deadline_s
        self.failure_hook = failure_hook
        self.checkpointer = CKPT.AsyncCheckpointer(ckpt_dir)
        self.report = TrainerReport()
        self.straggler = StragglerDetector(
            factor=straggler_factor, min_deadline_s=min_deadline_s
        )

    # ------------------------------------------------------------------
    def _heartbeat(self, step: int):
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        hb = self.ckpt_dir / "heartbeat.json"
        tmp = hb.with_name(hb.name + ".tmp")
        tmp.write_text(json.dumps({"step": step, "time": time.time()}))
        os.replace(tmp, hb)

    def _restore(self, params, opt_state):
        self.checkpointer.wait()  # an in-flight save may be the latest good step
        step = CKPT.latest_step(self.ckpt_dir)
        self.report.restores += 1
        if step is None:
            return 0, params, opt_state  # cold restart
        tree, _extra = CKPT.restore(
            self.ckpt_dir, step, like={"params": params, "opt": opt_state}
        )
        device = opt_state["step"].device
        return (step + 1, CKPT.device_put_like(tree["params"], device),
                CKPT.device_put_like(tree["opt"], device))

    def _run_one(self, params, opt_state, step: int, batch):
        if self.failure_hook is not None:
            self.failure_hook(step)  # may raise (simulated node failure)
        t0 = time.perf_counter()
        params, opt_state, metrics = self.train_step(params, opt_state, batch)
        _sync(metrics["loss"])
        dt = time.perf_counter() - t0
        return params, opt_state, metrics, dt

    # ------------------------------------------------------------------
    def run(self, params, opt_state, n_steps: int, *, start_step: int = 0):
        """Train from ``start_step`` for ``n_steps`` steps; returns the
        final (params, opt_state) after the last checkpoint is written."""
        step = start_step
        while step < start_step + n_steps:
            batch = self.stream.batch_at(step)
            try:
                params, opt_state, metrics, dt = self._run_one(
                    params, opt_state, step, batch
                )
            except Exception:
                self.report.failures += 1
                step, params, opt_state = self._restore(params, opt_state)
                continue

            # Straggler detection + deterministic re-dispatch.
            if self.straggler.is_straggler(dt):
                self.report.stragglers += 1
                params, opt_state, metrics, dt = self._run_one(
                    params, opt_state, step, batch
                )
                self.report.redispatches += 1
            self.straggler.observe(dt)

            loss = float(metrics["loss"])
            self.report.steps_run += 1
            self.report.last_loss = loss
            self.report.losses.append(loss)
            self._heartbeat(step)
            if (step + 1) % self.ckpt_every == 0:
                self.checkpointer.submit(
                    step, {"params": params, "opt": opt_state},
                    extra={"loss": loss},
                )
            step += 1
        self.checkpointer.wait()
        return params, opt_state


def flaky(fail_at_steps: set[int], *, already: set | None = None):
    """Failure hook raising once per listed step (then healing)."""
    seen = already if already is not None else set()

    def hook(step: int):
        if step in fail_at_steps and step not in seen:
            seen.add(step)
            raise RuntimeError(f"injected node failure at step {step}")

    return hook
