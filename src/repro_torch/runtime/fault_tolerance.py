"""Fault tolerance shared by the sweep: the straggler detector.

The fleet sweep's chunk loop (:func:`repro_torch.core.flow.run_fleet` with
``hw_chunk``) feeds each chunk's wall time, net of its set-up, to a
:class:`StragglerDetector` and reports the chunks it flags in
``FleetResult.straggler_chunks``.  The training driver of the JAX
reference (restore-on-failure, heartbeats) waits for the training slice.
"""
from __future__ import annotations

import statistics


class StragglerDetector:
    """Running-median wall-time deadline for the fleet sweep's chunk loop.

    ``observe(dt)`` feeds one duration; ``is_straggler(dt)`` is True when
    ``dt`` exceeds ``factor x`` the running median of the last ``window``
    observations (never below ``min_deadline_s``), once at least
    ``min_samples`` durations are in.  The detector only *flags* — what to
    do about a straggler (record the chunk index) is the caller's policy.
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
