"""Elastic fallback for the sweep: degrade a sick device layout.

:func:`sweep_degradation_ladder` is the layout fallback the fleet sweep
walks when its device layout keeps failing: the split sweep and the
single-device sweep are bit-identical by construction (every raw row is
computed independently of the others), so degrading mid-sweep changes
wall-clock, never answers.  Re-sharding a training checkpoint onto a new
device layout waits for the training slice.
"""
from __future__ import annotations


def sweep_degradation_ladder(devices) -> tuple:
    """Device layouts a sick sweep falls back through, best first.

    ``devices`` is :func:`repro_torch.core.flow.run_fleet`'s layout spec
    (None = single device; an int or device sequence = a split of the
    hardware axis).  The ladder is the requested layout followed by the
    single-device sweep.  Results are bit-identical at every rung, so
    walking down the ladder trades only throughput, never correctness.
    """
    if devices is None:
        return (None,)
    return (devices, None)
