"""Checkpointing: the fleet sweep's durable per-chunk store."""
from .checkpoint import (  # noqa: F401
    SWEEP_LOG_NAME,
    SWEEP_RECORD_TYPES,
    SweepCheckpoint,
    sweep_fingerprint,
)
