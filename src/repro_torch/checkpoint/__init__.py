"""Checkpointing: training pytrees (atomic, hashed, async) and the fleet
sweep's durable per-chunk store."""
from .checkpoint import (  # noqa: F401
    SWEEP_LOG_NAME,
    SWEEP_RECORD_TYPES,
    AsyncCheckpointer,
    SweepCheckpoint,
    device_put_like,
    latest_step,
    restore,
    save,
    sweep_fingerprint,
)
