"""Optimizer substrate (AdamW + schedules), the port of the JAX package's
``optim/``: plain functions over trees of tensors."""
from .adamw import AdamWConfig, adamw_update, global_norm, init_opt_state  # noqa: F401
from .schedule import warmup_cosine  # noqa: F401
