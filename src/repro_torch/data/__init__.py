"""Deterministic synthetic data pipeline (counter-based, restart-safe), a
copy of the JAX package's ``data/`` (numpy only)."""
from .pipeline import TokenStream, make_batch  # noqa: F401
