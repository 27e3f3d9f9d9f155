"""Repository-wide pytest setup.

The reference package (``src/repro``) imports ``enable_x64`` from
``jax.experimental``.  JAX 0.9 moved that context manager to
``jax.enable_x64`` and dropped the old name, so on such a JAX every module
that needs scoped float64 fails to import.  The alias below restores the
old name for the test session without editing the reference package.
Where JAX is not installed (the PyTorch port's tests run without it) this
file does nothing.
"""
try:
    import jax
    import jax.experimental
except ImportError:  # the PyTorch port runs without JAX
    jax = None

if jax is not None and not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64
