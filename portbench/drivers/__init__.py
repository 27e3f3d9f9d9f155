"""Traffic drivers, one module per ``driver`` a traffic mix names: each has
``run(cell, seed, seconds, trace, clock) -> harness.Outcome``."""
