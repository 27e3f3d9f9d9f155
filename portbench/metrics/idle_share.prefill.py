"""Per cent of the traced window in which the card ran no operation (the
union of kernel, copy and set intervals in the profiler's trace of the
device's activity alone)."""
from portbench.readout import idle_share


def read(ctx):
    return idle_share(ctx)
