"""Model FLOPs of the window's work over the window's seconds on the host's
clock, per cent of the card's bfloat16 peak (989 TFLOP/s): the whole step's
share of the peak.  The traced run's window records the device's activity
alone, so it runs as an untraced window does."""
from portbench.readout import mfu


def read(ctx):
    return mfu(ctx)
