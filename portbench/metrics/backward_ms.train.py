"""Device milliseconds a training step spends in its backward passes: what
the port's span `repro_torch.train.backward` launched on the thread that
runs the backward (the recomputed forward included), per step of the span
window."""
from portbench.spans import TRAIN_BACKWARD, ms_per_step


def read(ctx):
    return ms_per_step(ctx, TRAIN_BACKWARD)
