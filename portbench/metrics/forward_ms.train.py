"""Device milliseconds a training step spends in its forward passes: what
the port's span `repro_torch.train.forward` launched (the loss of each
microbatch), per step of the span window."""
from portbench.spans import TRAIN_FORWARD, ms_per_step


def read(ctx):
    return ms_per_step(ctx, TRAIN_FORWARD)
