"""Device milliseconds a training step spends on its float32 gradient sums:
what the port's span `repro_torch.train.grad_accum` launched (the zeros,
each microbatch's sum, the division), per step of the span window."""
from portbench.spans import GRAD_ACCUM, ms_per_step


def read(ctx):
    return ms_per_step(ctx, GRAD_ACCUM)
