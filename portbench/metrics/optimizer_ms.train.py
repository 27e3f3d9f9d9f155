"""Device milliseconds a training step spends in AdamW: what the port's span
`repro_torch.optim.adamw` launched (the global norm, the clip and every
slice of the update), per step of the span window."""
from portbench.spans import ADAMW, ms_per_step


def read(ctx):
    return ms_per_step(ctx, ADAMW)
