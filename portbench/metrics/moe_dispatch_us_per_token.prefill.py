"""Device microseconds of the MoE layers' routing per prompt token: what the
port's spans `repro_torch.moe.dispatch` (router, top-k, capacity, one-hots,
the dispatch product) and `repro_torch.moe.combine` launched over the span
window, over its prompt tokens."""
from portbench.spans import moe_dispatch_us_per_token


def read(ctx):
    return moe_dispatch_us_per_token(ctx)
