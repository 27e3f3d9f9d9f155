"""Device microseconds the Mamba mixers take per prompt token and Mamba
layer: what the port's spans `repro_torch.mamba.in`, `.discretize`,
`.scan` and `.out` launched over the span window, over the port's counter
`mamba.tokens` (B x S summed over the Mamba layers' calls)."""
from portbench.spans_mamba import mamba_us_per_token


def read(ctx):
    return mamba_us_per_token(ctx)
