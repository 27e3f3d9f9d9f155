"""Per cent of the expert products' capacity slots that carry a routed
claim over the span window: the port's counters `moe.kept` over
`moe.slots` (a count, exact)."""
from portbench.spans import moe_slot_fill


def read(ctx):
    return moe_slot_fill(ctx)
