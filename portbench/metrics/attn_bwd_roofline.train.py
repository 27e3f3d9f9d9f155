"""Per cent of its roofline at which the attention's backward runs: the
bound of every backward call, from its shapes (portbench/cost.py), over the
device time of what the calls launched inside their backward spans."""
from portbench.readout import attention_roofline


def read(ctx):
    return attention_roofline(ctx, backward=True)
