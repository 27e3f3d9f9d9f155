"""Per cent of its roofline at which the attention runs in the prefill: the
bound of every call, from its shapes (portbench/cost.py), over the device
time of what the calls launched inside their spans."""
from portbench.readout import attention_roofline


def read(ctx):
    return attention_roofline(ctx, backward=False)
