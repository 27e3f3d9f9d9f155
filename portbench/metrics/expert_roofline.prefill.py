"""Per cent of its roofline at which the routed expert work runs: the kept
claims (the port's counter `moe.kept`) times 2 FLOPs a weight of one
expert, at the bfloat16 peak, over the device seconds of what the port's
span `repro_torch.moe.experts` launched.  Routed work only: slots that
hold no claim count as waste, so the share cannot pass 100 %."""
from portbench.spans import expert_roofline


def read(ctx):
    return expert_roofline(ctx)
