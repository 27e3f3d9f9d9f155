"""What the per-layer readers (``metrics/<name>.py``) share: each reads the
traced run's context (the trace summary, the attention calls of the span
window, the window's work) and returns a number, or ``None`` where it finds
nothing to read."""
from __future__ import annotations

from . import cost
from .program import BWD_SPAN, FWD_SPAN


def idle_share(ctx: dict) -> float | None:
    """Per cent of the traced window in which no operation ran on the card."""
    trace, window = ctx["trace"], ctx["outcome"].window_s
    if not trace or not trace["device_count"] or window <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / window)


def mfu(ctx: dict) -> float | None:
    """Model FLOPs of the window's work over its seconds (the host's clock),
    per cent of the card's bfloat16 peak."""
    window = ctx["outcome"].window_s
    if not ctx.get("model_flops") or window <= 0:
        return None
    return 100.0 * ctx["model_flops"] / window / cost.PEAK_BF16_FLOPS


def attention_roofline(ctx: dict, backward: bool) -> float | None:
    """Per cent: the bound of every attention call of the span window (or
    of its backward), from the shapes, over the device time of what the
    calls launched inside their spans."""
    trace = ctx["trace"]
    span = BWD_SPAN if backward else FWD_SPAN
    calls = ctx["calls"].backward if backward else ctx["calls"].forward
    if not trace or not calls or trace["span_s"].get(span, 0.0) <= 0:
        return None
    bound = 0.0
    for q, kv, causal, window, chunk, itemsize in calls:
        B, Sq, H, hd = q
        flops, nbytes = cost.attention_cost(B, Sq, kv[1], H, kv[2], hd, itemsize=itemsize,
                                            causal=causal, window=window, chunk=chunk,
                                            backward=backward)
        bound += cost.bound_seconds(flops, nbytes)
    return 100.0 * bound / trace["span_s"][span]
