"""The port's own spans and counters (``repro_torch.runtime.spans``) as the
benchmark reads them: the span names, copied here so that the yardstick
stays put, the switch a driver turns around its span window, and the
arithmetic of the per-layer metrics that read them.

A driver that traces the port runs its span window inside
:func:`enabled`, after :func:`reset`, passes :data:`NAMES` to
``trace.read`` beside its own spans (so that the ranges the profiler draws
on the device for them are not counted as kernels), and hands the readers
``span_steps`` (training: the span window's steps), ``span_tokens``
(prefill: its prompt tokens) and ``port_counters`` (:func:`counters` after
the window).  On a program without the port's spans the switch does
nothing, no counter is counted and each reader returns ``None``.
"""
from __future__ import annotations

import contextlib

from . import cost

TRAIN_STEP = "repro_torch.train.step"
TRAIN_FORWARD = "repro_torch.train.forward"
TRAIN_BACKWARD = "repro_torch.train.backward"
GRAD_ACCUM = "repro_torch.train.grad_accum"
ADAMW = "repro_torch.optim.adamw"
PREFILL_STEP = "repro_torch.prefill.step"
MOE_DISPATCH = "repro_torch.moe.dispatch"
MOE_EXPERTS = "repro_torch.moe.experts"
MOE_COMBINE = "repro_torch.moe.combine"
ATTENTION = "repro_torch.attention"
ATTENTION_BACKWARD = "repro_torch.attention.backward"
NAMES = (TRAIN_STEP, TRAIN_FORWARD, TRAIN_BACKWARD, GRAD_ACCUM, ADAMW, PREFILL_STEP,
         MOE_DISPATCH, MOE_EXPERTS, MOE_COMBINE, ATTENTION, ATTENTION_BACKWARD)
GATED = ("swiglu", "geglu")


def _port():
    """The port's spans module, or ``None`` in a program without it."""
    try:
        from repro_torch.runtime import spans
    except ImportError:
        return None
    return spans


def enabled():
    """The port's tracing on for the block (nothing where it has none)."""
    port = _port()
    return port.enabled() if port else contextlib.nullcontext()


def reset() -> None:
    """Zero the port's counters (nothing where it has none)."""
    port = _port()
    if port:
        port.reset()


def counters() -> dict:
    """{name: int} the port counted since :func:`reset` (``{}`` without)."""
    port = _port()
    return port.counters() if port else {}


def _span_s(ctx: dict, span: str) -> float | None:
    trace = ctx.get("trace")
    seconds = trace["span_s"].get(span, 0.0) if trace else 0.0
    return seconds if seconds > 0 else None


def ms_per_step(ctx: dict, span: str) -> float | None:
    """Device milliseconds of what ``span`` launched, per step of the span
    window."""
    seconds, steps = _span_s(ctx, span), ctx.get("span_steps")
    if seconds is None or not steps:
        return None
    return 1e3 * seconds / steps


def moe_dispatch_us_per_token(ctx: dict) -> float | None:
    """Device microseconds of the MoE layers' dispatch and combine per prompt
    token of the span window."""
    dispatch, combine = _span_s(ctx, MOE_DISPATCH), _span_s(ctx, MOE_COMBINE)
    tokens = ctx.get("span_tokens")
    if dispatch is None or combine is None or not tokens:
        return None
    return 1e6 * (dispatch + combine) / tokens


def expert_roofline(ctx: dict) -> float | None:
    """Per cent: the routed work's compute bound (each kept claim through
    one expert: 2 FLOPs a weight of its 3 matrices, 2 ungated, at the
    bfloat16 peak) over the device seconds of the expert products."""
    seconds = _span_s(ctx, MOE_EXPERTS)
    kept = ctx.get("port_counters", {}).get("moe.kept")
    if seconds is None or not kept:
        return None
    cfg = ctx["cell"].config
    mats = 3 if cfg.get("ffn_act", "swiglu") in GATED else 2
    flops = kept * 2.0 * mats * cfg["d_model"] * cfg["d_ff"]
    return 100.0 * flops / cost.PEAK_BF16_FLOPS / seconds


def moe_slot_fill(ctx: dict) -> float | None:
    """Per cent of the expert products' capacity slots that hold a routed
    claim over the span window (a count)."""
    counted = ctx.get("port_counters", {})
    if not counted.get("moe.slots"):
        return None
    return 100.0 * counted.get("moe.kept", 0) / counted["moe.slots"]
