"""The port's Mamba spans and counters as the benchmark reads them: the
names, copied here so that the yardstick stays put, and the arithmetic of
the per-layer metrics that read them.  ``spans.py`` holds the switch and
the other spans; a driver that traces a hybrid model passes
:data:`NAMES` to ``trace.read`` beside those.

The mixer runs, one after another, in ``repro_torch.mamba.in`` (in_proj,
the convolution, SiLU), ``.discretize`` (x_proj, the inner norms, dt, and a
chunk of time at a time dA and dBx), ``.scan`` (each call of the selective
scan, K4, and nothing else) and ``.out`` (the D skip, the gate, out_proj).
The counters: ``mamba.tokens``, B x S of every layer's call summed over the
calls; ``mamba.scans``, the scan calls.  On a program without them each
reader returns ``None``.
"""
from __future__ import annotations

from . import cost_hybrid
from .spans import _span_s

MAMBA_IN = "repro_torch.mamba.in"
MAMBA_DISCRETIZE = "repro_torch.mamba.discretize"
MAMBA_SCAN = "repro_torch.mamba.scan"
MAMBA_OUT = "repro_torch.mamba.out"
NAMES = (MAMBA_IN, MAMBA_DISCRETIZE, MAMBA_SCAN, MAMBA_OUT)


def mamba_us_per_token(ctx: dict) -> float | None:
    """Device microseconds of the four Mamba spans over the span window, per
    prompt token and Mamba layer (the counter ``mamba.tokens``)."""
    seconds = [_span_s(ctx, s) for s in NAMES]
    tokens = ctx.get("port_counters", {}).get("mamba.tokens")
    if any(s is None for s in seconds) or not tokens:
        return None
    return 1e6 * sum(seconds) / tokens


def ssm_scan_roofline(ctx: dict) -> float | None:
    """Per cent: the scan's bytes over the span window (``mamba.tokens``,
    ``mamba.scans``; ``cost_hybrid.scan_bytes``) at 3.35 TB/s, over the
    device seconds of what ``repro_torch.mamba.scan`` launched."""
    seconds = _span_s(ctx, MAMBA_SCAN)
    counted = ctx.get("port_counters", {})
    if seconds is None or not counted.get("mamba.tokens") or not counted.get("mamba.scans"):
        return None
    cell = ctx["cell"]
    nbytes = cost_hybrid.scan_bytes(cell.config, counted["mamba.tokens"],
                                    counted["mamba.scans"], cell.traffic["batch"])
    return 100.0 * nbytes / cost_hybrid.cost.HBM_BYTES_PER_S / seconds
