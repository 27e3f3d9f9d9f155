"""Reading the profiler's traces of a traced run: the device's busy time
and largest operations over the window, which is profiled for the
device's activity alone so that it runs as an untraced window does; then,
from a short window after it that records the host too, the device time of
what each benchmark span launched and the longest idle gaps by what the
host was doing.

The events are read from ``prof.profiler.kineto_results`` (the raw
events; the public ``prof.events()`` builds a per-op tree that takes
seconds per training step): the arithmetic of the port's
``chip_smoke.py`` (``device_intervals``, ``busy_us``), copied here.  A
device operation belongs to a span when the host call that launched it
(matched by correlation id) started inside that span on the same thread.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import sys

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def profiled(enabled: bool, device: str, host: bool = False):
    """A profiler over the block when ``enabled``, else nothing; yields the
    profiler or ``None``.  It records the device's activity (on a run
    without a card, the host's) and, with ``host``, the host's too."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] if device == "cuda" else []
    if host or not activities:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        yield prof


def busy_seconds(intervals) -> float:
    """Seconds covered by the union of ``intervals`` ((start, end, ...) in
    nanoseconds)."""
    busy, end = 0, float("-inf")
    for a, b, *_ in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e9


def _merged(intervals) -> list:
    out = []
    for a, b, *_ in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _kind(e, cuda, spans) -> str:
    """The event's activity, from its device and its name: ``kernel``,
    ``gpu_memcpy``, ``gpu_memset``, ``gpu_user_annotation`` (a span's range
    on the device), ``cuda_runtime`` (a launch on the host),
    ``user_annotation`` (a span) or ``cpu_op``."""
    name = e.name()
    if e.device_type() == cuda:
        if name in spans:
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if name in spans:
        return "user_annotation"
    if name.startswith("cu") and not name.startswith("cutlass"):
        return "cuda_runtime"
    return "cpu_op"


def read(window_prof, span_prof, spans: tuple) -> dict:
    """The traced run's summary: the busy seconds, the device operations
    and their count from the window's profile, the spans' device seconds
    and the idle gaps from the span window's."""
    window = summarize(window_prof)
    spanned = summarize(span_prof, spans)
    return {**spanned, **{k: window[k] for k in ("busy_s", "device_ops", "device_count")}}


def summarize(prof, spans: tuple = ()) -> dict:
    """{"busy_s", "device_ops", "idle_gaps", "span_s": {span: device
    seconds}, "span_ops": {span: operations}} of a finished profile."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, host, launches = [], [], {}
    kinds = collections.Counter()
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e, cuda, spans)
        kinds[kind] += 1
        if e.device_type() == cuda:
            if kind in DEVICE_KINDS:
                device.append((e.start_ns(), e.end_ns(), e.name(), e.correlation_id(),
                               e.linked_correlation_id()))
        elif kind == "cuda_runtime":
            launches[e.correlation_id()] = (e.start_ns(), e.start_thread_id())
        elif kind in ("cpu_op", "user_annotation"):
            host.append((e.start_ns(), e.end_ns(), e.name(), e.start_thread_id(),
                         e.correlation_id()))
    by_corr = {h[4]: h for h in host}

    span_s = {s: 0.0 for s in spans}
    span_ops = {s: 0 for s in spans}
    ranges = collections.defaultdict(list)  # (span, thread) -> [(start, end)]
    for a, b, name, tid, _ in host:
        if name in span_s:
            ranges[(name, tid)].append((a, b))
    starts = {k: [r[0] for r in sorted(v)] for k, v in ranges.items()}
    ranges = {k: sorted(v) for k, v in ranges.items()}
    unlinked = by_launch = 0
    for a, b, name, corr, linked in device:
        if corr in launches:
            by_launch += 1
            t, tid = launches[corr]
        elif linked in by_corr:
            t, tid = by_corr[linked][0], by_corr[linked][3]
        else:
            unlinked += 1
            continue
        for span in span_s:
            key = (span, tid)
            if key not in ranges:
                continue
            i = bisect.bisect_right(starts[key], t) - 1
            if i >= 0 and ranges[key][i][0] <= t <= ranges[key][i][1]:
                span_s[span] += (b - a) / 1e9
                span_ops[span] += 1

    by_name = collections.Counter()
    for a, b, name, *_ in device:
        by_name[name[:80]] += (b - a) / 1e9
    gaps = _idle_gaps(device, host)
    print(f"[portbench] trace: {len(device)} device operations, {len(host)} host events, "
          f"{len(launches)} launches, {by_launch} device operations matched to their launch, "
          f"{unlinked} to nothing; events by kind {dict(kinds)}; device seconds by span "
          f"{span_s}, operations by span {span_ops}", file=sys.stderr)
    return {"busy_s": busy_seconds(device), "device_ops": by_name.most_common(10),
            "idle_gaps": gaps, "span_s": span_s, "span_ops": span_ops,
            "device_count": len(device)}


def _idle_gaps(device: list, host: list, top: int = 10) -> list:
    """[(what the host was doing, idle seconds)] of the gaps between device
    operations, summed by the innermost host event running at each gap's
    start, largest first."""
    merged = _merged(device)
    ops = sorted(host)
    starts = [h[0] for h in ops]
    by = collections.Counter()
    for (_, end), (nxt, _) in zip(merged, merged[1:]):
        t = end + 1
        label = "host outside any recorded op"
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(i - 400, -1), -1):
            if ops[j][1] >= t:
                label = ops[j][2][:80]
                break
        by[label] += (nxt - end) / 1e9
    return by.most_common(top)
