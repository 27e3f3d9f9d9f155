"""The readers of the port's own spans and counters (``portbench/spans.py``
and ``metrics/<name>.py``) on trace summaries made from hand-made events:
each reads the number worked out by hand, and nothing where its span or
counter is missing."""
import pytest
from test_portbench_trace import CPU, CUDA, Event, _prof

from portbench import harness, spans, trace

TRAIN = ("forward_ms.train", "backward_ms.train", "grad_accum_ms.train", "optimizer_ms.train")
PREFILL = ("moe_dispatch_us_per_token.prefill", "expert_roofline.prefill",
           "moe_slot_fill.prefill")


def _read(name: str, ctx: dict):
    return harness._reader(harness.BENCH_DIR, name)(ctx)


def _launch(corr, t, tid, start, end, name="k"):
    """A launch on the host at ``t`` on thread ``tid`` and the kernel it
    ran on the device from ``start`` to ``end``."""
    return [Event("cudaLaunchKernel", CPU, t, t + 5, corr=corr, tid=tid),
            Event(name, CUDA, start, end, corr=corr)]


def _train_summary():
    # the step, forward, the sums and AdamW on thread 1; the backward on the
    # engine's thread 2; 500, 1000, 250 and 400 ns of kernels in each
    events = [
        Event(spans.TRAIN_STEP, CPU, 0, 10_000, tid=1),
        Event(spans.TRAIN_FORWARD, CPU, 100, 1_000, tid=1),
        Event(spans.TRAIN_BACKWARD, CPU, 1_100, 2_900, tid=2),
        Event(spans.GRAD_ACCUM, CPU, 3_000, 3_500, tid=1),
        Event(spans.ADAMW, CPU, 4_000, 5_000, tid=1),
        Event(spans.TRAIN_FORWARD, CUDA, 100, 1_000),  # the span's range on the device
        *_launch(1, 200, 1, 300, 800),
        *_launch(2, 1_200, 2, 1_300, 2_300),
        *_launch(3, 3_100, 1, 3_200, 3_450),
        *_launch(4, 4_100, 1, 4_200, 4_600),
    ]
    return trace.summarize(_prof(events), spans.NAMES)


def _prefill_summary():
    events = [
        Event(spans.PREFILL_STEP, CPU, 0, 7_000),
        Event(spans.MOE_DISPATCH, CPU, 0, 1_000),
        Event(spans.MOE_EXPERTS, CPU, 1_000, 5_000),
        Event(spans.MOE_COMBINE, CPU, 5_000, 6_000),
        *_launch(1, 100, 1, 200, 500),
        *_launch(2, 1_100, 1, 1_200, 3_200),
        *_launch(3, 5_100, 1, 5_200, 5_300),
    ]
    return trace.summarize(_prof(events), spans.NAMES)


@pytest.mark.parametrize("name", spans.NAMES)
@pytest.mark.parametrize("device, passed, kind", [
    (CUDA, True, "gpu_user_annotation"), (CPU, True, "user_annotation"),
    (CUDA, False, "kernel"), (CPU, False, "cpu_op")])
def test_a_port_span_is_an_annotation_once_its_name_is_passed(name, device, passed, kind):
    names = spans.NAMES if passed else ()
    assert trace._kind(Event(name, device, 0, 1), CUDA, names) == kind


def test_the_span_window_counts_no_span_as_a_device_operation():
    summary = _train_summary()
    assert summary["device_count"] == 4
    assert summary["span_s"][spans.TRAIN_STEP] == pytest.approx(1_150e-9)  # thread 1's
    assert summary["span_ops"][spans.TRAIN_BACKWARD] == 1


@pytest.mark.parametrize("name, want", [
    ("forward_ms.train", 500e-9 * 1e3 / 2),
    ("backward_ms.train", 1_000e-9 * 1e3 / 2),
    ("grad_accum_ms.train", 250e-9 * 1e3 / 2),
    ("optimizer_ms.train", 400e-9 * 1e3 / 2),
])
def test_each_training_reader_reads_its_span_per_step(tiny_cell, name, want):
    ctx = {"cell": tiny_cell("tiny-train"), "trace": _train_summary(), "span_steps": 2}
    assert _read(name, ctx) == pytest.approx(want)


@pytest.mark.parametrize("name, want", [
    ("moe_dispatch_us_per_token.prefill", 1e6 * (300e-9 + 100e-9) / 4),
    # tiny-moe: d 64, ff 96, swiglu (3 matrices); 6 claims kept
    ("expert_roofline.prefill", 100.0 * 6 * 2 * 3 * 64 * 96 / 989e12 / 2_000e-9),
    ("moe_slot_fill.prefill", 50.0),
])
def test_each_prefill_reader_reads_its_spans_and_counters(tiny_cell, name, want):
    ctx = {"cell": tiny_cell("tiny-prefill"), "trace": _prefill_summary(), "span_tokens": 4,
           "port_counters": {"moe.claims": 8, "moe.kept": 6, "moe.slots": 12}}
    assert _read(name, ctx) == pytest.approx(want)


# (reader, what is missing): each reads its span and the window's size, or
# its counters, or both
MISSING = ([(n, m) for n in TRAIN + PREFILL[:1] for m in ("trace", "spans", "window")]
           + [(PREFILL[1], m) for m in ("trace", "spans", "counters")]
           + [(PREFILL[2], "counters")])


@pytest.mark.parametrize("name, missing", MISSING)
def test_each_reader_reads_nothing_where_its_span_or_counter_is_missing(tiny_cell, name,
                                                                        missing):
    train = name in TRAIN
    ctx = {"cell": tiny_cell("tiny-train" if train else "tiny-prefill"),
           "trace": _train_summary() if train else _prefill_summary(),
           "span_steps": 2, "span_tokens": 4,
           "port_counters": {"moe.claims": 8, "moe.kept": 6, "moe.slots": 12}}
    if missing == "trace":
        ctx["trace"] = None
    elif missing == "spans":  # a program without the port's spans: the benchmark's alone
        ctx["trace"] = trace.summarize(_prof([]), ("portbench.attention",))
    elif missing == "window":
        del ctx["span_steps"], ctx["span_tokens"]
    else:
        ctx["port_counters"] = {}
    assert _read(name, ctx) is None


def test_the_switch_turns_the_port_s_tracing_on_and_the_names_are_the_port_s():
    from repro_torch.runtime import spans as port

    assert spans.NAMES == port.NAMES
    spans.reset()
    port.count("moe.kept", 3)
    assert spans.counters() == {}
    with spans.enabled():
        port.count("moe.kept", 3)
    assert spans.counters() == {"moe.kept": 3}
    spans.reset()
    assert spans.counters() == {}
