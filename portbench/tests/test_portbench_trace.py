"""Reading the profiler's events: what each event is, the device's busy
time, and which span a device operation belongs to, on events made by
hand."""
import types

import pytest
import torch

from portbench import trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Event:
    def __init__(self, name, device, start, end, corr=0, linked=0, tid=1):
        self._v = (name, device, start, end, corr, linked, tid)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def start_thread_id(self):
        return self._v[6]


def _prof(events):
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=results))


@pytest.mark.parametrize("name, device, kind", [
    ("flash_attention_fwd_kernel", CUDA, "kernel"),
    ("Memcpy DtoH (Device -> Pinned)", CUDA, "gpu_memcpy"),
    ("Memset (Device)", CUDA, "gpu_memset"),
    ("portbench.attention", CUDA, "gpu_user_annotation"),
    ("portbench.attention", CPU, "user_annotation"),
    ("cudaLaunchKernel", CPU, "cuda_runtime"),
    ("cutlass::Kernel", CPU, "cpu_op"),
    ("aten::mm", CPU, "cpu_op"),
])
def test_an_event_is_classified_by_its_device_and_name(name, device, kind):
    assert trace._kind(Event(name, device, 0, 1), CUDA, ("portbench.attention",)) == kind


def test_busy_time_is_the_union_of_the_intervals():
    assert trace.busy_seconds([(0, 10), (5, 20), (30, 40)]) == pytest.approx(30e-9)


def test_busy_time_comes_from_the_window_and_spans_from_the_span_window():
    window = _prof([Event("k", CUDA, 0, 4_000), Event("k", CUDA, 6_000, 10_000)])
    spanned = _prof([
        Event("portbench.attention", CPU, 100, 200, corr=1),
        Event("cudaLaunchKernel", CPU, 150, 160, corr=2),
        Event("cudaLaunchKernel", CPU, 300, 310, corr=3),
        Event("attn", CUDA, 400, 900, corr=2),
        Event("mm", CUDA, 900, 2_900, corr=3),
    ])
    out = trace.read(window, spanned, ("portbench.attention",))
    assert out["busy_s"] == pytest.approx(8e-6) and out["device_count"] == 2
    assert out["span_s"] == {"portbench.attention": pytest.approx(500e-9)}
    assert out["span_ops"] == {"portbench.attention": 1}
