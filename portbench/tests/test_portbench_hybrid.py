"""The hybrid cell's driver, check and control at a size a test run holds
(a tiny Jamba on the CPU, bfloat16 as the real one, one period of 8
layers, the time chunk of the Mamba mixers cut to 12 steps so that every
prompt crosses chunk boundaries; limits read the same way at this size in
``data/limits/tiny-prefill-long.json``).

A sound run is correct and its reference drops no claim; the float8
control fails; the bfloat16-scan control fails on the float32 mixer, and
its recurrence is the reference's, rounded; and each fault this
configuration can have, planted in the port underneath the timed path,
fails the check: the Mamba mixer's inner
norms left out, RoPE applied, the routes renormalised, the state not
carried across a chunk boundary.
"""
import contextlib
import dataclasses
from unittest import mock

import pytest

from portbench import calibrate_hybrid, harness, program as P
from portbench.drivers import prefill_hybrid as PD
from portbench_tiny import DATA

NAME = "tiny-prefill-long"
BENCH = {"workloads": [{"name": NAME, "config": "tiny-jamba", "traffic": NAME, "chips": 1}],
         "end_to_end": [], "per_layer": []}
CHUNK = 12  # steps of time a chunk of the Mamba mixers takes here


@pytest.fixture
def cell():
    from repro_torch.models import ssm

    c = harness.load_cell(BENCH, NAME, base=DATA, device="cpu")
    B, di, ds = c.traffic["batch"], c.config["ssm_expand"] * c.config["d_model"], \
        c.config["ssm_state"]
    with mock.patch.object(ssm, "SCAN_BUDGET_BYTES", CHUNK * 2 * 4 * B * di * ds):
        assert ssm.time_chunk(B, di, ds) == CHUNK
        yield c


@pytest.mark.parametrize("seed", [1, 2**31 + 5])
def test_a_sound_run_is_correct_and_the_reference_drops_nothing(cell, seed):
    out = PD.run(cell, seed, 0.0, False, harness.Clock())
    assert out.notes["capacity_drops"].startswith("0 of "), out.notes["capacity_drops"]
    assert out.notes["port_counters"] == {}
    assert all(out.numbers[k] <= limit for k, limit in cell.limits.items()), out.numbers
    assert harness.run_cell(cell, seed, 0.0, False, harness.Clock())["correct"]


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 3])
def test_the_float8_control_fails(cell, seed):
    numbers, _ = calibrate_hybrid.control(cell, seed)
    assert any(numbers[k] > limit for k, limit in cell.limits.items()), numbers


@pytest.mark.parametrize("seed", [1, 2**31 + 3])
def test_the_bfloat16_scan_control_fails_on_the_float32_mixer(cell, seed):
    numbers, _ = calibrate_hybrid.control(cell, seed, calibrate_hybrid.scan_bf16)
    assert numbers["mamba_f32_err"] > cell.limits["mamba_f32_err"], numbers


@pytest.mark.parametrize("seed", [4, 2**31 + 7])
def test_the_bfloat16_scan_is_the_reference_recurrence_rounded(seed, monkeypatch):
    import torch

    from portbench.reference import jamba as R

    monkeypatch.setattr(calibrate_hybrid, "SEGMENT", 40)  # segments that do not divide S
    g = torch.Generator().manual_seed(seed)
    B, S, di, ds = 2, 300, 16, 4
    dt = torch.nn.functional.softplus(torch.randn((B, S, di), generator=g) - 3)
    A = -torch.arange(1, ds + 1.0).repeat(di, 1)
    Bm, Cm, x = (torch.randn(shape, generator=g) for shape in ((B, S, ds), (B, S, ds),
                                                                (B, S, di)))
    h0 = torch.randn((B, di, ds), generator=g)
    y, h = R.scan(dt, A, Bm, Cm, x, h0)
    y16, h16 = calibrate_hybrid.scan_bf16(dt, A, Bm, Cm, x, h0)
    assert h16.dtype == torch.float32 and y16.shape == y.shape
    for got, want in ((y16, y), (h16, h)):
        rel = float((got - want).norm() / want.norm())
        assert 1e-4 < rel < 0.03, rel  # bfloat16's rounding, and only that


@contextlib.contextmanager
def norms_left_out():
    from repro_torch.models import ssm

    real = ssm._selection
    with mock.patch.object(ssm, "_selection", lambda params, x_c, cfg: real(
            params, x_c, dataclasses.replace(cfg, ssm_inner_norms=False))):
        yield


@contextlib.contextmanager
def rope_applied():
    from repro_torch.models import layers

    real = layers.attention_block
    with mock.patch.object(layers, "attention_block", lambda params, x, cfg, **kw: real(
            params, x, dataclasses.replace(cfg, rope=True), **kw)):
        yield


@contextlib.contextmanager
def routes_renormalised():
    from repro_torch.models import moe

    real = moe.route_topk
    with mock.patch.object(moe, "route_topk", lambda logits, k, renormalize=True: real(
            logits, k, renormalize=True)):
        yield


@contextlib.contextmanager
def state_dropped_at_chunks():
    """Each scan call starts from zeros: the state is not carried from one
    chunk of time to the next (the prompt's first chunk is unchanged)."""
    inner = P.SERVE_KERNELS.ssm_scan
    kernels = dataclasses.replace(P.SERVE_KERNELS,
                                  ssm_scan=lambda dA, dBx, C, h0: inner(dA, dBx, C, None))
    with mock.patch.object(P, "SERVE_KERNELS", kernels):
        yield


@pytest.mark.parametrize("fault", [norms_left_out, rope_applied, routes_renormalised,
                                   state_dropped_at_chunks])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    with fault():
        result = harness.run_cell(cell, 9, 0.0, False, harness.Clock())
    assert not result["correct"], result["checks"]


def test_the_mamba_span_names_are_the_port_s():
    from portbench import spans_mamba
    from repro_torch.runtime import spans

    assert spans_mamba.NAMES == spans.MAMBA_NAMES
    assert {"mamba.tokens", "mamba.scans"} <= set(spans.COUNTERS)


def test_a_traced_run_reads_the_mamba_metrics(cell):
    bench = dict(BENCH, per_layer=[
        {"name": "mamba_us_per_token.prefill_long", "unit": "us"},
        {"name": "ssm_scan_roofline.prefill_long", "unit": "%"}])
    c = dataclasses.replace(cell, per_layer=bench["per_layer"])
    out = PD.run(c, 3, 0.0, True, harness.Clock())
    counted = out.reader["port_counters"]
    tokens = c.traffic["batch"] * sum(c.traffic["lengths"])
    assert out.reader["span_tokens"] == tokens
    assert counted["mamba.tokens"] == 7 * tokens
    assert counted["mamba.scans"] == 7 * sum(-(-n // CHUNK) for n in c.traffic["lengths"])
    result = harness.run_cell(c, 3, 0.0, True, harness.Clock())
    assert result["correct"]
    # on the CPU the trace holds no device time, so the readers find nothing
    assert result["metrics"] == {}
