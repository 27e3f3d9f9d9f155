"""Tests of the port that need an NVIDIA GPU: the fused_conv3x3,
flash_attention (forward and backward), fused_mlp and selective-scan CUDA
kernels, the training step on the card, the evaluator
sweep, the serving paths (the transformer, Mamba, MoE and encoder-decoder
models, the ring cache), the traced ResNet-18's
sweep and the MoE layer at full width, the fleet sweep split over one card
and the planning service on the card.

Every test here carries the ``cuda`` marker and skips without CUDA (the
kernel has no CPU mode).  On a machine with a GPU and ``nvcc``, from the
root of a checkout::

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_on_card.py

``--noconftest``: the suite's conftest files import JAX, which the port
does not need and the GPU machine may not have.  This file imports no JAX.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import resolve, run_config, scaled_down
from repro_torch.core import arch, flow, fusion, ir, metrics
from repro_torch.kernels import (builder, flash_attention_bwd, fused_attention,
                                 fused_conv, fused_mlp, mamba_scan, ops, ref)
from repro_torch.models import model as M
from repro_torch.models import vgg as VGG
from repro_torch.models.vgg import VGG16

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-1}  # tests/test_kernels.py
SHAPES = [  # (B, H, W, Cin, Cout, pool)
    (1, 8, 8, 4, 8, False),  # the shapes of tests/test_kernels.py ...
    (2, 16, 16, 8, 16, True),
    (1, 32, 32, 3, 8, True),
    (2, 8, 8, 16, 32, False),
    (1, 7, 9, 3, 8, True),  # odd frame: the last row/column is dropped
    (2, 20, 36, 5, 72, True),  # ragged tiles, chunks and channel blocks
    (1, 14, 14, 512, 512, True),  # conv5_3 of VGG-16
    (2, 28, 28, 64, 128, True),  # 28x28: the last tile row and column ragged
    (1, 5, 6, 16, 64, False),  # a frame smaller than a tile
    (3, 3, 3, 8, 8, True),  # a frame smaller than a pool window pair
    (1, 13, 15, 12, 40, True),  # odd frame, a half chunk, a part channel block
]


@pytest.fixture
def cuda():
    """The card, or a skip: the CUDA kernel cannot run without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(shape, dtype, seed=0):
    B, H, W, Cin, Cout, _pool = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*s, std=1.0):
        return (torch.randn(s, generator=gen, device="cuda") * std).to(dtype)

    return (randn(B, H, W, Cin), randn(3, 3, Cin, Cout, std=(2 / (9 * Cin)) ** 0.5),
            randn(Cout, std=0.1))


@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_kernel_matches_plain_version(cuda, shape, dtype):
    x, w, b = _inputs(shape, dtype)
    pool = shape[-1]
    before = fused_conv.fused_conv3x3.launches
    got = ops.conv3x3(x, w, b, pool=pool)
    torch.cuda.synchronize()
    assert fused_conv.fused_conv3x3.launches == before + 1
    want = ref.fused_conv3x3_ref(x, w, b, pool=pool)
    assert got.shape == want.shape and got.dtype == dtype
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("layer", ir.VGG16_CONV_PLAN, ids=[p[0] for p in ir.VGG16_CONV_PLAN])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_matches_plain_version_at_every_vgg_layer(cuda, layer, dtype):
    # the forward's 13 layers at batch 8: both tiles, Cin = 3 staged element
    # by element, the rest in cp.async pieces
    name, cin, cout, hw, pool = layer
    x, w, b = _inputs((8, hw, hw, cin, cout, pool), dtype, seed=9)
    got = fused_conv.fused_conv3x3(x, w, b, pool=pool)
    want = ref.fused_conv3x3_ref(x, w, b, pool=pool)
    tol = TOL[dtype]
    assert got.shape == want.shape and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("hw", [28, 14], ids=["conv4_2", "conv5_1"])
def test_float32_sums_keep_their_error_small_at_vgg_depth(cuda, hw):
    # K = 4,608: the tensor cores truncate each sum toward zero; summed
    # straight into one accumulator that bias grows with K, to errors near
    # the 2e-4 tolerance here and past 2e-4 x max at the 224x224 logits.
    # The per-chunk partial keeps the float32 error a few times below 1e-4
    x, w, b = _inputs((8, hw, hw, 512, 512, False), torch.float32, seed=11)
    got = fused_conv.fused_conv3x3(x, w, b)
    want = ref.fused_conv3x3_ref(x, w, b)
    assert float((got - want).abs().max()) < 1e-4


def test_kernel_stages_unaligned_inputs_element_by_element(cuda):
    # a view one element into its storage is not 16-byte aligned: the
    # bfloat16 body stages it element by element, the float32 body's TMA
    # map takes a staged copy; either way with the same result
    shape = (2, 12, 12, 16, 32, True)
    for dtype in (torch.float32, torch.bfloat16):
        x, w, b = _inputs(shape, dtype, seed=10)
        flat = torch.empty(x.numel() + 1, device="cuda", dtype=dtype)
        xu = flat[1:].view(x.shape)
        xu.copy_(x)
        assert not fused_conv.vectorised(xu, w) and fused_conv.vectorised(x, w)
        assert not fused_conv.tma_ready(xu) and fused_conv.tma_ready(x)
        got = fused_conv.fused_conv3x3(xu, w, b, pool=True)
        torch.testing.assert_close(got, fused_conv.fused_conv3x3(x, w, b, pool=True),
                                   atol=0, rtol=0)


def test_float32_inputs_the_tma_map_cannot_take_go_to_the_staged_copy(cuda, monkeypatch):
    # Cin not a multiple of 8 (VGG's Cin = 3) or a pointer off 16 bytes:
    # the call stages the input into its scratch (fused_conv.tma_ready says
    # so) and launches the kernel on the copy -- never the plain version
    cases = [((2, 20, 20, 3, 64, True), 0), ((1, 9, 11, 5, 72, False), 0),
             ((2, 12, 12, 16, 32, True), 1), ((2, 12, 12, 16, 32, True), 0)]
    wants = []
    for shape, off in cases:
        x, w, b = _inputs(shape, torch.float32, seed=12)
        if off:
            flat = torch.empty(x.numel() + off, device="cuda")
            flat[off:].copy_(x.reshape(-1))
            x = flat[off:].view(x.shape)
        wants.append((x, w, b, shape[-1], ref.fused_conv3x3_ref(x, w, b, pool=shape[-1])))

    def no_call(*args, **kwargs):
        raise AssertionError("the plain version ran on a CUDA tensor")

    ready = []
    original = fused_conv.tma_ready

    def recording(x):
        ready.append(original(x))
        return ready[-1]

    monkeypatch.setattr(ref, "fused_conv3x3_ref", no_call)
    monkeypatch.setattr(fused_conv, "tma_ready", recording)
    for (shape, off), (x, w, b, pool, want) in zip(cases, wants):
        before = fused_conv.fused_conv3x3.launches
        got = fused_conv.fused_conv3x3(x, w, b, pool=pool)
        assert ready[-1] == (shape[3] % 8 == 0 and not off), (shape, off)
        assert fused_conv.fused_conv3x3.launches == before + 1
        tol = TOL[torch.float32]
        torch.testing.assert_close(got, want, atol=tol, rtol=tol)
    assert ready == [False, False, False, True]


def test_weight_prep_kernel_equals_its_plain_version_bit_for_bit(cuda):
    for cin, cout in ((3, 64), (5, 72), (64, 128), (512, 512)):
        w = torch.randn(3, 3, cin, cout, device="cuda")
        got = fused_conv.prep_weights(w)
        assert torch.equal(got.cpu(), fused_conv.prep_weights_ref(w.cpu())), (cin, cout)


# Run in a fresh interpreter: profiled in the test process, it left the
# later flash-attention body test's profiler runs without kernel records
# (that test then skipped).
_PROFILE_VGG_LAYERS = """
import json, sys
import torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.core.ir import VGG16_CONV_PLAN
from repro_torch.kernels import fused_conv, ref

def no_call(*args, **kwargs):
    raise AssertionError("the plain version ran on a CUDA tensor")

ref.fused_conv3x3_ref = no_call
out = {}
for name, cin, cout, hw, pool in VGG16_CONV_PLAN:
    if name not in sys.argv[1:]:
        continue
    gen = torch.Generator(device="cuda").manual_seed(13)
    x = torch.randn(8, hw, hw, cin, device="cuda", generator=gen)
    w = torch.randn(3, 3, cin, cout, device="cuda", generator=gen) * (2 / (9 * cin)) ** 0.5
    b = torch.randn(cout, device="cuda", generator=gen) * 0.1
    fused_conv.fused_conv3x3(x, w, b, pool=pool)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fused_conv.fused_conv3x3(x, w, b, pool=pool)
        torch.cuda.synchronize()
    out[name] = {"tile": fused_conv.launch_geometry(8, hw, hw, cin, cout).tile,
                 "kernels": [e.key for e in prof.key_averages() if "fused_conv3x3" in e.key]}
print(json.dumps(out))
"""


def test_float32_vgg_layers_run_the_wgmma_body(cuda):
    # no fallback: the plain version raises if called; the profiler (in a
    # fresh interpreter) sees the float32 wgmma kernel at the tile each
    # layer takes (16 at 28x28, 8 at 14x14) after the weight prep, never the
    # bfloat16 body; and that instantiation's SASS holds HGMMA, no HMMA, no
    # spill, and ptxas keeps its wgmma asynchronous
    import json
    import os
    import subprocess
    import sys

    if builder.cuobjdump() is None:
        pytest.skip("cuobjdump not found beside nvcc or on PATH")
    built = fused_conv.build()
    sass = builder.sass_counts(built.path)
    report = builder.ptxas_report(built.log)
    serial = [line for line in built.log.splitlines() if "are serialized" in line]
    src = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(fused_conv.__file__))))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [src, os.environ.get("PYTHONPATH", "")]).rstrip(os.pathsep)}
    run = subprocess.run([sys.executable, "-c", _PROFILE_VGG_LAYERS, "conv4_2", "conv5_3"],
                         capture_output=True, text=True, env=env, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    layers = json.loads(run.stdout.strip().splitlines()[-1])
    assert sorted(layers) == ["conv4_2", "conv5_3"]
    if not any(layer["kernels"] for layer in layers.values()):
        pytest.skip("the profiler records no CUDA kernel on this machine")
    assert {layer["tile"] for layer in layers.values()} == {16, 8}
    for name, layer in layers.items():
        tile, names = layer["tile"], layer["kernels"]
        assert any(f"fused_conv3x3_f32_kernel<{tile}>" in n.replace(" ", "") for n in names), \
            (name, names)
        assert any("prep_weights" in n for n in names), (name, names)
        assert not any("bf16" in n for n in names), (name, names)
        (mangled,) = [n for n in sass if f"fused_conv3x3_f32_kernelILi{tile}E" in n]
        assert sass[mangled]["HGMMA"] > 0 and sass[mangled]["HMMA"] == 0, (name, sass[mangled])
        assert not report[mangled].get("spill_stores") and not report[mangled].get("spill_loads")
        assert not any(mangled in line for line in serial), name


def test_kernel_rejects_what_it_does_not_take(cuda):
    x, w, b = _inputs((1, 8, 8, 4, 8, False), torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        fused_conv.fused_conv3x3(x.transpose(1, 2), w, b)
    with pytest.raises(TypeError):
        fused_conv.fused_conv3x3(x.half(), w.half(), b.half())
    with pytest.raises(ValueError, match="one device"):
        fused_conv.fused_conv3x3(x, w.cpu(), b)


def test_library_reports_its_build(cuda):
    built = fused_conv.build()
    assert built.path.exists() and built.path.parent == fused_conv.BUILD_DIR
    assert "registers" in built.log  # -Xptxas -v


def test_sweep_on_the_card_is_bit_identical_to_the_cpu(cuda):
    g = ir.as_graph(ir.vgg16_ir())
    cuts = flow.groupings_batch(g, "exhaustive")
    args = flow.sweep_args(g, cuts, arch.default_config_space()[::16])
    on_card = metrics.evaluate_raw_graph(*args, device="cuda").cpu().numpy()
    on_cpu = metrics.evaluate_raw_graph(*args, device="cpu").numpy()
    assert np.array_equal(on_card, on_cpu)


def test_run_flow_on_the_card_equals_the_cpu(cuda):
    vgg = ir.vgg16_ir()
    kw = dict(config_space=arch.default_config_space(), groupings="pool",
              pareto=True)
    a = flow.run_flow(vgg, device="cuda", **kw)
    b = flow.run_flow(vgg, device="cpu", **kw)
    assert a.best_hw == b.best_hw and a.best_metrics == b.best_metrics
    assert np.array_equal(a.best_cuts, b.best_cuts)
    assert np.array_equal(a.pareto.metrics, b.pareto.metrics)


@pytest.mark.parametrize("case", ["resnet18_search", "residual_block_every_cut"])
def test_dag_sweep_on_the_card_equals_the_cpu_and_the_oracles(cuda, case):
    # joins sum two edges into one slot: index_add's atomics on the card add
    # them in no fixed order, exact only because every word is an integer
    if case == "resnet18_search":
        g = ir.resnet18_ir()
        cuts = flow.groupings_batch(g, "search")
    else:
        g = ir.residual_block_ir()
        cuts = fusion.enumerate_valid_edge_cuts(g)
    space = arch.default_config_space()
    args = flow.sweep_args(g, cuts, space)
    on_card = metrics.evaluate_raw_graph(*args, device="cuda").cpu().numpy()
    on_cpu = metrics.evaluate_raw_graph(*args, device="cpu").numpy()
    assert np.array_equal(on_card, on_cpu)
    c_sram = metrics.sram_accesses_ref(g)
    for h, hw in enumerate(space):
        c_pb = metrics.pe_energy_count_ref(g, hw)
        for c, cut in enumerate(cuts):
            want = (metrics.bandwidth_ref(g, cut), metrics.latency_ref(g, cut, hw),
                    c_sram, c_pb, metrics.area_ref(g, cut, hw))
            assert tuple(on_card[h, c].tolist()) == want, (h, c)


def test_vgg_forward_through_the_kernel_matches_plain(cuda):
    gen = torch.Generator(device="cuda").manual_seed(1)
    model = VGG16(in_hw=32, n_classes=10, generator=gen)
    x = torch.randn((2, 32, 32, 3), generator=gen, device="cuda")
    before = fused_conv.fused_conv3x3.launches
    with torch.inference_mode():
        got = model(x, fused_conv_fn=ops.fused_conv_fn())
        want = model(x)
    assert fused_conv.fused_conv3x3.launches == before + 13
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 2e-4 * scale


def _vgg_train_inputs(seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = VGG.init_params(gen, in_hw=32, n_classes=10)
    batch = {"images": torch.randn((2, 32, 32, 3), generator=gen, device="cuda"),
             "labels": torch.randint(0, 10, (2,), generator=gen, device="cuda")}
    return params, batch


def test_vgg_loss_through_the_kernel_refuses_grad(cuda):
    params, batch = _vgg_train_inputs()
    for t in params["conv_w"]:
        t.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        VGG.loss_fn(params, batch, fused_conv_fn=ops.fused_conv_fn())
    # torch.func's transform raises too: no silent switch to the plain path
    plain = {k: [t.detach() for t in v] for k, v in params.items()}
    with pytest.raises((NotImplementedError, RuntimeError)):
        torch.func.grad(lambda p: VGG.loss_fn(p, batch, fused_conv_fn=ops.fused_conv_fn()))(plain)


# The plain path's float32 gradients against float64 at 32x32, relative L2
# per leaf, TF32 off: float32 sums reordered over 16 layers (1e-6 on the
# CPU against the reference); TF32 in the backward gives about 1e-3.
VGG_GRAD_TOL = 1e-4


def test_vgg_float32_gradients_match_float64_with_tf32_off(cuda):
    params, batch = _vgg_train_inputs(1)
    with ref.no_tf32():
        g32, loss32 = torch.func.grad_and_value(VGG.loss_fn)(params, batch)
    p64 = {k: [t.double() for t in v] for k, v in params.items()}
    b64 = {"images": batch["images"].double(), "labels": batch["labels"]}
    g64, loss64 = torch.func.grad_and_value(VGG.loss_fn)(p64, b64)
    assert abs(float(loss32) - float(loss64)) <= 1e-5 * abs(float(loss64))
    for k in g64:
        for a, b in zip(g32[k], g64[k]):
            rel = float(torch.linalg.vector_norm(a.double() - b) / torch.linalg.vector_norm(b))
            assert rel <= VGG_GRAD_TOL, (k, rel)


# ---------------------------------------------------------------------------
# K2 flash_attention and K3 fused_mlp
# ---------------------------------------------------------------------------

ATT_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # tests/test_kernels.py
MLP_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-1}  # 10x, as there
ATT_SHAPES = [  # (B, Sq, Skv, H, KV, hd)
    (1, 128, 128, 4, 4, 64),   # the shapes of tests/test_kernels.py ...
    (2, 256, 256, 8, 2, 64),
    (1, 128, 256, 4, 1, 128),
    (2, 384, 384, 6, 2, 32),
    (2, 100, 100, 4, 2, 96),   # ragged tiles, head_dim 96
    (1, 70, 130, 2, 1, 128),   # ragged, cross-length
    (3, 1, 77, 4, 2, 64),      # one query (decode-shaped)
    (2, 200, 150, 2, 2, 64),   # more queries than keys: no tile skipping
    (2, 512, 512, 16, 8, 128),  # a qwen3 prefill layer at batch 2
    (1, 33, 47, 4, 2, 128),    # Sq, Skv not multiples of 16 (mma fragment edges)
    (2, 77, 77, 16, 8, 128),   # qwen3's 16 / 8 heads, ragged
    (1, 130, 300, 4, 4, 32),   # Sq < Skv, neither a multiple of a tile
]
MLP_SHAPES = [  # (T, d, ff, act)
    (128, 64, 256, "swiglu"),  # the shapes of tests/test_kernels.py ...
    (256, 128, 512, "geglu"),
    (128, 64, 128, "gelu"),
    (384, 96, 384, "relu"),
    (1, 1024, 3072, "swiglu"),  # decode rows at qwen3's width
    (8, 1024, 3072, "swiglu"),
    (16, 1024, 3072, "swiglu"),  # the last decode-tile row count
    (17, 1024, 3072, "swiglu"),  # the first prefill-tile row count
    (4096, 1024, 3072, "swiglu"),  # qwen3's prefill MLP
    (100, 72, 200, "geglu"),   # ragged rows, columns and hidden units
]
DTYPES = [torch.float32, torch.bfloat16]


def _randn(gen, *shape, dtype, std=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * std).to(dtype)


def _att_inputs(shape, dtype, seed=0):
    B, Sq, Skv, H, KV, hd = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return (_randn(gen, B, Sq, H, hd, dtype=dtype),
            _randn(gen, B, Skv, KV, hd, dtype=dtype),
            _randn(gen, B, Skv, KV, hd, dtype=dtype))


def _assert_att(got, want, dtype):
    tol = ATT_TOL[dtype]
    assert got.shape == want.shape and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", ATT_SHAPES, ids=[str(s) for s in ATT_SHAPES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_attention_matches_plain_version(cuda, shape, dtype):
    q, k, v = _att_inputs(shape, dtype)
    before = fused_attention.flash_attention.launches
    got = ops.attention(q, k, v)
    torch.cuda.synchronize()
    assert fused_attention.flash_attention.launches == before + 1
    _assert_att(got, ref.flash_attention_ref(q, k, v), dtype)


@pytest.mark.parametrize("tile", fused_attention.TILES, ids=str)
@pytest.mark.parametrize("hd", fused_attention.HEAD_DIMS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_flash_attention_every_built_tile(cuda, tile, hd, dtype):
    q, k, v = _att_inputs((2, 320, 320, 4, 2, hd), dtype, seed=1)
    got = fused_attention.flash_attention(q, k, v, block_q=tile[0], block_k=tile[1])
    _assert_att(got, ref.flash_attention_ref(q, k, v), dtype)


@pytest.mark.parametrize("causal,window,chunk", [
    (True, 64, 0), (True, 0, 128), (True, 32, 0), (False, 0, 0),
    (False, 48, 0), (False, 0, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_attention_masks(cuda, causal, window, chunk, dtype):
    q, k, v = _att_inputs((2, 256, 256, 4, 2, 64), dtype, seed=2)
    got = fused_attention.flash_attention(q, k, v, causal=causal, window=window,
                                          chunk=chunk)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window, chunk=chunk)
    _assert_att(got, want, dtype)


@pytest.mark.parametrize("tile", fused_attention.TILES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_flash_attention_rows_fully_masked_in_the_first_tile(cuda, tile, dtype):
    # window 16 < block_k: rows past 16 + block_k - 1 see no key of the
    # first KV tile; its exp(0) garbage must be wiped, not turn into NaN
    q, k, v = _att_inputs((1, 256, 256, 2, 1, 64), dtype, seed=3)
    got = fused_attention.flash_attention(q, k, v, window=16, block_q=tile[0],
                                          block_k=tile[1])
    assert bool(torch.isfinite(got.float()).all())
    _assert_att(got, ref.flash_attention_ref(q, k, v, window=16), dtype)


# The wgmma body's tile edges (bfloat16 at head dims 64 and 128): 64-row
# warpgroups, 64- or 128-key tiles, the rows the TMA zero-fills past Sq and
# Skv, the tiles a warpgroup skips or masks.
WG_EDGE_CASES = [  # (B, Sq, Skv, H, KV, hd, causal, window, chunk)
    (1, 300, 300, 8, 4, 128, True, 0, 0),    # Sq, Skv not multiples of 64 or 128
    (1, 200, 72, 4, 2, 128, True, 0, 48),    # Sq > Skv, chunked: queries 96.. see no key
    (1, 200, 72, 4, 2, 64, False, 0, 48),    # the same, not causal, hd 64
    (2, 256, 256, 16, 2, 64, True, 0, 0),    # GQA 8 at hd 64
    (2, 320, 320, 4, 2, 128, False, 0, 0),   # non-causal hd 128
    (1, 256, 256, 2, 1, 128, True, 16, 0),   # window 16: whole first tiles masked
    (1, 256, 256, 2, 1, 64, True, 16, 0),    # the same at hd 64
    (1, 333, 333, 4, 2, 64, False, 48, 0),   # non-causal window, ragged
]


@pytest.mark.parametrize("tile", fused_attention.TILES, ids=str)
@pytest.mark.parametrize("case", WG_EDGE_CASES, ids=[str(c) for c in WG_EDGE_CASES])
def test_flash_attention_wgmma_tile_edges(cuda, case, tile):
    # out against the plain version, lse against the plain logsumexp on the
    # rows that see a key, and the serving launch bit for bit the same
    B, Sq, Skv, H, KV, hd, causal, window, chunk = case
    assert hd in fused_attention.WGMMA_HEAD_DIMS
    q, k, v = _att_inputs((B, Sq, Skv, H, KV, hd), torch.bfloat16, seed=21)
    mask = dict(causal=causal, window=window, chunk=chunk)
    before = fused_attention.flash_attention.launches
    out, lse = fused_attention.flash_attention_lse(q, k, v, block_q=tile[0],
                                                   block_k=tile[1], **mask)
    torch.cuda.synchronize()
    assert fused_attention.flash_attention.launches == before + 1
    assert bool(torch.isfinite(out.float()).all())
    _assert_att(out, ref.flash_attention_ref(q, k, v, **mask), torch.bfloat16)
    seen = ref._visible(Sq, Skv, causal, window, chunk, "cuda").any(dim=1)
    want = ref.attention_lse_ref(q, k, **mask)
    tol = LSE_TOL[torch.bfloat16]
    torch.testing.assert_close(lse[:, :, seen], want[:, :, seen], atol=tol, rtol=tol)
    again = fused_attention.flash_attention(q, k, v, block_q=tile[0], block_k=tile[1], **mask)
    assert torch.equal(again, out)


def test_flash_attention_bf16_at_64_and_128_runs_the_wgmma_body(cuda, monkeypatch):
    # no fallback: the plain version and SDPA are never called, and the
    # profiler sees the wgmma kernel, never the mma.sync one, at head dims
    # 64 and 128 (and the mma.sync one at 32 and 96)
    from torch.profiler import ProfilerActivity, profile

    def no_call(*args, **kwargs):
        raise AssertionError("a plain or library attention ran on a CUDA tensor")

    monkeypatch.setattr(ref, "flash_attention_ref", no_call)
    monkeypatch.setattr(torch.nn.functional, "scaled_dot_product_attention", no_call)
    for hd in fused_attention.HEAD_DIMS:
        q, k, v = _att_inputs((1, 128, 128, 4, 2, hd), torch.bfloat16, seed=22)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fused_attention.flash_attention(q, k, v)
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages() if "flash_attention" in e.key]
        if not names:
            pytest.skip("the profiler records no CUDA kernel on this machine")
        body = "wgmma" if hd in fused_attention.WGMMA_HEAD_DIMS else "mma"
        other = "mma" if body == "wgmma" else "wgmma"
        assert any(f"flash_attention_{body}_kernel" in n for n in names), (hd, names)
        assert not any(f"flash_attention_{other}_kernel" in n for n in names), (hd, names)


def test_flash_attention_shared_memory_is_the_wrappers(cuda):
    lib = fused_attention._library()  # checks the same when it loads
    for dtype, code in fused_attention._DTYPES.items():
        for hd in fused_attention.HEAD_DIMS:
            for bq, bk in fused_attention.TILES:
                assert lib.flash_attention_smem_bytes(hd, bq, bk, code) == \
                    fused_attention.smem_bytes(bq, bk, hd, dtype)
    assert lib.flash_attention_smem_bytes(48, 64, 64, 1) == -1


# The served registry families' attention cases that no earlier model
# reached (chip_smoke.py's serve_zoo): granite's multi-query attention (48
# query heads on one KV head) and internvl2's 7 query heads a KV head, both
# on the wgmma body; phi3's head dim 96 with one query head a KV head, on
# the mma.sync body.  Small batches, the models' heads and head dims.
ZOO_ATT_SHAPES = [  # (B, Sq, Skv, H, KV, hd)
    (2, 300, 300, 48, 1, 128),  # granite: G 48, ragged tiles
    (2, 200, 200, 14, 2, 64),   # internvl2: G 7
    (2, 777, 777, 14, 2, 64),   # G 7 past 512 keys
]


@pytest.mark.parametrize("tile", fused_attention.TILES, ids=str)
@pytest.mark.parametrize("shape", ZOO_ATT_SHAPES, ids=[str(s) for s in ZOO_ATT_SHAPES])
def test_flash_attention_wgmma_body_at_48_and_7_query_heads_a_kv_head(cuda, shape, tile):
    assert shape[5] in fused_attention.WGMMA_HEAD_DIMS
    q, k, v = _att_inputs(shape, torch.bfloat16, seed=31)
    before = fused_attention.flash_attention.launches
    got = fused_attention.flash_attention(q, k, v, block_q=tile[0], block_k=tile[1])
    torch.cuda.synchronize()
    assert fused_attention.flash_attention.launches == before + 1
    _assert_att(got, ref.flash_attention_ref(q, k, v), torch.bfloat16)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_flash_attention_head_dim_96_with_one_query_head_a_kv_head(cuda, dtype):
    # phi3's 32 / 32 heads of 96 (the mma.sync body in bfloat16), ragged
    q, k, v = _att_inputs((2, 333, 333, 32, 32, 96), dtype, seed=32)
    _assert_att(ops.attention(q, k, v), ref.flash_attention_ref(q, k, v), dtype)


@pytest.mark.parametrize("hd", [128, 64])
def test_flash_attention_chunk_mask_across_the_8192_boundary(cuda, hd):
    # llama4's chunked attention at its real chunk (8192): one head, queries
    # past the boundary see only the keys of their own chunk
    S, chunk = 8192 + 300, 8192
    q, k, v = _att_inputs((1, S, S, 1, 1, hd), torch.bfloat16, seed=33)
    got = fused_attention.flash_attention(q, k, v, chunk=chunk)
    want = ref.flash_attention_ref(q, k, v, chunk=chunk)
    _assert_att(got, want, torch.bfloat16)
    # past the boundary the result is the attention over that chunk alone
    tail = ref.flash_attention_ref(q[:, chunk:].contiguous(), k[:, chunk:].contiguous(),
                                   v[:, chunk:].contiguous())
    _assert_att(got[:, chunk:], tail, torch.bfloat16)


@pytest.mark.parametrize("T", [8, 256], ids=["decode_tile", "prefill_tile"])
def test_fused_mlp_gelu_without_w3_at_granite_width(cuda, T):
    # granite's plain GELU MLP (d 6144, d_ff 24,576): no gate, so no w3 is
    # passed; the kernel must not read one
    cfg = resolve("granite")
    d, ff = cfg.d_model, cfg.d_ff
    assert cfg.ffn_act == "gelu" and fused_mlp.default_tile(T)[0] == (16 if T <= 16 else 128)
    gen = torch.Generator(device="cuda").manual_seed(34)
    x = _randn(gen, T, d, dtype=torch.bfloat16)
    w1 = _randn(gen, d, ff, dtype=torch.bfloat16, std=d ** -0.5)
    w2 = _randn(gen, ff, d, dtype=torch.bfloat16, std=ff ** -0.5)
    before = fused_mlp.fused_mlp.launches
    got = ops.mlp(x, w1, w2, None, act="gelu")
    torch.cuda.synchronize()
    assert fused_mlp.fused_mlp.launches == before + 1
    want = ref.fused_mlp_ref(x, w1, w2, None, act="gelu")
    tol = MLP_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", MLP_SHAPES, ids=[str(s) for s in MLP_SHAPES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fused_mlp_matches_plain_version(cuda, shape, dtype):
    T, d, ff, act = shape
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = _randn(gen, T, d, dtype=dtype)
    w1, w3 = (_randn(gen, d, ff, dtype=dtype, std=d ** -0.5) for _ in range(2))
    w2 = _randn(gen, ff, d, dtype=dtype, std=ff ** -0.5)
    before = fused_mlp.fused_mlp.launches
    got = ops.mlp(x, w1, w2, w3, act=act)
    torch.cuda.synchronize()
    assert fused_mlp.fused_mlp.launches == before + 1
    want = ref.fused_mlp_ref(x, w1, w2, w3, act=act)
    tol = MLP_TOL[dtype]
    assert got.shape == want.shape and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("tile", fused_mlp.TILES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_fused_mlp_every_built_tile(cuda, tile, dtype):
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = _randn(gen, 200, 160, dtype=dtype)
    w1, w3 = (_randn(gen, 160, 448, dtype=dtype, std=0.08) for _ in range(2))
    w2 = _randn(gen, 448, 160, dtype=dtype, std=0.05)
    got = fused_mlp.fused_mlp(x, w1, w2, w3, block_m=tile[0], block_f=tile[1])
    want = ref.fused_mlp_ref(x, w1, w2, w3)
    tol = MLP_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_fused_mlp_keeps_the_hidden_frame_off_the_device(cuda):
    # qwen3's prefill MLP: the kernel's only extra memory is its float32
    # (T, d) sum buffer, below the bfloat16 (T, d_ff) hidden frame
    T, d, ff = 4096, 1024, 3072
    gen = torch.Generator(device="cuda").manual_seed(6)
    x = _randn(gen, T, d, dtype=torch.bfloat16)
    w1, w3 = (_randn(gen, d, ff, dtype=torch.bfloat16, std=d ** -0.5) for _ in range(2))
    w2 = _randn(gen, ff, d, dtype=torch.bfloat16, std=ff ** -0.5)
    fused_mlp.fused_mlp(x, w1, w2, w3)  # build and load first
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    y = fused_mlp.fused_mlp(x, w1, w2, w3)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - before - y.numel() * y.element_size()
    assert 0 < extra < T * ff * x.element_size()


def test_attention_and_mlp_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q, k, v = _att_inputs((1, 64, 64, 2, 1, 48), torch.float32)
    with pytest.raises(ValueError, match="head_dim 48"):
        fused_attention.flash_attention(q, k, v)
    q, k, v = _att_inputs((1, 64, 64, 2, 1, 64), torch.float32)
    with pytest.raises(ValueError, match="tile"):
        fused_attention.flash_attention(q, k, v, block_q=32)
    with pytest.raises(TypeError):
        fused_attention.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous"):
        fused_attention.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                                        k, v)
    x, w = torch.ones(8, 64, device="cuda"), torch.ones(64, 64, device="cuda")
    with pytest.raises(ValueError, match="tile"):
        fused_mlp.fused_mlp(x, w, w, act="relu", block_m=32)
    with pytest.raises(ValueError, match="one device"):
        fused_mlp.fused_mlp(x, w.cpu(), w, act="relu")
    # the bf16 bodies copy 16-byte rows: d and d_ff multiples of 8, aligned
    xb = torch.ones(8, 60, device="cuda").bfloat16()
    wb = torch.ones(60, 60, device="cuda").bfloat16()
    with pytest.raises(ValueError, match="multiples of 8"):
        fused_mlp.fused_mlp(xb, wb, wb, act="relu")
    flat = torch.ones(8 * 64 + 1, device="cuda").bfloat16()
    with pytest.raises(ValueError, match="aligned"):
        fused_mlp.fused_mlp(flat[1:].view(8, 64), w.bfloat16(), w.bfloat16(), act="relu")
    qb = torch.ones(1 * 64 * 2 * 64 + 1, device="cuda").bfloat16()[1:].view(1, 64, 2, 64)
    kb = torch.ones(1, 64, 1, 64, device="cuda").bfloat16()
    with pytest.raises(ValueError, match="aligned"):
        fused_attention.flash_attention(qb, kb, kb)


def test_libraries_report_their_builds(cuda):
    for mod in (fused_attention, fused_mlp):
        built = mod.build()
        assert built.path.exists() and "registers" in built.log


def test_bf16_bodies_run_on_the_tensor_cores(cuda):
    # every bf16 instantiation's SASS holds tensor-core instructions (HMMA,
    # or HGMMA for K2's and K3's wgmma bodies), the float32 ones none; K3's
    # bf16 kernels come gated and not.  K2: the wgmma body (HGMMA, no HMMA,
    # no spill) at head dims 64 and 128, the mma.sync body (HMMA) at 32 and
    # 96, one body per (head dim, tile).  K1: its bf16 instantiations (both
    # tiles, mma.sync) hold HMMA, its float32 ones (3xTF32 on wgmma) HGMMA
    # and no HMMA, its weight prep and input staging neither; none spills
    if builder.cuobjdump() is None:
        pytest.skip("cuobjdump not found beside nvcc or on PATH")
    built = fused_conv.build()
    conv = {n: c for n, c in builder.sass_counts(built.path).items()
            if "fused_conv3x3_" in n and "_kernel" in n}
    assert len(conv) == 2 * len(fused_conv.TILES) + 2
    bf16 = [c for n, c in conv.items() if "fused_conv3x3_bf16_kernel" in n]
    f32 = [c for n, c in conv.items() if "fused_conv3x3_f32_kernel" in n]
    assert len(bf16) == len(f32) == len(fused_conv.TILES)
    assert all(c["HMMA"] > 0 for c in bf16)
    assert all(c["HGMMA"] > 0 and c["HMMA"] == 0 for c in f32)
    report = builder.ptxas_report(built.log)
    assert set(report) == set(conv)
    assert not any(r.get("spill_stores") or r.get("spill_loads") for r in report.values())
    for mod, n_bf16, n_f32 in ((fused_attention, 16, 16), (fused_mlp, 8, 4)):
        counts = builder.sass_counts(mod.build().path)
        bf16 = {name: c for name, c in counts.items()
                if "_mma_" in name or "_wgmma_" in name}
        f32 = [c for name, c in counts.items() if "_f32_kernel" in name]
        assert len(bf16) == n_bf16 and len(f32) == n_f32
        assert all(c["HMMA"] + c["HGMMA"] > 0 for c in bf16.values())
        assert all(c["HGMMA"] > 0 for name, c in bf16.items() if "prefill" in name)
        assert not any(c["HMMA"] + c["HGMMA"] for c in f32)
    built = fused_attention.build()
    counts = builder.sass_counts(built.path)
    report = builder.ptxas_report(built.log)
    for hd in fused_attention.HEAD_DIMS:
        body = "wgmma" if hd in fused_attention.WGMMA_HEAD_DIMS else "mma"
        other = "mma" if body == "wgmma" else "wgmma"
        assert not any(f"flash_attention_{other}_kernelILi{hd}E" in n for n in counts)
        for bq, bk in fused_attention.TILES:
            want = f"flash_attention_{body}_kernelILi{hd}ELi{bq}ELi{bk}E"
            (name,) = [n for n in counts if want in n]
            c = counts[name]
            if body == "wgmma":
                assert c["HGMMA"] > 0 and c["HMMA"] == 0, (name, c)
                assert not report[name].get("spill_stores"), name
                assert not report[name].get("spill_loads"), name
            else:
                assert c["HMMA"] > 0, (name, c)


def test_prefill_and_decode_through_the_kernels_match_plain(cuda):
    cfg = scaled_down(resolve("qwen3"), max_seq_len=80)
    rc = dataclasses.replace(run_config(cfg.name, "decode_32k"), attn_chunk_kv=64)
    gen = torch.Generator(device="cuda").manual_seed(7)
    params = M.init_params(cfg, generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen, device="cuda")
    a0, m0 = fused_attention.flash_attention.launches, fused_mlp.fused_mlp.launches
    out = {}
    with torch.inference_mode():
        for name, kernels in (("fused", ops.KERNELS), ("plain", ops.PLAIN)):
            cache = M.init_cache(cfg, 2, 80)
            logits, cache = M.prefill(params, cfg, rc, {"tokens": tokens}, cache,
                                      kernels=kernels)
            tok = logits[:, -1].argmax(-1)[:, None]
            steps = [logits]
            for _ in range(3):
                logits, cache = M.decode(params, cfg, rc, tok, cache, kernels=kernels)
                tok = logits[:, -1].argmax(-1)[:, None]
                steps.append(logits)
            out[name] = torch.cat(steps, dim=1)
    n = cfg.n_layers
    assert fused_attention.flash_attention.launches == a0 + n
    assert fused_mlp.fused_mlp.launches == m0 + 4 * n
    torch.testing.assert_close(out["fused"], out["plain"], atol=1e-4, rtol=1e-4)


# The tensor cores add each product to the accumulator with truncation
# (found in K1's float32 body, which now sums each chunk into a zeroed
# partial).  K2 sums P.V over Skv and K3 x.w1 over d and h.w2 over a block's
# share of d_ff straight into their accumulators.  Measured at several K:
# the error against a float64 computation on the same bfloat16 inputs,
# as a relative RMS (stable over the 10^5-10^7 outputs, where a maximum is
# not), beside the float32 oracle's own; a sum biased by truncation would
# make the kernel's error grow with K faster than the oracle's.  The signed
# mean error (in units of the result's RMS) is printed: truncation's mark.
GROWTH_SLACK = 1.25  # the ratio's change over K that rounding alone gives


def _rms_errors(got, want32, want64) -> dict:
    """The kernel's and the oracle's relative RMS errors against the float64
    result, and the kernel's signed mean error, all over its RMS."""
    rms = float(want64.pow(2).mean().sqrt())
    diff = got.double() - want64
    return {"kernel": float(diff.pow(2).mean().sqrt()) / rms,
            "oracle": float((want32.double() - want64).pow(2).mean().sqrt()) / rms,
            "bias": float((diff * want64.sign()).mean()) / rms,
            "max_abs_err": float((got.float() - want32.float()).abs().max())}


def _assert_no_growth(what: str, rows: dict) -> None:
    """The kernel's error over the oracle's grows by at most GROWTH_SLACK
    from the smallest K to every larger one."""
    ks = sorted(rows)
    base = rows[ks[0]]["kernel"] / rows[ks[0]]["oracle"]
    for k in ks:
        r = rows[k]
        print(f"truncation {what} K={k}: kernel rms {r['kernel']:.4g}, float32 "
              f"oracle rms {r['oracle']:.4g} (ratio {r['kernel'] / r['oracle']:.4g}), "
              f"kernel signed mean {r['bias']:.3g}, max |kernel - oracle| "
              f"{r['max_abs_err']:.4g}")
        assert r["kernel"] / r["oracle"] <= GROWTH_SLACK * base, (what, k, rows)


@pytest.mark.parametrize("T", [1024, 8], ids=["prefill_tile", "decode_tile"])
@pytest.mark.parametrize("sweep", ["d_ff", "d"])
def test_mlp_bf16_sums_do_not_grow_their_error_at_granite_width(cuda, T, sweep):
    cfg = resolve("granite")
    d, ff = cfg.d_model, cfg.d_ff  # 6144, 24,576
    ks = (ff // 8, ff // 4, ff // 2, ff) if sweep == "d_ff" else (d // 4, d // 2, d)
    assert fused_mlp.default_tile(T) == ((16, 32) if T <= 16 else (128, 256))
    rows = {}
    for k in ks:
        dk, fk = (d, k) if sweep == "d_ff" else (k, ff)
        gen = torch.Generator(device="cuda").manual_seed(12)
        x = _randn(gen, T, dk, dtype=torch.bfloat16)
        w1, w3 = (_randn(gen, dk, fk, dtype=torch.bfloat16, std=dk ** -0.5)
                  for _ in range(2))
        w2 = _randn(gen, fk, dk, dtype=torch.bfloat16, std=fk ** -0.5)
        got = fused_mlp.fused_mlp(x, w1, w2, w3)
        want32 = ref.fused_mlp_ref(x, w1, w2, w3)
        torch.testing.assert_close(got.float(), want32.float(),
                                   atol=MLP_TOL[torch.bfloat16],
                                   rtol=MLP_TOL[torch.bfloat16])
        xd = x.double()
        h = torch.nn.functional.silu(xd @ w1.double()) * (xd @ w3.double())
        rows[k] = _rms_errors(got, want32, h @ w2.double())
        del x, w1, w2, w3, h, xd
    _assert_no_growth(f"fused_mlp T={T} d={d if sweep == 'd_ff' else 'K'} "
                      f"d_ff={ff if sweep == 'd' else 'K'}", rows)


def test_attention_bf16_sums_do_not_grow_their_error_at_long_prefill(cuda):
    # qwen3's serve prefill (8 x 512, 16 / 8 heads, 128) and 2x, 4x its length
    rows = {}
    for S in (512, 1024, 2048):
        q, k, v = _att_inputs((8, S, S, 16, 8, 128), torch.bfloat16, seed=13)
        got = fused_attention.flash_attention(q, k, v)
        want32 = ref.flash_attention_ref(q, k, v)
        _assert_att(got, want32, torch.bfloat16)
        idx = torch.arange(16, device="cuda") // 2
        kd = k.index_select(2, idx).double()
        vd = v.index_select(2, idx).double()
        scores = torch.einsum("bqhd,bchd->bhqc", q.double(), kd) / 128 ** 0.5
        mask = torch.ones(S, S, dtype=torch.bool, device="cuda").tril()
        probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
        del scores
        want64 = torch.einsum("bhqc,bchd->bqhd", probs, vd)
        rows[S] = _rms_errors(got, want32, want64)
        del probs, want64, want32, kd, vd
        torch.cuda.empty_cache()
    _assert_no_growth("flash_attention causal (8, S, 16/8, 128) S", rows)


# ---------------------------------------------------------------------------
# K4 selective_scan
# ---------------------------------------------------------------------------

SCAN_TOL = 1e-4  # tests/test_kernels.py
SCAN_CASES = [  # (B, S, di, ds, chunk, block_d, with h0 and the final state)
    (1, 64, 16, 4, 16, 16, False),  # the shapes of tests/test_kernels.py ...
    (2, 128, 32, 8, 32, 16, False),
    (1, 64, 64, 16, 64, 32, False),
    (2, 128, 32, 8, 32, 16, True),
    (8, 1, 8192, 16, None, None, True),  # falcon-mamba's decode step
    (3, 200, 1000, 16, 64, 384, True),  # ragged S and di
    (2, 77, 300, 5, 16, 128, True),  # odd ds: scalar loads
    (2, 50, 130, 6, 7, 64, True),  # ds % 4 == 2: float2 loads
    (1, 9, 40, 1, 4, 32, False),  # one state value a channel
    (8, 1, 8192, 16, None, None, False),  # the decode body without a state
    (3, 1, 1000, 5, None, None, True),  # the decode body, ragged, odd ds
    (3, 1, 1000, 5, None, None, False),
]


def _scan_inputs(B, S, di, ds, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dA = 0.3 + 0.68 * torch.rand((B, S, di, ds), generator=gen, device="cuda")
    dBx = 0.1 * torch.randn((B, S, di, ds), generator=gen, device="cuda")
    C = torch.randn((B, S, ds), generator=gen, device="cuda")
    h0 = 0.5 * torch.randn((B, di, ds), generator=gen, device="cuda")
    return dA, dBx, C, h0


@pytest.mark.parametrize("case", SCAN_CASES, ids=[str(c) for c in SCAN_CASES])
def test_selective_scan_matches_plain_version(cuda, case):
    B, S, di, ds, chunk, block_d, state = case
    dA, dBx, C, h0 = _scan_inputs(B, S, di, ds)
    h0 = h0 if state else None
    before = mamba_scan.selective_scan.launches
    y, h = ops.ssm_scan(dA, dBx, C, h0=h0, chunk=chunk, block_d=block_d)
    torch.cuda.synchronize()
    assert mamba_scan.selective_scan.launches == before + 1
    want_y, want_h = ref.selective_scan_ref(dA, dBx, C, h0)
    torch.testing.assert_close(y, want_y, atol=SCAN_TOL, rtol=SCAN_TOL)
    torch.testing.assert_close(h, want_h, atol=SCAN_TOL, rtol=SCAN_TOL)


@pytest.mark.parametrize("S", [33, 1], ids=["prefill_body", "decode_body"])
def test_selective_scan_at_jambas_d_inner(cuda, S):
    # jamba's Mamba layers: d_inner 16,384 (twice falcon-mamba's), the
    # default tile's 32 channel blocks, the state carried in and out
    di, ds = resolve("jamba").d_inner, resolve("jamba").ssm_state
    assert (di, ds) == (16384, 16) and mamba_scan.default_tile(di) == (64, 512)
    dA, dBx, C, h0 = _scan_inputs(8 if S == 1 else 2, S, di, ds, seed=5)
    before = mamba_scan.selective_scan.launches
    y, h = ops.ssm_scan(dA, dBx, C, h0=h0)
    torch.cuda.synchronize()
    assert mamba_scan.selective_scan.launches == before + 1
    want_y, want_h = ref.selective_scan_ref(dA, dBx, C, h0)
    torch.testing.assert_close(y, want_y, atol=SCAN_TOL, rtol=SCAN_TOL)
    torch.testing.assert_close(h, want_h, atol=SCAN_TOL, rtol=SCAN_TOL)


@pytest.mark.parametrize("S", [33, 1], ids=["prefill_body", "decode_body"])
def test_selective_scan_without_the_final_state_writes_none(cuda, S):
    dA, dBx, C, h0 = _scan_inputs(2, S, 70, 16, seed=1)
    y, h = mamba_scan.selective_scan(dA, dBx, C, final_state=False, block_d=32)
    assert h is None
    torch.testing.assert_close(y, ref.selective_scan_ref(dA, dBx, C)[0],
                               atol=SCAN_TOL, rtol=SCAN_TOL)
    y, h = mamba_scan.selective_scan(dA, dBx, C, h0, final_state=False)
    assert h is None
    torch.testing.assert_close(y, ref.selective_scan_ref(dA, dBx, C, h0)[0],
                               atol=SCAN_TOL, rtol=SCAN_TOL)


def test_selective_scan_decode_body_equals_the_prefill_body_at_one_step(cuda):
    # the S == 1 body does the prefill body's FMAs in its order: the same
    # bits as the first step of a longer scan
    dA, dBx, C, h0 = _scan_inputs(3, 2, 1000, 16, seed=4)
    y2, _ = mamba_scan.selective_scan(dA, dBx, C, h0)
    y1, h1 = mamba_scan.selective_scan(dA[:, :1].contiguous(), dBx[:, :1].contiguous(),
                                       C[:, :1].contiguous(), h0)
    assert torch.equal(y1[:, 0], y2[:, 0])
    _, h_next = mamba_scan.selective_scan(dA[:, 1:].contiguous(), dBx[:, 1:].contiguous(),
                                          C[:, 1:].contiguous(), h1)
    _, h_two = mamba_scan.selective_scan(dA, dBx, C, h0)
    assert torch.equal(h_next, h_two)


def test_selective_scan_on_the_card_never_runs_the_plain_version(cuda, monkeypatch):
    def no_plain(*args, **kwargs):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(ref, "selective_scan_ref", no_plain)
    dA, dBx, C, h0 = _scan_inputs(2, 16, 64, 16, seed=2)
    y, h = mamba_scan.selective_scan(dA, dBx, C, h0)
    assert y.is_cuda and h.is_cuda
    with pytest.raises(ValueError, match="ds 17"):  # raises, no fallback
        mamba_scan.selective_scan(*_scan_inputs(1, 4, 8, 17)[:3])


def test_selective_scan_rejects_what_the_kernel_does_not_take(cuda):
    dA, dBx, C, h0 = _scan_inputs(2, 16, 64, 16, seed=3)
    with pytest.raises(TypeError):
        mamba_scan.selective_scan(dA.double(), dBx.double(), C.double())
    with pytest.raises(ValueError, match="contiguous"):
        mamba_scan.selective_scan(dA, dBx, C, h0.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="one device"):
        mamba_scan.selective_scan(dA, dBx, C.cpu())
    with pytest.raises(ValueError, match="block_d"):
        mamba_scan.selective_scan(dA, dBx, C, block_d=1024)
    with pytest.raises(ValueError, match="chunk"):
        mamba_scan.selective_scan(dA, dBx, C, chunk=100_000)
    flat = torch.empty(dA.numel() + 1, device="cuda")
    with pytest.raises(ValueError, match="aligned"):
        mamba_scan.selective_scan(flat[1:].view(dA.shape), dBx, C)


def test_scan_library_reports_its_build(cuda):
    built = mamba_scan.build()
    assert built.path.exists() and "registers" in built.log


def test_mamba_prefill_and_decode_through_the_kernel_match_plain(cuda):
    cfg = scaled_down(resolve("falcon-mamba"), max_seq_len=80)
    rc = run_config(cfg.name, "decode_32k")
    gen = torch.Generator(device="cuda").manual_seed(8)
    params = M.init_params(cfg, generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen, device="cuda")
    s0 = mamba_scan.selective_scan.launches
    out = {}
    with torch.inference_mode():
        for name, kernels in (("fused", ops.KERNELS), ("plain", ops.PLAIN)):
            cache = M.init_cache(cfg, 2, 80)
            logits, cache = M.prefill(params, cfg, rc, {"tokens": tokens}, cache,
                                      kernels=kernels)
            tok = logits[:, -1].argmax(-1)[:, None]
            steps = [logits]
            for _ in range(3):
                logits, cache = M.decode(params, cfg, rc, tok, cache, kernels=kernels)
                tok = logits[:, -1].argmax(-1)[:, None]
                steps.append(logits)
            out[name] = torch.cat(steps, dim=1)
    assert mamba_scan.selective_scan.launches == s0 + 4 * cfg.n_layers
    torch.testing.assert_close(out["fused"], out["plain"], atol=1e-4, rtol=1e-4)


def _jamba2_mini_mamba(seed: int, S: int):
    """(cfg, one full-width Jamba2-Mini Mamba mixer in bfloat16, x (1, S,
    4096), a zeroed cache): d_inner 8192, d_state 16, dt_rank 256, the
    inner norms."""
    from repro_torch.configs import JambaConfig
    from repro_torch.models import ssm

    cfg = JambaConfig(name="jamba2-mini", family="hybrid", n_layers=16, d_model=4096,
                      n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14_336, vocab_size=65_536,
                      layer_pattern=("mamba",) * 4 + ("attn",) + ("mamba",) * 3,
                      n_experts=16, top_k=2, moe_every=2, moe_offset=1, ssm_dt_rank=256,
                      tie_embeddings=False, dtype="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = ssm.init_mamba(gen, cfg, torch.bfloat16)
    x = torch.randn((1, S, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
    return cfg, params, x, ssm.init_mamba_cache(cfg, 1, torch.bfloat16, "cuda")


def test_a_jamba2_mini_mamba_layer_prefills_32768_tokens_in_chunks_of_time(cuda):
    from repro_torch.models import ssm

    cfg, params, x, cache = _jamba2_mini_mamba(11, 32_768)
    chunk = ssm.time_chunk(1, cfg.d_inner, cfg.ssm_state)
    assert chunk == 8192
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    s0 = mamba_scan.selective_scan.launches
    with torch.inference_mode():
        out, new = ssm.mamba_block(params, x, cfg, cache)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert mamba_scan.selective_scan.launches == s0 + 32_768 // chunk
    whole = 2 * 4 * 32_768 * cfg.d_inner * cfg.ssm_state  # dA and dBx at once: 32 GiB
    print(f"jamba2-mini mamba layer, 32768 tokens: peak {peak} B above the inputs "
          f"(dA + dBx whole: {whole} B)")
    finite = bool(torch.isfinite(out).all()) and bool(torch.isfinite(new["h"]).all())
    # hand the allocator's 8 GiB blocks back: a later allocation carved from
    # one would pin it, and the full-width MoE tests need nearly the card
    del params, x, cache, out, new
    torch.cuda.empty_cache()
    assert peak < ssm.SCAN_BUDGET_BYTES + (6 << 30) < whole
    assert finite


def test_the_chunked_jamba2_mini_mamba_layer_matches_one_call_at_8192_tokens(
        cuda, monkeypatch):
    from repro_torch.models import ssm

    cfg, params, x, cache = _jamba2_mini_mamba(12, 8192)
    got = {}
    for steps in (8192, 3000):
        monkeypatch.setattr(ssm, "SCAN_BUDGET_BYTES", steps * 2 * 4 * cfg.d_inner * cfg.ssm_state)
        with torch.inference_mode():
            out, new = ssm.mamba_block(params, x, cfg, {k: v.clone() for k, v in cache.items()})
        got[steps] = (out.float(), new["h"], new["conv"])
    (out, h, conv), (out_c, h_c, conv_c) = got[8192], got[3000]
    print(f"chunks of 3000 against one call: out equal {torch.equal(out, out_c)}, "
          f"h equal {torch.equal(h, h_c)}")
    assert torch.equal(conv, conv_c)
    torch.testing.assert_close(h_c, h, rtol=1e-5, atol=1e-6)
    out_err = float((out_c - out).norm() / out.norm())
    del params, x, cache, got, out, h, conv, out_c, h_c, conv_c
    torch.cuda.empty_cache()  # as the 32,768-token test does
    assert out_err < 1e-3  # a bf16 rounding flipped at most


# ---------------------------------------------------------------------------
# The tracing frontend's graphs and models on the card
# ---------------------------------------------------------------------------


def test_traced_resnet18_sweeps_on_the_card_as_the_hand_built_one(cuda):
    from repro_torch.core import frontend

    traced = frontend.resnet18_graph()
    a = flow.run_flow(traced, groupings="search", pareto=True, device="cuda")
    b = flow.run_flow(ir.resnet18_ir(), groupings="search", pareto=True, device="cuda")
    assert a.best_hw == b.best_hw and a.best_metrics == b.best_metrics
    np.testing.assert_array_equal(a.best_cuts, b.best_cuts)
    assert (a.group_sizes, a.n_candidates, a.n_feasible, a.search_engine) == \
        (b.group_sizes, b.n_candidates, b.n_feasible, b.search_engine)
    np.testing.assert_array_equal(a.pareto.metrics, b.pareto.metrics)
    np.testing.assert_array_equal(a.pareto.cuts, b.pareto.cuts)
    assert metrics.evaluate_ref(traced, a.best_cuts, a.best_hw) == a.best_metrics


def test_moe_layer_at_full_width_in_bfloat16_matches_float32(cuda):
    """One mixtral-8x7b MoE layer (d 4096, ff 14336, 8 experts, top-2) on
    4096 tokens: bfloat16 against float32 from the same bfloat16 input,
    within 5e-2 of the largest |y| (chip_smoke.py's MOE_BF16_TOL)."""
    from repro_torch.models import moe

    cfg = resolve("mixtral")
    gen = torch.Generator(device="cuda").manual_seed(0)
    p32 = moe.init_moe(gen, cfg, torch.float32)
    p16 = {k: v if k == "router" else v.to(torch.bfloat16) for k, v in p32.items()}
    x16 = torch.randn((1, 4096, cfg.d_model), generator=gen,
                      device="cuda").to(torch.bfloat16)
    with torch.inference_mode():
        y16, aux16 = moe.moe_block(p16, x16, cfg)
        y32, aux32 = moe.moe_block(p32, x16.float(), cfg)
    assert y16.dtype == torch.bfloat16 and y16.shape == x16.shape
    assert torch.isfinite(y16).all()
    assert float((y16.float() - y32).abs().max()) <= 5e-2 * float(y32.abs().max())
    assert abs(float(aux16) - float(aux32)) <= 1e-6 * abs(float(aux32))



def _moe_pass(moe, spans, cfg, params, x, r, dtype=None, frozen=()):
    """(y, aux, {"x": its grad, and each parameter's but the ``frozen``},
    counters) of one forward and backward of ``moe.moe_block`` on the card,
    in ``dtype`` (default: the tensors' own) on the path ``moe._sorted``
    picks."""
    cast = (lambda t: t) if dtype is None else (lambda t: t.to(dtype))
    p = {k: (v if k == "router" else cast(v)).detach().requires_grad_(k not in frozen)
         for k, v in params.items()}
    xi = cast(x).detach().requires_grad_()
    spans.reset()
    with spans.enabled():
        y, aux = moe.moe_block(p, xi, cfg)
    ((y.float() * r).sum() + aux).backward()
    counted = spans.counters()
    spans.reset()
    return (y.detach().float(), aux.detach(),
            {"x": xi.grad.float(),
             **{k: v.grad.float() for k, v in p.items() if k not in frozen}}, counted)


@pytest.mark.parametrize("arch, tokens, C", [("mixtral", 4096, 256), ("mixtral", 32256, 256),
                                             ("jamba", 4096, 128)],
                         ids=["4096", "8x4032", "jamba-4096"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_moe_sorted_path_matches_the_capacity_path_at_full_width(cuda, dtype, arch, tokens,
                                                                 C, monkeypatch):
    """One MoE layer at full width, groups of 512, capacity factor 2:
    mixtral-8x7b's (d 4096, ff 14336, 8 experts, top-2) on 4096 tokens and
    on 32,256 (the benchmark's longest batch), jamba-1.5-large's (d 8192,
    ff 24576, 16 experts, top-2) on 4096 tokens, its prefill's.  The
    sorted path, which the card takes (its products count the kept rows),
    against the capacity path, patched in (every slot), on the same routes,
    forward and backward: the gradients of x and every parameter, jamba's
    experts' weights left out (their gradients do not fit beside a float32
    reference of its 19.3 GB of bfloat16 experts; mixtral's cover them).
    Float32: within 1e-4 of each number's largest magnitude.  Bfloat16: no
    further from the capacity path run in float32 on the same inputs than
    twice the bfloat16 capacity path is, plus one bfloat16 rounding (2**-8)
    of the largest magnitude."""
    from repro_torch.models import moe
    from repro_torch.runtime import spans

    cfg = resolve(arch)
    frozen = ("w1", "w2", "w3") if arch == "jamba" else ()
    gen = torch.Generator(device="cuda").manual_seed(11)
    params = moe.init_moe(gen, cfg, dtype)
    x = torch.randn((1, tokens, cfg.d_model), generator=gen, device="cuda").to(dtype)
    r = torch.randn(x.shape, generator=gen, device="cuda")
    G, E = tokens // 512, cfg.n_experts
    assert moe._capacity(cfg, 512) == C

    y_s, aux_s, g_s, n_s = _moe_pass(moe, spans, cfg, params, x, r, frozen=frozen)
    assert n_s["moe.rows"] == n_s["moe.kept"] <= n_s["moe.claims"] == 2 * tokens
    monkeypatch.setattr(moe, "_sorted", lambda *a: False)
    y_c, aux_c, g_c, n_c = _moe_pass(moe, spans, cfg, params, x, r, frozen=frozen)
    assert n_c == {**n_s, "moe.rows": G * E * C}
    assert torch.equal(aux_s, aux_c)
    got, capacity = {"y": y_s, **g_s}, {"y": y_c, **g_c}
    if dtype == torch.float32:
        for k, want in capacity.items():
            err = float((got[k] - want).abs().max())
            assert err <= 1e-4 * float(want.abs().max()), (k, err)
        return
    y_r, _, g_r, _ = _moe_pass(moe, spans, cfg, params, x, r, torch.float32, frozen)
    for k, want in {"y": y_r, **g_r}.items():
        err_s = float((got[k] - want).abs().max())
        err_c = float((capacity[k] - want).abs().max())
        assert err_s <= 2 * err_c + 2**-8 * float(want.abs().max()), (k, err_s, err_c)


@pytest.mark.parametrize("tokens", [4096, 32256], ids=["4096", "8x4032"])
def test_moe_sorted_combine_equals_the_one_hot_product_bit_for_bit(cuda, tokens, monkeypatch):
    """Bfloat16 at mixtral's width, with experts rigged to be exact (w1, w3
    and w2 the identity on the first d of ff columns, times powers of two):
    both paths compute the same ``ye`` bits, so the sorted path's float32
    sum of each token's ``ye * gate``, rounded once, equals the capacity
    path's one-hot combine product, which accumulates in float32 and rounds
    once, bit for bit.  A decode step's eight tokens (G * C = 4) take the
    capacity path on the card."""
    from repro_torch.models import moe
    from repro_torch.runtime import spans

    cfg = resolve("mixtral")
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    gen = torch.Generator(device="cuda").manual_seed(12)
    eye = torch.eye(d, ff, device="cuda")
    two = 2.0 ** (torch.arange(E, device="cuda") % 3 - 1)[:, None, None]  # 1/2, 1, 2
    params = {"router": torch.randn((d, E), generator=gen, device="cuda") / d**0.5,
              "w1": (eye * two).to(torch.bfloat16), "w3": (eye / two).to(torch.bfloat16),
              "w2": (eye.T * two.flip(0)).to(torch.bfloat16)}
    x = torch.randn((1, tokens, d), generator=gen, device="cuda").to(torch.bfloat16)
    counted = []
    with torch.inference_mode():
        for part in (x[:, :8], x):
            with spans.enabled():
                out = moe.moe_block(params, part, cfg)
            counted.append(spans.counters())
            spans.reset()
        monkeypatch.setattr(moe, "_sorted", lambda *a: False)
        y_c, aux_c = moe.moe_block(params, x, cfg)
    n_decode, n = counted
    y_s, aux_s = out
    assert n["moe.rows"] == n["moe.kept"] and n_decode["moe.rows"] == 1 * E * 4
    assert y_s.dtype == torch.bfloat16 and torch.isfinite(y_s).all()
    assert torch.equal(aux_s, aux_c)
    assert torch.equal(y_s, y_c)


def _same_fleet(a, b):
    for ra, rb in zip(a.results, b.results):
        assert ra.best_hw == rb.best_hw and ra.best_metrics == rb.best_metrics
        np.testing.assert_array_equal(ra.best_cuts, rb.best_cuts)
        assert (ra.n_candidates, ra.n_feasible, ra.n_pruned, ra.group_sizes) == \
            (rb.n_candidates, rb.n_feasible, rb.n_pruned, rb.group_sizes)
        np.testing.assert_array_equal(ra.pareto.metrics, rb.pareto.metrics)
        np.testing.assert_array_equal(ra.pareto.hw_indices, rb.pareto.hw_indices)
        np.testing.assert_array_equal(ra.pareto.cut_indices, rb.pareto.cut_indices)


def test_fleet_split_on_one_card_equals_the_single_device_sweep_and_the_cpu(cuda):
    """bench_shard's four workloads over the 2,560-point grid: two shards on
    one card (three: H padded) equal the one-device sweep on the card and on
    the CPU, bit for bit."""
    gs = [ir.resnet18_ir(), ir.residual_block_ir(),
          ir.as_graph(ir.vgg16_ir(pool_mode="separate")), ir.encoder_decoder_ir()]
    kw = dict(config_space=arch.config_space_grid(),
              constraints=arch.Constraints(*[float("inf")] * 4),
              groupings="pool", pareto=True)
    one = flow.run_fleet(gs, device="cuda", **kw)
    for devices in (("cuda:0", "cuda:0"), ("cuda:0",) * 3):
        split = flow.run_fleet(gs, devices=devices, **kw)
        assert split.device_count == len(devices)
        _same_fleet(split, one)
    _same_fleet(one, flow.run_fleet(gs, device="cpu", **kw))


def test_a_service_plan_on_the_card_equals_its_plan_on_the_cpu(cuda):
    from repro_torch.core.service import PlanRequest, PlanningService
    from repro_torch.testing.faults import _valid_graphs

    card, host = PlanningService(device="cuda"), PlanningService(device="cpu")
    assert card.device == torch.device("cuda", torch.cuda.current_device())
    for g in _valid_graphs() + [ir.resnet18_ir()]:
        for budget in (float("inf"), 1e6):
            a = card.plan(PlanRequest(graph=g, sram_budget_words=budget))
            b = host.plan(PlanRequest(graph=g, sram_budget_words=budget))
            assert (a.ok, a.error_type, a.engine, a.rung) == (b.ok, b.error_type,
                                                              b.engine, b.rung)
            if a.ok:
                assert a.plan.best_hw == b.plan.best_hw
                assert a.plan.best_metrics == b.plan.best_metrics
                np.testing.assert_array_equal(a.plan.best_cuts, b.plan.best_cuts)


# ---------------------------------------------------------------------------
# Serving the MoE and encoder-decoder models, and the ring cache
# ---------------------------------------------------------------------------

# Logits through the kernels against the plain path in float32, relative to
# the largest logit: chip_smoke.PREFILL_TOL's float32 1e-3 (per-kernel float32
# differences adding along the residual stream over a few layers).
SERVE_F32_TOL = 1e-3
SEAMLESS_SHAPES = [  # (B, Sq, Skv, H, KV, hd): cross-attention, the encoder
    (8, 512, 1024, 16, 16, 64), (8, 1024, 1024, 16, 16, 64)]


@pytest.mark.parametrize("shape", SEAMLESS_SHAPES, ids=["cross", "encoder"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_flash_attention_without_the_causal_mask_at_seamless_shapes(cuda, shape, dtype):
    q, k, v = _att_inputs(shape, dtype, seed=3)
    before = fused_attention.flash_attention.launches
    got = ops.attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert fused_attention.flash_attention.launches == before + 1
    _assert_att(got, ref.flash_attention_ref(q, k, v, causal=False), dtype)


def _serve_logits(cfg, rc, params, batch, *, steps: int, kernels, ring=False,
                  tokens=None):
    """Prefill logits and ``steps`` decode steps' (B, 1 + steps, V) and the
    decoded tokens; ``tokens`` (a list of (B, 1)) are fed instead of the
    greedy ones where given."""
    B, S = batch["tokens"].shape
    fed = [] if tokens is None else tokens
    with torch.inference_mode():
        cache = M.init_cache(cfg, B, S + steps + 8, ring=ring)
        logits, cache = M.prefill(params, cfg, rc, batch, cache, kernels=kernels)
        out = [logits]
        for i in range(steps):
            if tokens is None:
                fed.append(logits[:, -1].argmax(-1)[:, None])
            logits, cache = M.decode(params, cfg, rc, fed[i], cache, kernels=kernels)
            out.append(logits)
    return torch.cat(out, dim=1), fed, cache


def _assert_relative(got, want, tol):
    assert bool(torch.isfinite(got).all())
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    assert err <= tol * scale, (err, tol * scale)


def test_mixtral_two_layers_at_full_width_through_the_kernels_match_plain(cuda):
    cfg = dataclasses.replace(resolve("mixtral"), n_layers=2, dtype="float32")
    rc = dataclasses.replace(run_config(cfg.name, "decode_32k"), attn_chunk_kv=64)
    gen = torch.Generator(device="cuda").manual_seed(9)
    params = M.init_params(cfg, generator=gen)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 128), generator=gen,
                                     device="cuda")}
    a0, m0 = fused_attention.flash_attention.launches, fused_mlp.fused_mlp.launches
    got, fed, _ = _serve_logits(cfg, rc, params, batch, steps=3, kernels=ops.KERNELS)
    assert fused_attention.flash_attention.launches == a0 + cfg.n_layers
    assert fused_mlp.fused_mlp.launches == m0  # the experts are batched products
    want, _, _ = _serve_logits(cfg, rc, params, batch, steps=3, kernels=ops.PLAIN,
                               tokens=fed)
    _assert_relative(got, want, SERVE_F32_TOL)


def test_seamless_two_plus_two_layers_through_the_kernels_match_plain(cuda):
    cfg = dataclasses.replace(resolve("seamless"), n_layers=2, n_enc_layers=2,
                              dtype="float32")
    rc = dataclasses.replace(run_config(cfg.name, "decode_32k"), attn_chunk_kv=64)
    gen = torch.Generator(device="cuda").manual_seed(10)
    params = M.init_params(cfg, generator=gen)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                                     device="cuda"),
             "frontend": torch.randn((2, cfg.frontend_len, cfg.d_model), generator=gen,
                                     device="cuda")}
    a0, m0 = fused_attention.flash_attention.launches, fused_mlp.fused_mlp.launches
    got, fed, cache = _serve_logits(cfg, rc, params, batch, steps=3, kernels=ops.KERNELS)
    # the prefill: 2 encoder, 2 decoder self- and 2 cross-attentions; the
    # MLP once per layer per forward
    assert fused_attention.flash_attention.launches == a0 + 6
    assert fused_mlp.fused_mlp.launches == m0 + 4 + 2 * 3
    assert cache["len"] == 64 + 3
    want, _, _ = _serve_logits(cfg, rc, params, batch, steps=3, kernels=ops.PLAIN,
                               tokens=fed)
    _assert_relative(got, want, SERVE_F32_TOL)


def test_gemma3_ring_cache_through_the_kernels_matches_the_full_cache(cuda):
    # one superblock at full width, float32: 5 sliding-window layers of 1024
    # and a global one; a 1100-token prompt wraps the ring, and decode too
    cfg = dataclasses.replace(resolve("gemma3"), n_layers=6, dtype="float32")
    rc = dataclasses.replace(run_config(cfg.name, "decode_32k"), attn_chunk_kv=64)
    gen = torch.Generator(device="cuda").manual_seed(11)
    params = M.init_params(cfg, generator=gen)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 1100), generator=gen,
                                     device="cuda")}
    a0 = fused_attention.flash_attention.launches
    ring, fed, cache = _serve_logits(cfg, dataclasses.replace(rc, local_ring_cache=True),
                                     params, batch, steps=8, kernels=ops.KERNELS, ring=True)
    assert fused_attention.flash_attention.launches == a0 + cfg.n_layers
    layer = cache["segments"][0][0]
    assert [layer[f"sub{j}"]["k"].shape[1] for j in range(6)] == [1024] * 5 + [1116]
    full, _, _ = _serve_logits(cfg, rc, params, batch, steps=8, kernels=ops.KERNELS,
                               tokens=fed)
    # the same calls, but fused_mlp's atomics add in a run-to-run order
    torch.testing.assert_close(ring, full, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# The training slice: K2's logsumexp, the flash-attention backward kernel,
# the autograd refusals of K1 / K3 / K4, a train step on the card
# ---------------------------------------------------------------------------

BWD_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}  # tests/test_flash_vjp.py
LSE_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-4}
BWD_CASES = [  # (B, Sq, Skv, H, KV, hd, causal, window, chunk)
    (2, 128, 128, 4, 4, 64, True, 0, 0),       # GQA 1
    (2, 256, 256, 8, 4, 128, True, 0, 0),      # GQA 2, qwen3's head width
    (1, 200, 200, 8, 2, 32, True, 0, 0),       # GQA 4, ragged S
    (2, 192, 192, 4, 2, 96, True, 64, 0),      # sliding window, hd 96
    (1, 256, 256, 4, 1, 64, True, 0, 64),      # chunked, GQA 4
    (1, 130, 130, 2, 2, 128, False, 0, 0),     # non-causal, ragged
    (1, 96, 160, 4, 2, 64, False, 48, 0),      # non-causal window, Sq < Skv
    (1, 160, 64, 4, 2, 64, True, 0, 32),       # Sq > Skv: queries 64.. see no key
    # the wgmma bodies' tile edges (128 keys a dK/dV block, 128 queries a dQ
    # block, 64-row stages)
    (1, 300, 300, 8, 4, 128, True, 0, 0),      # Skv not a multiple of 128
    (1, 200, 72, 4, 2, 128, True, 0, 48),      # Sq > Skv, chunked: queries 96.. see no key
    (2, 256, 256, 16, 2, 64, True, 0, 0),      # GQA 8 at hd 64
    (2, 320, 320, 4, 2, 128, False, 0, 0),     # non-causal hd 128
]


def _bwd_inputs(case, dtype, seed=0):
    B, Sq, Skv, H, KV, hd, causal, window, chunk = case
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    q, k, v = randn(B, Sq, H, hd), randn(B, Skv, KV, hd), randn(B, Skv, KV, hd)
    mask = dict(causal=causal, window=window, chunk=chunk)
    out, lse = fused_attention.flash_attention_lse(q, k, v, **mask)
    return q, k, v, out, randn(B, Sq, H, hd), lse, mask


def _assert_grad_close(got, want, dtype, what):
    got, want = got.float(), want.float()
    assert bool(torch.isfinite(got).all()), what
    tol = BWD_TOL[dtype]
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=tol, rtol=tol, msg=what)
    else:
        err = float((got - want).abs().max())
        assert err <= tol * float(want.abs().max()), f"{what}: max |diff| {err}"


@pytest.mark.parametrize("case", BWD_CASES, ids=[str(c) for c in BWD_CASES])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_flash_attention_bwd_matches_plain_version(cuda, case, dtype):
    q, k, v, out, dout, lse, mask = _bwd_inputs(case, dtype)
    before = flash_attention_bwd.flash_attention_bwd.launches
    got = flash_attention_bwd.flash_attention_bwd(q, k, v, out, dout, lse, **mask)
    torch.cuda.synchronize()
    assert flash_attention_bwd.flash_attention_bwd.launches == before + 1
    want = ref.flash_attention_bwd_ref(q, k, v, out, dout, lse, **mask)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape
        _assert_grad_close(g, w, dtype, f"{name} {case}")


@pytest.mark.parametrize("case", BWD_CASES, ids=[str(c) for c in BWD_CASES])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_flash_attention_lse_matches_the_plain_logsumexp(cuda, case, dtype):
    q, k, v, out, _, lse, mask = _bwd_inputs(case, dtype, seed=1)
    Sq, Skv = q.shape[1], k.shape[1]
    seen = ref._visible(Sq, Skv, mask["causal"], mask["window"], mask["chunk"],
                        "cuda").any(dim=1)
    want = ref.attention_lse_ref(q, k, **mask)
    tol = LSE_TOL[dtype]
    torch.testing.assert_close(lse[:, :, seen], want[:, :, seen], atol=tol, rtol=tol)
    # the serving launch (no lse) writes the same output, bit for bit
    assert torch.equal(fused_attention.flash_attention(q, k, v, **mask), out)


@pytest.mark.parametrize("case", [c for c in BWD_CASES if c[1] > c[2]],
                         ids=[str(c) for c in BWD_CASES if c[1] > c[2]])
def test_flash_attention_bwd_rows_that_see_no_key_get_zero(cuda, case):
    q, k, v, out, dout, lse, mask = _bwd_inputs(case, torch.bfloat16, seed=4)
    dead = ~ref._visible(q.shape[1], k.shape[1], mask["causal"], mask["window"],
                         mask["chunk"], "cuda").any(dim=1)
    assert bool(dead.any())
    dq, dk, dv = flash_attention_bwd.flash_attention_bwd(q, k, v, out, dout, lse, **mask)
    assert not bool(dq[:, dead].any()) and bool(dq[:, ~dead].any())
    assert all(bool(torch.isfinite(g).all()) for g in (dq, dk, dv))


def test_flash_attention_bwd_on_the_card_never_runs_the_plain_version(cuda, monkeypatch):
    def no_plain(*args, **kwargs):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(ref, "flash_attention_bwd_ref", no_plain)
    for case in ((1, 128, 128, 4, 2, 64, True, 0, 0), (1, 128, 128, 4, 2, 128, True, 0, 0)):
        q, k, v, out, dout, lse, mask = _bwd_inputs(case, torch.bfloat16, seed=5)
        got = flash_attention_bwd.flash_attention_bwd(q, k, v, out, dout, lse, **mask)
        assert all(g.is_cuda for g in got)
    with pytest.raises(ValueError, match="head_dim 48"):  # raises, no fallback
        q, k, v = (t[..., :48].contiguous() for t in (q, k, v))
        flash_attention_bwd.flash_attention_bwd(q, k, v, q, q, lse)


def _bwd_oracle64(q, k, v, out, dout, lse, scale):
    """dq, dk, dv of the same formula as the kernel and its plain version
    (P from the given lse, D from the given out), causal, in float64."""
    G = q.shape[2] // k.shape[2]
    qd, dod, od = q.double(), dout.double(), out.double()
    kd = k.double().repeat_interleave(G, dim=2)
    vd = v.double().repeat_interleave(G, dim=2)
    S = q.shape[1]
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qd, kd) * scale - lse.double()[..., None])
    p.masked_fill_(~causal, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dod, vd)
    dp -= (dod * od).sum(-1).transpose(1, 2)[..., None]
    ds = p * dp * scale
    del dp
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dod)
    del p
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kd)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qd)
    B, Skv, KV, hd = k.shape
    fold = lambda t: t.reshape(B, Skv, KV, G, hd).sum(3)  # noqa: E731
    return dq, fold(dk), fold(dv)


def test_attention_bwd_bf16_sums_do_not_grow_their_error_at_long_sequences(cuda):
    # dK and dV sum over Sq queries, dQ over Skv keys, straight into the
    # float32 accumulators of the wgmma bodies: qwen3's training shape (16 /
    # 8 heads, 128) at 512, 2048 and 4096 tokens, against the same formula in
    # float64 on the same inputs
    rows = {name: {} for name in ("dq", "dk", "dv")}
    for S in (512, 2048, 4096):
        case = (1, S, S, 16, 8, 128, True, 0, 0)
        q, k, v, out, dout, lse, mask = _bwd_inputs(case, torch.bfloat16, seed=14)
        got = flash_attention_bwd.flash_attention_bwd(q, k, v, out, dout, lse, **mask)
        want32 = ref.flash_attention_bwd_ref(q, k, v, out, dout, lse, **mask)
        want64 = _bwd_oracle64(q, k, v, out, dout, lse, 128 ** -0.5)
        for name, g, w32, w64 in zip(("dq", "dk", "dv"), got, want32, want64):
            _assert_grad_close(g, w32, torch.bfloat16, f"{name} S={S}")
            rows[name][S] = _rms_errors(g, w32, w64)
        del got, want32, want64
        torch.cuda.empty_cache()
    for name, r in rows.items():
        _assert_no_growth(f"flash_attention_bwd {name} causal (1, S, 16/8, 128) S", r)


TRAIN_ZOO_CASES = [  # (B, Sq, Skv, H, KV, hd, causal, window, chunk): phase train_zoo's
    (1, 4096, 4096, 48, 1, 128, True, 0, 0),      # granite: MQA, 48 query heads a KV head
    (2, 4096, 4096, 32, 32, 96, True, 0, 0),      # phi3: hd 96, the mma.sync bodies
    (4, 4096, 4096, 32, 16, 128, True, 1024, 0),  # gemma3: window 1024 at 4096 tokens
    (2, 4096, 1024, 16, 16, 64, False, 0, 0),     # seamless: cross attention
    (2, 4352, 4352, 14, 2, 64, True, 0, 0),       # internvl2: G 7, 256 frames + 4096
]


@pytest.mark.parametrize("case", TRAIN_ZOO_CASES, ids=[str(c) for c in TRAIN_ZOO_CASES])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_flash_attention_and_its_backward_at_the_train_zoo_shapes(cuda, case, dtype):
    q, k, v, out, dout, lse, mask = _bwd_inputs(case, dtype, seed=6)
    _assert_att(out, ref.flash_attention_ref(q, k, v, **mask), dtype)
    tol = LSE_TOL[dtype]
    torch.testing.assert_close(lse, ref.attention_lse_ref(q, k, **mask), atol=tol, rtol=tol)
    got = flash_attention_bwd.flash_attention_bwd(q, k, v, out, dout, lse, **mask)
    want = ref.flash_attention_bwd_ref(q, k, v, out, dout, lse, **mask)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape
        _assert_grad_close(g, w, dtype, f"{name} {case}")


@pytest.mark.parametrize("hd", flash_attention_bwd.HEAD_DIMS)
def test_backward_rows_of_ds_add_to_zero_when_the_keys_nearly_agree(cuda, hd):
    """Keys and values nearly one vector (seamless's 1024 encoder frames at
    random initialisation): the bfloat16 bodies sum D from their own P and
    dP, so a row of dS adds to 0 up to dS's rounding to bfloat16 and the
    keys' gradients add to 0.  dq and dk keep within 0.1 relative L2 of the
    float32 backward: the rounding of dS for its products leaves 0.031-0.034
    here on an H100; D from the stored bfloat16 output (rowsum(dO * O), the
    kernel's earlier D) moves the plain version's dq by 4.7 relative L2 at
    this spread of the keys (tests/test_torch_train_zoo.py)."""
    gen = torch.Generator(device="cuda").manual_seed(9)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    mask = dict(causal=False, window=0, chunk=0)
    q = randn(2, 256, 4, hd).bfloat16()
    k, v = ((randn(2, 1, 2, hd) + 0.05 * randn(2, 192, 2, hd)).bfloat16() for _ in range(2))
    dout = randn(2, 256, 4, hd).bfloat16()
    out, lse = fused_attention.flash_attention_lse(q, k, v, **mask)
    dq, dk, _ = flash_attention_bwd.flash_attention_bwd(q, k, v, out, dout, lse, **mask)
    wide = [t.float() for t in (q, k, v)]
    want = ref.flash_attention_bwd_ref(*wide, ref.flash_attention_ref(*wide, **mask),
                                       dout.float(), lse, **mask)
    for name, g, w in (("dq", dq, want[0]), ("dk", dk, want[1])):
        rel = float((g.float() - w).norm() / w.norm())
        assert rel <= 0.1, f"{name} at head_dim {hd}: relative L2 {rel}"
    key_sum = float(dk.float().sum(1).norm() / dk.float().norm())
    assert key_sum <= 1e-2, key_sum


def test_flash_attention_bwd_is_deterministic(cuda):
    case = (2, 1024, 1024, 16, 8, 128, True, 0, 0)
    q, k, v, out, dout, lse, mask = _bwd_inputs(case, torch.bfloat16, seed=2)
    a = flash_attention_bwd.flash_attention_bwd(q, k, v, out, dout, lse, **mask)
    b = flash_attention_bwd.flash_attention_bwd(q, k, v, out, dout, lse, **mask)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_flash_attention_is_differentiable_on_the_card(cuda, dtype):
    case = (2, 192, 192, 8, 2, 64, True, 0, 0)
    q, k, v, out, dout, lse, mask = _bwd_inputs(case, dtype, seed=3)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    f0 = fused_attention.flash_attention.launches
    b0 = flash_attention_bwd.flash_attention_bwd.launches
    o = fused_attention.flash_attention(*leaves, **mask)
    assert o.grad_fn is not None and torch.equal(o.detach(), out)
    grads = torch.autograd.grad(o, leaves, dout)
    assert fused_attention.flash_attention.launches == f0 + 1
    assert flash_attention_bwd.flash_attention_bwd.launches == b0 + 1
    want = flash_attention_bwd.flash_attention_bwd(q, k, v, out, dout, lse, **mask)
    assert all(torch.equal(g, w) for g, w in zip(grads, want))


def test_kernels_without_a_backward_refuse_autograd_inputs(cuda):
    # K1, K3 and K4 would return outputs with no grad_fn: the weights before
    # them would silently get no gradient
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn((1, 8, 8, 4), generator=gen, device="cuda")
    w = torch.randn((3, 3, 4, 8), generator=gen, device="cuda").requires_grad_(True)
    b = torch.zeros(8, device="cuda")
    with pytest.raises(NotImplementedError, match="fused_conv3x3 has no backward"):
        fused_conv.fused_conv3x3(x, w, b)
    xm = torch.randn((16, 64), generator=gen, device="cuda")
    w1, w3 = (torch.randn((64, 128), generator=gen, device="cuda") for _ in range(2))
    w2 = torch.randn((128, 64), generator=gen, device="cuda").requires_grad_(True)
    with pytest.raises(NotImplementedError, match="fused_mlp has no backward"):
        ops.mlp(xm, w1, w2, w3)
    dA = torch.rand((1, 8, 16, 4), generator=gen, device="cuda").requires_grad_(True)
    dBx = torch.randn((1, 8, 16, 4), generator=gen, device="cuda")
    C = torch.randn((1, 8, 4), generator=gen, device="cuda")
    with pytest.raises(NotImplementedError, match="selective_scan has no backward"):
        ops.ssm_scan(dA, dBx, C)
    with torch.no_grad():  # without grad mode they launch as before
        fused_conv.fused_conv3x3(x, w, b)
        ops.mlp(xm, w1, w2, w3)
        ops.ssm_scan(dA, dBx, C)
    torch.cuda.synchronize()


def test_train_step_on_the_card_matches_the_cpu(cuda):
    # qwen3 at scaled_down, float32, "full" remat: the loss and every
    # gradient through K2 and its backward kernel against the CPU's plain
    # path (1e-3 of each leaf's largest: float32 sums in other orders); a
    # train step launches K2 twice a layer (the forward and its recompute),
    # its backward once
    from torch.utils import _pytree as pytree

    from repro_torch.data import make_batch
    from repro_torch.runtime.steps import batch_to_device, make_train_step

    cfg = scaled_down(resolve("qwen3"))
    rc = dataclasses.replace(run_config(cfg.name, "train_4k"), remat="full",
                             flash_vjp=True, xent_chunk=64)
    params = M.init_params(cfg, generator=torch.Generator().manual_seed(5), device="cpu")
    batch = make_batch(cfg, 4, 128, seed=5)

    def loss_and_grads(device):
        flat, spec = pytree.tree_flatten(params)
        leaves = [p.to(device).requires_grad_(True) for p in flat]
        loss, _ = M.loss_fn(pytree.tree_unflatten(leaves, spec), cfg, rc,
                            batch_to_device(batch, device))
        return float(loss.detach()), [g.cpu() for g in torch.autograd.grad(loss, leaves)]

    l_cpu, g_cpu = loss_and_grads("cpu")
    l_gpu, g_gpu = loss_and_grads("cuda")
    assert l_gpu == pytest.approx(l_cpu, rel=1e-5)
    for a, b in zip(g_gpu, g_cpu):
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())
    opt = {"m": pytree.tree_map(torch.zeros_like, params),
           "v": pytree.tree_map(torch.zeros_like, params),
           "step": torch.zeros((), dtype=torch.int32)}
    to = lambda t: t.to("cuda")  # noqa: E731
    f0 = fused_attention.flash_attention.launches
    b0 = flash_attention_bwd.flash_attention_bwd.launches
    _, _, m = make_train_step(cfg, rc)(pytree.tree_map(to, params),
                                       pytree.tree_map(to, opt), batch)
    assert fused_attention.flash_attention.launches == f0 + 2 * cfg.n_layers
    assert flash_attention_bwd.flash_attention_bwd.launches == b0 + cfg.n_layers
    assert float(m["loss"]) == pytest.approx(l_cpu, rel=1e-5)


def test_the_backward_span_owns_the_backward_on_the_engine_thread(cuda):
    # On CUDA tensors the autograd engine runs the backward on a thread of
    # its own: each microbatch's span repro_torch.train.backward opens and
    # closes there, inside the step's range, and holds launches and every
    # layer's attention backward span, none of which is on the step's thread
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import make_batch
    from repro_torch.runtime import spans
    from repro_torch.runtime.steps import make_init, make_train_step

    cfg = scaled_down(resolve("qwen3"))
    rc = dataclasses.replace(run_config(cfg.name, "train_4k"), microbatches=2, remat="full",
                             flash_vjp=True, xent_chunk=64)
    params, opt = make_init(cfg, rc, device="cuda")(torch.Generator("cuda").manual_seed(5))
    step = make_train_step(cfg, rc)
    batch = make_batch(cfg, 4, 128, seed=5)
    params, opt, _ = step(params, opt, batch)  # builds and loads the kernels
    torch.cuda.synchronize()
    with spans.enabled(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        step(params, opt, batch)
        torch.cuda.synchronize()
    cpu = torch.autograd.DeviceType.CPU
    host = [(e.name(), e.start_ns(), e.end_ns(), e.start_thread_id())
            for e in prof.profiler.kineto_results.events() if e.device_type() == cpu]

    def named(name):
        return [h for h in host if h[0] == name]

    (_, s0, s1, main), = named(spans.TRAIN_STEP)
    backward = named(spans.TRAIN_BACKWARD)
    assert len(backward) == 2 and len(named(spans.TRAIN_FORWARD)) == 2
    for _, b0, b1, tid in backward:
        assert tid != main and s0 <= b0 < b1 <= s1
        inside = [h for h in host if h[3] == tid and b0 <= h[1] and h[2] <= b1]
        assert sum(h[0] == spans.ATTENTION_BACKWARD for h in inside) == cfg.n_layers
        assert any(h[0].startswith("cu") and "Launch" in h[0] for h in inside)
    assert all(h[3] != main for h in named(spans.ATTENTION_BACKWARD))


def test_backward_library_reports_its_build(cuda):
    built = flash_attention_bwd.build()
    report = builder.ptxas_report(built.log)
    names = [n for n in report if "flash_bwd_" in n]
    # 4 head dims x (3 bf16: dK/dV, dQ and its D pass + 2 float32) + the
    # float32 D kernel
    assert len(names) == 4 * 5 + 1
    # bf16 on wgmma at head dims 64 and 128, on mma.sync at 32 and 96, and
    # no mma.sync body left at 64 or 128
    bf16 = {f"flash_bwd_{part}_{body}_kernelILi{hd}E"
            for part in ("dkdv", "dq") for hd in flash_attention_bwd.HEAD_DIMS
            for body in ("wgmma" if hd in flash_attention_bwd.WGMMA_HEAD_DIMS else "mma",)}
    assert {b for b in bf16 if any(b in n for n in names)} == bf16
    assert sum(1 for n in names if "_wgmma_kernel" in n or "_mma_kernel" in n) == \
        3 * len(flash_attention_bwd.HEAD_DIMS)
    for n in names:
        if "_wgmma_kernel" in n:
            assert not report[n].get("spill_stores") and not report[n].get("spill_loads"), n
    if builder.cuobjdump() is not None:
        counts = builder.sass_counts(built.path)
        assert all(c["HMMA"] > 0 for n, c in counts.items() if "_mma_kernel" in n)
        assert all(c["HGMMA"] > 0 and c["HMMA"] == 0
                   for n, c in counts.items() if "_wgmma_kernel" in n)


def test_backward_shared_memory_is_the_wrappers(cuda):
    lib = flash_attention_bwd._library()  # checks the same when it loads
    for dtype, code in flash_attention_bwd._DTYPES.items():
        for hd in flash_attention_bwd.HEAD_DIMS:
            assert lib.flash_attention_bwd_smem(hd, code) == \
                flash_attention_bwd.smem_bytes(hd, dtype)
    assert lib.flash_attention_bwd_smem(48, 1) == -1


def test_device_intervals_match_the_profilers_public_events(cuda):
    """chip_smoke.device_intervals reads the profiler's raw events (not a
    public interface); on a small training step it gives the device
    activities, and their busy time, that the public ``prof.events()``
    gives."""
    import importlib.util
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    case = (2, 256, 256, 8, 2, 64, True, 0, 0)
    q, k, v, _, dout, _, mask = _bwd_inputs(case, torch.bfloat16, seed=4)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        o = fused_attention.flash_attention(*leaves, **mask)
        torch.autograd.grad((o.float() @ o.float().transpose(-1, -2)).sum(), leaves)
        torch.cuda.synchronize()
    raw = smoke.device_intervals(torch, prof)
    public = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(raw) == len(public) > 4
    assert sorted(n for *_, n in raw) == sorted(n for *_, n in public)
    # the two read the same activities, their ends to within a microsecond
    # each (busy 76.75 against 75.913 us over 10 of them on an H100)
    assert abs(smoke.busy_us(raw) - smoke.busy_us(public)) <= len(raw)
