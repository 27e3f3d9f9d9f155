"""Tests of the port that need an NVIDIA GPU: the fused_conv3x3 CUDA kernel
and the evaluator sweep on the card.

Every test here carries the ``cuda`` marker and skips without CUDA (the
kernel has no CPU mode).  On a machine with a GPU and ``nvcc``, from the
root of a checkout::

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_on_card.py

``--noconftest``: the suite's conftest files import JAX, which the port
does not need and the GPU machine may not have.  This file imports no JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import arch, flow, ir, metrics
from repro_torch.kernels import fused_conv, ops, ref
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
