"""ResNet-18 in PyTorch (He et al., 2016) — the port of the JAX package's
``models/resnet.py``, the residual workload the tracing frontend turns into
a :class:`repro_torch.core.ir.GraphIR` (``core.frontend.resnet18_graph``).

NHWC activations and HWIO conv weights, as in the reference model.  Its
convolutions and its 3x3/2 max-pool use ``SAME`` padding, which pads
``(0, 1)`` (3x3) or ``(2, 3)`` (7x7) where the stride is 2 and the input
even: more after than before.  PyTorch's ``padding=`` is symmetric, so an
asymmetric pad is applied explicitly with ``F.pad`` (``-inf`` for the
pool) and the convolution then runs with none; the tracer looks through
that pad.  Float32 convolutions run with cuDNN's TF32 off
(:func:`repro_torch.kernels.ref.no_tf32`), in full float32 as the reference.

The block body keeps the reference's order (conv_a -> conv_b -> downsample
-> add), so the traced node order matches the hand-built ``resnet18_ir``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree

from ..core.ir import RESNET18_STAGE_PLAN
from ..kernels.ref import no_tf32
from .layers import params_from_jax  # noqa: F401  (the reference tree as tensors)


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """(before, after) padding of XLA's ``SAME`` for one spatial axis:
    ``ceil(size / stride)`` outputs, the odd pixel of padding after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, w: torch.Tensor, stride: int, *,
              groups: int = 1) -> torch.Tensor:
    """``SAME`` convolution of NHWC ``x`` with HWIO ``w`` -> NHWC."""
    kh, kw = w.shape[0], w.shape[1]
    ph = same_pads(x.shape[1], kh, stride)
    pw = same_pads(x.shape[2], kw, stride)
    xc = x.permute(0, 3, 1, 2)
    padding = (ph[0], pw[0])
    if ph[0] != ph[1] or pw[0] != pw[1]:
        xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]))
        padding = (0, 0)
    with no_tf32():
        y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride, padding=padding,
                     groups=groups)
    return y.permute(0, 2, 3, 1)


def max_pool_same(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """``SAME`` k x k max-pool of NHWC ``x`` (padding reads as ``-inf``)."""
    ph = same_pads(x.shape[1], k, stride)
    pw = same_pads(x.shape[2], k, stride)
    xc = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]),
               value=-math.inf)
    return F.max_pool2d(xc, k, stride).permute(0, 2, 3, 1)


def _block_channels() -> list[tuple[int, int, int]]:
    """(c_in, c_out, stride) per basic block, following the stage plan."""
    out = []
    c_in = 64
    for _stage, n_blocks, c_out, stride0 in RESNET18_STAGE_PLAN:
        for b in range(n_blocks):
            out.append((c_in if b == 0 else c_out, c_out, stride0 if b == 0 else 1))
        c_in = c_out
    return out


def param_specs(*, n_classes: int = 1000, dtype=torch.float32) -> dict:
    """The parameter tree as ``device="meta"`` tensors (nothing
    materialised).  Weight shapes do not depend on the input size."""
    def spec(*s):
        return torch.empty(s, dtype=dtype, device="meta")

    blocks = []
    for c_in, c_out, stride in _block_channels():
        p = {"wa": spec(3, 3, c_in, c_out), "ba": spec(c_out),
             "wb": spec(3, 3, c_out, c_out), "bb": spec(c_out)}
        if stride != 1 or c_in != c_out:
            p["wd"] = spec(1, 1, c_in, c_out)
        blocks.append(p)
    return {"conv1": {"w": spec(7, 7, 3, 64), "b": spec(64)},
            "blocks": blocks,
            "fc": {"w": spec(512, n_classes), "b": spec(n_classes)}}


def he_init(specs, generator: torch.Generator, dtype) -> dict:
    """He-normal weights (every leaf of rank >= 2, fan-in the product of
    all but its last axis) and zero biases, drawn from ``generator`` on its
    device: the reference's scheme, not its random stream."""
    dev = generator.device

    def init(leaf):
        if leaf.dim() >= 2:
            fan_in = math.prod(leaf.shape[:-1])
            w = torch.randn(leaf.shape, generator=generator, device=dev,
                            dtype=torch.float32)
            return (w * (2.0 / fan_in) ** 0.5).to(dtype)
        return torch.zeros(leaf.shape, dtype=dtype, device=dev)

    return pytree.tree_map(init, specs)


def init_params(generator: torch.Generator, *, n_classes: int = 1000,
                dtype=torch.float32) -> dict:
    """He-initialised parameters matching :func:`param_specs`."""
    return he_init(param_specs(n_classes=n_classes, dtype=dtype), generator, dtype)


def forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, 3) NHWC -> logits (B, n_classes)."""
    x = torch.relu(conv_same(x, params["conv1"]["w"], 2) + params["conv1"]["b"])
    x = max_pool_same(x, 3, 2)
    for p, (_c_in, _c_out, stride) in zip(params["blocks"], _block_channels()):
        y = torch.relu(conv_same(x, p["wa"], stride) + p["ba"])
        y = conv_same(y, p["wb"], 1) + p["bb"]
        s = conv_same(x, p["wd"], stride) if "wd" in p else x
        x = torch.relu(y + s)
    x = x.mean(dim=(1, 2))  # global average pool over the NHWC frame
    return x @ params["fc"]["w"] + params["fc"]["b"]
