"""MobileNet-style inverted-residual stack (Sandler et al., 2018) — the
port of the JAX package's ``models/mobilenet.py``.

The depthwise 3x3 convolutions (``groups == channels``) and the
linear-bottleneck skip adds make this the evaluator's beyond-3x3-conv
workload: the frontend traces :func:`forward` into a graph whose depthwise
nodes carry ``LayerSpec.groups`` and whose stride-1 blocks contribute
residual joins (``core.frontend.mobilenet_graph``).  NHWC activations, HWIO
weights and ``SAME`` padding as in :mod:`repro_torch.models.resnet` (the
stride-2 depthwise convs pad ``(0, 1)`` explicitly).

``MOBILENET_PLAN`` rows are ``(c_in, c_out, stride, expand)``; ``expand ==
1`` blocks skip the expansion 1x1, and a block has an identity skip iff
``stride == 1 and c_in == c_out``.
"""
from __future__ import annotations

import torch

from .layers import params_from_jax  # noqa: F401  (the reference tree as tensors)
from .resnet import conv_same, he_init

# (c_in, c_out, stride, expand) — a v2-style truncation: stem 3->32 /2,
# then bottlenecks through two stride-2 stages with stride-1 skips.
MOBILENET_PLAN = (
    (32, 16, 1, 1),
    (16, 24, 2, 4),
    (24, 24, 1, 4),
    (24, 32, 2, 4),
    (32, 32, 1, 4),
)


def relu6(x: torch.Tensor) -> torch.Tensor:
    """min(max(x, 0), 6)."""
    return torch.clamp(x, 0.0, 6.0)


def param_specs(*, plan=MOBILENET_PLAN, dtype=torch.float32) -> dict:
    """The parameter tree as ``device="meta"`` tensors (nothing
    materialised)."""
    def spec(*s):
        return torch.empty(s, dtype=dtype, device="meta")

    blocks = []
    for c_in, c_out, _stride, expand in plan:
        hidden = c_in * expand
        p = {}
        if expand != 1:
            p["we"] = spec(1, 1, c_in, hidden)
            p["be"] = spec(hidden)
        p["wd"] = spec(3, 3, 1, hidden)  # depthwise: one kernel per channel
        p["bd"] = spec(hidden)
        p["wp"] = spec(1, 1, hidden, c_out)
        p["bp"] = spec(c_out)
        blocks.append(p)
    stem_out = plan[0][0]
    return {"stem": {"w": spec(3, 3, 3, stem_out), "b": spec(stem_out)},
            "blocks": blocks}


def init_params(generator: torch.Generator, *, plan=MOBILENET_PLAN,
                dtype=torch.float32) -> dict:
    """He-initialised parameters matching :func:`param_specs` (the
    reference model has no initialiser; this follows its ResNet's)."""
    return he_init(param_specs(plan=plan, dtype=dtype), generator, dtype)


def forward(params: dict, x: torch.Tensor, *, plan=MOBILENET_PLAN) -> torch.Tensor:
    """x: (B, H, W, 3) NHWC -> features (B, H', W', c_out of the last block)."""
    x = relu6(conv_same(x, params["stem"]["w"], 2) + params["stem"]["b"])
    for p, (c_in, c_out, stride, expand) in zip(params["blocks"], plan):
        h = x
        if expand != 1:
            h = relu6(conv_same(h, p["we"], 1) + p["be"])
        hidden = c_in * expand
        h = relu6(conv_same(h, p["wd"], stride, groups=hidden) + p["bd"])
        h = conv_same(h, p["wp"], 1) + p["bp"]  # linear bottleneck
        x = x + h if (stride == 1 and c_in == c_out) else h
    return x
