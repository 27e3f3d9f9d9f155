"""VGG-16 in PyTorch — the paper's own Sec. III workload, inference only.

NHWC activations and HWIO conv weights, as in the reference model, so the
fused conv kernel and the tests compare like with like.  Each conv layer is
one fusion group — conv3x3 + bias + ReLU (+ 2x2 max-pool) — run through a
``fused_conv_fn`` (the Hopper kernel, :func:`repro_torch.kernels.ops.fused_conv_fn`)
or, by default, through the group's plain PyTorch version.  The classifier
stays plain ``x @ w + b`` matrix products (float32 matmuls on the GPU run
in full float32: ``torch.backends.cuda.matmul.allow_tf32`` is False by
default).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.ir import VGG16_CONV_PLAN
from ..device import resolve_device
from ..kernels import ref


class VGG16(nn.Module):
    """VGG-16 with ``in_hw x in_hw x 3`` NHWC input and ``n_classes``
    logits, weights drawn from ``generator`` (He-normal convs, zero biases,
    N(0, 0.01^2) classifier) — the reference model's initialisation scheme,
    not its random stream.  Parameters do not require gradients: this model
    runs inference only.

    ``device`` defaults to ``"cuda"`` and raises without CUDA; pass
    ``device="cpu"`` to build it on the CPU.  ``generator`` must live on
    that device; ``None`` seeds a fresh one with 0.
    """

    def __init__(self, *, in_hw: int = 224, n_classes: int = 1000,
                 dtype: torch.dtype = torch.float32,
                 device: "str | torch.device" = "cuda",
                 generator: torch.Generator | None = None):
        """Draw every parameter on ``device`` from ``generator``."""
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)

        def normal(*shape, std):
            t = torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32) * std
            return nn.Parameter(t.to(dtype), requires_grad=False)

        def zeros(n):
            return nn.Parameter(torch.zeros(n, device=dev, dtype=dtype),
                                requires_grad=False)

        self.conv_w = nn.ParameterList()
        self.conv_b = nn.ParameterList()
        for _name, n_in, n_out, _hw, _pooled in VGG16_CONV_PLAN:
            self.conv_w.append(normal(3, 3, n_in, n_out, std=(2.0 / (9 * n_in)) ** 0.5))
            self.conv_b.append(zeros(n_out))
        s = in_hw // 32  # spatial size after the five pools
        fc_dims = ((512 * s * s, 4096), (4096, 4096), (4096, n_classes))
        self.fc_w = nn.ParameterList(normal(i, o, std=0.01) for i, o in fc_dims)
        self.fc_b = nn.ParameterList(zeros(o) for _i, o in fc_dims)

    def forward(self, x: torch.Tensor, fused_conv_fn=None) -> torch.Tensor:
        """``x``: (B, H, W, 3) NHWC -> logits (B, n_classes).

        ``fused_conv_fn(x, w, b, pool=...)`` runs each conv + ReLU (+ pool)
        fusion group; ``None`` takes the group's plain PyTorch version.
        """
        conv = fused_conv_fn if fused_conv_fn is not None else ref.fused_conv3x3_ref
        for i, (_name, _n_in, _n_out, _hw, pooled) in enumerate(VGG16_CONV_PLAN):
            x = conv(x, self.conv_w[i], self.conv_b[i], pool=pooled)
        x = x.reshape(x.shape[0], -1)  # NHWC flatten, as the reference
        for i, (w, b) in enumerate(zip(self.fc_w, self.fc_b)):
            x = x @ w + b
            if i < 2:
                x = torch.relu(x)
        return x


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """The reference model's parameter pytree (``{"convs": [{"w", "b"}],
    "fcs": [{"w", "b"}]}`` of numpy arrays) as a :class:`VGG16` state dict,
    for ``model.load_state_dict``.  Layouts already agree (HWIO convs,
    ``(in, out)`` classifier weights), so values are copied as they are."""
    state = {}
    for group, (w_key, b_key) in (("convs", ("conv_w", "conv_b")),
                                  ("fcs", ("fc_w", "fc_b"))):
        for i, p in enumerate(tree[group]):
            state[f"{w_key}.{i}"] = torch.from_numpy(np.array(p["w"]))
            state[f"{b_key}.{i}"] = torch.from_numpy(np.array(p["b"]))
    return state
