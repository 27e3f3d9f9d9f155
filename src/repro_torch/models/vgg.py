"""VGG-16 in PyTorch — the paper's own Sec. III workload, forward and
training.

NHWC activations and HWIO conv weights, as in the reference model, so the
fused conv kernel and the tests compare like with like.  The functional
half mirrors the reference: :func:`init_params` draws the parameter tree
(``conv_w``, ``conv_b``, ``fc_w``, ``fc_b``: one tensor a layer),
:func:`forward` runs it, :func:`loss_fn` is the differentiable loss, and
:func:`conv_bn_relu` / :func:`max_pool_2x2` are the plain layer ops.  Each
conv layer is one fusion group -- conv3x3 + bias + ReLU (+ 2x2 max-pool) --
run either through a ``fused_conv_fn`` (the Hopper kernel,
:func:`repro_torch.kernels.ops.fused_conv_fn`, forward only) or, by
default, through those plain ops, which autograd differentiates.  The
classifier stays plain ``x @ w + b`` matrix products (float32 matmuls on
the GPU run in full float32: ``torch.backends.cuda.matmul.allow_tf32`` is
False by default).

Float32 convolutions on the GPU go through cuDNN, which rounds to TF32
unless ``torch.backends.cudnn.allow_tf32`` is False.  :func:`conv_bn_relu`
switches it off for its forward; autograd runs the backward convolutions
later, under whatever the flag says then, so a float32 training step runs
its forward and backward inside :func:`repro_torch.kernels.ref.no_tf32`.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.ir import VGG16_CONV_PLAN
from ..device import resolve_device
from ..kernels.ref import no_tf32


def _fc_dims(in_hw: int, n_classes: int) -> tuple:
    """(in, out) of the three classifier layers; ``in_hw // 32`` is the
    spatial size after the five pools."""
    s = in_hw // 32
    return ((512 * s * s, 4096), (4096, 4096), (4096, n_classes))


def init_params(generator: torch.Generator, *, in_hw: int = 224,
                n_classes: int = 1000, dtype: torch.dtype = torch.float32) -> dict:
    """The parameter tree :func:`forward` takes, drawn from ``generator``
    on its device: He-normal conv weights ``N(0, 2 / (9 n_in))``, zero
    biases and ``N(0, 0.01^2)`` classifier weights -- the reference's
    scheme, not its random stream.  The leaves are plain tensors (drawn in
    float32, then cast to ``dtype``) that a caller may ``requires_grad_()``.
    """
    dev = generator.device

    def normal(*shape, std):
        t = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
        return (t * std).to(dtype)

    def zeros(n):
        return torch.zeros(n, device=dev, dtype=dtype)

    fc = _fc_dims(in_hw, n_classes)
    return {
        "conv_w": [normal(3, 3, n_in, n_out, std=(2.0 / (9 * n_in)) ** 0.5)
                   for _name, n_in, n_out, _hw, _pooled in VGG16_CONV_PLAN],
        "conv_b": [zeros(n_out) for _name, _n_in, n_out, _hw, _pooled in VGG16_CONV_PLAN],
        "fc_w": [normal(i, o, std=0.01) for i, o in fc],
        "fc_b": [zeros(o) for _i, o in fc],
    }


class VGG16(nn.Module):
    """VGG-16 with ``in_hw x in_hw x 3`` NHWC input and ``n_classes``
    logits, its parameters those of :func:`init_params` (``generator``'s
    draws) held as frozen ``nn.Parameter``s: the module runs inference.
    Training goes through the functional tree (:func:`init_params`,
    :func:`loss_fn`).

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
        tree = init_params(generator, in_hw=in_hw, n_classes=n_classes, dtype=dtype)
        for key, leaves in tree.items():
            setattr(self, key, nn.ParameterList(
                nn.Parameter(t, requires_grad=False) for t in leaves))

    def forward(self, x: torch.Tensor, fused_conv_fn=None) -> torch.Tensor:
        """``x``: (B, H, W, 3) NHWC -> logits (B, n_classes); see
        :func:`forward`."""
        params = {"conv_w": self.conv_w, "conv_b": self.conv_b,
                  "fc_w": self.fc_w, "fc_b": self.fc_b}
        return forward(params, x, fused_conv_fn=fused_conv_fn)


def param_specs(*, in_hw: int = 224, n_classes: int = 1000,
                dtype: torch.dtype = torch.float32) -> dict:
    """:func:`init_params`' tree as ``device="meta"`` tensors -- lets the
    tracing frontend trace VGG-16 without materialising its ~138M
    parameters."""
    def spec(*s):
        return torch.empty(s, dtype=dtype, device="meta")

    fc = _fc_dims(in_hw, n_classes)
    return {
        "conv_w": [spec(3, 3, n_in, n_out) for _, n_in, n_out, _, _ in VGG16_CONV_PLAN],
        "conv_b": [spec(n_out) for _, _, n_out, _, _ in VGG16_CONV_PLAN],
        "fc_w": [spec(i, o) for i, o in fc],
        "fc_b": [spec(o) for _, o in fc],
    }


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 VALID max-pool of NHWC ``x`` (an odd edge row or column is
    dropped)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def conv_bn_relu(x: torch.Tensor, p: dict) -> torch.Tensor:
    """3x3 SAME conv of NHWC ``x`` with HWIO ``p["w"]``, + ``p["b"]``, ReLU;
    in ``x``'s dtype, as the reference's XLA ops (cuDNN's TF32 off for the
    forward: see the module docstring for the backward)."""
    with no_tf32():
        y = F.conv2d(x.permute(0, 3, 1, 2), p["w"].permute(3, 2, 0, 1), padding=1)
    return torch.relu(y.permute(0, 2, 3, 1) + p["b"])


def forward(params: dict, x: torch.Tensor, fused_conv_fn=None) -> torch.Tensor:
    """``x``: (B, H, W, 3) NHWC -> logits (B, n_classes) under ``params``
    (``conv_w``, ``conv_b``, ``fc_w``, ``fc_b``: one entry per layer).

    ``fused_conv_fn(x, w, b, pool=...)`` runs each conv + ReLU (+ pool)
    fusion group; ``None`` takes :func:`conv_bn_relu` and
    :func:`max_pool_2x2`, as the reference.
    """
    for i, (_name, _n_in, _n_out, _hw, pooled) in enumerate(VGG16_CONV_PLAN):
        w, b = params["conv_w"][i], params["conv_b"][i]
        if fused_conv_fn is not None:
            x = fused_conv_fn(x, w, b, pool=pooled)
        else:
            x = conv_bn_relu(x, {"w": w, "b": b})
            if pooled:
                x = max_pool_2x2(x)
    x = x.reshape(x.shape[0], -1)  # NHWC flatten, as the reference
    for i, (w, b) in enumerate(zip(params["fc_w"], params["fc_b"])):
        x = x @ w + b
        if i < 2:
            x = torch.relu(x)
    return x


def loss_fn(params: dict, batch: dict, *, fused_conv_fn=None) -> torch.Tensor:
    """Mean negative log-likelihood of ``batch["labels"]`` (B,) under the
    float32 ``log_softmax`` of the logits of ``batch["images"]`` -- the
    reference's loss, differentiable by autograd and by
    ``torch.func.grad_and_value``.  A kernel ``fused_conv_fn`` on CUDA
    tensors that require grad raises (the kernel has no backward)."""
    logits = forward(params, batch["images"], fused_conv_fn=fused_conv_fn)
    logp = torch.log_softmax(logits.float(), dim=-1)
    gold = torch.gather(logp, -1, batch["labels"][:, None])
    return -gold.mean()


def params_from_jax(tree: dict, *, as_tree: bool = False) -> dict[str, torch.Tensor]:
    """The reference model's parameter pytree (``{"convs": [{"w", "b"}],
    "fcs": [{"w", "b"}]}`` of numpy arrays) as copied tensors: the tree
    :func:`forward` takes when ``as_tree``, else a :class:`VGG16` state
    dict for ``model.load_state_dict``.  Layouts already agree (HWIO convs,
    ``(in, out)`` classifier weights), so values are copied as they are."""
    out = {}
    for group, (w_key, b_key) in (("convs", ("conv_w", "conv_b")),
                                  ("fcs", ("fc_w", "fc_b"))):
        out[w_key] = [torch.from_numpy(np.array(p["w"])) for p in tree[group]]
        out[b_key] = [torch.from_numpy(np.array(p["b"])) for p in tree[group]]
    if as_tree:
        return out
    return {f"{key}.{i}": t for key, leaves in out.items() for i, t in enumerate(leaves)}
