"""Plain PyTorch versions of the kernels (the ground truth in tests).

On the GPU a float32 convolution goes through cuDNN, which by default
(``torch.backends.cudnn.allow_tf32 = True``) rounds its operands to TF32
and keeps about three decimal digits.  The plain version switches that off
for its own call, so it computes in full float32 like the kernel it is held
against.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def no_tf32():
    """Full-precision float32 convolutions for the duration of the block
    (cuDNN's TF32 switched off, then restored)."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def fused_conv3x3_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                      pool: bool = False) -> torch.Tensor:
    """3x3 SAME conv + bias + ReLU (+ 2x2/2 max-pool), in float32.

    ``x`` is NHWC ``(B, H, W, Cin)``, ``w`` HWIO ``(3, 3, Cin, Cout)``, ``b``
    ``(Cout,)``; the result is NHWC in ``x.dtype``, pooled to
    ``(B, H // 2, W // 2, Cout)`` when ``pool`` (an odd edge row/column is
    dropped, as a VALID 2x2 window does).
    """
    with no_tf32():
        y = F.conv2d(
            x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1),
            padding=1,
        )
    y = torch.relu(y + b.float()[None, :, None, None])
    if pool:
        y = F.max_pool2d(y, 2)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()
