"""Device selection shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    """``device`` as a :class:`torch.device`, checked to exist.

    Entry points default to ``"cuda"``: asking for a GPU on a host without
    CUDA raises rather than falling back to the CPU, so a CPU run can never
    be mistaken for a GPU run.  Pass ``device="cpu"`` to run on the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev


def refuse_autograd(kernel: str, *tensors) -> None:
    """Raise ``NotImplementedError`` when grad mode is on and one of
    ``tensors`` (``None`` skipped) requires grad: ``kernel`` has no backward
    kernel, and its launch would return an output with no gradient, so the
    weights before it would silently get none.  Compute under
    ``torch.no_grad()``, or train through the model's own torch ops
    (``ops.train_kernels``)."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise NotImplementedError(
            f"{kernel} has no backward kernel: it does not launch on tensors "
            "that require grad (train through ops.train_kernels, or run under "
            "torch.no_grad())")
