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
