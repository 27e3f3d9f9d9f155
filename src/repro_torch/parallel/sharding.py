"""The device layout of the fleet sweep's hardware axis.

The (G, H, C) sweep's hardware axis is embarrassingly parallel, so
:func:`repro_torch.core.flow.run_fleet` (``devices=``) splits it across
an ordered tuple of devices: each device sweeps its H-shard, and the raw
planes are gathered along H on the host
(:func:`repro_torch.core.metrics.sharded_fleet_kernel`).  Where the JAX
reference builds a 1-D ``Mesh`` and ``shard_map``s the kernel over it,
the layout here is a plain tuple of :class:`torch.device`; the
parameter/activation sharding rules of the training stack wait for the
training slice.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..device import resolve_device

# Name of the hardware-config axis, the first field of a layout's
# fingerprint (the reference's mesh axis name).
HW_AXIS = "hardware"


def hardware_mesh(devices=None) -> tuple[torch.device, ...]:
    """The ordered devices of a hardware-axis split.

    ``devices`` may be ``None`` (every visible CUDA device), an int N
    (``cuda:0`` .. ``cuda:N-1``; more than are visible raises
    ``ValueError``), or an explicit sequence used as given — the same
    device may appear twice (``("cuda:0", "cuda:0")``: two shards on one
    card; ``("cpu", "cpu")`` in the CPU tests).  A CUDA device without
    CUDA raises ``RuntimeError``, as every entry point does.
    """
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < 1:
            raise ValueError("no CUDA device is visible; pass devices=... "
                             "explicitly (e.g. ('cpu',)) to split on the CPU")
        return tuple(torch.device("cuda", i) for i in range(n))
    if isinstance(devices, int):
        if devices < 1:
            raise ValueError(f"need >= 1 device, got {devices}")
        avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if devices > avail:
            raise ValueError(
                f"requested {devices} devices but only {avail} visible"
            )
        return tuple(torch.device("cuda", i) for i in range(devices))
    out = tuple(_checked(d) for d in devices)
    if not out:
        raise ValueError("empty device list")
    return out


def _checked(device) -> torch.device:
    """One layout entry, resolved and checked to exist."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        index = torch.cuda.current_device() if dev.index is None else dev.index
        if index >= n:
            raise ValueError(f"{str(dev)!r} requested but only {n} CUDA "
                             "devices are visible")
        dev = torch.device("cuda", index)
    return dev


def mesh_fingerprint(mesh: Sequence[torch.device]) -> tuple:
    """Hashable identity of a layout: axis name, size, and device names —
    the reference's ``(axis names, size, device ids)`` shape."""
    return (HW_AXIS, len(mesh), tuple(str(d) for d in mesh))
