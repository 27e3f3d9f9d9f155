"""Device meshes for the sharded training path.

The port of the JAX package's ``launch/mesh.py``.  A mesh is a
:class:`torch.distributed.device_mesh.DeviceMesh` over the ranks of the
default process group, with named dimensions (``("data", "model")`` or
``("pod", "data", "model")``).  Building one needs that group: under
``torchrun`` it comes from the environment; a single process gets a
one-rank group (:func:`make_mesh`).  The sharding rules
(:mod:`repro_torch.parallel.sharding`) also take a :class:`MeshShape`, the
axis names and sizes alone, so the production meshes' specs can be computed
without 256 or 512 ranks.

Every mesh here is built by a function, never at import, and a CUDA mesh
raises without CUDA: ``device_type="cpu"`` (gloo) is for the CPU tests.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, with no process group behind it."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.sizes)} sizes")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape`` gives it."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def production_mesh_shape(*, multi_pod: bool = False) -> MeshShape:
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")`` for two pods: the reference's production meshes."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with dimension names ``axes`` over the
    default process group's ranks, in rank order (row-major).  The group's
    world size must equal the mesh's size; with no group yet, a mesh of one
    rank makes this process a one-rank group (NCCL for ``"cuda"``, gloo for
    ``"cpu"``) and a larger one raises."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device_type)
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    if not dist.is_initialized():
        if math.prod(shape) != 1:
            raise RuntimeError(
                f"a {shape} mesh needs a process group of {math.prod(shape)} ranks "
                "(run under torchrun, or call torch.distributed.init_process_group)")
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; the process "
                         f"group has {world}")
    if dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The reference's production mesh (:func:`production_mesh_shape`) as a
    ``DeviceMesh``: needs 256 (or 512) ranks."""
    ms = production_mesh_shape(multi_pod=multi_pod)
    return make_mesh(ms.sizes, ms.axis_names, device_type=device_type)


def single_device_mesh(*, device_type: str = "cuda"):
    """A (1, 1) ``("data", "model")`` mesh of this process alone."""
    return make_mesh((1, 1), ("data", "model"), device_type=device_type)
