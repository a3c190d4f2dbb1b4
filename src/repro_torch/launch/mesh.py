"""Meshes (port of repro/launch/mesh.py).

Single pod: 256 cards as (data=16, model=16).  Multi-pod: 2 x 256 as
(pod=2, data=16, model=16).

`MeshShape` is a mesh's axis names and sizes without devices: the plans
(`parallel/sharding.py`) and the placements (`parallel/fsdp.py`) read only
that, so they run in tests without a process group.  `make_local_mesh`
and `make_production_mesh` build a `torch.distributed` `DeviceMesh` over
the running process group.  No interconnect constant lives here: the
reference's `HBM_BW`, `ICI_BW` and `PEAK_FLOPS_BF16` are a TPU's; the
H100's peaks are in `core/hw.py`, which has no link bandwidth yet (ROADMAP
A.4c).

`backend_for(device)` is the process group's backend: NCCL for a CUDA
device, gloo for the CPU, and nothing else.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.distributed as dist

__all__ = ["MeshShape", "backend_for", "make_local_mesh", "make_production_mesh",
           "production_mesh_shape", "world"]

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """Axis names in order, with their sizes; ranks lie on the mesh in
    row-major order (rank = the coordinates' row-major index)."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{self.axis_names} against sizes {self.sizes}")

    @property
    def shape(self) -> Dict[str, int]:
        """{axis name: size}, as the reference's `Mesh.shape`."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def coordinate(self, rank: int) -> Dict[str, int]:
        """{axis name: index} of `rank`."""
        out = {}
        for name, n in reversed(list(zip(self.axis_names, self.sizes))):
            rank, out[name] = divmod(rank, n)
        return out

    @classmethod
    def of(cls, mesh) -> "MeshShape":
        """The shape of a `MeshShape` (itself) or of a `DeviceMesh`."""
        if isinstance(mesh, MeshShape):
            return mesh
        return cls(tuple(mesh.mesh_dim_names), tuple(mesh.mesh.shape))


def backend_for(device) -> str:
    """The process group's backend for `device`'s type."""
    kind = torch.device(device).type
    if kind not in _BACKENDS:
        raise ValueError(f"no process-group backend for device type {kind!r} "
                         f"(known: {_BACKENDS})")
    return _BACKENDS[kind]


def world() -> Tuple[int, int]:
    """(rank, world size) of the running process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def production_mesh_shape(multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def _device_mesh(shape: MeshShape, device_type: str):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device_type, torch.arange(shape.size).reshape(shape.sizes),
                      mesh_dim_names=shape.axis_names)


def make_production_mesh(multi_pod: bool = False, device_type: str = "cuda"):
    shape = production_mesh_shape(multi_pod)
    _, n = world()
    if n != shape.size:
        raise ValueError(f"the production mesh {shape.shape} needs a world of {shape.size} "
                         f"ranks, the running one has {n}")
    return _device_mesh(shape, device_type)


def make_local_mesh(model_axis: int = 1, device_type: str = "cuda"):
    """(world // model_axis, model_axis) as ("data", "model"): a
    `DeviceMesh` over the running process group, or without one (world
    size 1) the `MeshShape` alone."""
    _, n = world()
    if model_axis < 1 or n % model_axis:
        raise ValueError(f"--model-parallel {model_axis} does not divide the world of {n}")
    shape = MeshShape(("data", "model"), (n // model_axis, model_axis))
    if not dist.is_initialized():
        return shape
    return _device_mesh(shape, device_type)
