"""Mesh construction.

Production: (data=16, model=16) on one pod, (pod=2, data=16, model=16)
across two; the ``pod`` axis is the slow inter-pod link, DALEK's 2.5 GbE
analogue: only data-parallel gradient reductions cross it. The
production mesh is *abstract*: its axis names and sizes, which is all the
sharding specs read; it touches no device and no process group.

A ``RankMesh`` is one rank's view of a mesh with no process group: the
axes' sizes, rank 0's coordinates and a stand-in group per axis
(``parallel.comm.ShapeGroup``). The dry-run runs a rank's step on it: the
model treats its tensors as the rank's blocks, as on a DeviceMesh, and
each collective is shape-only.

The host mesh is a ``torch.distributed`` DeviceMesh over the running
process group's ranks, axes ("pod", "data", "model") in that order (a dim
split over ("pod", "data") is then split major to minor, as JAX does).

Functions, not module-level constants: importing this module touches no
device and no process group.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, without devices."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


class RankMesh:
    """Rank 0 of a mesh (an ``AbstractMesh``, a dict of sizes or anything
    with ``shape``) with stand-in collectives. Every rank's blocks have
    one shape, so rank 0's step is every rank's to count. ``world`` is
    the stand-in group of every rank."""

    def __init__(self, mesh):
        from repro_torch.parallel.sharding import mesh_shape
        self.sizes = mesh_shape(mesh)
        self.mesh_dim_names = tuple(self.sizes)
        self.shape = tuple(self.sizes.values())
        self.coords = {a: 0 for a in self.sizes}
        self.world = self.get_group()

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def get_coordinate(self):
        return [self.coords[a] for a in self.mesh_dim_names]

    def get_local_rank(self, axis: str) -> int:
        return self.coords[axis]

    def get_group(self, axis=None):
        """The stand-in group along ``axis`` (a name or a tuple of names;
        every axis for None)."""
        from repro_torch.parallel.comm import ShapeGroup
        axes = self.mesh_dim_names if axis is None else (
            (axis,) if isinstance(axis, str) else tuple(axis))
        return ShapeGroup(self.sizes, axes)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(axes, shape)


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 1,
                   device_type: Optional[str] = None):
    """A DeviceMesh ("pod", "data", "model") over the running process
    group, whose world size must be ``pod * data * model``.
    ``device_type`` None takes the group's: ``cuda`` under NCCL, else
    ``cpu``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError(
            "make_host_mesh: no process group (torchrun sets one up; "
            "otherwise call torch.distributed.init_process_group first)")
    world = dist.get_world_size()
    if pod * data * model != world:
        raise ValueError(f"mesh pod {pod} x data {data} x model {model} = "
                         f"{pod * data * model} ranks, the process group "
                         f"has {world}")
    if device_type is None:
        device_type = "cuda" if "nccl" in dist.get_backend() else "cpu"
    return init_device_mesh(device_type, (pod, data, model),
                            mesh_dim_names=("pod", "data", "model"))
