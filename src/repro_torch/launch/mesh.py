"""Meshes: descriptions, and a mesh over live ranks.

``MeshDesc`` holds the reference's meshes (``repro/launch/mesh.py``) as
shapes and axis names only: the dry-run reads the axis sizes to size
each device's shard, and a description touches no device and no
``torch.distributed``. ``ProcessMesh`` lays a description over the live
process group, one rank a mesh position (row-major, as ``jax.make_mesh``
lays devices), through torch's ``init_device_mesh``: the expert-parallel
branch of ``models/moe.py`` and the tensor-parallel dense path
(``models/partitioning.TensorParallel``) call their collectives over the
groups of its axes (``launch/collectives.py``). ``CountingMesh`` is one
rank's view of a description with no group: on the ``meta`` device the
collectives count what that rank would move and move nothing (the
dry-run's collective term).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple


@dataclass(frozen=True)
class MeshDesc:
    """A mesh of devices: its shape and one name an axis."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> MeshDesc:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MeshDesc(shape, axes)


def make_local_mesh() -> MeshDesc:
    """1x1 mesh over the single local device (tests / examples)."""
    return MeshDesc((1, 1), ("data", "model"))


class ProcessMesh:
    """A ``MeshDesc`` over the live process group: its size must equal
    the world size. ``axis_sizes`` and ``axis_names`` read as the
    description's, so ``ShardingRules.size`` works as it does with one;
    ``coordinate(axis)`` is this rank's index along an axis and
    ``group(axis)`` the process group of the ranks that differ from this
    one only along it."""

    def __init__(self, desc: MeshDesc, device_type: str):
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        if not dist.is_initialized():
            raise RuntimeError("ProcessMesh: no process group; join one "
                               "first (launch/distributed.py)")
        world = dist.get_world_size()
        if desc.size != world:
            raise ValueError(f"ProcessMesh: mesh {desc.shape} holds "
                             f"{desc.size} ranks, the world {world}")
        self.desc = desc
        self.device_mesh = init_device_mesh(
            device_type, desc.shape, mesh_dim_names=desc.axis_names)
        self._coord = dict(zip(desc.axis_names,
                               self.device_mesh.get_coordinate()))

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return self.desc.axis_names

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return self.desc.axis_sizes

    def coordinate(self, axis: str) -> int:
        return self._coord[axis]

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)


class CountingMesh:
    """One rank of a ``MeshDesc``, at ``coords`` (an index an axis), with
    no process group: it reads as a ``ProcessMesh`` (``axis_sizes``,
    ``coordinate``) for the code that places tensors, and its collectives
    run only on ``meta`` tensors, where they count and communicate
    nothing."""

    def __init__(self, desc: MeshDesc, coords: Dict[str, int]):
        if set(coords) != set(desc.axis_names) or any(
                not 0 <= coords[a] < n for a, n in desc.axis_sizes.items()):
            raise ValueError(f"CountingMesh: coordinates {coords} outside "
                             f"the mesh {desc.axis_sizes}")
        self.desc = desc
        self._coord = dict(coords)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return self.desc.axis_names

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return self.desc.axis_sizes

    def coordinate(self, axis: str) -> int:
        return self._coord[axis]

    def group(self, axis: str):
        raise RuntimeError("CountingMesh: no process group; its collectives "
                           "run on meta tensors only (count, no data)")
