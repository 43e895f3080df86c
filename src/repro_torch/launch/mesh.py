"""Production mesh descriptions.

The reference's meshes (``repro/launch/mesh.py``) as shapes and axis
names only: the dry-run reads the axis sizes to size each device's
shard, and nothing here touches a device or ``torch.distributed``. A
device mesh over real ranks comes with the first collective that needs
one.
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
