"""Production mesh shapes (the reference's assignment-prescribed meshes).

Mirrors ``src/repro/launch/mesh.py``.  The reference builds a
``jax.sharding.Mesh`` of placeholder devices; the port has no SPMD
partitioner, so a mesh here is a plain description, its axis names and
sizes, which the dry-run (launch/dryrun.py) resolves partition specs
against to size each device's share.  No device is touched and no
process group is made.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and the number of devices along each."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"mesh axes {self.axis_names}, sizes "
                             f"{self.sizes}")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def tag(self) -> str:
        return "x".join(map(str, self.sizes))


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """(data=16, model=16) single pod; (pod=2, data=16, model=16) for 512."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_host_mesh(data: int = 1, model: int = 1) -> MeshShape:
    """A small (data, model) mesh, as the reference's for CPU tests."""
    return MeshShape(("data", "model"), (data, model))
