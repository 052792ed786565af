"""Mesh axis conventions and the segmented executor's query mesh.

Mirrors ``src/repro/distributed/mesh.py``.  The reference's query mesh is a
1-D ``jax.sharding.Mesh`` with one device per shard.  The port's is
``n_shards`` *logical* shards on one torch device: a sharded array is a
tensor with a leading shard dimension ``[n_shards, rows_per_shard]``, and
the collectives of engine/exchange.py become tensor reshuffles on that
device (an all_to_all is a transpose of ``[src, dst, per]`` to ``[dst, src,
per]``, an all_gather a concatenation, a psum a sum over the source
dimension).  Tuple-to-shard ownership, exchanges and per-shard
pre-aggregation keep their meaning, so the plan and its results are the
ones a mesh of that many devices gives.

Axes:
  pod   -- inter-pod data parallelism
  data  -- data parallelism / segmentation (the Vertica 'segmentation'
           axis: tuple -> node)
  model -- tensor/expert parallelism
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

POD, DATA, MODEL = "pod", "data", "model"


@dataclasses.dataclass(frozen=True)
class QueryMesh:
    """``n_shards`` logical shards on ``device``, along one named axis."""
    n_shards: int
    device: torch.device
    axis_names: Tuple[str, ...] = (DATA,)

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_names[0]: self.n_shards}

    def signature(self, axis: str) -> tuple:
        """Stable identity for plan-cache and slab keys: two meshes of the
        same width on the same device run the same programs."""
        return (self.axis_names, (self.n_shards,), str(self.device), axis)


def _device_count(device: torch.device) -> int:
    if device.type == "cuda":
        return torch.cuda.device_count()
    return 1


def make_query_mesh(n_shards: Optional[int] = None, axis: str = DATA,
                    device=None) -> QueryMesh:
    """1-D query mesh for the segmented executor (engine/segmented.py):
    every shard is one 'node' of the Vertica ring, tuples land on shards
    by segmentation hash.  ``device`` defaults to CUDA (asking for it
    without a GPU raises); ``n_shards`` defaults to the count of visible
    devices of that kind -- the reference's ``jax.device_count()`` -- and
    may be any positive width."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"make_query_mesh(device={str(device)!r}): no CUDA device is "
            f"available; pass device='cpu' to run on the CPU")
    n = _device_count(device) if n_shards is None else int(n_shards)
    if n < 1:
        raise ValueError(f"make_query_mesh: n_shards {n} < 1")
    return QueryMesh(n, device, (axis,))


def mesh_axis_size(mesh, name: str) -> int:
    return mesh.shape.get(name, 1)


def dp_size(mesh) -> int:
    """Total data-parallel ways = pod * data."""
    return mesh_axis_size(mesh, POD) * mesh_axis_size(mesh, DATA)


def tp_size(mesh) -> int:
    return mesh_axis_size(mesh, MODEL)
