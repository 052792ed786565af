"""Mesh axis conventions and the segmented executor's query mesh.

Mirrors ``src/repro/distributed/mesh.py``.  The reference's query mesh is a
1-D ``jax.sharding.Mesh`` with one device per shard.  The port's holds
``n_shards`` shards on a tuple of *placements*, one torch device each: the
shards are split into contiguous blocks of ``k = n_shards / placements``,
and a sharded array is one ``[k, rows_per_shard]`` tensor per placement, on
that placement's device.  Placements may repeat a device -- the port's
counterpart of the reference's placeholder devices -- and a mesh of one
placement holds every shard in one ``[n_shards, rows]`` tensor.  One
controller process plans, caches and merges over the placements, as the
reference's single jax controller does over its ``Mesh``; the collectives
of engine/exchange.py move blocks between placements with device-to-device
copies.  Tuple-to-shard ownership, exchanges and per-shard pre-aggregation
keep their meaning, so the plan and its results are the ones a mesh of
that many devices gives, whatever the layout.

Axes:
  pod   -- inter-pod data parallelism
  data  -- data parallelism / segmentation (the Vertica 'segmentation'
           axis: tuple -> node)
  model -- tensor/expert parallelism
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

POD, DATA, MODEL = "pod", "data", "model"


@dataclasses.dataclass(frozen=True)
class QueryMesh:
    """``n_shards`` shards along one named axis, split into contiguous
    blocks over ``devices`` (one device per placement)."""
    n_shards: int
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = (DATA,)

    def __post_init__(self):
        if self.n_shards < 1:
            raise ValueError(f"QueryMesh: n_shards {self.n_shards} < 1")
        if not self.devices or self.n_shards % len(self.devices):
            raise ValueError(f"QueryMesh: {self.n_shards} shards are no "
                             f"multiple of {len(self.devices)} placements")

    @property
    def device(self) -> torch.device:
        """The first placement's device: where the controller gathers."""
        return self.devices[0]

    @property
    def shards_per_placement(self) -> int:
        return self.n_shards // len(self.devices)

    def placements(self) -> List[Tuple[int, torch.device]]:
        """(first shard, device) of each placement, in shard order."""
        k = self.shards_per_placement
        return [(p * k, d) for p, d in enumerate(self.devices)]

    def cards(self) -> Tuple[torch.device, ...]:
        """The distinct devices of the placements, in order."""
        return tuple(dict.fromkeys(self.devices))

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_names[0]: self.n_shards}

    def signature(self, axis: str) -> tuple:
        """Stable identity for plan-cache and slab keys: two meshes of the
        same width on the same placements run the same programs."""
        return (self.axis_names, (self.n_shards,),
                tuple(str(d) for d in self.devices), axis)

    def gather(self, blocks: Sequence[torch.Tensor]) -> torch.Tensor:
        """The placements' blocks concatenated along the shard dimension
        on the first placement's device."""
        if len(blocks) == 1:
            return blocks[0]
        return torch.cat([b.to(self.device) for b in blocks])


def _cuda(device: torch.device, what: str) -> torch.device:
    """``device``, a bare "cuda" resolved to the current card's index (a
    tensor's device always carries one, so placements compare equal to
    the devices of the tensors they hold)."""
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"make_query_mesh({what}={str(device)!r}): no CUDA device "
                f"is available; pass device='cpu' to run on the CPU")
        if device.index is None:
            return torch.device("cuda", torch.cuda.current_device())
    return device


def make_query_mesh(n_shards: Optional[int] = None, axis: str = DATA,
                    device=None, devices: Optional[Sequence] = None
                    ) -> QueryMesh:
    """1-D query mesh for the segmented executor (engine/segmented.py):
    every shard is one 'node' of the Vertica ring, tuples land on shards
    by segmentation hash.

    * ``devices``: one placement per entry (``["cpu"] * 4``, ``["cuda:0"]
      * 4``, ``["cuda:0", "cuda:1"]``); ``n_shards`` defaults to their
      count and must be a multiple of it.
    * ``device``: every shard on that one device (one placement);
      ``n_shards`` defaults to 1 on the CPU and to the visible card count
      on CUDA.
    * neither: every visible card, one shard each -- the reference's
      ``jax.devices()`` (asking for it without a GPU raises).  Given
      ``n_shards``, the first cards up to it, as many as divide it."""
    if devices is not None and device is not None:
        raise ValueError("make_query_mesh: pass device or devices, not both")
    if devices is not None:
        devs = tuple(_cuda(torch.device(d), "devices") for d in devices)
        n = len(devs) if n_shards is None else int(n_shards)
    elif device is not None:
        devs = (_cuda(torch.device(device), "device"),)
        n = (torch.cuda.device_count() if devs[0].type == "cuda" else 1) \
            if n_shards is None else int(n_shards)
    else:
        _cuda(torch.device("cuda"), "device")
        cards = torch.cuda.device_count()
        n = cards if n_shards is None else int(n_shards)
        p = max((c for c in range(1, min(n, cards) + 1) if n % c == 0),
                default=1)
        devs = tuple(torch.device("cuda", i) for i in range(p))
    if n < 1:
        raise ValueError(f"make_query_mesh: n_shards {n} < 1")
    return QueryMesh(n, devs, (axis,))


def mesh_axis_size(mesh, name: str) -> int:
    return mesh.shape.get(name, 1)


def dp_size(mesh) -> int:
    """Total data-parallel ways = pod * data."""
    return mesh_axis_size(mesh, POD) * mesh_axis_size(mesh, DATA)


def tp_size(mesh) -> int:
    return mesh_axis_size(mesh, MODEL)
