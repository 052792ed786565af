"""Inter-node segmentation (paper §3.6) + local segments for elasticity.

A projection is either *replicated* (every node stores every tuple) or
*segmented* by an integral expression: the ring [0, C_MAX) is cut into N
contiguous node ranges, and within each node into ``n_local_segments``
sub-ranges. Elastic rebalance moves whole local segments between nodes
without re-splitting files -- exactly the paper's wholesale-transfer trick
(and the same mechanism our training stack reuses to re-shard data-parallel
ranks; see train/fault_tolerance.py).

Mirrors ``src/repro/core/segmentation.py``: a verbatim copy of the numpy
half; the device twins of ``hash_columns``/``shard_of`` are torch functions
(``hash_columns_torch``/``shard_of_torch``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .types import C_MAX

_FNV_PRIME = np.uint64(1099511628211)
_FNV_OFFSET = np.uint64(14695981039346656037)


def hash_columns(*cols: np.ndarray) -> np.ndarray:
    """Deterministic 32-bit ring hash of one or more integral columns
    (vectorized FNV-1a over 8-byte words)."""
    h = np.full(cols[0].shape, _FNV_OFFSET, dtype=np.uint64)
    with np.errstate(over="ignore"):
        for c in cols:
            v = np.asarray(c).astype(np.int64).view(np.uint64)
            for shift in (0, 16, 32, 48):
                h = h ^ ((v >> np.uint64(shift)) & np.uint64(0xFFFF))
                h = h * _FNV_PRIME
    return (h % C_MAX).astype(np.uint64)


def shard_of(ring: np.ndarray, n_shards: int) -> np.ndarray:
    """Offset-free ring-range assignment: the base map from a ring value to
    one of ``n_shards`` contiguous ranges.  The segmented executor
    (engine/segmented.py) uses this for *device* shard placement -- the
    same row must land on the same shard no matter which physical store
    (primary or ring-offset buddy) served it, so the buddy offset applies
    only to node routing, never here."""
    return (np.asarray(ring).astype(np.float64) * n_shards
            / float(C_MAX)).astype(np.int64).astype(np.int32)


# --------------------------------------------------------------------------
# Device twins of hash_columns / shard_of (torch)
# --------------------------------------------------------------------------
# The segmented executor builds its ROS slabs ON the device, so ring values
# and shard assignments are computed there -- bit for bit equal to the
# numpy originals above, because the host still places build sides and WOS
# batches with them and a co-located join relies on both agreeing.
#
# PyTorch has no full uint32 arithmetic, so the FNV state lives in int64
# lanes masked to 32 bits.  The ring value is ``hash % 2^32``, the low word
# of the 64-bit state, and the low word of ``(h ^ w) * prime`` depends only
# on the low words of ``h ^ w`` and of the prime (0x1B3): the high word the
# reference's jax twin carries beside it never reaches the result, so it is
# not computed here.  ``lo * 0x1B3`` stays below 2^41, so no int64 product
# wraps.

_P_LO = 0x1B3          # low 32 bits of the FNV prime
_FNV_OFFSET_LO = 0x84222325
_M32 = 0xFFFFFFFF


def hash_columns_torch(*cols):
    """Device twin of :func:`hash_columns`: int/uint/bool columns (any
    width up to 64 bits) -> int64 ring values in [0, 2^32), equal to
    ``hash_columns(...)``.  Signed values hash as their sign-extended
    int64 words, as ``astype(np.int64)`` makes them."""
    import torch
    h = torch.full(cols[0].shape, _FNV_OFFSET_LO, dtype=torch.int64,
                   device=cols[0].device)
    for c in cols:
        v = c.to(torch.int64)
        for shift in (0, 16, 32, 48):
            h = ((h ^ ((v >> shift) & 0xFFFF)) * _P_LO) & _M32
    return h


def shard_of_torch(ring, n_shards: int):
    """Device twin of :func:`shard_of`: floor(ring * n / 2^32) as int32.
    ``ring < 2^32`` and ``n < 2^31`` keep the int64 product exact."""
    import torch
    return ((ring.to(torch.int64) * int(n_shards)) >> 32).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class SegmentationSpec:
    """SEGMENTED BY HASH(cols) ALL NODES / UNSEGMENTED (replicated)."""

    kind: str = "hash"                   # hash | replicated
    columns: Tuple[str, ...] = ()
    n_local_segments: int = 3            # per node, for elastic rebalance
    offset: int = 0                      # buddy projections: ring offset

    @property
    def replicated(self) -> bool:
        return self.kind == "replicated"

    def ring_values(self, data: Dict[str, np.ndarray]) -> np.ndarray:
        cols = [data[c] for c in self.columns]
        return hash_columns(*cols)

    def node_of(self, ring: np.ndarray, n_nodes: int) -> np.ndarray:
        """Ring range assignment with buddy offset (paper §5.2: a buddy
        projection's segmentation guarantees no row lands on the same node)."""
        base = shard_of(ring, n_nodes).astype(np.int64)
        return ((base + self.offset) % n_nodes).astype(np.int32)

    def local_segment_of(self, ring: np.ndarray, n_nodes: int) -> np.ndarray:
        """Sub-range within the node's slice."""
        width = float(C_MAX) / n_nodes
        within = ring.astype(np.float64) % width
        seg = (within * self.n_local_segments / width).astype(np.int64)
        return np.clip(seg, 0, self.n_local_segments - 1).astype(np.int32)

    def place(self, data: Dict[str, np.ndarray],
              n_nodes: int) -> Tuple[np.ndarray, np.ndarray]:
        """(node, local_segment) per row; replicated raises (caller fans
        out to every node instead)."""
        nodes, segs, _ = self.place_with_ring(data, n_nodes)
        return nodes, segs

    def place_with_ring(self, data: Dict[str, np.ndarray], n_nodes: int
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(node, local_segment, ring) per row.  The ring value is the
        mesh-independent ownership coordinate: stores stamp it onto WOS
        batches at commit so the segmented executor can re-derive *device*
        shard ownership (shard_of) for any mesh width without re-hashing
        the segmentation columns."""
        assert not self.replicated
        ring = self.ring_values(data)
        return (self.node_of(ring, n_nodes),
                self.local_segment_of(ring, n_nodes), ring)


def rebalance_plan(n_old: int, n_new: int,
                   n_local: int) -> List[Tuple[int, int, int]]:
    """Moves of whole local segments when the cluster resizes.

    Returns [(old_node, local_segment, new_node), ...]: every (node, seg)
    slot of the old topology whose ring range now belongs to a different
    node. Only whole-segment moves -- no file splitting (paper §3.6)."""
    moves = []
    for node in range(n_old):
        for seg in range(n_local):
            # representative ring point at the center of this sub-range
            width = float(C_MAX) / n_old
            point = node * width + (seg + 0.5) * width / n_local
            new_node = int(point * n_new / float(C_MAX))
            new_node = min(new_node, n_new - 1)
            if new_node != node:
                moves.append((node, seg, new_node))
    return moves
