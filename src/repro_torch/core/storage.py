"""ROS containers, WOS, delete vectors (paper §3.7).

A ROS container is immutable: per-column encoded data + a position index
(ColumnSMA min/max/count per block -- the paper's ~1/1000-size index; no
B-tree, containers never change). Positions are implicit ordinals. Every
row carries its commit epoch (the paper's implicit 64-bit epoch column).

Deletes never modify containers: a DeleteVector lists deleted positions with
their delete epochs; DVWOS (in-memory) -> DVROS (encoded, delta on sorted
positions) via the tuple mover.

Mirrors ``src/repro/core/storage.py``: a verbatim copy, so the port imports
nothing of the reference package.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np

from .encodings import EncodedColumn, Encoding, encode
from .projection import ProjectionDef
from .sma import ColumnSMA
from .types import BLOCK_ROWS, SQLType, TableSchema

_next_container_id = itertools.count(1)


@dataclasses.dataclass
class ROSContainer:
    """Immutable sorted run of tuples for one projection segment."""

    id: int
    projection: str
    columns: Dict[str, EncodedColumn]
    smas: Dict[str, ColumnSMA]
    epochs: np.ndarray                  # (n_rows,) commit epoch per row
    n_rows: int
    partition_key: Optional[int] = None
    local_segment: int = 0
    _max_epoch: Optional[int] = None     # lazy cache, see max_epoch()

    @staticmethod
    def build(proj: ProjectionDef, data: Dict[str, np.ndarray],
              epochs: np.ndarray, *, sql_types: Dict[str, SQLType],
              partition_key: Optional[int] = None, local_segment: int = 0,
              presorted: bool = False,
              block_rows: int = BLOCK_ROWS) -> "ROSContainer":
        """Sort by the projection's sort order and encode every column."""
        n = len(epochs)
        if n and not presorted and proj.sort_order:
            order = np.lexsort(tuple(data[c] for c in
                                     reversed(proj.sort_order)))
            data = {c: v[order] for c, v in data.items()}
            epochs = epochs[order]
        cols, smas = {}, {}
        for c in proj.columns:
            v = data[c]
            cols[c] = encode(v, sql_types.get(c, SQLType.INT),
                             proj.encoding_for(c), block_rows=block_rows)
            smas[c] = ColumnSMA.build(v, block_rows)
        return ROSContainer(next(_next_container_id), proj.name, cols, smas,
                            np.asarray(epochs, np.int64), n,
                            partition_key, local_segment)

    def storage_bytes(self) -> float:
        return sum(c.storage_bytes() for c in self.columns.values())

    def raw_bytes(self) -> float:
        return sum(c.n_rows * 8 for c in self.columns.values())

    def decode_column(self, name: str) -> np.ndarray:
        return self.columns[name].decode()

    def decode_all(self) -> Dict[str, np.ndarray]:
        return {c: col.decode() for c, col in self.columns.items()}

    def max_epoch(self) -> int:
        """Newest commit epoch in this container (cached: the container is
        immutable).  Epoch-keyed caches use it to clamp a query's as-of to
        the newest epoch that can affect ROS visibility."""
        if self._max_epoch is None:
            self._max_epoch = int(self.epochs.max()) if self.n_rows else 0
        return self._max_epoch

    def clone(self, projection: Optional[str] = None) -> "ROSContainer":
        """A fresh-id copy sharing the (immutable) encoded columns, SMAs
        and epochs -- the paper's 'simply copies whole ROS containers'
        recovery path and the backup hard-link trick: no decode, no
        re-sort, no re-encode.  The new id keeps per-store cache identity
        (retiring the copy never invalidates the original's entries)."""
        return dataclasses.replace(
            self, id=next(_next_container_id),
            projection=projection if projection is not None
            else self.projection)


@dataclasses.dataclass
class DeleteVector:
    """Deleted positions of one container (or the WOS), with epochs."""

    container_id: int                   # -1 = targets the WOS
    positions: np.ndarray               # sorted unique positions
    delete_epochs: np.ndarray
    stored: Optional[EncodedColumn] = None  # DVROS: encoded positions

    @staticmethod
    def build(container_id: int, positions: np.ndarray,
              epochs: np.ndarray) -> "DeleteVector":
        order = np.argsort(positions, kind="stable")
        return DeleteVector(container_id, positions[order], epochs[order])

    def to_ros(self, block_rows: int = BLOCK_ROWS) -> "DeleteVector":
        """Encode (delta-range over sorted positions compresses superbly)."""
        stored = encode(self.positions, SQLType.INT, Encoding.DELTA_RANGE,
                        block_rows=block_rows)
        return dataclasses.replace(self, stored=stored)

    def mask(self, n_rows: int, as_of_epoch: Optional[int] = None
             ) -> np.ndarray:
        """Boolean deleted-mask over positions, at snapshot ``as_of_epoch``."""
        m = np.zeros(n_rows, bool)
        if as_of_epoch is None:
            m[self.positions] = True
        else:
            vis = self.delete_epochs <= as_of_epoch
            m[self.positions[vis]] = True
        return m


@dataclasses.dataclass
class WOS:
    """In-memory write-optimized store for one projection segment.

    Unencoded (paper: 'data is not encoded or compressed in the WOS'), but
    already segmented: each appended batch carries its local segment AND
    its segmentation *ring* value, so the segmented executor
    (engine/segmented.py) can slab trickle-loaded rows per device shard
    (core/segmentation.shard_of) without re-hashing the segmentation
    columns at query time.  Buffers inserts until moveout."""

    projection: str
    data: Dict[str, List[np.ndarray]] = dataclasses.field(
        default_factory=dict)
    epochs: List[np.ndarray] = dataclasses.field(default_factory=list)
    local_segments: List[np.ndarray] = dataclasses.field(default_factory=list)
    # per-batch ring values (uint64, core/segmentation.hash_columns), or
    # None for batches of replicated projections / legacy callers
    rings: List[Optional[np.ndarray]] = dataclasses.field(
        default_factory=list)
    # monotonic content-version: bumped on every mutation (append / clear /
    # truncate, and by the database when WOS delete epochs change).  The
    # segmented executor keys its commit-time per-shard device WOS buffers
    # (engine/segmented.py) by this counter, so a stale buffer simply
    # becomes an unreachable cache entry -- no explicit invalidation walk.
    version: int = 0

    @property
    def n_rows(self) -> int:
        return int(sum(len(e) for e in self.epochs))

    def max_epoch(self) -> int:
        return int(max((int(e.max()) for e in self.epochs if len(e)),
                       default=0))

    def append(self, data: Dict[str, np.ndarray], epoch_or_epochs,
               local_segment: np.ndarray,
               ring: Optional[np.ndarray] = None):
        n = len(next(iter(data.values()))) if data else 0
        if n == 0:
            return
        for c, v in data.items():
            self.data.setdefault(c, []).append(np.asarray(v))
        e = np.asarray(epoch_or_epochs)
        if e.ndim == 0:
            e = np.full(n, int(e), np.int64)
        self.epochs.append(e.astype(np.int64))
        self.local_segments.append(np.asarray(local_segment, np.int32))
        self.rings.append(None if ring is None
                          else np.asarray(ring, np.uint64))
        self.version += 1

    def snapshot(self) -> Tuple[Dict[str, np.ndarray], np.ndarray,
                                np.ndarray]:
        if not self.epochs:
            return {}, np.zeros(0, np.int64), np.zeros(0, np.int32)
        data = {c: np.concatenate(v) for c, v in self.data.items()}
        return data, np.concatenate(self.epochs), \
            np.concatenate(self.local_segments)

    def ring_snapshot(self) -> Optional[np.ndarray]:
        """Ring values aligned with ``snapshot()`` row order, or None when
        any batch was appended untagged (caller re-hashes)."""
        if not self.epochs:
            return np.zeros(0, np.uint64)
        if any(r is None for r in self.rings):
            return None
        return np.concatenate(self.rings)

    def truncate_after(self, epoch: int):
        """Drop rows committed after ``epoch`` (recovery: back to LGE)."""
        data, eps, segs = self.snapshot()
        rings = self.ring_snapshot()
        keep = eps <= epoch
        self.data = {c: [v[keep]] for c, v in data.items()}
        self.epochs = [eps[keep]]
        self.local_segments = [segs[keep]]
        self.rings = [None if rings is None else rings[keep]]
        self.version += 1

    def clear(self):
        self.data, self.epochs, self.local_segments = {}, [], []
        self.rings = []
        self.version += 1

    def memory_bytes(self) -> float:
        return sum(v.nbytes for arrs in self.data.values() for v in arrs)
