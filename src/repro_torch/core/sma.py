"""Position index / Small Materialized Aggregates (paper §3.7, [22]).

Vertica stores, per column file, a position index ~1/1000 the size of the
data holding per-disk-block metadata (start position, min, max).  Here each
ROS container column carries a ``(n_blocks,)`` min/max/count triple; the
engine uses it for:

* container-level pruning at plan time (paper §3.5: partitioning makes
  min/max pruning more effective), and
* block-level pruning inside a scan, which on TPU becomes *masking whole
  VMEM tiles* -- pruned blocks are never touched, saving HBM->VMEM traffic.

Positions remain implicit (ordinal within container), exactly as in the
paper: fast tuple reconstruction = aligned indexing across column arrays.

Mirrors ``src/repro/core/sma.py``: a verbatim copy, so the port imports
nothing of the reference package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .types import BLOCK_ROWS, num_blocks


@dataclasses.dataclass(frozen=True)
class ColumnSMA:
    """Per-block min/max/count for one column of one ROS container."""

    mins: np.ndarray    # (n_blocks,)
    maxs: np.ndarray    # (n_blocks,)
    counts: np.ndarray  # (n_blocks,) valid rows per block (tail may be short)

    @staticmethod
    def build(values: np.ndarray, block_rows: int = BLOCK_ROWS) -> "ColumnSMA":
        n = values.size
        nb = num_blocks(n, block_rows)
        mins = np.empty(nb, dtype=values.dtype)
        maxs = np.empty(nb, dtype=values.dtype)
        counts = np.empty(nb, dtype=np.int32)
        for i in range(nb):
            blk = values[i * block_rows: min((i + 1) * block_rows, n)]
            counts[i] = blk.size
            if blk.size:
                mins[i] = blk.min()
                maxs[i] = blk.max()
            else:  # empty container edge case
                mins[i] = 0
                maxs[i] = 0
        return ColumnSMA(mins, maxs, counts)

    @property
    def n_rows(self) -> int:
        return int(self.counts.sum())

    def container_min(self):
        return self.mins.min()

    def container_max(self):
        return self.maxs.max()

    def prune_blocks(self, lo=None, hi=None) -> np.ndarray:
        """Block mask: True = block may contain rows with lo <= v <= hi.

        This is the §3.5 pruning predicate applied per block.  ``None``
        bounds are open.
        """
        keep = np.ones(self.mins.shape[0], dtype=bool)
        if lo is not None:
            keep &= self.maxs >= lo
        if hi is not None:
            keep &= self.mins <= hi
        return keep

    def prunes_container(self, lo=None, hi=None) -> bool:
        """True when the whole container provably fails the predicate."""
        return not bool(self.prune_blocks(lo, hi).any())


def interval_of_predicate(op: str, literal) -> Tuple[Optional[float],
                                                     Optional[float]]:
    """Map a comparison predicate to the (lo, hi) interval it accepts."""
    if op == "==":
        return literal, literal
    if op == "<":
        return None, literal
    if op == "<=":
        return None, literal
    if op == ">":
        return literal, None
    if op == ">=":
        return literal, None
    return None, None  # !=, etc: cannot prune
