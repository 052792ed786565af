"""Core columnar types for the Vertica-in-JAX engine.

Block geometry
--------------
Vertica stores column data in ~64KB disk blocks with a per-block position
index entry (min/max/start).  On TPU the analogous unit is a VMEM-tile-aligned
block of rows: every column in a ROS container is stored block-structured,
``(n_blocks, BLOCK_ROWS)`` after decode, so that block pruning (SMA min/max)
maps onto masking whole tiles and scan kernels can tile HBM->VMEM transfers.

Rows are identified by *position* (implicit ordinal within the container),
exactly as in the paper -- positions are never materialized.

Mirrors ``src/repro/core/types.py``: a verbatim copy, so the port imports
nothing of the reference package.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

# Default rows per block.  8 sublanes x 128 lanes x 4 = TPU friendly; also a
# realistic analogue of Vertica's 64KB blocks (4096 x 8B ints = 32KB).
BLOCK_ROWS = 4096

# Ring size for segmentation.  The paper uses C_MAX = 2^64; we use 2^32
# because jax defaults to 32-bit integers (DESIGN.md deviation note).
C_MAX = np.uint64(1) << np.uint64(32)


class SQLType(enum.Enum):
    """Logical column types (the commercial system's FLOAT/VARCHAR lesson:
    C-Store supported only INTEGER; supporting real types is table stakes)."""

    INT = "int"          # stored int64 host-side, int32 on device when safe
    FLOAT = "float"      # stored float64 host-side, float32 on device
    VARCHAR = "varchar"  # dictionary-encoded to int codes at ingest

    @property
    def np_dtype(self) -> np.dtype:
        return {
            SQLType.INT: np.dtype(np.int64),
            SQLType.FLOAT: np.dtype(np.float64),
            SQLType.VARCHAR: np.dtype(np.int64),  # code space
        }[self]


@dataclasses.dataclass(frozen=True)
class ColumnDef:
    name: str
    sql_type: SQLType = SQLType.INT
    nullable: bool = False


@dataclasses.dataclass(frozen=True)
class TableSchema:
    name: str
    columns: Tuple[ColumnDef, ...]
    partition_by: Optional[str] = None  # expression name, see partitioning.py

    def column(self, name: str) -> ColumnDef:
        for c in self.columns:
            if c.name == name:
                return c
        raise KeyError(f"no column {name!r} in table {self.name!r}")

    def column_names(self) -> Tuple[str, ...]:
        return tuple(c.name for c in self.columns)

    def __contains__(self, name: str) -> bool:
        return any(c.name == name for c in self.columns)


def num_blocks(n_rows: int, block_rows: int = BLOCK_ROWS) -> int:
    return max(1, -(-n_rows // block_rows))


def pad_to_blocks(values: np.ndarray, block_rows: int = BLOCK_ROWS,
                  pad_value: Any = 0) -> np.ndarray:
    """Pad a 1-D array to a whole number of blocks and reshape to 2-D."""
    n = values.shape[0]
    nb = num_blocks(n, block_rows)
    padded = np.full(nb * block_rows, pad_value, dtype=values.dtype)
    padded[:n] = values
    return padded.reshape(nb, block_rows)


def nullable_to_sentinel(values: np.ndarray, mask: Optional[np.ndarray],
                         sql_type: SQLType) -> np.ndarray:
    """SQL NULL handling: NULLs are carried as a sentinel + validity mask.

    The paper lists "processing SQL NULLs, which often have to be special
    cased" among the features added over C-Store; we carry an explicit
    validity bitmap per column (see storage.EncodedColumn.valid).
    """
    if mask is None:
        return values
    out = values.copy()
    if sql_type == SQLType.FLOAT:
        out[~mask] = np.nan
    else:
        out[~mask] = 0
    return out
