"""Intra-node partitioning (paper §3.5): CREATE TABLE ... PARTITION BY expr.

Every ROS container holds rows of exactly one partition-expression value, so
bulk deletion = dropping files, and min/max pruning never sees intermixed
values. Partitioning is a *table* property (all projections partition the
same way, or bulk delete would not be fast).

Partition expressions are evaluated host-side on integral columns; the
common date-style expression (paper: 'extract month+year') is provided.

Mirrors ``src/repro/core/partitioning.py``: a verbatim copy, so the port imports
nothing of the reference package.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

PartitionFn = Callable[[np.ndarray], np.ndarray]

EXPRESSIONS: Dict[str, PartitionFn] = {
    # value used directly as the partition key
    "identity": lambda v: np.asarray(v, np.int64),
    # days-since-epoch -> YYYYMM style key
    "month_year": lambda v: (np.asarray(v, "datetime64[D]").astype(
        "datetime64[M]").astype(np.int64)),
    # integral bucketing for synthetic workloads
    "div_1000": lambda v: np.asarray(v, np.int64) // 1000,
}


def partition_keys(expr: Optional[str], column: Optional[np.ndarray]
                   ) -> Optional[np.ndarray]:
    if expr is None or column is None:
        return None
    fn = EXPRESSIONS.get(expr)
    if fn is None:
        raise KeyError(f"unknown partition expression {expr!r}; "
                       f"known: {sorted(EXPRESSIONS)}")
    return fn(column)
