"""Compression-aware cost model (paper §6.2: 'compression aware I/O, CPU
and Network transfer costs').

Costs are in abstract seconds built from the same hardware constants the
roofline uses: I/O = *encoded* bytes touched after SMA pruning (compression
directly buys scan speed -- the paper's central costing change), CPU = rows
processed, NET = bytes exchanged for non-co-located joins/groupbys.

Mirrors ``src/repro/planner/cost.py``: a verbatim copy, so the port imports
nothing of the reference package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from ..core.database import VerticaDB
from ..core.projection import ProjectionDef
from ..engine.expr import Expr

IO_BW = 819e9       # bytes/s (HBM on the TPU adaptation)
CPU_RATE = 2e9      # rows/s per node
NET_BW = 50e9       # bytes/s (ICI)


@dataclasses.dataclass
class CostEstimate:
    io_s: float = 0.0
    cpu_s: float = 0.0
    net_s: float = 0.0
    rows: int = 0
    bytes_scanned: float = 0.0

    @property
    def total(self) -> float:
        return self.io_s + self.cpu_s + self.net_s


def scan_cost(db: VerticaDB, proj: ProjectionDef,
              predicate: Optional[Expr], columns) -> CostEstimate:
    """Encoded bytes surviving SMA pruning, for the needed columns only
    (columnar: untouched columns cost nothing)."""
    bounds = predicate.bounds() if predicate is not None else {}
    est = CostEstimate()
    for node in db.nodes:
        if not node.serving():      # recovering stores are incomplete
            continue
        store = node.stores.get(proj.name)
        if store is None:
            continue
        for c in store.containers:
            frac = 1.0
            for colname, (lo, hi) in bounds.items():
                if colname in c.smas:
                    keep = c.smas[colname].prune_blocks(lo, hi)
                    frac = min(frac, keep.mean() if keep.size else 0.0)
            for colname in columns:
                if colname in c.columns:
                    est.bytes_scanned += c.columns[colname].storage_bytes() \
                        * frac
            est.rows += int(c.n_rows * frac)
    est.io_s = est.bytes_scanned / IO_BW
    est.cpu_s = est.rows / CPU_RATE
    return est


def selectivity(db: VerticaDB, proj: ProjectionDef,
                predicate: Optional[Expr]) -> float:
    """Fraction of rows expected to pass (SMA-based histogram proxy)."""
    if predicate is None:
        return 1.0
    bounds = predicate.bounds()
    if not bounds:
        return 0.5
    frac = 1.0
    for node in db.nodes:
        if not node.serving():
            continue
        store = node.stores.get(proj.name)
        if not store or not store.containers:
            continue
        for colname, (lo, hi) in bounds.items():
            kept = total = 0
            for c in store.containers:
                if colname in c.smas:
                    k = c.smas[colname].prune_blocks(lo, hi)
                    kept += int(k.sum())
                    total += k.size
            if total:
                frac = min(frac, kept / total)
        break
    return max(frac, 1e-4)


def join_distribution(db: VerticaDB, fact_proj: ProjectionDef,
                      fact_key: str, dim_table: str,
                      dim_rows: int, dim_key: str = "",
                      placement: Optional[Tuple[str, ...]] = None
                      ) -> Tuple[str, float]:
    """Pick co-located / broadcast / resegment and its NET cost (paper
    §6.2: 'optimizing queries to favor co-located joins where possible').

    * co-located: both sides segmented on the join key (or dim replicated)
      -> zero network.
    * broadcast: small dim -> all_gather of the build side.
    * resegment: both large -> all_to_all of the probe side.

    ``placement`` is the probe side's *current* hash-segmentation columns
    at the point this join runs -- the planner threads it through a join
    chain because an earlier resegment changes it (a resegment on k1 makes
    a later 'co-located on k2' claim false even when the stored projection
    is segmented by k2); None means 'use the projection's stored
    segmentation'.
    """
    dim_super = db.catalog.super_of(dim_table)
    fact_seg = fact_proj.segmentation
    if placement is None:
        placement = None if fact_seg.replicated else tuple(fact_seg.columns)
    if dim_super.segmentation.replicated:
        return "co-located (replicated dim)", 0.0
    if (placement == (fact_key,) and dim_key
            and dim_super.segmentation.columns == (dim_key,)):
        return "co-located (matching segmentation)", 0.0
    bcast_bytes = dim_rows * 16.0 * db.catalog.n_nodes
    fact_rows = sum(
        st.ros_rows() for n in db.nodes if n.serving()
        for st in [n.stores[fact_proj.name]])
    reseg_bytes = fact_rows * 16.0
    if bcast_bytes <= reseg_bytes:
        return "broadcast", bcast_bytes / NET_BW
    return "resegment", reseg_bytes / NET_BW


def resegment_capacity(dest_counts: np.ndarray, n_shards: int,
                       pad_multiple: int = 8) -> int:
    """Per-exchange static capacity for exchange.resegment: enough slots
    on the fullest destination shard (rounded up), times n_shards.  Exact
    when ``dest_counts`` comes from the actual destination histogram; the
    caller still checks the reported overflow."""
    per = int(max(int(np.max(dest_counts)) if len(dest_counts) else 0, 1))
    per = -(-per // pad_multiple) * pad_multiple
    return per * n_shards
