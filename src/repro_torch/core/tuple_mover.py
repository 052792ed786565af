"""The Tuple Mover (paper §4): moveout (WOS -> ROS) and mergeout (strata).

Semantics implemented from the paper:
  * moveout drains the WOS into new ROS containers, one per
    (partition key, local segment) -- never intermixing WOS and ROS data
    (unlike C-Store), so a tuple is merged a strongly bounded number of
    times.
  * mergeout quantizes containers into exponential strata by size and only
    merges within a stratum; merging >= 2 same-stratum containers always
    produces a container at least one stratum up, so each tuple is
    (re)merged O(log(total/initial)) times. A max container size caps the
    strata count. Partition and local-segment boundaries are never crossed.
  * rows deleted at an epoch <= AHM are elided during any rewrite; delete
    vectors are re-mapped to the merged container's new positions.
  * operations are per-node autonomous (no cluster coordination): two nodes
    holding the same rows may have different container layouts.

Mirrors ``src/repro/core/tuple_mover.py``: a verbatim copy, so the port imports
nothing of the reference package.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from .block_cache import BlockCache, KIND_SEG
from .projection import ProjectionDef
from .storage import DeleteVector, ROSContainer, WOS
from .types import SQLType

MERGE_FANIN = 4            # max containers merged per operation
STRATUM_BASE = 1 << 14     # bytes of the smallest stratum
MAX_CONTAINER_BYTES = 1 << 31  # scaled-down analogue of the paper's 2TB


@dataclasses.dataclass
class ProjectionStore:
    """One node's physical state for one projection."""

    proj: ProjectionDef
    wos: WOS
    containers: List[ROSContainer] = dataclasses.field(default_factory=list)
    # container_id -> delete vectors (possibly several, as in the paper)
    delete_vectors: Dict[int, List[DeleteVector]] = dataclasses.field(
        default_factory=dict)
    # WOS delete epochs aligned to the WOS snapshot order (0 = live)
    wos_delete_epochs: List[np.ndarray] = dataclasses.field(
        default_factory=list)
    # device block cache shared across the node (set by VerticaDB); entries
    # of a container must be dropped when the container is retired
    cache: Optional[BlockCache] = None

    def invalidate_cached(self, container_ids) -> None:
        if self.cache is not None:
            self.cache.invalidate_containers(container_ids)

    def invalidate_seg_slabs(self, retired_ids=(), require_ids=()) -> int:
        """Precise invalidation of the segmented executor's partitioned
        scan slabs (``seg:<projection>`` / KIND_SEG).  Each slab key
        carries the exact container-id set it was built from, so we evict
        exactly the slabs that referenced a retired container
        (``retired_ids``: mergeout, truncate, drop_partition) or that
        predate a moveout (``require_ids``: every post-moveout lookup
        includes the new containers, so slabs without them are
        unreachable garbage holding HBM) -- never the projection's whole
        slab set, and never slabs of other (epoch, mesh, container-set)
        combinations that are still live."""
        if self.cache is None:
            return 0
        retired, required = set(retired_ids), set(require_ids)
        if not retired and not required:
            return 0

        def dead(key) -> bool:
            _, col, kind = key
            if kind != KIND_SEG:
                return False
            if not (isinstance(col, tuple) and len(col) >= 3
                    and isinstance(col[1], frozenset)):
                return True          # unknown key shape: evict, stay safe
            if retired & col[1]:     # container ids are globally unique
                return True
            if required:
                # post-moveout staleness is per-STORE: only entries that
                # sourced THIS projection's stores and predate the new
                # containers are unreachable; entries built purely from
                # other stores (e.g. buddy routing) stay live
                try:
                    items = col[2][0]
                except (TypeError, IndexError):
                    return True
                for _host, owner, ids in items:
                    if owner == self.proj.name \
                            and not (required & set(ids)):
                        return True
            return False

        # slabs are namespaced by the PRIMARY projection the planner
        # chose (buddies are never plan candidates), so a buddy store's
        # containers live under its primary's namespace
        primary = self.proj.buddy_of or self.proj.name
        return self.cache.invalidate_where(f"seg:{primary}", dead)

    def ros_rows(self) -> int:
        return sum(c.n_rows for c in self.containers)

    def epoch_ceiling(self, *, include_wos: bool = True) -> int:
        """Newest epoch affecting this store's visible state: container
        commit epochs, delete-vector epochs and (optionally) WOS rows.
        Visibility at any as-of >= ceiling equals visibility at the
        ceiling, so epoch-keyed caches clamp to it -- a trickle commit
        that only touched OTHER stores advances the cluster epoch without
        invalidating this store's cached scans."""
        hi = 0
        for c in self.containers:
            hi = max(hi, c.max_epoch())
        for dvs in self.delete_vectors.values():
            for dv in dvs:
                if len(dv.delete_epochs):
                    hi = max(hi, int(dv.delete_epochs.max()))
        if include_wos:
            hi = max(hi, self.wos.max_epoch())
            for de in self.wos_delete_epochs:
                if len(de):
                    hi = max(hi, int(de.max()))
        return hi

    def deleted_mask(self, c: ROSContainer,
                     as_of: Optional[int] = None) -> np.ndarray:
        m = np.zeros(c.n_rows, bool)
        for dv in self.delete_vectors.get(c.id, []):
            m |= dv.mask(c.n_rows, as_of)
        return m

    def delete_epochs_of(self, c: ROSContainer) -> np.ndarray:
        """Per-position delete epoch (0 = live)."""
        out = np.zeros(c.n_rows, np.int64)
        for dv in self.delete_vectors.get(c.id, []):
            out[dv.positions] = dv.delete_epochs
        return out


def moveout(store: ProjectionStore, *, sql_types: Dict[str, SQLType],
            ahm: int, partition_of: Optional[Dict[str, np.ndarray]] = None,
            partition_expr=None,
            block_rows: int = 4096) -> List[ROSContainer]:
    """Drain the WOS into ROS containers. Returns the new containers.

    Rows already deleted at epochs <= AHM are elided; later-deleted rows are
    written with a delete vector so historical queries still see them."""
    data, epochs, segs = store.wos.snapshot()
    if len(epochs) == 0:
        return []
    del_eps = (np.concatenate(store.wos_delete_epochs)
               if store.wos_delete_epochs else np.zeros(len(epochs),
                                                        np.int64))
    keep = ~((del_eps > 0) & (del_eps <= ahm))
    data = {c: v[keep] for c, v in data.items()}
    epochs, segs, del_eps = epochs[keep], segs[keep], del_eps[keep]

    pkeys = None
    if partition_expr is not None:
        from .partitioning import partition_keys
        pcol, expr = partition_expr
        pkeys = partition_keys(expr, data[pcol])

    new = []
    for seg in np.unique(segs):
        seg_sel = segs == seg
        pvals = [None] if pkeys is None else list(np.unique(pkeys[seg_sel]))
        for pv in pvals:
            sel = seg_sel if pv is None else seg_sel & (pkeys == pv)
            if not sel.any():
                continue
            sub = {c: v[sel] for c, v in data.items()}
            sub_eps, sub_del = epochs[sel], del_eps[sel]
            # sort now so we can map delete epochs to sorted positions
            if store.proj.sort_order:
                order = np.lexsort(tuple(sub[c] for c in
                                         reversed(store.proj.sort_order)))
                sub = {c: v[order] for c, v in sub.items()}
                sub_eps, sub_del = sub_eps[order], sub_del[order]
            c = ROSContainer.build(
                store.proj, sub, sub_eps, sql_types=sql_types,
                partition_key=None if pv is None else int(pv),
                local_segment=int(seg), presorted=True,
                block_rows=block_rows)
            store.containers.append(c)
            new.append(c)
            dpos = np.flatnonzero(sub_del > 0)
            if dpos.size:
                store.delete_vectors.setdefault(c.id, []).append(
                    DeleteVector.build(c.id, dpos, sub_del[dpos]).to_ros())
    store.wos.clear()
    store.wos_delete_epochs = []
    if new:
        # post-moveout slab lookups always include the new containers:
        # slabs built before this drain are unreachable -- evict precisely
        store.invalidate_seg_slabs(require_ids=[c.id for c in new])
    return new


def stratum_of(c: ROSContainer) -> int:
    b = max(c.raw_bytes(), 1)
    return max(0, int(math.log2(b / STRATUM_BASE))) if b > STRATUM_BASE \
        else 0


def plan_mergeout(store: ProjectionStore) -> Optional[List[ROSContainer]]:
    """Pick >= 2 same-stratum containers within one
    (partition, local_segment) group; smallest stratum first."""
    groups: Dict[Tuple, Dict[int, List[ROSContainer]]] = {}
    for c in store.containers:
        key = (c.partition_key, c.local_segment)
        groups.setdefault(key, {}).setdefault(stratum_of(c), []).append(c)
    best = None
    for strata in groups.values():
        for s in sorted(strata):
            cand = strata[s]
            if len(cand) < 2:
                continue
            cand = sorted(cand, key=lambda c: c.raw_bytes())[:MERGE_FANIN]
            if sum(c.raw_bytes() for c in cand) > MAX_CONTAINER_BYTES:
                continue
            if best is None or s < best[0]:
                best = (s, cand)
    return best[1] if best else None


def mergeout(store: ProjectionStore, *, sql_types: Dict[str, SQLType],
             ahm: int, block_rows: int = 4096) -> Optional[ROSContainer]:
    """One mergeout operation: merge one planned group. Each input tuple is
    read once and written (at most) once; AHM-deleted rows are elided."""
    cand = plan_mergeout(store)
    if not cand:
        return None
    datas, epochs, del_eps = [], [], []
    for c in cand:
        d = c.decode_all()
        de = store.delete_epochs_of(c)
        keep = ~((de > 0) & (de <= ahm))          # AHM elision
        datas.append({k: v[keep] for k, v in d.items()})
        epochs.append(c.epochs[keep])
        del_eps.append(de[keep])
    data = {c: np.concatenate([d[c] for d in datas])
            for c in cand[0].columns}
    eps = np.concatenate(epochs)
    dels = np.concatenate(del_eps)
    if store.proj.sort_order:
        order = np.lexsort(tuple(data[c] for c in
                                 reversed(store.proj.sort_order)))
        data = {c: v[order] for c, v in data.items()}
        eps, dels = eps[order], dels[order]
    merged = ROSContainer.build(
        store.proj, data, eps, sql_types=sql_types,
        partition_key=cand[0].partition_key,
        local_segment=cand[0].local_segment, presorted=True,
        block_rows=block_rows)
    ids = {c.id for c in cand}
    store.containers = [c for c in store.containers if c.id not in ids]
    store.invalidate_cached(ids)   # merged-away containers are retired
    store.invalidate_seg_slabs(retired_ids=ids)
    for cid in ids:
        store.delete_vectors.pop(cid, None)
    store.containers.append(merged)
    dpos = np.flatnonzero(dels > 0)
    if dpos.size:
        store.delete_vectors.setdefault(merged.id, []).append(
            DeleteVector.build(merged.id, dpos, dels[dpos]).to_ros())
    return merged


def run_tuple_mover(store: ProjectionStore, *, sql_types, ahm,
                    partition_expr=None, wos_row_limit: int = 8192,
                    block_rows: int = 4096,
                    do_mergeout: bool = True) -> Dict[str, int]:
    """Policy loop: moveout when the WOS is saturated, then (unless
    ``do_mergeout=False`` -- moveout and mergeout are independent
    services, paper §4) mergeout until no stratum has >= 2 containers
    (or caps block further merging)."""
    stats = {"moveouts": 0, "mergeouts": 0}
    if store.wos.n_rows >= wos_row_limit:
        if moveout(store, sql_types=sql_types, ahm=ahm,
                   partition_expr=partition_expr, block_rows=block_rows):
            stats["moveouts"] += 1
    while do_mergeout and mergeout(store, sql_types=sql_types, ahm=ahm,
                                   block_rows=block_rows) is not None:
        stats["mergeouts"] += 1
    return stats
