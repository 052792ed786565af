"""Recovery, refresh, rebalance, backup (paper §5.2).

All four are online: the cluster keeps serving reads/writes from live nodes
while they run (our simulation is single-threaded, but the lock discipline
matches: historical phase lock-free, current phase under an S lock).

Recovery of a rejoining node, per projection segment:
  1. truncate everything past the node's LGE (WOS already lost),
  2. historical phase (no locks): copy committed rows in (LGE, E_h] from
     the buddy -- buddies share sort orders here, so this is the paper's
     'simply copies whole ROS containers and their delete vectors' path,
  3. current phase (S lock on the anchor table): copy (E_h, current].

There is no transaction log: data + epochs ARE the log.

Mirrors ``src/repro/core/recovery.py``: a verbatim copy, so the port imports
nothing of the reference package.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .database import (AvailabilityError, RecoverySourceLostError,
                       VerticaDB)
from .faults import (NodeCrashError, TransientFaultError,
                     fire_with_retries)
from .projection import ProjectionDef
from .segmentation import rebalance_plan
from .storage import DeleteVector, ROSContainer, WOS
from .tuple_mover import ProjectionStore


def _rows_with_delete_epochs(db: VerticaDB, store: ProjectionStore,
                             lo: int, hi: int, skip_ids=frozenset()):
    """All rows (incl. deleted ones) with commit epoch in (lo, hi], plus
    their delete epochs -- the replay stream.  ``skip_ids`` excludes
    containers already copied wholesale by incremental recovery."""
    parts, dparts, eparts = [], [], []
    for c in store.containers:
        if c.id in skip_ids:
            continue
        sel = (c.epochs > lo) & (c.epochs <= hi)
        if sel.any():
            rows = c.decode_all()
            parts.append({k: v[sel] for k, v in rows.items()})
            eparts.append(c.epochs[sel])
            dparts.append(store.delete_epochs_of(c)[sel])
    data, eps, _ = store.wos.snapshot()
    if len(eps):
        sel = (eps > lo) & (eps <= hi)
        if sel.any():
            dels = (np.concatenate(store.wos_delete_epochs)
                    if store.wos_delete_epochs
                    else np.zeros(len(eps), np.int64))
            parts.append({k: v[sel] for k, v in data.items()})
            eparts.append(eps[sel])
            dparts.append(dels[sel])
    if not parts:
        return None
    cols = {c: np.concatenate([p[c] for p in parts]) for c in parts[0]}
    return cols, np.concatenate(eparts), np.concatenate(dparts)


def _install_rows(db: VerticaDB, store: ProjectionStore, node_id: int,
                  rows, epochs, delete_epochs):
    """Build ROS containers on the recovering node from a replay stream,
    keeping only rows belonging to this node's ring range."""
    proj = store.proj
    entry = db.catalog.tables[proj.anchor]
    if not proj.segmentation.replicated:
        nodes, segs = proj.segmentation.place(rows, db.catalog.n_nodes)
        sel = nodes == node_id
        rows = {c: v[sel] for c, v in rows.items()}
        epochs, delete_epochs = epochs[sel], delete_epochs[sel]
        segs = segs[sel]
    else:
        segs = np.zeros(len(epochs), np.int32)
    if len(epochs) == 0:
        return
    tmp = ProjectionStore(proj, WOS(proj.name))
    tmp.wos.append(rows, epochs, segs)
    tmp.wos_delete_epochs = [delete_epochs]
    from .tuple_mover import moveout
    new = moveout(tmp, sql_types=db._sql_types(proj), ahm=db.epochs.ahm,
                  partition_expr=entry.partition_expr,
                  block_rows=db.block_rows)
    store.containers.extend(new)
    for c in new:
        if c.id in tmp.delete_vectors:
            store.delete_vectors[c.id] = tmp.delete_vectors[c.id]
    if new:
        store.invalidate_seg_slabs(require_ids=[c.id for c in new])


def _truncate_past(db: VerticaDB, store: ProjectionStore, epoch: int):
    """Drop rows committed after ``epoch``; clear newer delete marks."""
    kept = []
    for c in store.containers:
        sel = c.epochs <= epoch
        dvs = store.delete_vectors.pop(c.id, [])
        if sel.all():
            kept.append(c)
            ndvs = []
            for dv in dvs:
                keep = dv.delete_epochs <= epoch
                if keep.any():
                    ndvs.append(DeleteVector.build(
                        c.id, dv.positions[keep],
                        dv.delete_epochs[keep]).to_ros())
            if ndvs:
                store.delete_vectors[c.id] = ndvs
            continue
        if not sel.any():
            continue
        rows = c.decode_all()
        dels = store.delete_epochs_of(c)
        dels = np.where(dels <= epoch, dels, 0)
        nc = ROSContainer.build(
            store.proj, {k: v[sel] for k, v in rows.items()},
            c.epochs[sel], sql_types=db._sql_types(store.proj),
            partition_key=c.partition_key, local_segment=c.local_segment,
            presorted=True, block_rows=db.block_rows)
        kept.append(nc)
        dpos = np.flatnonzero(dels[sel] > 0)
        if dpos.size:
            store.delete_vectors[nc.id] = [DeleteVector.build(
                nc.id, dpos, dels[sel][dpos]).to_ros()]
    retired = {c.id for c in store.containers} - {c.id for c in kept}
    store.invalidate_cached(retired)   # truncation retires containers
    store.invalidate_seg_slabs(retired_ids=retired)
    store.containers = kept


def _replay_deletes(db: VerticaDB, store: ProjectionStore,
                    src: ProjectionStore, lo: int, hi: int, node_id: int):
    """Replay DELETEs of rows that the recovering node already has (commit
    epoch <= lo) but whose delete vector (delete epoch in (lo, hi]) it
    missed while down. Rows are matched by full-tuple hash -- the data +
    epoch IS the log, there are no row ids (paper §5.2)."""
    proj = store.proj
    from .segmentation import hash_columns
    from collections import Counter
    wanted: Counter = Counter()
    epochs_for = {}
    for c in src.containers:
        de = src.delete_epochs_of(c)
        sel = (de > lo) & (de <= hi) & (c.epochs <= lo)
        if not sel.any():
            continue
        rows = c.decode_all()
        if not proj.segmentation.replicated:
            nodes_arr, _ = proj.segmentation.place(rows, db.catalog.n_nodes)
            sel &= nodes_arr == node_id
        h = hash_columns(*[rows[col].astype(np.int64)
                           if rows[col].dtype.kind != "f"
                           else rows[col].view(np.int64)
                           for col in proj.columns])
        for hv, ep in zip(h[sel].tolist(), de[sel].tolist()):
            wanted[hv] += 1
            epochs_for[hv] = ep
    if not wanted:
        return
    for c in store.containers:
        rows = c.decode_all()
        h = hash_columns(*[rows[col].astype(np.int64)
                           if rows[col].dtype.kind != "f"
                           else rows[col].view(np.int64)
                           for col in proj.columns])
        already = store.deleted_mask(c)
        pos, eps = [], []
        for i, hv in enumerate(h.tolist()):
            if wanted.get(hv, 0) > 0 and not already[i]:
                wanted[hv] -= 1
                pos.append(i)
                eps.append(epochs_for[hv])
        if pos:
            store.delete_vectors.setdefault(c.id, []).append(
                DeleteVector.build(c.id, np.asarray(pos),
                                   np.asarray(eps, np.int64)).to_ros())


def rejoin_node(db: VerticaDB, node_id: int) -> Optional[int]:
    """Phase 0 of incremental recovery: bring a failed node back online
    *without* serving reads.  Its ROS is truncated back to the LGE (the
    WOS was already lost with the failure), and from here on it receives
    every new commit -- so the epoch range it must later replay is frozen
    at (LGE, rejoin_epoch] no matter how long recovery takes or how many
    trickle loads land meanwhile.  Reads keep routing to the buddy
    (``NodeState.serving``) until ``recover_node`` completes."""
    node = db.nodes[node_id]
    if node.up:
        return node.rejoin_epoch
    node.up = True
    node.recovering = True
    node.rejoin_epoch = db.epochs.latest_queryable()
    for proj_name, store in node.stores.items():
        _truncate_past(db, store, db.epochs.get_lge(proj_name, node_id))
    return node.rejoin_epoch


def _copy_epoch_range(db: VerticaDB, store: ProjectionStore,
                      src: ProjectionStore, node_id: int,
                      lo: int, hi: int) -> Tuple[int, int]:
    """Replay commits in (lo, hi] from the buddy.  Buddy containers are
    segment-aligned with the recovering store (same ring sub-range, same
    sort order -- a buddy host holds exactly the primary segment of the
    recovering node), so any container wholly inside the epoch window is
    adopted WHOLESALE: a fresh-id clone sharing the encoded payloads and
    its delete vectors, zero decode/sort/encode (paper §4.4 'simply
    copies whole ROS containers and their delete vectors').  Only rows in
    containers straddling the window boundary replay row-wise.  Returns
    (containers adopted, rows installed)."""
    if hi <= lo:
        return 0, 0
    adopted_ids = set()
    clone_ids = []
    rows = 0
    for c in src.containers:
        if c.n_rows == 0:
            continue
        if not ((c.epochs > lo).all() and (c.epochs <= hi).all()):
            continue
        nc = c.clone(projection=store.proj.name)
        store.containers.append(nc)
        for dv in src.delete_vectors.get(c.id, []):
            store.delete_vectors.setdefault(nc.id, []).append(
                DeleteVector.build(nc.id, dv.positions,
                                   dv.delete_epochs).to_ros())
        adopted_ids.add(c.id)
        clone_ids.append(nc.id)
        rows += c.n_rows
    if clone_ids:
        # adoption grows the container set exactly like a moveout does:
        # slabs built before it can never match a future lookup (their
        # keys lack the new ids) -- free their HBM now, precisely
        store.invalidate_seg_slabs(require_ids=clone_ids)
    stream = _rows_with_delete_epochs(db, src, lo, hi,
                                      skip_ids=adopted_ids)
    if stream:
        _install_rows(db, store, node_id, *stream)
        rows += len(stream[1])
    return len(adopted_ids), rows


def recover_node(db: VerticaDB, node_id: int, *,
                 historical_lag: int = 1) -> Dict[str, int]:
    """Recover a failed or rejoined node incrementally: replay ONLY the
    epochs it missed while down, (LGE, rejoin_epoch], from the buddy --
    commits after the rejoin already landed on it live.  Returns rows
    replayed per projection; adoption/replay counts land in
    ``node.last_recovery``."""
    node = db.nodes[node_id]
    if node.up and not node.recovering:
        return {}
    if not node.up:                     # direct call: rejoin now
        rejoin_node(db, node_id)
    e_join = node.rejoin_epoch
    current = db.epochs.latest_queryable()
    replayed: Dict[str, int] = {}
    adopted_total = 0
    complete = True
    failed: Dict[str, Tuple[int, ...]] = {}
    window_lo: Optional[int] = None
    for proj_name, store in node.stores.items():
        proj = db.catalog.projections[proj_name]
        lge = db.epochs.get_lge(proj_name, node_id)
        # the historical/current boundary must never fall below the LGE or
        # the current phase would re-install rows the node already has
        e_h = max(lge, e_join - historical_lag)
        try:
            # injection point fires BEFORE any replay state mutates: a
            # crash or exhausted transient here leaves this projection
            # cleanly un-replayed (its per-projection LGE is untouched,
            # so a later recover_node retry is idempotent)
            fire_with_retries(db, "recovery.replay", node=node_id,
                              projection=proj_name)
            src = _buddy_source(db, proj, node_id)
        except NodeCrashError as e:
            if e.node == node_id:
                raise       # the recovering node itself died again
            src = None      # the replay source crashed under us
        except TransientFaultError:
            src = None      # buddy unreachable after the retry budget
        if src is None:
            # no live replay source.  With K=0 (no buddy exists) there is
            # nothing to ever replay from -- proceed.  But if a buddy
            # EXISTS and is merely down/recovering, going back to serving
            # now would silently drop every epoch in (LGE, rejoin]: stay
            # in recovering state so a later recover_node can retry.
            if lge < e_join and _replay_source_exists(db, proj):
                complete = False
                failed[proj_name] = (node_id,)
                window_lo = lge if window_lo is None \
                    else min(window_lo, lge)
            continue
        # historical phase: (LGE, e_h], no locks
        total = 0
        a, r = _copy_epoch_range(db, store, src, node_id, lge, e_h)
        adopted_total += a
        total += r
        _replay_deletes(db, store, src, lge, e_h, node_id)
        db.epochs.set_lge(proj_name, node_id, e_h)
        # current phase: (e_h, rejoin] under a Shared lock; deletes replay
        # through `current` -- a delete committed while the node was
        # recovering targeted rows it did not have yet
        db.locks.acquire(proj.anchor, f"recover-{node_id}", "S")
        try:
            a, r = _copy_epoch_range(db, store, src, node_id, e_h, e_join)
            adopted_total += a
            total += r
            _replay_deletes(db, store, src, e_h, current, node_id)
            db.epochs.set_lge(proj_name, node_id, e_join)
        finally:
            db.locks.release_all(f"recover-{node_id}")
        replayed[proj_name] = total
    node.last_recovery = {"adopted_containers": adopted_total,
                          "replayed_rows": sum(replayed.values()),
                          "replay_hi": e_join,
                          "complete": complete}
    if complete:
        node.recovering = False
        node.rejoin_epoch = None
        node.stale_since = None
        return replayed
    # LOUD incomplete (never silently partial): the node STAYS in
    # recovering state -- buddies keep serving its segments where they
    # can, commits keep landing on it, and a later recover_node retry
    # (once the replay source is back) completes.  The typed error
    # carries exactly which projections/segments still owe which epochs.
    raise RecoverySourceLostError(node_id, failed,
                                  window=(window_lo, e_join))


def _replay_source_exists(db: VerticaDB, proj: ProjectionDef) -> bool:
    """Whether a replay source for this projection exists AT ALL (live or
    not) -- distinguishes 'buddy temporarily unavailable' (recovery must
    wait) from K=0 'no buddy was ever kept' (nothing to replay from)."""
    if proj.segmentation.replicated:
        return db.catalog.n_nodes > 1
    if proj.buddy_of is not None:
        return True
    return (proj.name + "_b1") in db.catalog.projections


def _buddy_source(db: VerticaDB, proj: ProjectionDef,
                  node_id: int) -> Optional[ProjectionStore]:
    """The live store that holds this node's rows: the buddy projection's
    store on the offset node (or, for a buddy/replicated projection, the
    primary's).  Opening the source is an injection point
    (``recovery.buddy_read``): transients retry with backoff; a crash or
    an exhausted budget propagates for recover_node to record the
    projection as source-lost."""
    if proj.segmentation.replicated:
        for n in db.nodes:
            if n.serving() and n.id != node_id:
                return _open_source(db, n.id, proj.name,
                                    n.stores[proj.name])
        return None
    if proj.buddy_of is not None:
        primary = db.catalog.projections[proj.buddy_of]
        # rows this buddy-node stores = primary segment of (node - offset)
        src_node = db.nodes[(node_id - proj.segmentation.offset)
                            % db.catalog.n_nodes]
        if src_node.serving():
            return _open_source(db, src_node.id, primary.name,
                                src_node.stores[primary.name])
        return None
    buddy = db.catalog.projections.get(proj.name + "_b1")
    if buddy is None:
        return None
    host = (node_id + buddy.segmentation.offset) % db.catalog.n_nodes
    if db.nodes[host].serving():
        return _open_source(db, host, buddy.name,
                            db.nodes[host].stores[buddy.name])
    return None


def _open_source(db: VerticaDB, host: int, proj_name: str,
                 store: ProjectionStore) -> ProjectionStore:
    fire_with_retries(db, "recovery.buddy_read", node=host,
                      projection=proj_name)
    return store


def refresh_projection(db: VerticaDB, proj_name: str):
    """Populate a projection created after its table was loaded (§5.2):
    historical phase from the super projection, current under S lock."""
    proj = db.catalog.projections[proj_name]
    current = db.epochs.latest_queryable()
    sp = db.catalog.super_of(proj.anchor)
    rows = db.read_projection(sp.name, as_of=current)
    base = {c: rows[c] for c in proj.columns if c in rows}
    if proj.prejoin is not None:
        base = db._project_rows(proj, rows)
    n = len(next(iter(base.values()))) if base else 0
    if n == 0:
        return
    epochs = np.full(n, max(current, 1), np.int64)
    dels = np.zeros(n, np.int64)
    db.locks.acquire(proj.anchor, "refresh", "S")
    try:
        for node in db.nodes:
            if not node.up:
                continue
            store = node.stores[proj_name]
            if proj.segmentation.replicated:
                _install_rows(db, store, node.id, base, epochs, dels)
            else:
                _install_rows(db, store, node.id, base, epochs, dels)
            db.epochs.set_lge(proj_name, node.id, current)
    finally:
        db.locks.release_all("refresh")


def rebalance(db: VerticaDB, new_n_nodes: int) -> int:
    """Elastic resize: move whole local segments to the new topology
    (paper §3.6 'local segments'), then re-register stores. Returns the
    number of segment moves."""
    old_n = db.catalog.n_nodes
    if new_n_nodes == old_n:
        return 0
    from .database import NodeState
    # snapshot all rows per projection before resizing
    snapshots = {}
    for proj in list(db.catalog.projections.values()):
        parts = []
        for node in db.nodes:
            st = node.stores.get(proj.name)
            if st is None:
                continue
            stream = _rows_with_delete_epochs(db, st, 0,
                                              db.epochs.latest_queryable())
            if stream:
                parts.append(stream)
        snapshots[proj.name] = parts
    moves = rebalance_plan(old_n, new_n_nodes, 3)
    # rebuild topology
    if new_n_nodes > old_n:
        for i in range(old_n, new_n_nodes):
            db.nodes.append(NodeState(i))
            for proj in db.catalog.projections.values():
                db.nodes[i].stores[proj.name] = ProjectionStore(
                    proj, WOS(proj.name))
    else:
        db.nodes = db.nodes[:new_n_nodes]
    db.catalog.n_nodes = new_n_nodes
    # redistribute (wholesale per projection; the plan above is the
    # accounting of which local segments physically move)
    for proj in db.catalog.projections.values():
        for node in db.nodes:
            node.stores[proj.name] = ProjectionStore(proj, WOS(proj.name))
        for rows, eps, dels in snapshots.get(proj.name, []):
            if proj.segmentation.replicated:
                for node in db.nodes:
                    _install_rows(db, node.stores[proj.name], node.id,
                                  rows, eps, dels)
            else:
                nodes_arr, _ = proj.segmentation.place(rows, new_n_nodes)
                for nid in np.unique(nodes_arr):
                    _install_rows(db, db.nodes[int(nid)].stores[proj.name],
                                  int(nid), rows, eps, dels)
        for node in db.nodes:
            db.epochs.set_lge(proj.name, node.id,
                              db.epochs.latest_queryable())
    return len(moves)


def backup(db: VerticaDB) -> Dict:
    """Snapshot backup: catalog + references to immutable containers (the
    'hard link' trick -- containers are never modified, so references
    suffice; no data copy)."""
    img = {"epoch": db.epochs.latest_queryable(), "catalog": db.catalog,
           "nodes": {}}
    for node in db.nodes:
        img["nodes"][node.id] = {
            p: {"containers": list(st.containers),
                "delete_vectors": {k: list(v) for k, v in
                                   st.delete_vectors.items()}}
            for p, st in node.stores.items()}
    return img


def restore(db: VerticaDB, img: Dict):
    db.catalog = img["catalog"]
    for node in db.nodes:
        for p, snap in img["nodes"].get(node.id, {}).items():
            st = node.stores[p]
            st.containers = list(snap["containers"])
            st.delete_vectors = {k: list(v) for k, v in
                                 snap["delete_vectors"].items()}
            st.wos.clear()
            st.wos_delete_epochs = []
    db.epochs.current_epoch = img["epoch"] + 1
    # the epoch counter rolls BACK: epoch-keyed valid@{epoch} cache
    # entries from the abandoned timeline would otherwise be revived
    # once the counter re-reaches their epoch -- drop everything
    db.block_cache.clear()
