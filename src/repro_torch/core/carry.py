"""Carry a database's stored state across packages.

The system's "weights" are its stored data.  ``state_of(db)`` walks a
database -- the port's ``VerticaDB`` or the reference's, read by duck
typing without importing either package -- and returns plain Python and
numpy only (str, int, float, bool, None, tuple, dict, ``np.ndarray``):
the catalog (tables, schemas, projections, segmentation, encodings), the
epoch state, and for every node and projection store its ROS containers
(each column's encoding, SQL type, payload arrays, packed widths, scale,
inner column, SMAs and row epochs), delete vectors and WOS rows.
``database_from_state(state, device)`` builds the port's ``VerticaDB``
from it; the payload arrays are shared, not re-encoded, so the rebuilt
database answers byte-identically.
"""
from __future__ import annotations

import itertools
from collections import Counter
from typing import Any, Dict, Optional

import numpy as np

from . import storage as storage_mod
from .catalog import Catalog, TableEntry
from .database import NodeState, VerticaDB
from .encodings import EncodedColumn, Encoding
from .epochs import EpochManager
from .projection import PrejoinSpec, ProjectionDef
from .segmentation import SegmentationSpec
from .sma import ColumnSMA
from .storage import DeleteVector, ROSContainer, WOS
from .tuple_mover import ProjectionStore
from .types import ColumnDef, SQLType, TableSchema


# ---------------------------------------------------------------- export --

def _column_state(c) -> Optional[Dict[str, Any]]:
    if c is None:
        return None
    return {"encoding": c.encoding.value, "sql_type": c.sql_type.value,
            "n_rows": int(c.n_rows), "block_rows": int(c.block_rows),
            "arrays": {k: np.asarray(v) for k, v in c.arrays.items()},
            "valid": None if c.valid is None else np.asarray(c.valid),
            "packed_bytes": float(c.packed_bytes),
            "inner": _column_state(c.inner), "scale": float(c.scale),
            "widths": {k: int(w) for k, w in c.widths.items()}}


def _projection_state(p) -> Dict[str, Any]:
    seg = p.segmentation
    pj = p.prejoin
    return {"name": p.name, "anchor": p.anchor,
            "columns": tuple(p.columns), "sort_order": tuple(p.sort_order),
            "segmentation": {"kind": seg.kind, "columns": tuple(seg.columns),
                             "n_local_segments": int(seg.n_local_segments),
                             "offset": int(seg.offset)},
            "encodings": {c: e.value for c, e in p.encodings.items()},
            "is_super": bool(p.is_super), "buddy_of": p.buddy_of,
            "prejoin": None if pj is None else {
                "anchor_key": pj.anchor_key, "dim_table": pj.dim_table,
                "dim_key": pj.dim_key,
                "dim_columns": tuple(pj.dim_columns)}}


def _store_state(st) -> Dict[str, Any]:
    w = st.wos
    return {
        "containers": tuple({
            "id": int(c.id), "projection": c.projection,
            "columns": {n: _column_state(col)
                        for n, col in c.columns.items()},
            "smas": {n: {"mins": np.asarray(s.mins),
                         "maxs": np.asarray(s.maxs),
                         "counts": np.asarray(s.counts)}
                     for n, s in c.smas.items()},
            "epochs": np.asarray(c.epochs), "n_rows": int(c.n_rows),
            "partition_key": None if c.partition_key is None
            else int(c.partition_key),
            "local_segment": int(c.local_segment)}
            for c in st.containers),
        "delete_vectors": {int(cid): tuple({
            "container_id": int(dv.container_id),
            "positions": np.asarray(dv.positions),
            "delete_epochs": np.asarray(dv.delete_epochs),
            "stored": _column_state(dv.stored)} for dv in dvs)
            for cid, dvs in st.delete_vectors.items()},
        "wos": {"projection": w.projection,
                "data": {c: tuple(np.asarray(a) for a in v)
                         for c, v in w.data.items()},
                "epochs": tuple(np.asarray(e) for e in w.epochs),
                "local_segments": tuple(np.asarray(s)
                                        for s in w.local_segments),
                "rings": tuple(None if r is None else np.asarray(r)
                               for r in w.rings),
                "version": int(w.version)},
        "wos_delete_epochs": tuple(np.asarray(e)
                                   for e in st.wos_delete_epochs)}


def state_of(db) -> Dict[str, Any]:
    """The stored state of a database as plain Python and numpy."""
    cat = db.catalog
    ep = db.epochs
    return {
        "block_rows": int(db.block_rows),
        "cache_budget_bytes": int(db.block_cache.budget_bytes),
        "exec_mode": str(db.exec_mode),
        "max_failover_retries": int(db.max_failover_retries),
        "catalog": {
            "n_nodes": int(cat.n_nodes), "k_safety": int(cat.k_safety),
            "version_epoch": int(cat.version_epoch),
            "tables": {name: {
                "name": e.schema.name,
                "columns": tuple((c.name, c.sql_type.value, bool(c.nullable))
                                 for c in e.schema.columns),
                "partition_by": e.schema.partition_by,
                "partition_expr": None if e.partition_expr is None
                else tuple(e.partition_expr)}
                for name, e in cat.tables.items()},
            "projections": tuple(_projection_state(p)
                                 for p in cat.projections.values())},
        "epochs": {"current_epoch": int(ep.current_epoch),
                   "ahm": int(ep.ahm),
                   "lge": tuple((p, int(n), int(e))
                                for (p, n), e in ep.lge.items()),
                   "pins": tuple((int(e), int(k))
                                 for e, k in ep.pins.items())},
        "nodes": tuple({
            "id": int(n.id), "up": bool(n.up),
            "stale_since": n.stale_since, "recovering": bool(n.recovering),
            "rejoin_epoch": n.rejoin_epoch,
            "last_recovery": {k: int(v) for k, v in n.last_recovery.items()},
            "stores": {name: _store_state(st)
                       for name, st in n.stores.items()}}
            for n in db.nodes),
    }


# ---------------------------------------------------------------- import --

def _column(s) -> Optional[EncodedColumn]:
    if s is None:
        return None
    return EncodedColumn(Encoding(s["encoding"]), SQLType(s["sql_type"]),
                         s["n_rows"], s["block_rows"], dict(s["arrays"]),
                         s["valid"], s["packed_bytes"],
                         inner=_column(s["inner"]), scale=s["scale"],
                         widths=dict(s["widths"]))


def _projection(s) -> ProjectionDef:
    seg = SegmentationSpec(**s["segmentation"])
    pj = None if s["prejoin"] is None else PrejoinSpec(**s["prejoin"])
    return ProjectionDef(
        name=s["name"], anchor=s["anchor"], columns=tuple(s["columns"]),
        sort_order=tuple(s["sort_order"]), segmentation=seg,
        encodings={c: Encoding(e) for c, e in s["encodings"].items()},
        is_super=s["is_super"], buddy_of=s["buddy_of"], prejoin=pj)


def _store(s, proj: ProjectionDef, cache) -> ProjectionStore:
    w = s["wos"]
    wos = WOS(w["projection"],
              data={c: list(v) for c, v in w["data"].items()},
              epochs=list(w["epochs"]),
              local_segments=list(w["local_segments"]),
              rings=list(w["rings"]), version=w["version"])
    containers = [ROSContainer(
        c["id"], c["projection"],
        {n: _column(col) for n, col in c["columns"].items()},
        {n: ColumnSMA(m["mins"], m["maxs"], m["counts"])
         for n, m in c["smas"].items()},
        c["epochs"], c["n_rows"], c["partition_key"], c["local_segment"])
        for c in s["containers"]]
    dvs = {cid: [DeleteVector(d["container_id"], d["positions"],
                              d["delete_epochs"], _column(d["stored"]))
                 for d in lst]
           for cid, lst in s["delete_vectors"].items()}
    return ProjectionStore(proj, wos, containers, dvs,
                           list(s["wos_delete_epochs"]), cache=cache)


def database_from_state(state: Dict[str, Any], device="cuda") -> VerticaDB:
    """Build the port's VerticaDB from ``state_of`` output."""
    cs = state["catalog"]
    db = VerticaDB(n_nodes=cs["n_nodes"], k_safety=cs["k_safety"],
                   block_rows=state["block_rows"],
                   cache_budget_bytes=state["cache_budget_bytes"],
                   device=device)
    db.exec_mode = state["exec_mode"]
    db.max_failover_retries = state["max_failover_retries"]
    cat = Catalog(n_nodes=cs["n_nodes"], k_safety=cs["k_safety"],
                  version_epoch=cs["version_epoch"])
    for name, t in cs["tables"].items():
        schema = TableSchema(t["name"], tuple(
            ColumnDef(n, SQLType(ty), nullable)
            for n, ty, nullable in t["columns"]), t["partition_by"])
        cat.tables[name] = TableEntry(schema, t["partition_expr"])
    for p in cs["projections"]:
        cat.projections[p["name"]] = _projection(p)
    db.catalog = cat
    es = state["epochs"]
    db.epochs = EpochManager(
        current_epoch=es["current_epoch"], ahm=es["ahm"],
        lge={(p, n): e for p, n, e in es["lge"]},
        pins=Counter({e: k for e, k in es["pins"]}))
    max_id = 0
    db.nodes = []
    for ns in state["nodes"]:
        node = NodeState(ns["id"], up=ns["up"],
                         stale_since=ns["stale_since"],
                         recovering=ns["recovering"],
                         rejoin_epoch=ns["rejoin_epoch"],
                         last_recovery=dict(ns["last_recovery"]))
        for name, st in ns["stores"].items():
            store = _store(st, cat.projections[name], db.block_cache)
            node.stores[name] = store
            max_id = max([max_id] + [c.id for c in store.containers])
        db.nodes.append(node)
    # containers built from here on must not reuse a carried id: the
    # block cache keys device blocks by container id
    nxt = next(storage_mod._next_container_id)
    storage_mod._next_container_id = itertools.count(max(nxt, max_id + 1))
    return db
