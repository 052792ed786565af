"""The database facade: a simulated shared-nothing cluster with the paper's
transaction, distribution and availability semantics.

* N logical nodes, each holding per-projection physical state
  (WOS + ROS containers + delete vectors).
* Quorum commit without 2PC (paper §5): a commit succeeds iff >= N/2+1
  nodes are up; nodes that miss a commit are marked stale and must recover.
* K-safety (paper §5.3): every segmented projection gets a ring-offset
  buddy; reads route around down nodes via buddies; losing every replica of
  a segment (or quorum) shuts the database down.
* Inserts are transactional: data is staged per txn and becomes a WOS (or
  direct-ROS) write only at commit, with the commit epoch -- rollback simply
  discards the staging, exactly the paper's 'discard ROS/WOS created by the
  transaction'.
* Deletes create delete vectors; UPDATE = DELETE + INSERT. No in-place
  modification anywhere.

Mirrors ``src/repro/core/database.py`` with these changes: the database
holds the torch ``device`` its block cache and queries use (``"cuda"`` by
default; asking for CUDA without a GPU raises), ``query()`` returns the
port's QueryBuilder, and ``serve()`` raises NotImplementedError until the
slice that brings it (ROADMAP.md queue 1 item 8).  ``attach_mesh()`` takes
a mesh of the port (distributed/mesh.py): logical shards on one device.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .block_cache import BlockCache, KIND_SEG, KIND_WOS
from .catalog import Catalog, TableEntry
from .epochs import EpochManager
from .faults import (NULL_INJECTOR, FaultInjector, NodeCrashError,
                     TransientFaultError, fire_with_retries)
from .locks import LockManager
from .projection import ProjectionDef, super_projection
from .segmentation import SegmentationSpec
from .storage import DeleteVector, ROSContainer, WOS
from .tuple_mover import (ProjectionStore, mergeout, moveout,
                          run_tuple_mover)
from .types import SQLType, TableSchema

_txn_ids = itertools.count(1)


class AvailabilityError(Exception):
    """Quorum lost or a segment has no live replica: database shutdown."""


class SegmentUnavailableError(AvailabilityError):
    """Every replica of one or more segments is down.  Carries exactly
    which ring segments are unserveable (and at which epoch, when known)
    so callers degrade loudly and precisely, never silently."""

    def __init__(self, projection: str, segments: Sequence[int], *,
                 epoch: Optional[int] = None, reason: str = ""):
        self.projection = projection
        self.segments: Tuple[int, ...] = tuple(sorted(set(segments)))
        self.epoch = epoch
        msg = (f"segment(s) {list(self.segments)} of {projection} "
               f"unavailable")
        if epoch is not None:
            msg += f" at epoch {epoch}"
        if reason:
            msg += f" ({reason})"
        super().__init__(msg)


class RecoverySourceLostError(AvailabilityError):
    """A recovering node's replay source is gone: recovery cannot
    complete.  The node STAYS in recovering state (its segments keep
    routing to whatever buddies remain; a later ``recover_node`` retry
    may succeed).  Carries which projections could not replay, the
    segments affected, and the epoch window (lge, rejoin] still owed."""

    def __init__(self, node: int,
                 projections: Dict[str, Tuple[int, ...]], *,
                 window: Optional[Tuple[int, int]] = None):
        self.node = node
        self.projections = dict(projections)
        self.segments: Tuple[int, ...] = tuple(sorted(
            {s for segs in self.projections.values() for s in segs}))
        self.window = window
        msg = (f"node {node} recovery incomplete: no replay source for "
               f"{sorted(self.projections)} (segments "
               f"{list(self.segments)})")
        if window is not None:
            msg += f", epochs ({window[0]}, {window[1]}] unreplayed"
        super().__init__(msg)


class QueryRejectedError(AvailabilityError):
    """A query exhausted its failover/retry budget.  The pinned snapshot
    epoch and attempt count ride along so the caller knows exactly what
    was refused -- the refusal is the guarantee: never a wrong answer."""

    def __init__(self, reason: str, *, epoch: Optional[int] = None,
                 attempts: int = 0,
                 segments: Sequence[int] = ()):
        self.reason = reason
        self.epoch = epoch
        self.attempts = attempts
        self.segments = tuple(segments)
        msg = f"query rejected: {reason}"
        if epoch is not None:
            msg += f" (pinned epoch {epoch}, {attempts} failover(s))"
        super().__init__(msg)


class TxnError(Exception):
    pass


@dataclasses.dataclass
class NodeState:
    id: int
    up: bool = True
    stores: Dict[str, ProjectionStore] = dataclasses.field(
        default_factory=dict)
    # commits missed while down (drives recovery)
    stale_since: Optional[int] = None
    # rejoined but not yet recovered: the node RECEIVES new commits (so it
    # stops falling further behind) but serves no reads -- the planner
    # routes its segments to the buddy until recover_node() completes
    recovering: bool = False
    rejoin_epoch: Optional[int] = None
    # incremental-recovery telemetry (core/recovery.py)
    last_recovery: Dict[str, int] = dataclasses.field(default_factory=dict)

    def serving(self) -> bool:
        return self.up and not self.recovering


@dataclasses.dataclass
class Txn:
    id: str
    # (projection, node) -> staged row dict
    staged: Dict[Tuple[str, int], Dict[str, np.ndarray]] = \
        dataclasses.field(default_factory=dict)
    staged_segments: Dict[Tuple[str, int], np.ndarray] = \
        dataclasses.field(default_factory=dict)
    # (projection, node) -> segmentation ring value per staged row (None
    # for replicated projections); stamped onto the WOS at commit so the
    # segmented executor slabs trickle loads per device shard directly
    staged_rings: Dict[Tuple[str, int], Optional[np.ndarray]] = \
        dataclasses.field(default_factory=dict)
    deletes: List[Tuple[str, Callable]] = dataclasses.field(
        default_factory=list)
    direct_to_ros: bool = False


class VerticaDB:
    def __init__(self, n_nodes: int = 4, k_safety: int = 1,
                 block_rows: int = 256,
                 cache_budget_bytes: int = 256 << 20,
                 device="cuda"):
        assert k_safety in (0, 1)
        import torch
        # every block-cache upload, decode and operator of this database
        # puts its tensors here; CUDA without a GPU is an error, never a
        # silent fall back to the CPU
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"VerticaDB(device={device!r}): no CUDA device is "
                f"available; pass device='cpu' to run on the CPU")
        self.catalog = Catalog(n_nodes=n_nodes, k_safety=k_safety)
        self.nodes = [NodeState(i) for i in range(n_nodes)]
        self.epochs = EpochManager()
        self.locks = LockManager()
        self.block_rows = block_rows
        # device-resident block cache, shared by every store of this DB
        # (our HBM analog of Vertica leaning on the OS page cache)
        self.block_cache = BlockCache(cache_budget_bytes)
        # mesh for the segmented executor (engine/segmented.py);
        # None = single-device execution
        self.mesh = None
        self.mesh_axis = "data"
        # compressed-domain execution policy (engine/compressed.py):
        #   "auto"       -- code-domain scan only when the decoded working
        #                   set is not already device-resident
        #   "compressed" -- always, when the plan is eligible
        #   "decoded"    -- never (the legacy decode-then-filter scan)
        self.exec_mode = "auto"
        # fault injection (core/faults.py): a no-op NullInjector unless a
        # test/chaos harness opts in via enable_faults(seed=...)
        self.faults = NULL_INJECTOR
        # bounded mid-query failover budget (engine/pipeline.py): how many
        # node-crash replans a single query absorbs before rejecting
        self.max_failover_retries = 2

    # ------------------------------------------------------------- DDL --

    def create_table(self, schema: TableSchema, *,
                     sort_order: Optional[Sequence[str]] = None,
                     segment_by: Optional[Sequence[str]] = None,
                     partition_by: Optional[Tuple[str, str]] = None):
        self.catalog.add_table(schema, partition_by)
        cols = schema.column_names()
        sp = super_projection(schema, tuple(sort_order or cols[:1]),
                              tuple(segment_by or ()))
        self.create_projection(sp)

    def create_projection(self, proj: ProjectionDef, *,
                          populate: bool = False):
        self.catalog.add_projection(proj)
        self._init_stores(proj)
        buddy = None
        if self.catalog.k_safety >= 1 and not proj.segmentation.replicated \
                and proj.buddy_of is None:
            buddy = proj.buddy_def()
            self.catalog.add_projection(buddy)
            self._init_stores(buddy)
        if populate:
            from .recovery import refresh_projection
            refresh_projection(self, proj.name)
            if buddy is not None:
                refresh_projection(self, buddy.name)

    def _init_stores(self, proj: ProjectionDef):
        for node in self.nodes:
            node.stores[proj.name] = ProjectionStore(
                proj, WOS(proj.name), cache=self.block_cache)

    # ----------------------------------------------------------- query --

    def attach_mesh(self, mesh=None, axis: str = "data"):
        """Route aggregate queries through the segmented executor
        (engine/segmented.py).  With no argument, builds a query mesh of
        one logical shard per visible device of ``self.device``'s kind
        (distributed/mesh.py).  Tuple-to-shard ownership follows each
        projection's SegmentationSpec hash ring
        (core/segmentation.shard_of)."""
        if mesh is None:
            from ..distributed.mesh import make_query_mesh
            mesh = make_query_mesh(axis=axis, device=self.device)
        elif mesh.device.type != self.device.type:
            raise ValueError(f"attach_mesh: a mesh on {mesh.device} for a "
                             f"database on {self.device}")
        self.mesh, self.mesh_axis = mesh, axis
        return mesh

    def detach_mesh(self):
        """Back to single-device execution."""
        self.mesh = None

    # ---------------------------------------------------------- faults --

    def enable_faults(self, seed: Optional[int] = None,
                      **cfg) -> FaultInjector:
        """Attach a seeded deterministic fault injector (core/faults.py);
        schedules registered on the returned injector fire at the named
        injection points threaded through commit, tuple mover, recovery
        and the segmented executor."""
        self.faults = FaultInjector(self, seed=seed, **cfg)
        return self.faults

    def disable_faults(self) -> None:
        self.faults = NULL_INJECTOR

    def query(self, table: str):
        """Fluent relational front-end (engine/builder.py):
        ``db.query("fact").where(...).join(...).group_by(...).agg(...)
        .collect()``.  Lowers to the logical-plan IR consumed by planner
        and executor."""
        if table not in self.catalog.tables:
            raise KeyError(f"unknown table {table!r}")
        from ..engine.builder import QueryBuilder
        return QueryBuilder(self, table)

    def serve(self, **kw):
        """Multi-tenant serving front door (admission control, priority
        queues, shared scans): not ported yet."""
        raise NotImplementedError(
            "serve: the serving layer is not ported yet (ROADMAP.md "
            "queue 1 item 8)")

    # ------------------------------------------------------------- txn --

    def begin(self, *, direct_to_ros: bool = False) -> Txn:
        return Txn(f"txn{next(_txn_ids)}", direct_to_ros=direct_to_ros)

    def _sql_types(self, proj: ProjectionDef) -> Dict[str, SQLType]:
        schema = self.catalog.tables[proj.anchor].schema
        out = {}
        for c in proj.columns:
            if c in schema:
                out[c] = schema.column(c).sql_type
            else:  # prejoined dimension column
                out[c] = SQLType.INT
        return out

    def insert(self, txn: Txn, table: str, data: Dict[str, np.ndarray]):
        """Stage rows for every projection of the table (lock mode I)."""
        self.locks.acquire(table, txn.id, "I")
        n = len(next(iter(data.values())))
        for proj in self.catalog.projections_of(table):
            pdata = self._project_rows(proj, data)
            if proj.segmentation.replicated:
                placements = [(node.id, np.zeros(n, np.int32))
                              for node in self.nodes]
                sel_all = np.ones(n, bool)
                for node_id, segs in placements:
                    self._stage(txn, proj.name, node_id, pdata, sel_all,
                                segs, None)
            else:
                nodes, segs, ring = proj.segmentation.place_with_ring(
                    pdata, self.catalog.n_nodes)
                for node_id in np.unique(nodes):
                    sel = nodes == node_id
                    self._stage(txn, proj.name, int(node_id), pdata, sel,
                                segs[sel], ring[sel])

    def _project_rows(self, proj: ProjectionDef,
                      data: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        if proj.prejoin is None:
            return {c: np.asarray(data[c]) for c in proj.columns}
        # prejoin projection: join fact rows with the dimension table at load
        pj = proj.prejoin
        dim = self.read_table(pj.dim_table)
        keys = np.asarray(dim[pj.dim_key])
        order = np.argsort(keys)
        idx = order[np.searchsorted(keys[order], np.asarray(
            data[pj.anchor_key]))]
        out = {}
        for c in proj.columns:
            if "." in c:
                dcol = c.split(".", 1)[1]
                out[c] = np.asarray(dim[dcol])[idx]
            else:
                out[c] = np.asarray(data[c])
        return out

    def _stage(self, txn: Txn, proj: str, node_id: int,
               data: Dict[str, np.ndarray], sel: np.ndarray,
               segs: np.ndarray, ring: Optional[np.ndarray]):
        key = (proj, node_id)
        sub = {c: v[sel] for c, v in data.items()}
        if key in txn.staged:
            txn.staged[key] = {c: np.concatenate([txn.staged[key][c],
                                                  sub[c]]) for c in sub}
            txn.staged_segments[key] = np.concatenate(
                [txn.staged_segments[key], segs])
            prev = txn.staged_rings[key]
            txn.staged_rings[key] = None if prev is None or ring is None \
                else np.concatenate([prev, ring])
        else:
            txn.staged[key] = sub
            txn.staged_segments[key] = segs
            txn.staged_rings[key] = ring

    def delete(self, txn: Txn, table: str,
               predicate: Callable[[Dict[str, np.ndarray]], np.ndarray]):
        self.locks.acquire(table, txn.id, "X")
        txn.deletes.append((table, predicate))

    def update(self, txn: Txn, table: str, predicate,
               assign: Dict[str, np.ndarray or Callable]):
        """UPDATE = DELETE matching rows + INSERT updated copies (§3.7.1)."""
        rows = self.read_table(table)
        mask = predicate(rows)
        self.delete(txn, table, predicate)
        new = {c: np.asarray(v[mask]).copy() for c, v in rows.items()}
        for c, v in assign.items():
            new[c] = v(new) if callable(v) else np.full(
                int(mask.sum()), v, new[c].dtype)
        self.insert(txn, table, new)

    def commit(self, txn: Txn, *, fail_nodes_during_commit: Sequence[int]
               = ()) -> int:
        """Quorum commit without 2PC. Nodes failing mid-commit are ejected
        and must recover; the commit succeeds iff a quorum remains."""
        for nid in fail_nodes_during_commit:
            self.fail_node(nid)
        up = [n for n in self.nodes if n.up]
        quorum = self.catalog.n_nodes // 2 + 1
        if len(up) < quorum:
            self.locks.release_all(txn.id)
            raise AvailabilityError(
                f"quorum lost: {len(up)}/{self.catalog.n_nodes} up, "
                f"need {quorum}")
        # ---- phase 1: every up staged node acknowledges the commit.
        # This is the only window injected crashes / transient ejections
        # can land in, and NO state has mutated yet -- so a commit refused
        # below aborts cleanly and can simply be retried after repair.
        for (proj_name, node_id) in txn.staged:
            node = self.nodes[node_id]
            if not node.up:
                continue
            try:
                fire_with_retries(self, "commit.apply", node=node_id,
                                  projection=proj_name)
            except NodeCrashError:
                pass  # the crashed node misses the commit; survivors
                #       proceed (quorum is re-checked below)
            except TransientFaultError:
                # a node that cannot acknowledge a commit after the retry
                # budget is ejected (paper §5: it must recover)
                self.fail_node(node_id)
        up = [n for n in self.nodes if n.up]
        if len(up) < quorum:
            self.locks.release_all(txn.id)
            raise AvailabilityError(
                f"quorum lost during commit: {len(up)}/"
                f"{self.catalog.n_nodes} up, need {quorum}")
        # ---- redundancy check: every staged row set must still have at
        # least one live home.  Committing past this would silently DROP
        # the rows of any segment whose every copy-holder died above --
        # refuse the whole commit instead (typed, nothing applied).
        lost = self._staged_segments_without_live_copy(txn)
        if lost:
            proj_name, segs = lost
            self.locks.release_all(txn.id)
            raise SegmentUnavailableError(
                proj_name, segs, epoch=self.epochs.latest_queryable(),
                reason="commit refused: every copy-holder of these "
                       "staged segments is down")
        # ---- phase 2: apply (survivors only; failed nodes' misses are
        # replayed by incremental recovery from their buddies)
        epoch = self.epochs.advance()  # auto-advance on DML commit (§5.1)
        # deletes first: they target rows visible BEFORE this commit, so an
        # UPDATE's re-inserted rows are not swallowed by its own delete
        for table, predicate in txn.deletes:
            self._apply_delete(table, predicate, epoch)
        for (proj_name, node_id), data in txn.staged.items():
            node = self.nodes[node_id]
            if not node.up:
                continue  # node missed the commit; recovery will replay
            store = node.stores[proj_name]
            segs = txn.staged_segments[(proj_name, node_id)]
            ring = txn.staged_rings.get((proj_name, node_id))
            if txn.direct_to_ros:
                self._direct_ros(store, data, epoch, segs)
            else:
                store.wos.append(data, epoch, segs, ring=ring)
                n = len(segs)
                store.wos_delete_epochs.append(np.zeros(n, np.int64))
        # stream the fresh WOS batches into their per-shard device buffers
        # while the rows are hot: a trickle-load commit pre-pays the
        # segmented executor's delta slab, so the next query only uploads
        # a visibility mask (engine/segmented.prewarm_wos_buffer; no-op
        # without an attached mesh)
        if self.mesh is not None and not txn.direct_to_ros:
            from ..engine.segmented import prewarm_wos_buffer
            for (proj_name, node_id) in txn.staged:
                prewarm_wos_buffer(self, node_id, proj_name)
        self.locks.release_all(txn.id)
        return epoch

    def _staged_segments_without_live_copy(self, txn: Txn):
        """Segments whose EVERY staged copy-holder is down (so committing
        would lose their rows outright).  Returns (primary projection
        name, sorted segment list) for the affected projection, or None.
        Replicated projections are covered by the quorum check; K=0
        projections have no second copy, so a down owner is fatal.
        Up-but-recovering nodes count as live homes: they receive every
        commit from the moment they rejoin."""
        lost: Dict[str, set] = {}
        for (proj_name, node_id) in txn.staged:
            if self.nodes[node_id].up:
                continue
            proj = self.catalog.projections[proj_name]
            if proj.segmentation.replicated:
                continue
            if proj.buddy_of is not None:
                seg = (node_id - proj.segmentation.offset) \
                    % self.catalog.n_nodes
                partner = (proj.buddy_of, seg)
                primary = proj.buddy_of
            else:
                seg = node_id
                primary = proj_name
                buddy = self.catalog.projections.get(proj_name + "_b1")
                partner = None if buddy is None else \
                    (buddy.name,
                     (node_id + buddy.segmentation.offset)
                     % self.catalog.n_nodes)
            if partner is None or partner not in txn.staged \
                    or not self.nodes[partner[1]].up:
                lost.setdefault(primary, set()).add(seg)
        if not lost:
            return None
        primary = sorted(lost)[0]
        return primary, sorted(lost[primary])

    def rollback(self, txn: Txn):
        txn.staged.clear()
        txn.staged_segments.clear()
        txn.staged_rings.clear()
        txn.deletes.clear()
        self.locks.release_all(txn.id)

    def _direct_ros(self, store: ProjectionStore, data, epoch: int,
                    segs: np.ndarray):
        """Bulk loads tagged direct-to-ROS (§7): skip the WOS entirely."""
        entry = self.catalog.tables[store.proj.anchor]
        tmp = ProjectionStore(store.proj, WOS(store.proj.name))
        tmp.wos.append(data, epoch, segs)
        tmp.wos_delete_epochs.append(np.zeros(len(segs), np.int64))
        new = moveout(tmp, sql_types=self._sql_types(store.proj),
                      ahm=self.epochs.ahm,
                      partition_expr=entry.partition_expr,
                      block_rows=self.block_rows)
        store.containers.extend(new)
        for c in new:
            if c.id in tmp.delete_vectors:
                store.delete_vectors[c.id] = tmp.delete_vectors[c.id]
        if new:
            # slabs built before this bulk load never match again (the
            # container set grew): free their HBM now, precisely
            store.invalidate_seg_slabs(require_ids=[c.id for c in new])

    def _apply_delete(self, table: str, predicate, epoch: int):
        for proj in self.catalog.projections_of(table):
            for node in self.nodes:
                if not node.up:
                    continue
                store = node.stores[proj.name]
                for c in store.containers:
                    rows = c.decode_all()
                    try:
                        m = predicate(rows)
                    except KeyError:
                        continue  # projection lacks predicate columns
                    m &= ~store.deleted_mask(c)
                    pos = np.flatnonzero(m)
                    if pos.size:
                        store.delete_vectors.setdefault(c.id, []).append(
                            DeleteVector.build(
                                c.id, pos,
                                np.full(pos.size, epoch, np.int64)).to_ros())
                        # evict cached blocks of a container whose delete
                        # state changed (visibility is epoch-keyed, but
                        # eager eviction keeps DV rewrites honest)
                        store.invalidate_cached([c.id])
                data, eps, _ = store.wos.snapshot()
                if len(eps):
                    try:
                        m = predicate(data)
                    except KeyError:
                        continue
                    cur = (np.concatenate(store.wos_delete_epochs)
                           if store.wos_delete_epochs
                           else np.zeros(len(eps), np.int64))
                    cur = np.where(m & (cur == 0), epoch, cur)
                    store.wos_delete_epochs = [cur]
                    # WOS content-version covers delete state too: the
                    # segmented executor's device WOS buffers key on it
                    store.wos.version += 1

    # ----------------------------------------------------------- reads --

    def segment_owners(self, proj: ProjectionDef) -> Dict[int, str]:
        """ring-node -> projection (primary or buddy) that can serve it
        from a live node.  Raises SegmentUnavailableError carrying the
        COMPLETE set of lost segments (not just the first) when any
        segment has no serving replica."""
        owners = {}
        lost: List[int] = []
        buddy_name = proj.name + "_b1"
        buddy = self.catalog.projections.get(buddy_name)
        for seg_node in range(self.catalog.n_nodes):
            # a recovering node receives commits but serves no reads: its
            # segments route to the buddy until recover_node() completes
            if self.nodes[seg_node].serving():
                owners[seg_node] = proj.name
            elif buddy is not None:
                # the buddy stores segment s on node (s + offset) % N
                host = (seg_node + buddy.segmentation.offset) % \
                    self.catalog.n_nodes
                if self.nodes[host].serving():
                    owners[seg_node] = buddy_name
                else:
                    lost.append(seg_node)
            else:
                lost.append(seg_node)
        if lost:
            raise SegmentUnavailableError(
                proj.name, lost,
                epoch=self.epochs.latest_queryable(),
                reason="" if buddy is not None else "K=0, no buddy")
        return owners

    def read_projection(self, proj_name: str, *,
                        as_of: Optional[int] = None,
                        include_wos: bool = True) -> Dict[str, np.ndarray]:
        """Snapshot read of all visible rows (host-side; the EE uses
        container-level access instead, see engine/)."""
        proj = self.catalog.projections[proj_name]
        as_of = as_of if as_of is not None else self.epochs.latest_queryable()
        if proj.segmentation.replicated:
            first_up = next((n.id for n in self.nodes if n.serving()), None)
            if first_up is None:
                raise SegmentUnavailableError(
                    proj_name, range(self.catalog.n_nodes), epoch=as_of,
                    reason="no serving replica")
            sources = [(first_up, proj_name)]
        else:
            owners = self.segment_owners(proj)
            sources = []
            for seg_node, owner_proj in owners.items():
                host = seg_node
                if owner_proj != proj_name:
                    host = (seg_node + self.catalog.projections[
                        owner_proj].segmentation.offset) % \
                        self.catalog.n_nodes
                # one host may serve several segments (its own via the
                # primary AND a down neighbor's via the buddy store)
                if (host, owner_proj) not in sources:
                    sources.append((host, owner_proj))
        parts = []
        for host, owner_proj in sources:
            store = self.nodes[host].stores[owner_proj]
            parts.extend(self._store_rows(store, as_of, include_wos))
        if not parts:
            return {c: np.zeros(0, np.int64) for c in proj.columns}
        return {c: np.concatenate([p[c] for p in parts])
                for c in proj.columns}

    def _store_rows(self, store: ProjectionStore, as_of: int,
                    include_wos: bool) -> List[Dict[str, np.ndarray]]:
        out = []
        for c in store.containers:
            vis = (c.epochs <= as_of) & ~store.deleted_mask(c, as_of)
            if vis.any():
                rows = c.decode_all()
                out.append({k: v[vis] for k, v in rows.items()})
        if include_wos:
            data, eps, _ = store.wos.snapshot()
            if len(eps):
                dels = (np.concatenate(store.wos_delete_epochs)
                        if store.wos_delete_epochs
                        else np.zeros(len(eps), np.int64))
                vis = (eps <= as_of) & ~((dels > 0) & (dels <= as_of))
                if vis.any():
                    out.append({k: v[vis] for k, v in data.items()})
        return out

    def read_table(self, table: str, *,
                   as_of: Optional[int] = None) -> Dict[str, np.ndarray]:
        return self.read_projection(self.catalog.super_of(table).name,
                                    as_of=as_of)

    # ----------------------------------------------- maintenance / ops --

    def run_tuple_mover(self, *, force_moveout: bool = False,
                        do_mergeout: bool = True):
        stats = {"moveouts": 0, "mergeouts": 0}
        for node in self.nodes:
            if not node.serving():
                continue
            try:
                for store in node.stores.values():
                    entry = self.catalog.tables[store.proj.anchor]
                    # injection points fire BEFORE the pass touches the
                    # store: a crash here simply skips this node's moves
                    # (the tuple mover is opportunistic, §4.2)
                    self.faults.fire("tuple_mover.moveout", node=node.id,
                                     projection=store.proj.name)
                    if do_mergeout:
                        self.faults.fire("tuple_mover.mergeout",
                                         node=node.id,
                                         projection=store.proj.name)
                    self.locks.acquire(store.proj.anchor,
                                       f"tm-{node.id}", "U")
                    try:
                        s = run_tuple_mover(
                            store, sql_types=self._sql_types(store.proj),
                            ahm=self.epochs.ahm,
                            partition_expr=entry.partition_expr,
                            wos_row_limit=0 if force_moveout else 8192,
                            block_rows=self.block_rows,
                            do_mergeout=do_mergeout)
                        stats["moveouts"] += s["moveouts"]
                        stats["mergeouts"] += s["mergeouts"]
                    finally:
                        self.locks.release_all(f"tm-{node.id}")
                    # LGE semantics (§5.1): it may only advance to the
                    # newest epoch FULLY persisted in ROS -- rows still in
                    # the WOS are lost on failure, so epochs buffered
                    # there cap it
                    _, wos_eps, _ = store.wos.snapshot()
                    if len(wos_eps):
                        lge = int(wos_eps.min()) - 1
                    else:
                        lge = self.epochs.latest_queryable()
                    self.epochs.set_lge(store.proj.name, node.id, lge)
            except NodeCrashError:
                continue            # a node died mid-pass; survivors go on
            except TransientFaultError:
                continue            # node skipped this pass; next run moves
        # recovering/down nodes gate the AHM: their LGE must not advance
        # (they are still missing history) and the AHM must keep the
        # epochs they will replay.  Computed HERE, after the pass -- a
        # node crashing mid-pass (fault injection) must gate it too.
        any_down = any(not n.serving() for n in self.nodes)
        self.epochs.advance_ahm(nodes_down=any_down)
        return stats

    def drop_partition(self, table: str, partition_key: int):
        """Fast bulk delete: drop whole containers (lock mode O, §3.5)."""
        self.locks.acquire(table, "ddl", "O")
        try:
            for proj in self.catalog.projections_of(table):
                for node in self.nodes:
                    store = node.stores[proj.name]
                    drop = [c for c in store.containers
                            if c.partition_key == partition_key]
                    store.containers = [c for c in store.containers
                                        if c.partition_key != partition_key]
                    store.invalidate_cached([c.id for c in drop])
                    # evict exactly the partitioned scan slabs that
                    # referenced a dropped container (keys carry the
                    # container-id set) -- other epochs/meshes stay warm
                    store.invalidate_seg_slabs(
                        retired_ids=[c.id for c in drop])
                    for c in drop:
                        store.delete_vectors.pop(c.id, None)
            # dropping containers bypasses MVCC: cached join build sides
            # of this table (engine/executor.py) are stale at EVERY epoch
            self.block_cache.invalidate_container(f"dim:{table}")
        finally:
            self.locks.release_all("ddl")

    def fail_node(self, node_id: int):
        node = self.nodes[node_id]
        if not node.up:
            return
        node.up = False
        node.recovering = False
        node.rejoin_epoch = None
        node.stale_since = self.epochs.latest_queryable()
        for store in node.stores.values():
            store.wos.clear()          # WOS is memory: lost on failure
            store.wos_delete_epochs = []
        self._evict_failed_node_slabs(node_id)

    def _evict_failed_node_slabs(self, node_id: int) -> int:
        """Evict every KIND_SEG slab whose source set references the
        failed node.  Slab keys embed (host, owner, container-ids) items
        (engine/segmented._source_sig); a slab sourced from the dead
        node's placement predates the failover routing and a warm hit on
        it would silently serve a pre-failure mesh identity."""

        def references_node(key) -> bool:
            _, col, kind = key
            if kind == KIND_WOS:
                # (("wos", version, mesh_sig), host, owner): the buffer
                # is one store's rows -- the dead node's are gone with it
                try:
                    return col[1] == node_id
                except (TypeError, IndexError):
                    return True
            if kind != KIND_SEG:
                return False
            if not (isinstance(col, tuple) and len(col) >= 3):
                return True          # unknown key shape: evict, stay safe
            try:
                items = col[2][0]
                return any(host == node_id for host, _owner, _ids in items)
            except (TypeError, ValueError, IndexError):
                return True
        n = 0
        for proj in self.catalog.projections.values():
            if proj.buddy_of is not None:
                continue             # slabs are namespaced by the primary
            n += self.block_cache.invalidate_where(
                f"seg:{proj.name}", references_node)
        return n

    def rejoin_node(self, node_id: int):
        """Bring a failed node back ONLINE but not yet SERVING: it starts
        receiving new commits immediately (so it stops falling behind)
        while reads keep routing to its buddy; ``recovery.recover_node``
        then replays only the epochs it missed while down
        (LGE, rejoin_epoch] and flips it back to serving (paper §4.4)."""
        from .recovery import rejoin_node
        return rejoin_node(self, node_id)

    # epoch ceilings: the newest epoch that can affect a store's (or a
    # table's) visible state.  Epoch-keyed caches clamp a query's as-of to
    # this ceiling, so trickle-load commits elsewhere in the cluster do
    # not invalidate entries whose underlying data did not change.

    def table_epoch_ceiling(self, table: str, *,
                            include_wos: bool = True) -> int:
        proj = self.catalog.super_of(table)
        return max((node.stores[proj.name].epoch_ceiling(
            include_wos=include_wos)
            for node in self.nodes if proj.name in node.stores),
            default=0)

    def storage_report(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for proj in self.catalog.projections.values():
            total = raw = n = nc = 0
            for node in self.nodes:
                st = node.stores[proj.name]
                total += sum(c.storage_bytes() for c in st.containers)
                raw += sum(c.raw_bytes() for c in st.containers)
                n += st.ros_rows()
                nc += len(st.containers)
            out[proj.name] = {"rows": n, "containers": nc,
                              "stored_bytes": total, "raw_bytes": raw,
                              "ratio": raw / total if total else 0.0}
        return out
