"""Query pipeline: logical IR -> chosen plan -> execution (paper §6).

Mirrors ``src/repro/engine/pipeline.py`` for single-node execution.  The
front-end is the logical-plan IR (engine/logical.py); the planner
(planner/planner.py) picks the projection, per-join strategy, SIP filters
and the GroupBy algorithm; this module runs the physical plan over a
VerticaDB's live nodes on ``db.device`` and returns numpy results.

Routes, in order: the segmented executor over a query mesh
(engine/segmented.py; when a mesh is passed or attached, for the shapes of
its subset), the scalar COUNT on RLE runs (host numpy), the RLE-direct
GROUP BY (the ``rle_grouped_agg`` kernel), the cached fused warm path
(engine/executor.py), and the general path -- taken when WOS rows are
pending or the shape is outside the fused subset -- which scans, joins,
filters and groups step by step.

Composite group-by keys are packed into one dense integer domain
(operators.pack_keys) so the single-key GroupBy machinery applies
unchanged; keys unpack on the (small) output.  Runtime algorithm
switching (§6.1): dense falls back to sort when the observed key domain
exceeds the table budget, and to a host-side unique-based GroupBy when
even packed keys would overflow the device integer width.

DEPRECATED SHIMS: ``Query`` and ``JoinSpec`` predate the IR (one join,
one group-by column).  They remain importable from ``repro_torch.engine``
as thin constructors that lower via ``Query.to_ir()``; new code should use
``db.query(...)`` (engine/builder.py) or LogicalQuery directly.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.database import VerticaDB
from ..core.encodings import Encoding, to_device
from .expr import Expr
from .logical import LogicalJoin, LogicalQuery, as_ir
from . import executor as fused_exec
from . import operators as ops
from .sip import sip_filter

# DEPRECATED back-compat alias: JoinSpec always matched the IR's join
# shape field-for-field, so the shim IS LogicalJoin.  New code should
# spell it ``LogicalJoin`` (engine/logical.py) or -- better -- use the
# fluent ``db.query(...).join(...)`` builder (engine/builder.py).
JoinSpec = LogicalJoin

_PACK_LIMIT = 1 << 31   # packed keys live in device int32
_RLE_CALL_ROWS = 1 << 31   # rows one rle_grouped_agg call may count

_shim_warned = False


@dataclasses.dataclass(frozen=True, eq=False)
class Query:
    """DEPRECATED pre-IR front-end (single join, single group-by column),
    frozen at its first feature set.  Kept only as a thin shim for old
    call sites: ``to_ir()`` lowers to the ``LogicalQuery`` consumed
    everywhere, and ``execute``/``plan_query`` accept it transparently
    (emitting one ``DeprecationWarning`` per process).  New code should
    use the fluent builder -- ``db.query("t").where(...).join(...)
    .group_by(...).agg(...).collect()`` (engine/builder.py) -- or build
    ``LogicalQuery`` directly; both support multi-join, multi-column
    GROUP BY, derived columns, HAVING and multi-key ORDER BY, which this
    shim never will."""
    table: str
    columns: Tuple[str, ...] = ()
    predicate: Optional[Expr] = None
    join: Optional[LogicalJoin] = None
    group_by: Optional[str] = None
    aggs: Tuple[Tuple[str, str, str], ...] = ()   # (out, col, kind)
    order_by: Optional[str] = None
    descending: bool = False
    limit: Optional[int] = None

    def to_ir(self) -> LogicalQuery:
        global _shim_warned
        if not _shim_warned:
            _shim_warned = True
            import warnings
            warnings.warn(
                "repro_torch.engine.Query is a deprecated shim; use "
                "db.query(...) (engine/builder.py) or LogicalQuery",
                DeprecationWarning, stacklevel=2)
        return LogicalQuery(
            table=self.table, columns=tuple(self.columns),
            predicate=self.predicate,
            joins=(self.join,) if self.join is not None else (),
            group_by=(self.group_by,) if self.group_by else (),
            aggs=tuple(self.aggs),
            order_by=((self.order_by, self.descending),)
            if self.order_by else (),
            limit=self.limit).validate()

    def needed_columns(self) -> set:
        return self.to_ir().needed_columns()


@dataclasses.dataclass
class ExecStats:
    projection: str = ""
    groupby_algorithm: str = ""
    join_strategy: str = ""
    containers_scanned: int = 0
    blocks_pruned: int = 0
    blocks_total: int = 0
    rows_scanned: int = 0
    sip_applied: bool = False
    wall_s: float = 0.0
    frontend_s: float = 0.0         # lowering + planning time
    # warm-path telemetry (engine/executor.py)
    fused: bool = False
    plan_cache: str = ""            # "hit" / "miss" / "" (not attempted)
    block_cache_hits: int = 0
    block_cache_misses: int = 0
    # compressed-domain execution telemetry (engine/compressed.py)
    compressed_scan: bool = False   # code-domain scan + late materialization
    rows_materialized: int = 0      # survivor rows actually decoded
    # per-stage wall times of the segmented path (engine/segmented.py):
    # slab_build / exchange_join / preagg / final_merge, in milliseconds
    stage_ms: Dict[str, float] = dataclasses.field(default_factory=dict)
    # segmented-execution telemetry (engine/segmented.py)
    segmented: bool = False
    n_shards: int = 0
    exchange: str = ""              # ";"-joined per-join exchange ops
    reseg_overflow: int = 0         # tuples that hit a full exchange slot
    seg_slab: str = ""              # ROS slab "hit"/"miss", "+wos" when a
    #                                 trickle-load delta slab was appended
    snapshot_epoch: int = 0         # pinned cluster snapshot this query read
    # fault/failover telemetry (core/faults.py): failovers = mid-query
    # node crashes absorbed by replanning onto buddies at the pinned
    # epoch; fault_retries = transient-fault attempt retries; injected =
    # fault actions fired while this query ran
    failovers: int = 0
    fault_retries: int = 0
    faults_injected: int = 0


def _np(x) -> np.ndarray:
    """A tensor (on any device) or array as numpy."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def execute(db: VerticaDB, q, *, as_of: Optional[int] = None, plan=None,
            mesh=None, mesh_axis: str = "data"
            ) -> Tuple[Dict[str, np.ndarray], ExecStats]:
    """Run a logical plan (LogicalQuery, node tree, builder, or the legacy
    Query shim).  ``plan`` (from planner.plan_query) may be supplied;
    otherwise the planner is invoked.

    When a ``mesh`` is passed -- or the database has one attached
    (``db.attach_mesh()``) -- aggregate queries route through the
    segmented executor (engine/segmented.py) and fall back here for
    shapes outside its subset."""
    from ..planner.planner import plan_query

    t0 = time.time()
    q = as_ir(q)
    if plan is None:
        plan = plan_query(db, q)
    if mesh is None:
        mesh = getattr(db, "mesh", None)
        mesh_axis = getattr(db, "mesh_axis", mesh_axis)
    frontend_s = time.time() - t0
    from ..core.database import QueryRejectedError
    from ..core.faults import NodeCrashError, TransientFaultError

    stats = ExecStats(projection=plan.projection,
                      groupby_algorithm=plan.groupby_algorithm,
                      join_strategy=plan.join_strategy,
                      frontend_s=frontend_s)
    faults = getattr(db, "faults", None)
    f0 = faults.total_fired if faults is not None else 0
    # pin the cluster snapshot epoch for the query's lifetime (§5):
    # trickle-load commits advancing the epoch concurrently cannot shift
    # what this query sees, and the AHM cannot purge the history it
    # reads.  EVERYTHING past the pin -- including failover replans --
    # runs inside the try so no failure path can leak a pin.
    as_of = db.epochs.pin(as_of)
    try:
        stats.snapshot_epoch = as_of
        bc = db.block_cache.stats
        bc_h0, bc_m0 = bc.hits, bc.misses

        def _finish(out, *, final: bool = True):
            if final:
                out = _finalize(q, out)
            stats.block_cache_hits = bc.hits - bc_h0
            stats.block_cache_misses = bc.misses - bc_m0
            if faults is not None:
                stats.faults_injected = faults.total_fired - f0
            stats.wall_s = time.time() - t0
            return out, stats

        retries_left = int(getattr(db, "max_failover_retries", 2))
        while True:
            try:
                return _execute_attempt(db, q, plan, as_of, mesh,
                                        mesh_axis, stats, _finish)
            except NodeCrashError as e:
                # mid-query node failure: bounded query-level failover.
                # Replan at the SAME pinned epoch -- the planner routes
                # the dead node's segments to buddies (identical rows at
                # as_of, §4.3); exhausted redundancy surfaces the
                # planner's SegmentUnavailableError instead.
                stats.failovers += 1
                if retries_left <= 0:
                    raise QueryRejectedError(
                        f"failover budget exhausted (node {e.node} "
                        f"crashed at {e.point})",
                        epoch=as_of, attempts=stats.failovers) from e
                retries_left -= 1
                plan = plan_query(db, q)
                stats.projection = plan.projection
                stats.groupby_algorithm = plan.groupby_algorithm
                stats.join_strategy = plan.join_strategy
            except TransientFaultError as e:
                raise QueryRejectedError(
                    f"transient retry budget exhausted: {e}",
                    epoch=as_of, attempts=stats.failovers) from e
    finally:
        db.epochs.unpin(as_of)


def _execute_attempt(db: VerticaDB, q: LogicalQuery, plan, as_of: int,
                     mesh, mesh_axis: str, stats: ExecStats, _finish):
    """One execution attempt of a pinned-epoch query (the body of
    ``execute``'s failover retry loop)."""
    # --- segmented path (explicit opt-in via mesh) ---
    if mesh is not None:
        from . import segmented
        res = segmented.execute_segmented(db, q, plan, as_of, mesh,
                                          mesh_axis, stats)
        if res is not None:
            return _finish(res)

    # --- scalar COUNT directly on RLE runs (predicate on sort leader) ---
    if plan.scalar_rle:
        res = _rle_scalar_count(db, q, plan, as_of)
        if res is not None:
            stats.groupby_algorithm = "rle-scalar"
            return _finish(res)

    # --- RLE-direct fast path: aggregate on encoded data, zero decode ---
    if rle_direct_eligible(q, plan):
        res = _rle_groupby(db, q, plan, as_of)
        if res is not None:
            return _finish(res)
        stats.groupby_algorithm = "sort (rle fallback)"
        plan = dataclasses.replace(plan, groupby_algorithm="sort")

    # --- warm path: cached fused scan->join->predicate->aggregate ---
    res = fused_exec.execute_fused(db, q, plan, as_of, stats)
    if res is not None:
        stats.fused = True
        return _finish(res)

    # --- build sides + SIP (§6.1), one per join in plan order ---
    builds = fused_exec.build_join_sides(db, q, as_of)
    sips: List[Callable] = []
    for ji, spec in enumerate(q.joins):
        if plan.sip_joins and plan.sip_joins[ji]:
            sips.append(sip_filter(builds[ji][spec.dim_key],
                                   spec.fact_key))
            stats.sip_applied = True
    sip = _combine_sips(sips)

    # --- scan (SMA pruning + predicate + SIP pushed down) ---
    proj = db.catalog.projections[plan.projection]
    need = q.scan_columns(proj)
    # predicates over join outputs / derived columns defer past the scan
    scan_pred = q.scan_predicate(proj.columns)
    scans = []
    ros = fused_exec.scan_stores_batched(db, plan, sorted(need), scan_pred,
                                         sip, as_of, stats)
    if ros is not None:
        scans.append(ros)
    scans.extend(wos_scan_results(db, plan, need, scan_pred, sip, as_of))
    merged = ops.concat_scans(scans)
    if merged is None:
        return _finish(_empty_result(q))
    stats.blocks_pruned = merged.pruned_blocks
    stats.blocks_total = merged.total_blocks
    cols, valid = dict(merged.columns), merged.valid
    stats.rows_scanned = int(cols[next(iter(cols))].shape[0])

    # --- joins (in plan order; later probes may use earlier outputs) ---
    for spec, build in zip(q.joins, builds):
        cols, valid = ops.hash_join(build, spec.dim_key, cols,
                                    spec.fact_key, valid, how=spec.how)

    # --- derived projections, then any deferred predicate ---
    for name, e in q.derived:
        cols[name] = e(cols)
    if scan_pred is None and q.predicate is not None:
        valid = valid & fused_exec.as_mask(q.predicate(cols), valid)

    # --- groupby / aggregate / plain select ---
    if q.group_by or q.aggs:
        out = _run_groupby(q, plan, cols, valid, stats)
    else:
        mask = _np(valid)
        keep = set(q.columns) | {n for n, _ in q.derived}
        out = {c: _np(v)[mask] for c, v in cols.items()
               if (c in keep) or (not keep and c != "_matched")}
    return _finish(out)


def wos_scan_results(db: VerticaDB, plan, need, scan_pred, sip,
                     as_of: int) -> List[ops.ScanResult]:
    """Unencoded side-scans of every pending WOS behind ``plan.sources``
    (rows the tuple mover hasn't drained yet participate in queries
    immediately)."""
    scans: List[ops.ScanResult] = []
    for host, owner in plan.sources:
        store = db.nodes[host].stores[owner]
        wos = fused_exec.wos_visible(store, as_of)
        if wos is not None:
            data, vis = wos
            cols = {c: to_device(data[c], db.device) for c in need}
            valid = to_device(vis, db.device)
            if scan_pred is not None:
                valid = valid & fused_exec.as_mask(scan_pred(cols), valid)
            if sip is not None:
                valid = valid & sip(cols)
            scans.append(ops.ScanResult(cols, valid))
    return scans


# ---------------------------------------------------------------------------
# result shaping shared by every path (incl. the fused executor)
# ---------------------------------------------------------------------------

def _finalize(q: LogicalQuery, out: Dict[str, np.ndarray]
              ) -> Dict[str, np.ndarray]:
    """HAVING -> ORDER BY (multi-key, per-key direction) -> LIMIT, on the
    (small) host-side result."""
    if q.having is not None and out:
        n = len(next(iter(out.values())))
        if n:
            m = np.asarray(q.having(out), bool)
            out = {c: np.asarray(v)[m] for c, v in out.items()}
    if q.order_by and out:
        n = len(next(iter(out.values())))
        if n:
            keys = []
            for c, desc in reversed(q.order_by):
                k = np.asarray(out[c])
                if desc:
                    # descending without precision loss: bit-complement
                    # for ints/bools (= -k-1, never overflows), negate
                    # floats
                    k = ~k if k.dtype.kind in "bui" else -k
                keys.append(k)
            order = np.lexsort(keys)       # last key = primary
            out = {c: np.asarray(v)[order] for c, v in out.items()}
    if q.limit is not None:
        out = {c: v[: q.limit] for c, v in out.items()}
    return out


def _empty_result(q: LogicalQuery) -> Dict[str, np.ndarray]:
    """Structured empty output for a fully pruned / empty scan (same key
    set as the non-empty path)."""
    out = {c: np.zeros(0, np.int64) for c in q.columns}
    for name, _ in q.derived:
        out[name] = np.zeros(0)
    for g in q.group_by:
        out[g] = np.zeros(0, np.int64)
    if q.group_by:
        out["group_count"] = np.zeros(0, np.int64)
    for name, _, kind in q.aggs:
        out[name] = np.zeros(1) if not q.group_by else np.zeros(0)
    return out


def _combine_sips(sips: List[Callable]) -> Optional[Callable]:
    if not sips:
        return None
    if len(sips) == 1:
        return sips[0]

    def apply(cols):
        m = sips[0](cols)
        for s in sips[1:]:
            m = m & s(cols)
        return m

    return apply


# ---------------------------------------------------------------------------
# RLE-direct paths (single-column group keys on encoded data)
# ---------------------------------------------------------------------------

def rle_direct_eligible(q: LogicalQuery, plan) -> bool:
    """Shape test for the RLE-direct GroupBy route."""
    return plan.groupby_algorithm == "rle" and not q.joins \
        and q.predicate is None


def _rle_scalar_count(db: VerticaDB, q: LogicalQuery, plan, as_of: int
                      ) -> Optional[Dict[str, np.ndarray]]:
    """COUNT(*) with a range predicate on the RLE-encoded sort leader:
    sum run lengths whose value passes -- O(runs), no decode (§6.1)."""
    from .expr import exact_int_interval

    proj = db.catalog.projections[plan.projection]
    leader = proj.sort_order[0]
    if q.predicate is not None:
        iv = exact_int_interval(q.predicate)
        if iv is None or iv[0] != leader:
            return None
        _, lo, hi = iv
    else:
        lo = hi = None
    lo = -np.inf if lo is None else lo
    hi = np.inf if hi is None else hi
    total = 0
    for host, owner in plan.sources:
        store = db.nodes[host].stores[owner]
        if store.wos.n_rows:
            return None
        for c in store.containers:
            if store.delete_vectors.get(c.id) or (c.epochs > as_of).any():
                return None
            colenc = c.columns[leader]
            if colenc.encoding != Encoding.RLE:
                return None
            rv = colenc.arrays["run_values"].reshape(-1)
            rl = colenc.arrays["run_lengths"].reshape(-1)
            m = (rv >= lo) & (rv <= hi) & (rl > 0)
            cnt = int(rl[m].sum())
            pad = colenc.n_blocks * colenc.block_rows - c.n_rows
            if pad and c.n_rows:
                last = rv[np.flatnonzero(rl)[-1]]
                if lo <= last <= hi:
                    cnt -= pad
            total += cnt
    out = {}
    for name, _, _ in q.aggs:
        out[name] = np.asarray([total])
    return out


def _rle_groupby(db: VerticaDB, q: LogicalQuery, plan, as_of: int
                 ) -> Optional[Dict[str, np.ndarray]]:
    """COUNT GROUP BY key straight off RLE runs (§6.1 'operate directly on
    encoded data'). Requires no pending deletes and fully-committed
    containers; otherwise returns None (before anything launches) and the
    caller decodes.  Every container's cached device runs go to one
    ``rle_grouped_agg`` call (more only when one call's rows would reach
    ``_RLE_CALL_ROWS``), and the counts come back in one copy."""
    from ..planner.planner import _domain_estimate

    group = q.group_by[0]
    proj = db.catalog.projections[plan.projection]
    dom = _domain_estimate(db, proj, group)
    if dom is None or dom > plan.dense_domain_limit:
        return None
    conts = []
    for host, owner in plan.sources:
        store = db.nodes[host].stores[owner]
        if store.wos.n_rows:
            return None
        for c in store.containers:
            if store.delete_vectors.get(c.id) or (c.epochs > as_of).any():
                return None
            if c.columns[group].encoding != Encoding.RLE:
                return None
            conts.append(c)
    # the reference counts each container in int32 and sums the counts in
    # int64: one call counts into one int32 lane, so calls stay below
    # 2^31 rows (block padding included) and their counts add in int64
    calls, rows = [], _RLE_CALL_ROWS
    for c in conts:
        col = c.columns[group]
        n = col.n_blocks * col.block_rows
        if rows + n >= _RLE_CALL_ROWS:
            calls.append([])
            rows = 0
        calls[-1].append(fused_exec.cached_runs(db, c, group))
        rows += n
    total = np.zeros(dom, np.int64)
    if calls:
        counts = [ops.groupby_rle_runs(runs, dom)["group_count"]
                  for runs in calls]
        total += _np(torch.stack(counts)).astype(np.int64).sum(0)
    for c in conts:
        # subtract tail-block padding (pad value = last value, the value
        # of the last run of nonzero length)
        colenc = c.columns[group]
        pad = colenc.n_blocks * colenc.block_rows - c.n_rows
        if pad and c.n_rows:
            rv = colenc.arrays["run_values"].reshape(-1)
            rl = colenc.arrays["run_lengths"].reshape(-1)
            total[int(rv[np.flatnonzero(rl)[-1]])] -= pad
    sel = total > 0
    out = {group: np.flatnonzero(sel), "group_count": total[sel]}
    for name, _, kind in q.aggs:
        if kind == "count":
            out[name] = total[sel]
    return out


# ---------------------------------------------------------------------------
# generic GroupBy over (possibly composite) keys
# ---------------------------------------------------------------------------

def _run_groupby(q: LogicalQuery, plan, cols, valid, stats
                 ) -> Dict[str, np.ndarray]:
    aggs = tuple(q.aggs)
    values = {c: cols[c] for _, c, kind in aggs
              if kind != "count" and c != "*"}
    if not q.group_by:
        # scalar aggregate: single group
        keys = torch.zeros(valid.shape[0], dtype=torch.int32,
                           device=valid.device)
        res = ops.groupby_dense(keys, valid, values, 1, aggs)
        return {name: v[:1] for name, v in fused_exec.to_host(res).items()}

    if not bool(valid.any()):
        out = {g: np.zeros(0, np.int64) for g in q.group_by}
        out["group_count"] = np.zeros(0, np.int64)
        for name, _, _ in aggs:
            out[name] = np.zeros(0)
        return out

    algo = plan.groupby_algorithm
    if algo == "rle":
        algo = "sort"

    key_cols = [cols[g] for g in q.group_by]
    packed, lows, domains = key_cols[0], None, None
    if len(key_cols) > 1 or algo == "dense":
        # observed per-key bounds for packing / the dense domain (tighter
        # than SMA estimates; one host sync each -- this is the cold
        # path).  A single-key sort GroupBy needs none of this.
        lows, domains = [], []
        for k in key_cols:
            big = 2**30 if k.is_floating_point() \
                else int(torch.iinfo(k.dtype).max)
            lo = int(torch.where(valid, k, big).min())
            hi = int(torch.where(valid, k, -big).max())
            lows.append(min(lo, 0))
            domains.append(hi - lows[-1] + 1)
        total = 1
        for d in domains:
            total *= d
        if total >= _PACK_LIMIT:
            # packed keys would overflow device int32: host fallback
            stats.groupby_algorithm = "host-unique (domain overflow)"
            return _groupby_host(q, cols, valid, values, aggs)
        if algo == "dense" and total > plan.dense_domain_limit:
            algo = "sort"   # runtime switch (§6.1)
            stats.groupby_algorithm = "sort (runtime switch)"
        if len(key_cols) > 1 or lows[0] != 0:
            packed = ops.pack_keys(key_cols, domains, lows)
        else:
            lows = domains = None    # raw single key: no unpack needed

    if algo == "dense":
        res = fused_exec.to_host(ops.groupby_dense(
            packed.to(torch.int32), valid, values, total, aggs))
        counts = res["group_count"]
        sel = counts > 0
        gkeys = np.flatnonzero(sel)
        out = {"group_count": counts[sel]}
        for name, _, _ in aggs:
            out[name] = res[name][sel]
    else:
        res = fused_exec.to_host(ops.groupby_sort(
            packed, valid, values, plan.max_groups, aggs))
        n = int(res["n_groups"])
        if n > plan.max_groups:
            # more distinct groups than the sort cap: groupby_sort would
            # silently merge the tail -- host fallback keeps it exact
            stats.groupby_algorithm = "host-unique (group overflow)"
            return _groupby_host(q, cols, valid, values, aggs)
        gkeys = res["group_keys"][:n]
        out = {"group_count": res["group_count"][:n]}
        for name, _, _ in aggs:
            out[name] = res[name][:n]
    unpacked = [gkeys] if domains is None \
        else ops.unpack_keys(gkeys, domains, lows)
    for g, kv in zip(q.group_by, unpacked):
        out[g] = kv
    return out


def _groupby_host(q: LogicalQuery, cols, valid, values, aggs
                  ) -> Dict[str, np.ndarray]:
    """numpy unique-based GroupBy for key domains too wide to pack into
    the device integer width.  Small-result assumption holds (grouped
    outputs are aggregated), only the scan stays device-side."""
    mask = _np(valid)
    keys2d = np.stack([_np(cols[g])[mask] for g in q.group_by], 1)
    uniq, inv = np.unique(keys2d, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    n_groups = len(uniq)
    counts = np.bincount(inv, minlength=n_groups)
    out = {g: uniq[:, i] for i, g in enumerate(q.group_by)}
    out["group_count"] = counts
    for name, c, kind in aggs:
        if kind == "count":
            out[name] = counts
            continue
        v = _np(values[c])[mask]
        if kind in ("sum", "avg"):
            acc = np.bincount(inv, weights=v, minlength=n_groups)
            out[name] = acc / np.maximum(counts, 1) if kind == "avg" \
                else acc
        elif kind == "min":
            acc = np.full(n_groups, np.inf)
            np.minimum.at(acc, inv, v)
            out[name] = acc
        else:
            acc = np.full(n_groups, -np.inf)
            np.maximum.at(acc, inv, v)
            out[name] = acc
    return out
