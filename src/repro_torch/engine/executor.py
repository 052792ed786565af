"""Warm-path executor: batched container scans + a plan-signature cache
(paper §6 "run fast on data already near the processor", §7 "plan once,
execute many").

Mirrors ``src/repro/engine/executor.py`` for single-node execution:

  1. **Block cache** (core/block_cache.py): encoded payloads and decoded
     ``(n_blocks, block_rows)`` blocks stay device-resident keyed by
     ``(container_id, column)``; ROS immutability makes entries coherent
     until the tuple mover retires the container.
  2. **Batched scan**: the SMA-surviving blocks of *all* containers are
     gathered from the cache and concatenated into one flat tensor per
     column.
  3. **Plan cache**: the join-chain->derived->predicate->mask->groupby
     closure is built once per *plan signature* -- the logical IR's
     ``exec_signature()`` plus the physical choices (projection,
     algorithm, static domain, pack radices, block shape) -- and memoized.
     PyTorch runs eagerly, so the cached closure replaces the reference's
     jitted program; the results come back in one batched device->host
     copy.

Every tensor lives on ``db.device``.  An eligible scan may run in the
code domain instead (engine/compressed.py, picked by ``db.exec_mode``).
The snapshot scans at the end of the scan section feed the segmented
executor (engine/segmented.py).  The deferred/shared serving variants are
not ported yet.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.block_cache import BlockCache, KIND_DECODED, KIND_ENCODED
from ..core.database import VerticaDB
from ..core.encodings import decode_torch, device_bytes, to_device, \
    upload_torch
from ..core.storage import ROSContainer
from . import operators as ops
from .compressed import plan_compressed_scan
from .expr import Expr

KIND_VALID = "valid"      # per-(container, as_of) visibility blocks
KIND_RLE_RUNS = "rle_runs"  # flat device runs of an RLE column
KIND_BUILD = "build"      # per-(dim_table, as_of, join-sig) build sides


# ---------------------------------------------------------------------------
# Plan cache: plan signature -> fused closure
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PlanCacheStats:
    hits: int = 0
    misses: int = 0


class PlanCache:
    """Bounded memo of fused closures keyed by plan signature.  The
    signature is the IR's canonical form plus the physical choices, so it
    captures everything that changes the program -- joins, derived
    expressions, predicate shape *and* literals, group keys, groupby
    algorithm and domain, agg set -- and a hit is exactly 'this query
    shape has run before'."""

    def __init__(self, max_entries: int = 256):
        self.max_entries = max_entries
        self.stats = PlanCacheStats()
        self._fns: "OrderedDict[tuple, Callable]" = OrderedDict()

    def get_or_build(self, sig: tuple, build: Callable[[], Callable]
                     ) -> Tuple[Callable, bool]:
        fn = self._fns.get(sig)
        if fn is not None:
            self._fns.move_to_end(sig)
            self.stats.hits += 1
            return fn, True
        fn = build()
        self._fns[sig] = fn
        if len(self._fns) > self.max_entries:
            self._fns.popitem(last=False)
        self.stats.misses += 1
        return fn, False

    def clear(self):
        self._fns.clear()


# one process-wide plan cache: plans are keyed by projection name and
# query shape, not by DB identity, and the closures hold no data
PLAN_CACHE = PlanCache()

# negative cache: plan signatures whose sort-path GroupBy overflowed
# max_groups -- repeats skip the doomed fused attempt and go straight to
# the general pipeline (which lands on the exact host GroupBy)
_SORT_OVERFLOWED: set = set()


# ---------------------------------------------------------------------------
# Cached device blocks
# ---------------------------------------------------------------------------

def cached_decoded(db: VerticaDB, c: ROSContainer,
                   name: str) -> torch.Tensor:
    """(n_blocks, block_rows) decoded device blocks of one column, via the
    cache: encoded payload uploaded once, decoded blocks kept resident."""
    col = c.columns[name]
    cache: Optional[BlockCache] = getattr(db, "block_cache", None)
    if cache is None:
        return decode_torch(col, db.device)

    def _decode():
        enc = cache.get_or_put(c.id, name, KIND_ENCODED,
                               lambda: upload_torch(col, db.device),
                               device_bytes)
        return decode_torch(col, db.device, enc)

    return cache.get_or_put(c.id, name, KIND_DECODED, _decode, device_bytes)


def cached_runs(db: VerticaDB, c: ROSContainer, name: str
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat device (run_values, run_lengths) of one RLE column, uploaded
    once per container and kept in the block cache: ROS containers are
    immutable, and the tuple mover's replacements carry new ids."""
    col = c.columns[name]

    def make():
        return (to_device(col.arrays["run_values"].reshape(-1), db.device),
                to_device(col.arrays["run_lengths"].reshape(-1), db.device))

    cache: Optional[BlockCache] = getattr(db, "block_cache", None)
    if cache is None:
        return make()
    return cache.get_or_put(c.id, name, KIND_RLE_RUNS, make,
                            lambda v: sum(device_bytes(t) for t in v))


def _valid_blocks_np(store, c: ROSContainer, as_of: int,
                     counts: np.ndarray) -> np.ndarray:
    """(n_blocks, block_rows) bool: inside n_rows, epoch-visible, not
    deleted as of the snapshot."""
    first = next(iter(c.columns.values()))
    nb, br = first.n_blocks, first.block_rows
    pos = np.arange(br)[None, :]
    valid = pos < counts[:, None]                     # inside n_rows
    dead = store.deleted_mask(c, as_of) | (c.epochs > as_of)
    if dead.any():
        flat = np.zeros(nb * br, bool)
        flat[np.flatnonzero(dead)] = True
        valid &= ~flat.reshape(nb, br)
    return valid


def _container_ceiling(store, c: ROSContainer) -> int:
    """Newest epoch affecting this container's visibility (commit epochs
    + its delete-vector epochs).  Visibility at any as-of >= ceiling
    equals visibility at the ceiling."""
    hi = c.max_epoch()
    for dv in store.delete_vectors.get(c.id, []):
        if len(dv.delete_epochs):
            hi = max(hi, int(dv.delete_epochs.max()))
    return hi


def cached_valid(db: VerticaDB, store, c: ROSContainer, as_of: int,
                 counts: np.ndarray) -> torch.Tensor:
    """Device copy of the container's visibility blocks at ``as_of``.
    Keyed by the *effective* epoch -- as-of clamped to the container's
    epoch ceiling -- so trickle-load commits that only touched the WOS
    (or other stores) keep every container's visibility entry warm; a
    commit or delete hitting THIS container moves its ceiling and misses
    naturally (a delete additionally invalidates the container's entries
    outright)."""
    eff = min(as_of, _container_ceiling(store, c))
    cache: Optional[BlockCache] = getattr(db, "block_cache", None)

    def make():
        return to_device(_valid_blocks_np(store, c, eff, counts), db.device)

    if cache is None:
        return make()
    return cache.get_or_put(c.id, f"@{eff}", KIND_VALID, make, device_bytes)


def as_mask(x, like: torch.Tensor) -> torch.Tensor:
    """A predicate's result as a bool mask on ``like``'s device."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.bool)
    return torch.as_tensor(x, dtype=torch.bool, device=like.device)


# ---------------------------------------------------------------------------
# Batched scan over all containers of a plan
# ---------------------------------------------------------------------------

def scan_stores_batched(db: VerticaDB, plan, need: Sequence[str],
                        predicate: Optional[Expr], sip, as_of: int,
                        stats) -> Optional[ops.ScanResult]:
    """Gather the SMA-surviving blocks of every ROS container behind
    ``plan.sources`` straight from the device cache and concatenate them
    into one flat tensor per column.  Pruning decisions stay host-side
    (they read tiny SMA arrays); all row-level work happens on the device
    downstream.  Returns None when everything was pruned."""
    need = sorted(set(need) | (predicate.columns() if predicate else set()))
    col_parts: Dict[str, List[torch.Tensor]] = {name: [] for name in need}
    valid_parts: List[torch.Tensor] = []
    pruned = total = 0
    for host, owner in plan.sources:
        store = db.nodes[host].stores[owner]
        for c in store.containers:
            if not need:
                continue
            first = c.columns[need[0]]
            nb = first.n_blocks
            total += nb
            # --- SMA block pruning (paper §3.5), host-side ---
            keep = np.ones(nb, dtype=bool)
            if predicate is not None:
                for colname, (lo, hi) in predicate.bounds().items():
                    if colname in c.smas:
                        keep &= c.smas[colname].prune_blocks(lo, hi)
            kept_idx = np.flatnonzero(keep)
            pruned += nb - kept_idx.size
            if kept_idx.size == 0:
                continue
            stats.containers_scanned += 1
            whole = kept_idx.size == nb
            idx = None if whole else torch.as_tensor(kept_idx,
                                                     device=db.device)
            for name in need:
                blocks = cached_decoded(db, c, name)
                col_parts[name].append(blocks if whole else blocks[idx])
            counts = c.smas[need[0]].counts
            vb = cached_valid(db, store, c, as_of, counts)
            valid_parts.append(vb if whole else vb[idx])
    stats.blocks_pruned, stats.blocks_total = pruned, total
    if not valid_parts:
        return None
    cols = {n: torch.cat(p).reshape(-1) for n, p in col_parts.items()}
    valid = torch.cat(valid_parts).reshape(-1)
    if predicate is not None:
        valid = valid & as_mask(predicate(cols), valid)
    if sip is not None:
        valid = valid & sip(cols)
    return ops.ScanResult(cols, valid, pruned, total)


def wos_visible(store, as_of: int
                ) -> Optional[Tuple[Dict[str, np.ndarray], np.ndarray]]:
    """(rows, visibility mask) of a store's WOS at a snapshot epoch, or
    None when the WOS is empty: committed at-or-before ``as_of`` and not
    deleted by then.  THE single definition of WOS MVCC visibility for
    the execution paths."""
    data, eps, _ = store.wos.snapshot()
    if not len(eps):
        return None
    dels = (np.concatenate(store.wos_delete_epochs)
            if store.wos_delete_epochs
            else np.zeros(len(eps), np.int64))
    return data, (eps <= as_of) & ~((dels > 0) & (dels <= as_of))


def wos_scan_host(db: VerticaDB, plan, need: Sequence[str], as_of: int
                  ) -> Optional[Tuple[Dict[str, np.ndarray], np.ndarray,
                                      Optional[np.ndarray]]]:
    """(cols, visibility, ring-values-or-None) of every pending WOS row
    behind ``plan.sources``.  Ring values were stamped at commit
    (core/database._stage -> WOS.append), so the segmented executor can
    place trickle-loaded rows on their owning shard without re-hashing;
    None means some batch was untagged (caller re-hashes)."""
    need = sorted(set(need))
    parts: List[Dict[str, np.ndarray]] = []
    valids: List[np.ndarray] = []
    rings: List[Optional[np.ndarray]] = []
    tagged = True
    for host, owner in plan.sources:
        store = db.nodes[host].stores[owner]
        wos = wos_visible(store, as_of)
        if wos is None:
            continue
        data, vis = wos
        parts.append({c: np.asarray(data[c]) for c in need})
        valids.append(vis)
        r = store.wos.ring_snapshot()
        tagged &= r is not None
        rings.append(r)
    if not parts:
        return None
    cols = {c: np.concatenate([p[c] for p in parts]) for c in need}
    ring = np.concatenate(rings) if tagged else None
    return cols, np.concatenate(valids), ring


def snapshot_scan_device(db: VerticaDB, plan, need: Sequence[str],
                         as_of: int, stats
                         ) -> Optional[Tuple[Dict[str, torch.Tensor],
                                             np.ndarray]]:
    """Device-side ROS snapshot for the segmented slab build: the decoded
    blocks of every container behind ``plan.sources`` (cached, decoded by
    ``decode_torch``, so packed columns launch ``bitunpack``) are
    concatenated into one flat device tensor per column -- the columns
    never round-trip through the host.  Only the visibility mask comes
    back as numpy: it is computed from host-side delete bitmaps and epoch
    arrays anyway, and uploading one bool array is the cheap direction.
    No SMA pruning here -- the slab caches ALL visible rows; per-query
    predicate pruning happens at slab-block granularity downstream."""
    need = sorted(set(need))
    col_parts: Dict[str, List[torch.Tensor]] = {name: [] for name in need}
    valid_parts: List[np.ndarray] = []
    for host, owner in plan.sources:
        store = db.nodes[host].stores[owner]
        for c in store.containers:
            if not need:
                continue
            stats.containers_scanned += 1
            for name in need:
                col_parts[name].append(cached_decoded(db, c, name))
            counts = c.smas[need[0]].counts
            eff = min(as_of, _container_ceiling(store, c))
            valid_parts.append(_valid_blocks_np(store, c, eff, counts))
    if not valid_parts:
        return None
    cols = {n: torch.cat([b.reshape(-1) for b in p])
            for n, p in col_parts.items()}
    valid = np.concatenate([v.reshape(-1) for v in valid_parts])
    return cols, valid


def snapshot_scan_host(db: VerticaDB, plan, need: Sequence[str],
                       as_of: int, stats, *, include_wos: bool = True
                       ) -> Optional[Tuple[Dict[str, np.ndarray],
                                           np.ndarray]]:
    """Host-side snapshot of every row behind ``plan.sources`` (ROS via
    the device block cache, plus pending WOS rows unless
    ``include_wos=False``), as flat numpy arrays with a visibility mask.
    The decode itself still runs through the cached device blocks."""
    need = sorted(set(need))
    ros = scan_stores_batched(db, plan, need, None, None, as_of, stats)
    parts: List[Dict[str, np.ndarray]] = []
    valids: List[np.ndarray] = []
    if ros is not None:
        host = to_host(dict(ros.columns, __valid=ros.valid))
        valids.append(host.pop("__valid"))
        parts.append(host)
    if include_wos:
        wos = wos_scan_host(db, plan, need, as_of)
        if wos is not None:
            parts.append(wos[0])
            valids.append(wos[1])
    if not parts:
        return None
    cols = {c: np.concatenate([p[c] for p in parts]) for c in need}
    return cols, np.concatenate(valids)


# ---------------------------------------------------------------------------
# Fused scan -> joins -> predicate -> mask -> aggregate (one cached closure)
# ---------------------------------------------------------------------------

def _plan_signature(db: VerticaDB, q, plan, algo: str, domain: int,
                    domains: Tuple[int, ...], br: int) -> tuple:
    """The IR's canonical exec signature (HAVING/ORDER BY/LIMIT shape
    host-side and are excluded) plus the physical choices (projection,
    algorithm, static domain, per-key pack radices, block shape).  The
    radices must be part of the key: the closure bakes them into
    pack_keys, so SMA-domain growth after new commits has to miss."""
    return ("fused", plan.projection, q.exec_signature(), algo,
            int(domain), tuple(domains), br)


def build_join_sides(db: VerticaDB, q, as_of: int
                     ) -> List[Dict[str, torch.Tensor]]:
    """Build sides for the IR's join list: snapshot-read each dimension,
    apply its dim predicate, upload key + carried columns.  Shared by the
    fused and general pipelines, and kept device-resident in the block
    cache keyed by (dim table, join signature, effective epoch) -- MVCC
    makes a fixed-epoch read immutable (drop_partition, the one non-MVCC
    mutation, invalidates the table's entries)."""
    cache = getattr(db, "block_cache", None)
    builds = []
    for spec in q.joins:
        def make(spec=spec):
            dim_rows = db.read_table(spec.dim_table, as_of=as_of)
            if spec.dim_predicate is not None:
                m = np.asarray(spec.dim_predicate(dim_rows), bool)
                dim_rows = {c: v[m] for c, v in dim_rows.items()}
            return {c: to_device(dim_rows[c], db.device)
                    for c in (spec.dim_key,) + tuple(spec.dim_columns)}
        if cache is None:
            builds.append(make())
        else:
            eff = min(as_of, db.table_epoch_ceiling(spec.dim_table))
            builds.append(cache.get_or_put(
                f"dim:{spec.dim_table}", f"{spec.signature()}@{eff}",
                KIND_BUILD, make, device_bytes))
    return builds


def _build_fused(ir, predicate: Optional[Expr], algo: str,
                 domains: Tuple[int, ...], domain: int,
                 aggs: Tuple[Tuple[str, str, str], ...]) -> Callable:
    """One closure: hash joins (build sides passed at call time), derived
    projections, predicate eval, composite-key packing, groupby/aggregate
    -- the reference's jitted program, run eagerly on the device."""

    values_cols = tuple(sorted({c for _, c, kind in aggs
                                if kind != "count" and c != "*"}))
    group_by = ir.group_by

    def fused(cols: Dict[str, torch.Tensor], valid: torch.Tensor,
              builds: Tuple[Dict[str, torch.Tensor], ...]):
        cols = dict(cols)
        for spec, build in zip(ir.joins, builds):
            cols, valid = ops.hash_join(build, spec.dim_key, cols,
                                        spec.fact_key, valid, how=spec.how)
        for name, e in ir.derived:
            cols[name] = e(cols)
        if predicate is not None:
            valid = valid & as_mask(predicate(cols), valid)
        values = {c: cols[c] for c in values_cols}
        if not group_by:
            keys = torch.zeros(valid.shape[0], dtype=torch.int32,
                               device=valid.device)
            return ops.groupby_dense(keys, valid, values, 1, aggs)
        keys = ops.pack_keys([cols[g] for g in group_by], domains) \
            if len(group_by) > 1 else cols[group_by[0]]
        if algo == "dense":
            return ops.groupby_dense(keys.to(torch.int32), valid, values,
                                     domain, aggs)
        return ops.groupby_sort(keys, valid, values, domain, aggs)

    return fused


def _stores_have_wos(db: VerticaDB, plan) -> bool:
    return any(db.nodes[host].stores[owner].wos.n_rows
               for host, owner in plan.sources)


def fused_plan_params(q, plan, stats=None, key_domains=None
                      ) -> Optional[Tuple[str, int, Tuple[int, ...]]]:
    """Static groupby algorithm + domain selection for a cached fused
    closure: dense/packing need per-key domains from container SMAs;
    unknown/oversized falls to sort for one key and to the general path
    (runtime bounds) for composite keys.  Returns ``(algo, domain,
    domains)`` or None when the shape is outside the fused subset.
    ``key_domains`` overrides the plan's SMA-derived domains (the
    compressed-domain path groups dict columns on union codes, whose
    domain is the dictionary size)."""
    if not (q.aggs or q.group_by):
        return None
    if any(j.how != "inner" for j in q.joins):
        return None   # left-join NULL groups need runtime key bounds
    algo = plan.groupby_algorithm
    if algo == "rle":
        algo = "sort"
    domain, domains = 1, ()
    if q.group_by:
        doms = key_domains if key_domains is not None \
            else (plan.key_domains or (None,) * len(q.group_by))
        if len(q.group_by) == 1:
            dom = doms[0]
            if algo == "dense" and (dom is None
                                    or dom > plan.dense_domain_limit):
                algo = "sort"
                if stats is not None:
                    stats.groupby_algorithm = "sort (runtime switch)"
            domains = (int(dom),) if dom is not None else (0,)
            domain = int(dom) if algo == "dense" else plan.max_groups
        else:
            if any(d is None for d in doms):
                return None   # composite packing needs static bounds
            total = 1
            for d in doms:
                total *= int(d)
            if total >= 1 << 31:
                return None   # packed key would overflow device int32
            if algo == "dense" and total > plan.dense_domain_limit:
                algo = "sort"
                if stats is not None:
                    stats.groupby_algorithm = "sort (runtime switch)"
            domains = tuple(int(d) for d in doms)
            domain = total if algo == "dense" else plan.max_groups
    return algo, domain, domains


def _shape_fused_result(q, res, algo: str, domain: int,
                        domains: Tuple[int, ...], stats,
                        sigs: Tuple[tuple, ...] = ()
                        ) -> Optional[Dict[str, np.ndarray]]:
    """Host-side shaping of a fused closure's output (small results);
    HAVING/ORDER/LIMIT are applied by pipeline._finalize, shared with the
    general path.  A sort-cap overflow negative-caches every signature in
    ``sigs`` and returns None -- the caller falls back to the general
    pipeline (which lands on the exact host GroupBy)."""
    aggs = tuple(q.aggs)
    if not q.group_by:
        return {name: np.asarray(v)[:1] for name, v in res.items()}
    if algo == "dense":
        counts = np.asarray(res["group_count"])
        sel = counts > 0
        gkeys = np.flatnonzero(sel)
        out = {"group_count": counts[sel]}
        for name, _, _ in aggs:
            out[name] = np.asarray(res[name])[sel]
    else:
        n = int(res["n_groups"])
        if n > domain:
            # distinct groups exceed the sort cap: results would be
            # silently merged -- fall back to the general pipeline
            # (which lands on the host GroupBy) and remember the shape
            if len(_SORT_OVERFLOWED) > 512:
                _SORT_OVERFLOWED.clear()
            _SORT_OVERFLOWED.update(sigs)
            stats.plan_cache = ""
            return None
        gkeys = np.asarray(res["group_keys"])[:n]
        out = {"group_count": np.asarray(res["group_count"])[:n]}
        for name, _, _ in aggs:
            out[name] = np.asarray(res[name])[:n]
    if len(q.group_by) > 1:
        for g, kv in zip(q.group_by, ops.unpack_keys(gkeys, domains)):
            out[g] = kv
    else:
        out[q.group_by[0]] = gkeys
    return out


def to_host(res: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Fetch a dict of device tensors in ONE device->host copy: the
    tensors' bytes are concatenated on the device, copied once, and split
    back into numpy arrays of their own dtype and shape."""
    names = list(res)
    ts = [res[n].contiguous() for n in names]
    if not ts or ts[0].device.type == "cpu":
        return {n: t.numpy() for n, t in zip(names, ts)}
    buf = torch.cat([t.reshape(-1).view(torch.uint8) for t in ts]) \
        .cpu().numpy()
    out, off = {}, 0
    for n, t in zip(names, ts):
        nbytes = t.numel() * t.element_size()
        dt = torch.empty(0, dtype=t.dtype).numpy().dtype
        # copy: a slice at an odd offset would be an unaligned view
        out[n] = buf[off:off + nbytes].view(dt).reshape(t.shape).copy()
        off += nbytes
    return out


def execute_fused(db: VerticaDB, q, plan, as_of: int,
                  stats) -> Optional[Dict[str, np.ndarray]]:
    """Run an aggregate query as one cached fused closure and bring the
    result back in one batched copy.  Returns None when the query shape
    is outside the fused subset (WOS rows pending, no aggregation, or
    composite keys without static SMA domains) or on sort-cap overflow
    -- the caller falls back to the general pipeline."""
    if _stores_have_wos(db, plan):
        return None   # WOS rows need the unencoded side-scan
    proj = db.catalog.projections[plan.projection]
    need = sorted(q.scan_columns(proj))
    scan_pred = q.scan_predicate(proj.columns)

    # plan-time code-domain rewrite (engine/compressed.py): predicates on
    # dict columns become code ranges, group keys stay codes, payloads
    # late-materialize for survivors only
    cplan = plan_compressed_scan(db, q, plan, need, scan_pred, as_of)
    params = fused_plan_params(q, plan, stats,
                               key_domains=cplan.key_domains(q, plan)
                               if cplan is not None else None)
    if params is None:
        return None
    algo, domain, domains = params

    sig = _plan_signature(db, q, plan, algo, domain, domains, db.block_rows)
    if cplan is not None:
        sig = sig + cplan.sig_suffix
    if sig in _SORT_OVERFLOWED:
        return None   # known to exceed the sort cap: don't re-try

    if cplan is not None:
        scan = cplan.scan(db, scan_pred, None, stats)
        stats.compressed_scan = scan is not None
    else:
        scan = scan_stores_batched(db, plan, need, scan_pred, None, as_of,
                                   stats)
        if scan is not None:
            stats.rows_scanned = int(scan.valid.shape[0])
    if scan is None:
        return None   # fully pruned; pipeline builds the empty result

    # build sides host-side (small dims); the dim predicate filters here,
    # which is the SIP effect pushed all the way into the probe
    builds = build_join_sides(db, q, as_of)
    if q.joins:
        stats.sip_applied = stats.sip_applied or plan.use_sip

    # the scan already masked a projection-covered predicate; only a
    # deferred one (join/derived columns) re-evaluates inside the closure
    fused_pred = q.predicate if scan_pred is None else None
    fused, hit = PLAN_CACHE.get_or_build(
        sig, lambda: _build_fused(q, fused_pred, algo, domains, domain,
                                  tuple(q.aggs)))
    stats.plan_cache = "hit" if hit else "miss"
    res = fused(scan.columns, scan.valid, tuple(builds))
    out = _shape_fused_result(q, to_host(res), algo, domain, domains,
                              stats, sigs=(sig,))
    return cplan.translate(out) if cplan is not None else out
