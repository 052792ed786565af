"""Segmented multi-shard query execution over a query mesh.

Mirrors ``src/repro/engine/segmented.py``.  A projection's
``SegmentationSpec`` (§3.6) decides which *shard* owns each tuple,
Send/Recv (§6.1) runs as ``exchange.resegment`` /
``exchange.broadcast_build_side``, and buddy projections (§5.2) keep every
segment scannable when a node is down -- the planner's ``plan.sources``
routing already walks buddies, so ``fail_node()`` failover is transparent
here too.

The port's mesh splits its shards into placements, one device each
(distributed/mesh.py): every sharded array is one ``[k, per]`` tensor per
placement, on that placement's device, and each of the reference's
``shard_map``-ped programs runs once per placement over its leading shard
dimension, with global shard ids -- a shard's rows, its build partition
and its partials live on its placement's device, and only the exchanges
(engine/exchange.py) move tuples between placements.  One controller
process plans, caches and merges, as the reference's jax controller does
over its ``Mesh``; a mesh of one placement holds every shard in one
``[n_shards, per]`` tensor.

Execution shape (one query):

  0. **RLE-direct routes**: a count-only GroupBy on the RLE-encoded sort
     leader (or a scalar COUNT with a sort-leader range predicate)
     aggregates straight off each node's encoded runs (the
     ``rle_grouped_agg`` kernel) -- no slab, no exchange.
  1. **Device slab build** (cold only, cached ``KIND_SEG``): the decoded
     device blocks of every source container are concatenated on the
     device (``executor.snapshot_scan_device``; packed columns launch
     ``bitunpack``), ring-hashed with the device twins
     ``hash_columns_torch`` / ``shard_of_torch`` on the database's device,
     sent to their owning shard's placement by one exchange sized from an
     exact destination histogram, then compacted (valid rows first) and
     annotated with per-512-row-block min/max/count SMAs on each
     placement -- the columns never round-trip through the host.
     Trickle-loaded WOS rows live in separate per-store device buffers
     (``KIND_WOS``, the placements' blocks) built at commit time
     (``prewarm_wos_buffer``) and keyed by ``WOS.version``; a query only
     uploads the per-row visibility mask for its epoch and appends them
     shard-locally.
  2. **Slab-block pruning** (per query): predicate bounds against the
     slab's block SMAs select the surviving 512-row blocks; each shard
     gathers just those, at the width of the fullest shard.
  3. **Stage programs** (one plan-cached closure per resegment stage):
     ``exchange.resegment_blocks`` (Send/Recv) with the stage's hash
     joins, each shard probing its own build partition, and -- in the
     final stage -- derived exprs, the deferred predicate, mixed-radix key
     packing and the shard-local pre-aggregation: ONE ``seg_preagg``
     launch per placement over its shards, with keys ``shard * domain +
     key`` (global shard ids) over a domain of ``n_shards * domain`` (one
     launch per shard past the int32 key lane), sort-based partials past
     the dense limit.  Exchange overflow reports are checked once after
     the final stage, so no host sync splits a stage chain.
  4. **Final merge** (host, small): the placements' partials come back in
     one copy per device and concatenate in shard order; partial
     counts/sums add, min/max combine, avg = merged sum / merged count;
     packed keys unpack.

The plan-cache signature includes the mesh identity, the projection's
segmentation, the per-join exchange ops and the pack radices -- two mesh
shapes (or a re-segmented projection) can never share a stage program.
PyTorch runs eagerly, so the reference's jit-only machinery is gone: the
memoised static-capacity factory (a stage takes its exchange capacity as
an argument), the power-of-two gather widths of the pruner and the cached
own-shard index columns (an ``expand`` view costs nothing).

Falls back to the single-node pipeline (returns None) for shapes outside
the segmented subset: plain selects, non-inner joins, derived group keys,
group domains past the device integer width, or an empty snapshot.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.block_cache import KIND_SEG, KIND_WOS
from ..core.database import VerticaDB
from ..core.encodings import to_device
from ..core.faults import fire_with_retries
from ..core.segmentation import (hash_columns, hash_columns_torch, shard_of,
                                 shard_of_torch)
from ..kernels import ops as kops
from ..planner import cost as cost_mod
from . import exchange
from . import executor as fused_exec
from . import operators as ops
from .executor import PLAN_CACHE, as_mask, to_host
from .logical import LogicalQuery

_PACK_LIMIT = 1 << 31         # packed keys live in device int32
_PAD_MULTIPLE = 8
_SLAB_BLOCK = 512             # rows per slab SMA block (pruning granule)


def _round_up(n: int, m: int = _PAD_MULTIPLE) -> int:
    return -(-max(int(n), 1) // m) * m


def _sync(devices) -> None:
    for device in devices:
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def _shard_ids(n: int, device, first: int = 0) -> torch.Tensor:
    """``[n, 1]`` int32 global shard index of a block of ``n`` shards
    from ``first`` on (the reference's axis_index)."""
    return torch.arange(first, first + n, dtype=torch.int32,
                        device=device).unsqueeze(1)


def _upload(mesh, a: np.ndarray) -> List[torch.Tensor]:
    """A host ``[n_shards, ...]`` array as its placements' blocks."""
    k = mesh.shards_per_placement
    return [to_device(a[lo:lo + k], dev) for lo, dev in mesh.placements()]


def _replicate(mesh, a: np.ndarray) -> List[torch.Tensor]:
    """One host array on every placement; placements on one device share
    its copy."""
    by_dev: Dict[torch.device, torch.Tensor] = {}
    for dev in mesh.devices:
        if dev not in by_dev:
            by_dev[dev] = to_device(a, dev)
    return [by_dev[dev] for dev in mesh.devices]


def _blocks_bytes(blocks) -> int:
    """Device bytes of a list of blocks, a tensor shared by placements
    counted once."""
    seen = {(t.device, t.data_ptr()): t.numel() * t.element_size()
            for t in blocks}
    return sum(seen.values())


def _host_blocks(blocks: Sequence[Dict[str, torch.Tensor]],
                 extra: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Dict[str, np.ndarray]:
    """The placements' per-shard tensors on the host, in one copy per
    device: each name's blocks concatenated along the shard dimension,
    and ``extra``'s tensors as they are."""
    flat = {f"{p}|{n}": t for p, d in enumerate(blocks) for n, t in d.items()}
    flat.update(extra or {})
    host = to_host(flat)
    out = {n: np.concatenate([host[f"{p}|{n}"] for p in range(len(blocks))])
           for n in blocks[0]}
    out.update({n: host[n] for n in extra or {}})
    return out


def _dest_hist(dest: torch.Tensor, n_shards: int,
               valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[src, dst]`` int64 counts of the rows of each source shard bound
    for each destination -- of every row, or of the ``valid`` ones."""
    n_src = dest.shape[0]
    src = torch.arange(n_src, device=dest.device).unsqueeze(1)
    key = src * n_shards + dest.to(torch.int64)
    n_bins = n_src * n_shards
    if valid is not None:
        key = torch.where(valid, key, n_bins)       # a bin that is dropped
    return torch.bincount(key.reshape(-1), minlength=n_bins + 1)[
        :n_bins].reshape(n_src, n_shards)


# ---------------------------------------------------------------------------
# 1. Partitioned scan slabs (device-built, cached)
# ---------------------------------------------------------------------------

def _canon_np(v: np.ndarray) -> np.ndarray:
    """Match the single-node path's device lanes (the port is always
    32-bit) so both execution models aggregate identical dtypes."""
    if v.dtype.kind in "iu" and v.dtype.itemsize > 4:
        return v.astype(np.int32)
    if v.dtype.kind == "f" and v.dtype.itemsize > 4:
        return v.astype(np.float32)
    return v


def _source_sig(db: VerticaDB, plan, need, reseg_keys, eff: int,
                mesh, axis: str) -> tuple:
    """Identity of a cached ROS slab: *effective* snapshot epoch (the
    query's as-of clamped to the sources' ROS epoch ceiling -- trickle
    commits that only touched the WOS advance the cluster epoch without
    changing ROS visibility, so warm slabs survive them), mesh identity,
    needed columns, resegment keys, and the exact physical container set
    (the tuple mover retires containers by replacing ids, so a mergeout
    or moveout naturally misses -- and ``ProjectionStore.
    invalidate_seg_slabs`` evicts precisely those entries)."""
    items = []
    for host, owner in plan.sources:
        store = db.nodes[host].stores[owner]
        items.append((host, owner,
                      tuple(c.id for c in store.containers)))
    return (tuple(items), tuple(need), tuple(reseg_keys), int(eff),
            _mesh_sig(mesh, axis))


def _slab_positions(shard: np.ndarray, n_shards: int):
    """Stable within-shard slot assignment shared by row and build-side
    packing: returns (order, sorted_shard, pos, counts) such that source
    row ``order[i]`` belongs in slab slot ``[sorted_shard[i], pos[i]]``."""
    counts = np.bincount(shard, minlength=n_shards)
    order = np.argsort(shard, kind="stable")
    ss = shard[order]
    starts = np.zeros(n_shards, np.int64)
    starts[1:] = np.cumsum(counts)[:-1]
    pos = np.arange(len(shard)) - starts[ss]
    return order, ss, pos, counts


def _slab_bytes(slab: dict) -> int:
    """Device bytes of a slab: its blocks on every placement."""
    blocks = [b for v in slab["cols"].values() for b in v]
    blocks += [b for v in slab["dests"].values() for b in v]
    return _blocks_bytes(blocks + list(slab["valid"]))


def _shard_assignment(proj, cols_np: Dict[str, np.ndarray], n: int,
                      n_shards: int, ring: Optional[np.ndarray] = None,
                      base: int = 0) -> np.ndarray:
    """Shard per row: ring hash of the segmentation columns, OFFSET-FREE
    (core/segmentation.shard_of) -- the same logical row must land on the
    same shard whether the primary or the ring-offset buddy store served
    it.  Trickle-loaded WOS rows arrive with their ring value already
    stamped at commit (``ring``), so no re-hash.  Replicated projections
    have no ring: spread rows round-robin."""
    seg = proj.segmentation
    if seg.replicated:
        return ((base + np.arange(n, dtype=np.int64))
                % n_shards).astype(np.int32)
    if ring is None:
        ring = hash_columns(*[cols_np[c] for c in seg.columns])
    return shard_of(ring, n_shards)


def _partition_to_slab(cols_np: Dict[str, np.ndarray], shard: np.ndarray,
                       reseg_keys: Sequence[str], mesh,
                       keep_layout: bool = False) -> Optional[dict]:
    """Pack host rows (already canonicalized) into a ``(n_shards, per)``
    slab from each row's shard assignment, uploaded as the placements'
    blocks.  Used for the
    commit-time WOS buffers (the ROS slab builds on the device,
    ``_build_ros_slab_device``).  Zero rows return the empty-slab sentinel
    ``None``.  ``keep_layout`` additionally records the (order, shard,
    slot) map so a caller can scatter per-row host data (e.g. an epoch
    visibility mask) into slab slots later without repartitioning."""
    n = len(shard)
    if n == 0:
        return None
    n_shards = mesh.n_shards
    dests = {k: shard_of(hash_columns(cols_np[k]), n_shards)
             for k in reseg_keys}

    # observed per-column bounds: static pack radices for the shard
    # program (exact, tighter than SMA estimates)
    bounds = {}
    for c, v in cols_np.items():
        bounds[c] = (int(v.min()), int(v.max())) \
            if v.dtype.kind in "iub" else None

    order, ss, pos, counts = _slab_positions(shard, n_shards)
    per = _round_up(counts.max())

    out_cols = {}
    for c, v in cols_np.items():
        buf = np.zeros((n_shards, per), v.dtype)
        buf[ss, pos] = v[order]
        out_cols[c] = _upload(mesh, buf)
    vbuf = np.zeros((n_shards, per), bool)
    vbuf[ss, pos] = True
    out_dests = {}
    for k, d in dests.items():
        # pad slots point at their own shard so an exchange leaves them
        # in place instead of piling them all onto shard 0
        dbuf = np.repeat(np.arange(n_shards, dtype=np.int32)[:, None],
                         per, axis=1)
        dbuf[ss, pos] = d[order]
        out_dests[k] = _upload(mesh, dbuf)

    out = {"cols": out_cols, "valid": _upload(mesh, vbuf),
           "per": int(per), "n_rows": n, "dests": out_dests,
           "real": {k: np.bincount(d, minlength=n_shards)
                    for k, d in dests.items()},
           "r0": counts, "bounds": bounds}
    if keep_layout:
        out["layout"] = (order, ss, pos)
    return out


# ------------------------------------------------- device ROS slab build --

def _dest_assign(valid: torch.Tensor, segd: Dict[str, torch.Tensor],
                 resegd: Dict[str, torch.Tensor], n_shards: int,
                 seg_cols: Tuple[str, ...], reseg_keys: Tuple[str, ...],
                 replicated: bool):
    """Build phase B1: per-row shard ownership and resegment destinations
    from the DEVICE hash twins, plus the exact histograms that size the
    build exchange -- per-source bucket counts over ALL rows (invalid
    rows stay on their own shard, so they can never overflow a bucket),
    and per-destination counts of the valid rows."""
    n_local = valid.shape[1]
    me = _shard_ids(n_shards, valid.device)
    if replicated:
        dest_v = ((me.to(torch.int64) * n_local
                   + torch.arange(n_local, device=valid.device))
                  % n_shards).to(torch.int32)
    else:
        dest_v = shard_of_torch(
            hash_columns_torch(*[segd[c] for c in seg_cols]), n_shards)
    dest0 = torch.where(valid, dest_v, me)
    bucket = _dest_hist(dest0, n_shards)          # ALL rows, per source
    r0 = _dest_hist(dest0, n_shards, valid).sum(0)
    dests, reals = {}, {}
    for k in reseg_keys:
        dk = shard_of_torch(hash_columns_torch(resegd[k]), n_shards)
        dests[k] = dk
        reals[k] = _dest_hist(dk, n_shards, valid).sum(0)
    return dest0, dests, bucket, r0, reals


def _compact(cols: Dict[str, torch.Tensor], valid: torch.Tensor,
             dests: Dict[str, torch.Tensor], names: Tuple[str, ...],
             per_out: int, sb: int):
    """Build phase B2: per shard, move valid rows to the front (stable,
    preserving source container order -- at one shard the slab keeps the
    exact single-node scan order, so its block SMAs prune at least as
    tightly), slice to the padded row budget, and compute per-block
    min/max/count SMAs over the surviving layout."""
    n_shards = valid.shape[0]
    nb = per_out // sb
    take = torch.argsort((~valid).to(torch.int8), dim=1,
                         stable=True)[:, :per_out]
    out_cols = {c: torch.gather(v, 1, take) for c, v in cols.items()}
    valid_c = torch.gather(valid, 1, take)
    out_dests = {k: torch.gather(d, 1, take) for k, d in dests.items()}
    v3 = valid_c.reshape(n_shards, nb, sb)
    bcount = v3.sum(2, dtype=torch.int32)
    bmins, bmaxs = {}, {}
    for c in names:
        arr = out_cols[c].reshape(n_shards, nb, sb)
        if arr.is_floating_point():
            hi, lo = float("inf"), float("-inf")
        else:
            info = torch.iinfo(arr.dtype)
            hi, lo = info.max, info.min
        bmins[c] = torch.where(v3, arr, hi).amin(2)
        bmaxs[c] = torch.where(v3, arr, lo).amax(2)
    return out_cols, valid_c, out_dests, bcount, bmins, bmaxs


def _build_ros_slab_device(db: VerticaDB, proj, plan, need: Sequence[str],
                           reseg_keys: Sequence[str], eff: int, mesh,
                           stats) -> Optional[dict]:
    """Device-side ROS slab build: cached decoded device blocks -> ring
    hash + destination histograms (B1) on the database's device -> one
    exchange that sends each row to its shard's placement -> compaction +
    block SMAs (B2) on every placement.  The only host traffic is the
    visibility mask going up and the small histograms/SMA stats coming
    back (one copy each per device) -- never the columns."""
    got = fused_exec.snapshot_scan_device(db, plan, need, eff, stats)
    if got is None:
        return None
    cols_dev, valid_np = got
    if not bool(valid_np.any()):
        return None
    n_shards = mesh.n_shards
    dev = db.device
    n_total = int(valid_np.shape[0])
    n_vis = int(valid_np.sum())
    per_src = -(-n_total // n_shards)
    pad = n_shards * per_src - n_total
    cols_p = {}
    for c in need:
        v = cols_dev[c]
        if pad:
            v = torch.cat([v, v.new_zeros(pad)])
        cols_p[c] = v.reshape(n_shards, per_src)
    vp = np.pad(valid_np, (0, pad)) if pad else valid_np
    valid_p = to_device(vp.reshape(n_shards, per_src), dev)

    seg = proj.segmentation
    seg_cols = () if seg.replicated else tuple(seg.columns)
    reseg_keys = tuple(reseg_keys)
    dest0, dests_raw, bucket, r0, reals = _dest_assign(
        valid_p, {c: cols_p[c] for c in seg_cols},
        {k: cols_p[k] for k in reseg_keys}, n_shards, seg_cols,
        reseg_keys, seg.replicated)
    hist = to_host(dict({"bucket": bucket, "r0": r0},
                        **{"real:" + k: v for k, v in reals.items()}))
    bucket_np = hist["bucket"]
    r0_np = hist["r0"].astype(np.int64)
    real_np = {k: hist["real:" + k].astype(np.int64) for k in reseg_keys}

    # capacity from the exact per-source histogram: overflow-free by
    # construction.  Block-multiple so the compacted layout reshapes.
    per_b = _round_up(int(bucket_np.max()), _SLAB_BLOCK)
    names_p = list(need) + ["__v"] + ["__d:" + k for k in reseg_keys]
    payload = [cols_p[c] for c in need] + [valid_p.to(torch.int8)] \
        + [dests_raw[k] for k in reseg_keys]      # bools ride as bytes
    # the snapshot is every source shard's, on the database's device: the
    # Send goes from there to each shard's placement
    moved, slot_valid, overflow = exchange.resegment_blocks(
        mesh, per_b, [dest0], [tuple(payload)], sources=[None])

    per_out = _round_up(max(int(r0_np.max()), 1), _SLAB_BLOCK)
    names = tuple(sorted(need))
    k = mesh.shards_per_placement
    blocks, stats_b = [], []
    for p, (lo, pdev) in enumerate(mesh.placements()):
        mv = dict(zip(names_p, moved[p]))
        valid2 = (mv["__v"] != 0) & slot_valid[p]
        # invalid slots (pads AND rows deleted at this epoch) must point
        # at their own shard so every later exchange leaves them in place
        # -- that invariant is what makes the staged capacity math exact
        me = _shard_ids(k, pdev, lo)
        dests2 = {d: torch.where(valid2, mv["__d:" + d], me)
                  for d in reseg_keys}
        cols_c, valid_c, dests_c, bcount, bmins, bmaxs = _compact(
            {c: mv[c] for c in need}, valid2, dests2, names, per_out,
            _SLAB_BLOCK)
        blocks.append((cols_c, valid_c, dests_c))
        stats_b.append(dict({"count": bcount},
                            **{"min:" + c: v for c, v in bmins.items()},
                            **{"max:" + c: v for c, v in bmaxs.items()}))
    sma = _host_blocks(stats_b, {"overflow": overflow})
    if int(sma["overflow"].sum()):
        return None                             # defensive; cannot happen
    bcount_np = sma["count"]
    bmins_np = {c: sma["min:" + c] for c in names}
    bmaxs_np = {c: sma["max:" + c] for c in names}
    bounds = {}
    for c in need:
        if not cols_p[c].is_floating_point():
            sel = bcount_np > 0
            bounds[c] = (int(bmins_np[c][sel].min()),
                         int(bmaxs_np[c][sel].max()))
        else:
            bounds[c] = None
    return {"cols": {c: [b[0][c] for b in blocks] for c in need},
            "valid": [b[1] for b in blocks],
            "dests": {d: [b[2][d] for b in blocks] for d in reseg_keys},
            "per": per_out, "n_rows": n_vis, "r0": r0_np,
            "real": real_np, "bounds": bounds, "sb": _SLAB_BLOCK,
            "bstats": (bcount_np, bmins_np, bmaxs_np)}


# -------------------------------------------- commit-time WOS buffers --

def _wos_buffer_key(store, mesh, axis: str) -> tuple:
    return ("wos", store.wos.version, _mesh_sig(mesh, axis))


def _build_wos_buffer(store, mesh) -> Optional[dict]:
    """Per-store device WOS buffer: EVERY projection column (plus a
    resegment-destination column per column), partitioned by the
    commit-stamped ring values.  Query-shape independent, so it can be
    built eagerly at commit time; a query subsets the columns it needs
    and uploads only its epoch's visibility mask."""
    proj = store.proj
    data, eps, _segs = store.wos.snapshot()
    n = len(eps)
    if n == 0:
        return None
    cols_np = {c: _canon_np(np.asarray(data[c])) for c in proj.columns}
    ring = store.wos.ring_snapshot()
    shard = _shard_assignment(proj, cols_np, n, mesh.n_shards, ring=ring)
    return _partition_to_slab(cols_np, shard, tuple(proj.columns), mesh,
                              keep_layout=True)


def _get_wos_buffer(db: VerticaDB, host: int, owner: str, mesh, axis: str
                    ) -> Optional[dict]:
    store = db.nodes[host].stores[owner]
    if store.wos.n_rows == 0:
        return None
    cache = getattr(db, "block_cache", None)
    if cache is None:
        return _build_wos_buffer(store, mesh)
    primary = store.proj.buddy_of or store.proj.name
    return cache.get_or_put(
        f"seg:{primary}", (_wos_buffer_key(store, mesh, axis), host, owner),
        KIND_WOS, lambda: _build_wos_buffer(store, mesh), _slab_bytes)


def prewarm_wos_buffer(db: VerticaDB, host: int, owner: str) -> None:
    """Commit-time hook (core/database.commit): stream the just-appended
    WOS batch into its per-shard device buffer while the commit is still
    holding the rows hot, so the next query's trickle delta is already
    resident.  Keyed by ``WOS.version`` -- a later append/delete/clear
    simply strands this entry for the LRU."""
    mesh = getattr(db, "mesh", None)
    axis = getattr(db, "mesh_axis", None)
    if mesh is None or getattr(db, "block_cache", None) is None:
        return
    node = db.nodes[host]
    if not node.up or owner not in node.stores:
        return
    _get_wos_buffer(db, host, owner, mesh, axis)


def _wos_parts(db: VerticaDB, plan, need: Sequence[str],
               reseg_keys: Sequence[str], as_of: int, mesh, axis: str
               ) -> List[dict]:
    """Per-source WOS slab views at this query's snapshot: the cached
    device buffer's columns subset to ``need``, with ONLY the epoch
    visibility mask built host-side and uploaded (one small bool array).
    Capacity accounting (``r0``/``real``) counts ALL buffered rows --
    rows invisible at this epoch still occupy slots whose destinations
    are their real ring targets, so undercounting them could overflow a
    later exchange."""
    parts = []
    for host, owner in plan.sources:
        store = db.nodes[host].stores[owner]
        buf = _get_wos_buffer(db, host, owner, mesh, axis)
        if buf is None:
            continue
        w = fused_exec.wos_visible(store, as_of)
        if w is None:
            continue
        vis = np.asarray(w[1], bool)
        if not vis.any():
            continue
        order, ss, pos = buf["layout"]
        vbuf = np.zeros((mesh.n_shards, buf["per"]), bool)
        vbuf[ss, pos] = vis[order]
        parts.append({
            "cols": {c: buf["cols"][c] for c in need},
            "valid": _upload(mesh, vbuf),
            "dests": {k: buf["dests"][k] for k in reseg_keys},
            "per": buf["per"], "n_rows": int(vis.sum()),
            "r0": buf["r0"],
            "real": {k: buf["real"][k] for k in reseg_keys},
            "bounds": {c: buf["bounds"][c] for c in need}})
    return parts


# ------------------------------------------------- slab concatenation --

def _merge_bounds(a: Optional[tuple], b: Optional[tuple]
                  ) -> Optional[tuple]:
    if a is None or b is None:
        return None
    return (min(a[0], b[0]), max(a[1], b[1]))


def _cat_rows(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor]
              ) -> List[torch.Tensor]:
    return [torch.cat([x, y], 1) for x, y in zip(a, b)]


def _concat_slabs(ros: dict, wos: dict) -> dict:
    """Append one slab to another shard-locally (both are already
    partitioned by the same ring map, so this is a concatenation along
    each shard's rows on its placement -- no exchange)."""
    return {"cols": {c: _cat_rows(v, wos["cols"][c])
                     for c, v in ros["cols"].items()},
            "valid": _cat_rows(ros["valid"], wos["valid"]),
            "dests": {k: _cat_rows(d, wos["dests"][k])
                      for k, d in ros["dests"].items()},
            "per": ros["per"] + wos["per"],
            "n_rows": ros["n_rows"] + wos["n_rows"],
            "real": {k: ros["real"][k] + wos["real"][k]
                     for k in ros["real"]},
            "r0": ros["r0"] + wos["r0"],
            "bounds": {c: _merge_bounds(ros["bounds"][c],
                                        wos["bounds"][c])
                       for c in ros["bounds"]}}


# ------------------------------------------------ slab-block pruning --

def _prune_slab(q: LogicalQuery, slab: dict, mesh, stats) -> dict:
    """Per-query slab-block pruning: the predicate's column bounds
    against the slab's per-block SMAs (device-computed at build time)
    select the surviving ``sb``-row blocks; each shard gathers just
    those, on its placement.  Conservative by construction -- a pruned
    block contains no row satisfying the predicate, and the segmented
    subset only runs inner joins, which never resurrect rows."""
    if "bstats" not in slab:
        return slab
    bcounts, bmins, bmaxs = slab["bstats"]
    total = int(bcounts.size)
    stats.blocks_total += total
    if q.predicate is None:
        return slab
    pbounds = q.predicate.bounds()
    keep = bcounts > 0
    applied = False
    for c, (lo, hi) in pbounds.items():
        if c not in bmins:
            continue
        lo = -np.inf if lo is None else lo
        hi = np.inf if hi is None else hi
        keep &= (bmaxs[c] >= lo) & (bmins[c] <= hi)
        applied = True
    if not applied:
        return slab
    kept = int(keep.sum())
    stats.blocks_pruned += total - kept
    if kept == total:
        return slab
    n_shards = mesh.n_shards
    sb = slab["sb"]
    nb = slab["per"] // sb
    # gather width: the most surviving blocks on any shard.  kept == 0
    # keeps one all-dead block -- the stage runs with every row invalid
    # and yields exactly the empty aggregation a predicate matching
    # nothing produces
    k2 = max(int(keep.sum(axis=1).max()), 1)
    idx = np.zeros((n_shards, k2), np.int64)
    live = np.zeros((n_shards, k2), bool)
    for s in range(n_shards):
        ki = np.flatnonzero(keep[s])[:k2]
        idx[s, :len(ki)] = ki
        live[s, :len(ki)] = True
    k = mesh.shards_per_placement
    cols = {c: [] for c in slab["cols"]}
    dests = {d: [] for d in slab["dests"]}
    valid, hists = [], []
    for p, (lo, dev) in enumerate(mesh.placements()):
        idx_d = torch.from_numpy(idx[lo:lo + k]).to(dev)
        liv = torch.from_numpy(live[lo:lo + k]).to(dev).repeat_interleave(
            sb, dim=1)
        rows = torch.arange(k, device=dev).unsqueeze(1)

        def gather(v: torch.Tensor) -> torch.Tensor:
            return v.reshape(k, nb, sb)[rows, idx_d].reshape(k, k2 * sb)

        for c, v in slab["cols"].items():
            cols[c].append(gather(v[p]))
        valid.append(gather(slab["valid"][p]) & liv)
        # gathered pad blocks replay block 0's destinations: re-point
        # them at their own shard or they would travel on the next
        # exchange and break the capacity accounting
        me = _shard_ids(k, dev, lo)
        for d, v in slab["dests"].items():
            dests[d].append(torch.where(liv, gather(v[p]), me))
        # EXACT per-destination histograms over the surviving rows: the
        # staged capacity proof needs ``real`` to count precisely the rows
        # occupying slots (a pre-prune overestimate could undersize a
        # SECOND resegment stage's own-shard pad accounting)
        hists.append({d: _dest_hist(v[-1], n_shards, valid[-1]).sum(
            0, keepdim=True) for d, v in dests.items()})
    reals = _host_blocks(hists) if dests else {}
    r0_kept = np.array([int(bcounts[s][keep[s]].sum())
                        for s in range(n_shards)], np.int64)
    out = dict(slab)
    out.update(cols=cols, valid=valid, dests=dests, per=k2 * sb,
               r0=r0_kept,
               real={d: v.sum(0).astype(np.int64) for d, v in reals.items()})
    out.pop("bstats", None)
    return out


def _sharded_scan(db: VerticaDB, proj, plan, q: LogicalQuery, need,
                  reseg_keys, as_of: int, mesh, axis: str, stats
                  ) -> Optional[dict]:
    """Partitioned scan: the device-built ROS slab is cached (keyed by
    the effective epoch + exact container set, invalidated precisely by
    the tuple mover), pruned per query against its block SMAs, then the
    per-store WOS buffer views are appended shard-locally -- a
    trickle-load commit therefore costs one small WOS visibility upload,
    never a whole-projection repartition."""
    # injection points: one per source store feeding the slab.  A crash
    # here fails the host node and escalates to query-level failover (the
    # retry replans onto buddy stores); transients retry in place.
    for host, owner in plan.sources:
        point = "segmented.buddy_read" \
            if db.catalog.projections[owner].buddy_of is not None \
            else "segmented.slab_build"
        fire_with_retries(db, point, stats=stats, node=host,
                          projection=owner)
    cache = getattr(db, "block_cache", None)
    ros = None
    if cache is None:
        ros = _build_ros_slab_device(db, proj, plan, need, reseg_keys,
                                     as_of, mesh, stats)
        stats.seg_slab = "nocache"
    else:
        ceil = max((db.nodes[h].stores[o].epoch_ceiling(include_wos=False)
                    for h, o in plan.sources), default=0)
        eff = min(as_of, ceil)
        sig = _source_sig(db, plan, need, reseg_keys, eff, mesh, axis)
        ids = frozenset(i for item in sig[0] for i in item[2])
        key = ("slab", ids, sig)
        cid = f"seg:{plan.projection}"
        ros = cache.get(cid, key, KIND_SEG)
        stats.seg_slab = "hit" if ros is not None else "miss"
        if ros is None:
            ros = _build_ros_slab_device(db, proj, plan, need, reseg_keys,
                                         eff, mesh, stats)
            if ros is not None:
                cache.put(cid, key, KIND_SEG, ros, _slab_bytes(ros))
    wos_parts = _wos_parts(db, plan, need, reseg_keys, as_of, mesh, axis)
    if wos_parts:
        stats.seg_slab += "+wos"
    if ros is None and not wos_parts:
        return None
    stats.rows_scanned = (0 if ros is None else ros["n_rows"]) \
        + sum(p["n_rows"] for p in wos_parts)
    if ros is not None:
        ros = _prune_slab(q, ros, mesh, stats)
    parts = ([] if ros is None else [ros]) + wos_parts
    slab = parts[0]
    for p in parts[1:]:
        slab = _concat_slabs(slab, p)
    return slab


# ---------------------------------------------------------------------------
# 2. Build-side placement per exchange strategy
# ---------------------------------------------------------------------------

def _partition_build(bnp: Dict[str, np.ndarray], shard: np.ndarray,
                     mesh) -> Dict[str, List[torch.Tensor]]:
    """Place dimension rows onto shards by hash(dim_key), padded per shard
    with copies of row 0, as the placements' ``[k, per]`` blocks.  A pad
    copy is harmless: a probe key equal to the pad's key hashes to the
    pad's home shard, so on any other shard no probe row can match it,
    and on its home shard the duplicate carries identical values."""
    n_shards = mesh.n_shards
    n = len(shard)
    if n == 0:
        return {c: _upload(mesh, np.zeros((n_shards, 0), _canon_np(v).dtype))
                for c, v in bnp.items()}
    order, ss, pos, counts = _slab_positions(shard, n_shards)
    per = max(int(counts.max()), 1)
    out = {}
    for c, v in bnp.items():
        v = _canon_np(v)
        buf = np.full((n_shards, per), v[0], v.dtype)
        buf[ss, pos] = v[order]
        out[c] = _upload(mesh, buf)
    return out


def _broadcast_build(bnp: Dict[str, np.ndarray], mesh, axis: str
                     ) -> Dict[str, List[torch.Tensor]]:
    """Split the build side contiguously across shards, then replicate it
    with the all_gather (exchange.broadcast_build_side)."""
    n_shards = mesh.n_shards
    n = len(next(iter(bnp.values())))
    per = -(-n // n_shards) if n else 0
    cols = {}
    for c, v in bnp.items():
        v = _canon_np(v)
        buf = np.full(n_shards * per, v[0] if n else 0, v.dtype)
        buf[:n] = v
        cols[c] = _upload(mesh, buf.reshape(n_shards, per))
    return exchange.broadcast_build_side(mesh, axis, cols)


def _place_one_build(db: VerticaDB, spec, exch: str,
                     build: Dict[str, torch.Tensor], mesh, axis: str,
                     replicated: bool
                     ) -> Tuple[Dict[str, List[torch.Tensor]], Dict]:
    """(placed blocks, per-column host bounds) for one join: per
    placement, a ``(n,)`` tensor every shard reads when ``replicated``,
    else the ``[k, per]`` partitions of its shards."""
    bnp = to_host(build)
    bounds = {}
    for c, v in bnp.items():
        if not v.size:
            bounds[c] = (0, 0)
        elif v.dtype.kind in "iub":
            bounds[c] = (int(v.min()), int(v.max()))
        else:
            bounds[c] = None
    if exch == "broadcast":
        return _broadcast_build(bnp, mesh, axis), bounds
    if replicated:
        return {c: _replicate(mesh, _canon_np(v))
                for c, v in bnp.items()}, bounds
    # co-located (probe placed by the join key) or the dim side of a
    # resegment: place rows by hash(dim_key) on the same offset-free
    # ring map the probe side uses
    shard = shard_of(hash_columns(bnp[spec.dim_key]), mesh.n_shards)
    return _partition_build(bnp, shard, mesh), bounds


def _place_builds(db: VerticaDB, q: LogicalQuery, plan, as_of: int, mesh,
                  axis: str, stats=None
                  ) -> Tuple[List[Dict[str, List[torch.Tensor]]],
                             List[bool], List[Dict]]:
    """Returns (placed build dicts, per-join "replicated" flags -- the
    reference's P() in_specs --, per-join dim-column bounds).  Placed
    builds are cached device-side keyed by (dim table, join signature,
    exchange op, mesh identity, snapshot epoch) -- MVCC makes the
    fixed-epoch read immutable, so a warm repeat skips the host
    round-trip and re-partition; drop_partition invalidates the dim's
    entries."""
    builds_dev = fused_exec.build_join_sides(db, q, as_of)
    cache = getattr(db, "block_cache", None)
    mh = hash(_mesh_sig(mesh, axis)) & 0xFFFFFFFFFFFFFFFF
    placed, reps, bounds = [], [], []
    for spec, exch, build in zip(q.joins, plan.join_exchanges, builds_dev):
        replicated_dim = db.catalog.super_of(
            spec.dim_table).segmentation.replicated
        replicated = exch == "broadcast" or (exch == "local"
                                             and replicated_dim)
        reps.append(replicated)
        if exch == "broadcast":
            # the all_gather of the small build side is an exchange too:
            # a crash/transient here follows the same taxonomy
            fire_with_retries(db, "exchange.broadcast", stats=stats,
                              join=spec.dim_table)

        def make(spec=spec, exch=exch, build=build, replicated=replicated):
            return _place_one_build(db, spec, exch, build, mesh, axis,
                                    replicated)
        if cache is None:
            pb = make()
        else:
            pb = cache.get_or_put(
                f"dim:{spec.dim_table}",
                f"seg|{spec.signature()}|{exch}|{mh:016x}@{as_of}",
                fused_exec.KIND_BUILD, make,
                lambda v: _blocks_bytes([b for a in v[0].values()
                                         for b in a]))
        placed.append(pb[0])
        bounds.append(pb[1])
    return placed, reps, bounds


# ---------------------------------------------------------------------------
# 3. Stage programs (plan-cached closures over the shard dimension)
# ---------------------------------------------------------------------------

def _mesh_sig(mesh, axis: str) -> tuple:
    return mesh.signature(axis)


def _shard_join(build: Dict[str, torch.Tensor], replicated: bool,
                spec, cols: Dict[str, torch.Tensor], valid: torch.Tensor
                ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Inner N:1 hash join of every shard's rows against its build side:
    the one replicated build (a flat join over all shards' rows), or the
    shard's own ``[n_shards, per]`` partition (a batched per-shard sort
    and search, so a row can only match the build rows of its shard)."""
    n_shards, n = valid.shape
    if replicated:
        flat = {c: v.reshape(-1) for c, v in cols.items()}
        out, ok = ops.hash_join(build, spec.dim_key, flat, spec.fact_key,
                                valid.reshape(-1), how=spec.how)
        return ({c: v.reshape(n_shards, n) for c, v in out.items()},
                ok.reshape(n_shards, n))
    bk, pk = build[spec.dim_key], cols[spec.fact_key]
    out = dict(cols)
    if bk.shape[1] == 0:
        for c, v in build.items():
            if c != spec.dim_key:
                out[c] = torch.full((n_shards, n), -1, dtype=v.dtype,
                                    device=pk.device)
        return out, torch.zeros_like(valid)
    dt = torch.promote_types(bk.dtype, pk.dtype)
    order = torch.argsort(bk, dim=1, stable=True)
    bks = torch.gather(bk, 1, order).to(dt)
    pkd = pk.to(dt).contiguous()
    idx = torch.searchsorted(bks, pkd).clamp_(0, bk.shape[1] - 1)
    matched = torch.gather(bks, 1, idx) == pkd
    for c, v in build.items():
        if c != spec.dim_key:
            out[c] = torch.gather(torch.gather(v, 1, order), 1, idx)
    return out, valid & matched


def _shard_preagg(keys: torch.Tensor, valid: torch.Tensor,
                  values: Dict[str, torch.Tensor], domain: int, aggs,
                  first: int, n_shards: int) -> Dict[str, torch.Tensor]:
    """Shard-local dense pre-aggregation of one placement's ``k`` shards
    from shard ``first`` on: ``[k, domain]`` partials, exactly each
    shard's own ``seg_preagg`` over its rows.  One launch covers the
    placement's shards -- keys clip into [0, domain) as the kernel clips
    them, then move to ``shard * domain + key`` with the GLOBAL shard id,
    over the mesh's whole domain of ``n_shards * domain``, so each
    placement fills its own shards' rows of the table one launch over
    every shard would -- unless that passes the int32 key lane, where each
    shard launches on its own."""
    k = keys.shape[0]
    if n_shards * domain < _PACK_LIMIT:
        g = _shard_ids(k, keys.device, first) * domain \
            + keys.to(torch.int32).clamp(0, domain - 1)
        out = kops.seg_preagg(g.reshape(-1), valid.reshape(-1),
                              {c: v.reshape(-1) for c, v in values.items()},
                              n_shards * domain, aggs)
        return {name: v.reshape(n_shards, domain)[first:first + k]
                for name, v in out.items()}
    parts = [kops.seg_preagg(keys[s].to(torch.int32), valid[s],
                             {c: v[s] for c, v in values.items()},
                             domain, aggs) for s in range(k)]
    return {name: torch.stack([p[name] for p in parts]) for name in parts[0]}


def _shard_groupby_sort(keys: torch.Tensor, valid: torch.Tensor,
                        values: Dict[str, torch.Tensor], max_groups: int,
                        aggs) -> Dict[str, torch.Tensor]:
    """Sort-based partials past the dense limit, one per shard."""
    parts = [ops.groupby_sort(keys[s], valid[s],
                              {c: v[s] for c, v in values.items()},
                              max_groups, aggs)
             for s in range(keys.shape[0])]
    return {name: torch.stack([p[name] for p in parts]) for name in parts[0]}


def _build_stage(mesh, specs: Sequence, reps: Sequence[bool],
                 reseg_key: Optional[str], final_cfg):
    """One exchange->join(->pre-agg) stage as a single closure over the
    placements: ``exchange.resegment_blocks`` (when the stage opens with a
    Send/Recv), then on each placement the stage's hash joins, and -- for
    the final stage -- derived exprs, deferred predicate, key packing and
    the shard-local pre-aggregation.  Inputs and outputs are per
    placement: columns, valid and destinations as lists of ``[k, per]``
    blocks, each build as lists of its placements' blocks; the result is
    one dict per placement.  The exchange OVERFLOW report is returned as
    an output instead of being checked inline, so a multi-stage query
    runs its whole chain without a host sync in the middle.  The exchange
    capacity ``per_new`` is an argument, so data growth reuses the
    entry."""
    reseg = reseg_key is not None
    k = mesh.shards_per_placement
    placements = mesh.placements()

    if final_cfg is not None:
        (ir, algo, domains, lows, domain, local_aggs, values_cols,
         packed) = final_cfg

    def local(cols, valid, dests, builds, first: int):
        """The stage's work on one placement's shards."""
        dev = valid.device
        for spec, bld, rep in zip(specs, builds, reps):
            cols, valid = _shard_join(bld, rep, spec, cols, valid)
        if final_cfg is None:
            out = dict(cols)
            out["__valid"] = valid
            for key, d in dests.items():
                out["__d:" + key] = d
            return out
        for name, e in ir.derived:
            cols[name] = e(cols)
        if ir.predicate is not None:
            valid = valid & as_mask(ir.predicate(cols), valid)
        values = {c: cols[c] for c in values_cols}
        if not ir.group_by:
            keys = torch.zeros(valid.shape, dtype=torch.int32, device=dev)
            return _shard_preagg(keys, valid, values, 1, local_aggs, first,
                                 mesh.n_shards)
        keys = ops.pack_keys([cols[g] for g in ir.group_by], domains, lows) \
            if packed else cols[ir.group_by[0]]
        if algo == "dense":
            return _shard_preagg(keys, valid, values, domain, local_aggs,
                                 first, mesh.n_shards)
        return _shard_groupby_sort(keys, valid, values, domain, local_aggs)

    def run(cols, valid, dests, builds, per_new: int):
        dests = dict(dests)
        if reseg:
            dest_l = dests.pop(reseg_key)
            names = sorted(cols)
            dkeys = sorted(dests)
            vals = [tuple(cols[c][p] for c in names)
                    + tuple(dests[d][p] for d in dkeys)
                    + (valid[p].to(torch.int8),)
                    for p in range(len(placements))]
            moved, vr, overflow = exchange.resegment_blocks(
                mesh, per_new, dest_l, vals)
        else:
            overflow = torch.zeros(mesh.n_shards, dtype=torch.int32,
                                   device=mesh.device)
        outs = []
        for p, (first, dev) in enumerate(placements):
            if reseg:
                nn = len(names)
                c_p = dict(zip(names, moved[p][:nn]))
                # empty slots point at their own shard so the NEXT
                # exchange leaves them in place; occupied slots keep their
                # moved destination (a join-invalidated row's destination
                # is still counted by the build histogram)
                me = _shard_ids(k, dev, first)
                d_p = {d: torch.where(vr[p], moved[p][nn + i], me)
                       for i, d in enumerate(dkeys)}
                v_p = (moved[p][-1] != 0) & vr[p]
            else:
                c_p = {c: v[p] for c, v in cols.items()}
                d_p = {d: v[p] for d, v in dests.items()}
                v_p = valid[p]
            b_p = [{c: v[p] for c, v in bld.items()} for bld in builds]
            outs.append(local(c_p, v_p, d_p, b_p, first))
        return outs, overflow

    return run


# ---------------------------------------------------------------------------
# 4. Final merge (host-side, over small partials)
# ---------------------------------------------------------------------------

def _merge_scalar(aggs, res, n_shards: int) -> Dict[str, np.ndarray]:
    counts = np.asarray(res["group_count"]).reshape(n_shards)
    total = int(counts.sum())
    out = {"group_count": np.asarray([total])}
    for name, _, kind in aggs:
        v = np.asarray(res[name]).reshape(n_shards)
        if kind in ("sum", "count"):
            out[name] = np.asarray([v.sum()])
        elif kind == "avg":
            out[name] = np.asarray([v.sum() / max(total, 1)])
        elif kind == "min":
            out[name] = np.asarray([v.min()])
        else:
            out[name] = np.asarray([v.max()])
    return out


def _merge_dense(aggs, res, n_shards: int, domain: int
                 ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    counts = np.asarray(res["group_count"]).reshape(n_shards, domain)
    counts = counts.sum(0)
    sel = counts > 0
    gkeys = np.flatnonzero(sel)
    out = {"group_count": counts[sel]}
    for name, _, kind in aggs:
        v = np.asarray(res[name]).reshape(n_shards, domain)
        if kind in ("sum", "count"):
            m = v.sum(0)
        elif kind == "avg":
            m = v.sum(0) / np.maximum(counts, 1)
        elif kind == "min":
            m = v.min(0)
        else:
            m = v.max(0)
        out[name] = m[sel]
    return gkeys, out


def _merge_sorted(aggs, res, n_shards: int, max_groups: int
                  ) -> Optional[Tuple[np.ndarray, Dict[str, np.ndarray]]]:
    ngs = np.asarray(res["n_groups"]).reshape(n_shards)
    if (ngs > max_groups).any():
        return None               # local sort cap exceeded: fall back
    gk = np.asarray(res["group_keys"]).reshape(n_shards, max_groups)
    gc = np.asarray(res["group_count"]).reshape(n_shards, max_groups)
    keys = np.concatenate([gk[s, :ngs[s]] for s in range(n_shards)])
    cnts = np.concatenate([gc[s, :ngs[s]] for s in range(n_shards)])
    if keys.size == 0:
        return np.zeros(0, np.int64), {
            "group_count": np.zeros(0, np.int64),
            **{name: np.zeros(0) for name, _, _ in aggs}}
    uniq, inv = np.unique(keys, return_inverse=True)
    inv = inv.reshape(-1)
    ng = len(uniq)
    counts = np.bincount(inv, weights=cnts, minlength=ng).astype(np.int64)
    out = {"group_count": counts}
    for name, _, kind in aggs:
        pv = np.asarray(res[name])
        v = np.concatenate([pv.reshape(
            n_shards, max_groups)[s, :ngs[s]] for s in range(n_shards)])
        if kind in ("sum", "count", "avg"):
            acc = np.bincount(inv, weights=v, minlength=ng)
            if kind == "avg":
                acc = acc / np.maximum(counts, 1)
        elif kind == "min":
            acc = np.full(ng, np.inf)
            np.minimum.at(acc, inv, v)
        else:
            acc = np.full(ng, -np.inf)
            np.maximum.at(acc, inv, v)
        # integer partials stay integral (the single-node path returns
        # int sums/mins/maxes for int columns; only avg is a ratio)
        if kind != "avg" and pv.dtype.kind in "iub":
            acc = acc.astype(np.int64)
        out[name] = acc
    return uniq, out


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def execute_segmented(db: VerticaDB, q: LogicalQuery, plan, as_of: int,
                      mesh, axis: str, stats
                      ) -> Optional[Dict[str, np.ndarray]]:
    """Run an aggregate query segmented across the mesh's shards.  Returns
    the merged (pre-HAVING/ORDER/LIMIT) result columns, or None to fall
    back to the single-node pipeline."""
    if not (q.aggs or q.group_by):
        return None               # plain selects stay single-node
    if any(j.how != "inner" for j in q.joins):
        return None
    derived_names = {n for n, _ in q.derived}
    if any(g in derived_names for g in q.group_by):
        return None               # no static pack bounds for derived keys

    n_shards = int(mesh.shape[axis])
    cards = tuple(dict.fromkeys((db.device,) + mesh.cards()))

    # ---- RLE-direct routes: aggregate each node's encoded runs and
    # merge -- the paper's "operate directly on encoded data" beats
    # shipping decoded rows through slabs for count-only GroupBys on the
    # sort leader (no predicate/joins/WOS/deletes; the helpers return
    # None otherwise and the slab path runs) ----
    from . import pipeline as _pipe
    if plan.scalar_rle:
        res = _pipe._rle_scalar_count(db, q, plan, as_of)
        if res is not None:
            stats.segmented = True
            stats.n_shards = n_shards
            stats.exchange = ";".join(plan.join_exchanges)
            stats.groupby_algorithm = "rle-scalar (segmented)"
            return res
    if _pipe.rle_direct_eligible(q, plan):
        res = _pipe._rle_groupby(db, q, plan, as_of)
        if res is not None:
            stats.segmented = True
            stats.n_shards = n_shards
            stats.exchange = ";".join(plan.join_exchanges)
            stats.groupby_algorithm = "rle (segmented)"
            return res

    proj = db.catalog.projections[plan.projection]
    reseg_keys = tuple(spec.fact_key for spec, e
                       in zip(q.joins, plan.join_exchanges)
                       if e == "resegment")
    need = set(q.scan_columns(proj))
    if not proj.segmentation.replicated:
        need |= set(proj.segmentation.columns)
    need |= set(reseg_keys)
    need = sorted(need & set(proj.columns))

    # per-stage wall clocks (ExecStats.stage_ms): opt-in because honest
    # stage boundaries need a device sync, which the normal path must
    # not pay
    timing = bool(getattr(db, "collect_stage_timing", False))

    def _tick(label: str, t0: float) -> float:
        if timing:
            _sync(cards)
            t1 = time.perf_counter()
            stats.stage_ms[label] = stats.stage_ms.get(label, 0.0) \
                + (t1 - t0) * 1e3
            return t1
        return t0

    t0 = time.perf_counter() if timing else 0.0
    slab = _sharded_scan(db, proj, plan, q, need, reseg_keys, as_of, mesh,
                         axis, stats)
    if slab is None:
        return None               # empty snapshot: pipeline shapes it
    _tick("slab_build", t0)

    builds, reps, build_bounds = _place_builds(
        db, q, plan, as_of, mesh, axis, stats)

    # ---- static pack radices for the group keys (exact host bounds) ----
    aggs = tuple(q.aggs)
    lows: Tuple[int, ...] = ()
    domains: Tuple[int, ...] = ()
    algo, domain = "dense", 1
    if q.group_by:
        los, doms = [], []
        for g in q.group_by:
            b = slab["bounds"].get(g)
            if b is None:
                for spec, bnds in zip(q.joins, build_bounds):
                    if g in spec.dim_columns:
                        b = bnds.get(g)
                        break
            if b is None:
                return None       # non-integral / unlocatable group key
            lo, hi = b
            lo = min(lo, 0)
            los.append(lo)
            doms.append(hi - lo + 1)
        total = 1
        for d in doms:
            total *= d
        if total >= _PACK_LIMIT:
            return None           # packed key overflows device int32
        lows, domains = tuple(los), tuple(doms)
        algo = "dense" if total <= plan.dense_domain_limit else "sort"
        domain = total if algo == "dense" else plan.max_groups

    values_cols = tuple(sorted({c for _, c, kind in aggs
                                if kind != "count" and c != "*"}))
    local_aggs = tuple((name, c, "sum" if kind == "avg" else kind)
                       for name, c, kind in aggs)
    packed = len(q.group_by) > 1 or (bool(lows) and lows[0] != 0)
    final_cfg = (q, algo, domains, lows, domain, local_aggs, values_cols,
                 packed)

    # ---- staged execution: joins run in plan order, with a resegment
    # exchange (Send/Recv) opening the stage of the join that needs it --
    # an up-front exchange would destroy the placement an earlier
    # co-located join depends on.  Each stage is ONE closure ----
    stage_joins: List[List[int]] = [[]]
    for ji, exch in enumerate(plan.join_exchanges):
        if exch == "resegment":
            stage_joins.append([])
        stage_joins[-1].append(ji)

    mesh_sig = _mesh_sig(mesh, axis)
    hit_all = True

    def run_stages(mult: int):
        nonlocal hit_all
        cols, valid = dict(slab["cols"]), slab["valid"]
        dest_cols = dict(slab["dests"])
        per_prev, real_prev = slab["per"], slab["r0"]
        overflows = []
        res = None
        ts = time.perf_counter() if timing else 0.0
        for si, stage in enumerate(stage_joins):
            final = si == len(stage_joins) - 1
            reseg_key = None
            per_new = 0
            if si > 0:
                spec0 = q.joins[stage[0]]
                reseg_key = spec0.fact_key
                if reseg_key not in dest_cols:
                    return None   # no destination column: fall back
                real_k = slab["real"][reseg_key]
                # exact destination occupancy: arriving rows + slots
                # that stay (pads and earlier arrivals not moving again)
                filled = real_k + per_prev - real_prev
                per_new = cost_mod.resegment_capacity(
                    filled, n_shards) // n_shards * mult
                fire_with_retries(db, "exchange.resegment", stats=stats,
                                  join=spec0.dim_table)
            elif not final and not stage:
                continue          # leading resegment: nothing local yet
            specs = tuple(q.joins[ji] for ji in stage)
            sb = tuple(builds[ji] for ji in stage)
            sreps = tuple(reps[ji] for ji in stage)
            if final:
                sig = ("seg2", q.exec_signature(), plan.projection,
                       proj.segmentation.kind,
                       tuple(proj.segmentation.columns), mesh_sig,
                       plan.join_exchanges, tuple(reps),
                       algo, int(domain), domains, lows, reseg_key)
                cfg = final_cfg
            else:
                sig = ("seg-stage2",
                       tuple(s.signature() for s in specs),
                       sreps, mesh_sig, reseg_key)
                cfg = None
            fn, hit = PLAN_CACHE.get_or_build(
                sig, lambda: _build_stage(mesh, specs, sreps, reseg_key,
                                          cfg))
            hit_all &= hit
            out, overflow = fn(cols, valid, dest_cols, sb, per_new)
            if reseg_key is not None:
                overflows.append(overflow)
                per_prev, real_prev = n_shards * per_new, real_k
            if final:
                # the final stage ends in the shard-local pre-aggregation
                # (kernels/seg_preagg)
                ts = _tick("preagg", ts)
                res = out
            else:
                ts = _tick("exchange_join", ts)
                valid = [o["__valid"] for o in out]
                dest_cols = {k[4:]: [o[k] for o in out] for k in out[0]
                             if k.startswith("__d:")}
                cols = {c: [o[c] for o in out] for c in out[0]
                        if not c.startswith("__")}
        return res, overflows

    # overflow is checked ONCE, after the final stage, in the same copy
    # that brings the partials back: capacities come from exact histograms
    # so a nonzero report is defensive -- record, double every stage's
    # capacity, retry the whole chain, then fall back
    res = None
    for mult in (1, 2):
        r = run_stages(mult)
        if r is None:
            return None
        res0, overflows = r
        # the placements' partials, concatenated in shard order, in one
        # copy per device
        host = _host_blocks(res0, {"__overflow": torch.stack(overflows)}
                            if overflows else None)
        ov = int(host.pop("__overflow").sum()) if overflows else 0
        if ov == 0:
            res = host
            break
        stats.reseg_overflow += ov
    if res is None:
        return None
    stats.plan_cache = "hit" if hit_all else "miss"

    # ---- final merge ----
    t0 = time.perf_counter() if timing else 0.0
    if not q.group_by:
        out = _merge_scalar(aggs, res, n_shards)
    else:
        merged = _merge_dense(aggs, res, n_shards, domain) \
            if algo == "dense" else _merge_sorted(aggs, res, n_shards,
                                                  domain)
        if merged is None:
            return None
        gkeys, out = merged
        key_cols = ops.unpack_keys(gkeys, domains, lows) if packed \
            else [np.asarray(gkeys).astype(np.int64)]
        for g, kv in zip(q.group_by, key_cols):
            out[g] = kv
    _tick("final_merge", t0)
    stats.segmented = True
    stats.n_shards = n_shards
    stats.exchange = ";".join(plan.join_exchanges)
    stats.groupby_algorithm = f"{algo} (segmented)"
    return out
