"""Compressed-domain execution: code-space predicates + late materialization.

Mirrors ``src/repro/engine/compressed.py``.  The paper's EE "operates
directly on encoded data" (§6.1): predicates on dictionary-encoded columns
are evaluated against the *codes*, GROUP BY keys stay in code space, and
only the rows that survive are ever decoded.  This module is the analog
for the fused aggregate path (engine/executor.py):

1.  **Plan-time rewrite** -- ``plan_compressed_scan`` decomposes the scan
    predicate into per-column integer intervals (expr.interval_decompose).
    For a BLOCK_DICT column the interval [lo, hi] becomes a per-block code
    range: codes are assigned in sorted value order, so the count of
    dictionary values below lo / at most hi brackets exactly the codes
    whose values fall inside the interval.

2.  **Code-domain GROUP BY** -- when every container encodes a group-by
    column as BLOCK_DICT, its container-global dictionaries are unioned
    and the per-block ``code_map`` composed into a block-code -> union-code
    remap.  The fused closure then groups on union codes (a dense domain
    of exactly ``len(union)``), and ``translate`` maps codes back to values
    on the host.  The union is sorted, so code order == value order.

3.  **Late materialization** -- non-predicate columns are gathered for
    *surviving rows only*: randomly-accessible encodings (PLAIN,
    DELTA_VALUE, BLOCK_DICT, FLOAT_SCALED over those) straight out of the
    packed device payload (``gather_decode_torch`` / ``gather_unpack``);
    sequential ones (RLE, DELTA_RANGE, COMMON_DELTA) decode into per-query
    temporaries.  The block cache only ever holds the packed payloads.

Where the port differs from the reference:

* It is eager: the reference's jitted-closure cache (``_JIT_CACHE``) has
  no counterpart.
* The mask program runs once per query over every container, not once
  per container: each packed predicate column -- BLOCK_DICT codes against
  per-block code ranges, DELTA_VALUE deltas with the base fused in,
  DELTA_RANGE deltas with ``delta_min`` fused in and the per-block cumsum
  after -- is unpacked by ONE ``bitunpack_segments`` launch over the kept
  blocks of all containers, the kept indices read in place.  Other
  encodings decode per container, as the reference does.
* ``_code_range`` is vectorised (counts instead of per-block
  ``searchsorted``; tests/test_torch_compressed.py holds it equal).
* The survivor positions stay on the device (the reference copies the
  whole mask to the host and uploads the survivor indices back, 24 bytes
  a survivor): the scan's one device-to-host copy is each kept block's
  running survivor count, which sizes every container's share.  No pow2
  survivor bucket (it only spared jax recompilations): the columns hold
  exactly the survivors, or one invalid row when none survives.
* Columns come out in the port's 32-bit lanes (``_to_lane``), and
  FLOAT_SCALED divides by a 0-d float32 tensor as ``decode_torch`` does,
  so every column is bit for bit the decoded scan's.

Eligibility is strict because the guarantee is byte-identity: integer
intervals on INT columns only, conjunctions only; anything else takes the
decoded scan.  ``db.exec_mode`` picks the policy ("auto" uses the
compressed scan only when the decoded working set is neither
device-resident nor able to fit the cache budget comfortably).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.block_cache import KIND_DECODED, KIND_ENCODED
from ..core.encodings import (Encoding, EncodedColumn, _stream_width,
                              _to_lane, decode_torch, device_bytes,
                              gather_decode_torch, random_access_torch,
                              upload_torch)
from ..core.types import SQLType
from ..kernels import ops as kops
from . import operators as ops
from .expr import Expr, interval_decompose

Interval = Tuple[Optional[int], Optional[int]]

_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1
# packed predicate streams the mask program unpacks in one launch, and the
# per-block base fused into the unpack
_PACKED_KEY = {Encoding.BLOCK_DICT: "codes_packed",
               Encoding.DELTA_VALUE: "deltas_packed",
               Encoding.DELTA_RANGE: "deltas_packed"}
_BASE_KEY = {Encoding.DELTA_VALUE: "base", Encoding.DELTA_RANGE: "delta_min"}


def _packed_key(col: EncodedColumn) -> Optional[str]:
    key = _PACKED_KEY.get(col.encoding)
    return key if key is not None and key in col.arrays else None


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """One host array on ``device`` (no stream sync: CUDA stages a pageable
    buffer before the copy call returns)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device,
                                                        non_blocking=True)


def _value_range(lo: Optional[int], hi: Optional[int]) -> Tuple[int, int]:
    """Inclusive [lo, hi] as int32 bounds with the same meaning on int32
    values: an open side is the lane's limit, an interval that misses the
    lane entirely is empty (1, 0)."""
    a = _I32_MIN if lo is None else max(lo, _I32_MIN)
    b = _I32_MAX if hi is None else min(hi, _I32_MAX)
    return (1, 0) if a > _I32_MAX or b < _I32_MIN else (a, b)


@dataclasses.dataclass
class CompressedScanPlan:
    """A plan-time rewrite of one fused scan into the code domain."""

    intervals: Dict[str, Interval]          # col -> inclusive int bounds
    containers: List[tuple]                 # [(store, ROSContainer), ...]
    need: List[str]                         # scan columns, sorted
    # group col -> sorted union dictionary (values); present only when the
    # column groups in code space
    group_dicts: Dict[str, np.ndarray]
    # (container id, group col) -> (n_blocks, dict_size) block-code ->
    # union-code remap
    union_maps: Dict[Tuple[int, str], np.ndarray]
    as_of: int
    # plan-cache identity: symbol widths of every packed stream touched +
    # union dictionary sizes (dictionary growth must miss the plan cache)
    sig_suffix: tuple

    # ------------------------------------------------------------ params --

    def key_domains(self, q, plan) -> Optional[Tuple[Optional[int], ...]]:
        """Per-key domains with dict-grouped columns overridden by their
        union dictionary size (codes are a dense [0, len(union)) domain)."""
        if not q.group_by:
            return None
        base = plan.key_domains or (None,) * len(q.group_by)
        return tuple(len(self.group_dicts[g]) if g in self.group_dicts
                     else base[i] for i, g in enumerate(q.group_by))

    # -------------------------------------------------------------- scan --

    def scan(self, db, predicate: Optional[Expr], sip,
             stats) -> Optional[ops.ScanResult]:
        """Code-domain scan: predicate in code/value space over packed
        payloads, ONE device-to-host copy (survivor counts), then
        late-materialize ``need`` columns for survivors only."""
        from .executor import cached_valid

        cache = getattr(db, "block_cache", None)
        dev = db.device

        def enc_of(c, name):
            col = c.columns[name]
            if cache is None:
                return upload_torch(col, dev)
            return cache.get_or_put(c.id, name, KIND_ENCODED,
                                    lambda: upload_torch(col, dev),
                                    device_bytes)

        # identical SMA pruning to scan_stores_batched (stats parity)
        bounds = predicate.bounds() if predicate is not None else {}
        pruned = total = 0
        parts = []                               # (store, container, kept)
        for store, c in self.containers:
            nb = c.columns[self.need[0]].n_blocks
            total += nb
            keep = np.ones(nb, dtype=bool)
            for colname, (lo, hi) in bounds.items():
                if colname in c.smas:
                    keep &= c.smas[colname].prune_blocks(lo, hi)
            kept = np.flatnonzero(keep)
            pruned += nb - kept.size
            if kept.size:
                stats.containers_scanned += 1
                parts.append((store, c, kept))
        stats.blocks_pruned, stats.blocks_total = pruned, total
        if not parts:
            return None

        br = parts[0][1].columns[self.need[0]].block_rows
        encs = [{name: enc_of(c, name) for name in self.need}
                for _, c, _ in parts]
        kepts = [kept for _, _, kept in parts]
        offs = np.cumsum([0] + [k.size for k in kepts])   # first scan row
        kept_all = _upload(np.concatenate(kepts), dev)
        kept_dev = [kept_all[offs[i]:offs[i + 1]] for i in range(len(parts))]

        # the mask program: validity, then every interval predicate
        vparts = []
        for (store, c, kept), kd in zip(parts, kept_dev):
            vb = cached_valid(db, store, c, self.as_of,
                              c.smas[self.need[0]].counts)
            vparts.append(vb if kept.size == vb.shape[0] else vb[kd])
        mask = vparts[0] if len(vparts) == 1 else torch.cat(vparts)
        tmps: List[Dict[str, torch.Tensor]] = [{} for _ in parts]
        for name, (lo, hi) in sorted(self.intervals.items()):
            mask = mask & _interval_mask(name, lo, hi, parts, encs,
                                         kept_dev, tmps, br, dev)

        # the scan's one device-to-host copy: the running survivor count
        # at the end of each kept block, which sizes every container's
        # share of the survivors; the positions themselves stay on the
        # device
        flat = mask.reshape(-1)
        ends = mask.sum(dim=1).cumsum(0).cpu().numpy()
        cuts = np.concatenate([[0], ends[offs[1:] - 1]])
        n = int(cuts[-1])
        stats.rows_scanned = int(flat.shape[0])
        stats.rows_materialized = n

        out: Dict[str, List[torch.Tensor]] = {name: [] for name in self.need}
        if n:
            # survivor positions in scan order: each survivor's rank is
            # its slot, every other row writes the spare slot n
            slot = torch.where(flat, flat.cumsum(0) - 1, n)
            surv = torch.empty(n + 1, dtype=torch.int64, device=dev) \
                .scatter_(0, slot, torch.arange(flat.shape[0], device=dev))
            gk = surv[:n] // br                  # kept block of the scan
            r = surv[:n] - gk * br               # row in the block
            b = kept_all[gk]                     # block of its container
            umaps = self._union_maps(parts, dev)
            for i, (_, c, _) in enumerate(parts):
                s0, s1 = int(cuts[i]), int(cuts[i + 1])
                if s0 == s1:
                    continue
                sel = (b[s0:s1], gk[s0:s1] - int(offs[i]), r[s0:s1])
                for name in self.need:
                    out[name].append(self._gather(
                        c, name, encs[i][name], tmps[i], umaps, i, sel, dev))

        cols: Dict[str, torch.Tensor] = {}
        for name in self.need:
            ps = out[name]
            if not ps:                           # zero survivors
                cols[name] = torch.zeros(1, dtype=self._empty_dtype(name),
                                         device=dev)
            else:
                cols[name] = _to_lane(ps[0] if len(ps) == 1
                                      else torch.cat(ps))
        valid = torch.ones(n, dtype=torch.bool, device=dev) if n else \
            torch.zeros(1, dtype=torch.bool, device=dev)
        if sip is not None:
            valid = valid & sip(cols)
        return ops.ScanResult(cols, valid, pruned, total)

    def _union_maps(self, parts, dev):
        """group col -> (every part's remap flattened into one device
        tensor, each part's (offset, dictionary size)): one upload per
        code-space group column."""
        umaps = {}
        for g in self.group_dicts:
            if g not in self.need:
                continue
            maps = [self.union_maps[(c.id, g)] for _, c, _ in parts]
            offs = np.cumsum([0] + [m.size for m in maps])
            umaps[g] = (_upload(np.concatenate([m.reshape(-1)
                                                for m in maps]), dev),
                        [(int(o), m.shape[1]) for o, m in zip(offs, maps)])
        return umaps

    def _gather(self, c, name, enc, tmps, umaps, i, sel, dev):
        """One need column of one container for its survivors ``sel``:
        (block, kept block of the container, row in the block)."""
        b, lb, r = sel
        col = c.columns[name]
        if name in umaps:
            # group col: gather union CODES, never the values
            flat, where = umaps[name]
            off, size = where[i]
            codes = kops.gather_unpack(
                enc["codes_packed"], _stream_width(col, "codes_packed"), b, r)
            return flat[off + b * size + codes.long()]
        if name in tmps:
            # already decoded (kept rows) by the mask program
            return tmps[name][lb, r]
        if random_access_torch(col):
            return gather_decode_torch(col, enc, b, r)
        # sequential encoding: decode, then index the survivors
        return decode_torch(col, dev, enc)[b, r]

    def _empty_dtype(self, name):
        if name in self.group_dicts:
            return torch.int32
        col = self.containers[0][1].columns[name]
        return torch.float32 if col.sql_type == SQLType.FLOAT \
            else torch.int32

    # ------------------------------------------------------------ finish --

    def translate(self, out: Optional[Dict[str, np.ndarray]]
                  ) -> Optional[Dict[str, np.ndarray]]:
        """Union codes -> values on the (small) host-side result."""
        if out is None:
            return None
        for g, union in self.group_dicts.items():
            if g in out:
                out[g] = union[np.asarray(out[g], dtype=np.int64)]
        return out


def _interval_mask(name: str, lo: Optional[int], hi: Optional[int], parts,
                   encs, kept_dev, tmps, br: int, dev) -> torch.Tensor:
    """(kept rows of the scan, block_rows) bool: ``lo <= name <= hi``.

    Packed containers go through ONE ``bitunpack_segments`` launch, their
    per-row bounds (code ranges for BLOCK_DICT, the clamped interval
    otherwise) and DELTA_RANGE firsts through one upload; the rest decode
    per container.  Decoded values are kept in ``tmps`` for the gather."""
    cols = [c.columns[name] for _, c, _ in parts]
    packed = [i for i, col in enumerate(cols) if _packed_key(col)]
    masks: List[Optional[torch.Tensor]] = [None] * len(parts)
    vlo, vhi = _value_range(lo, hi)
    if packed:
        segs, rows = [], []
        for i in packed:
            col, kept, a = cols[i], parts[i][2], encs[i][name]
            key = _packed_key(col)
            base = _BASE_KEY.get(col.encoding)
            segs.append(kops.Segment(a[key], _stream_width(col, key),
                                     None if base is None
                                     else _to_lane(a[base]), kept))
            if col.encoding == Encoding.BLOCK_DICT:
                clo, chi = _code_range(col, lo, hi)
                clo, chi = clo[kept], chi[kept]
            else:
                clo = np.full(kept.size, vlo, np.int64)
                chi = np.full(kept.size, vhi, np.int64)
            first = (col.arrays["first"][kept]
                     if col.encoding == Encoding.DELTA_RANGE
                     else np.zeros(kept.size, np.int64))
            rows.append(np.stack([clo, chi, first]).astype(np.int32))
        x = kops.bitunpack_segments(segs, br)
        bnd = _upload(np.concatenate(rows, axis=1), dev)
        is_dr = [cols[i].encoding == Encoding.DELTA_RANGE for i in packed]
        if any(is_dr):
            # the decoded scan's reconstruction, on every kept block at once
            cum = bnd[2][:, None] + torch.cumsum(x, dim=1, dtype=x.dtype) \
                - x[:, :1]
            if all(is_dr):
                x = cum
            else:
                pick = np.concatenate([np.full(parts[i][2].size, d)
                                       for i, d in zip(packed, is_dr)])
                x = torch.where(_upload(pick, dev)[:, None], cum, x)
        m = (x >= bnd[0][:, None]) & (x <= bnd[1][:, None])
        at = 0
        for i in packed:
            k = parts[i][2].size
            masks[i] = m[at:at + k]
            if cols[i].encoding != Encoding.BLOCK_DICT:
                tmps[i][name] = x[at:at + k]
            at += k
        if len(packed) == len(parts):
            return m
    for i, col in enumerate(cols):
        if masks[i] is not None:
            continue
        dec = decode_torch(col, dev, encs[i][name])
        if parts[i][2].size != dec.shape[0]:
            dec = dec[kept_dev[i]]
        tmps[i][name] = dec
        masks[i] = (dec >= vlo) & (dec <= vhi)
    return torch.cat(masks)


def _code_range(col: EncodedColumn, lo: Optional[int], hi: Optional[int]
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-block inclusive code range [clo, chi] matching value interval
    [lo, hi].  Blocks with no matching value get clo > chi (empty).  The
    block dictionaries are sorted, so ``searchsorted(u, lo, "left")`` is
    the count of live entries below lo and ``searchsorted(u, hi,
    "right")`` the count at most hi: one vectorised pass over all blocks."""
    dv, dn = col.arrays["dict_values"], col.arrays["dict_n"]
    live = np.arange(dv.shape[1])[None, :] < np.asarray(dn)[:, None]
    clo = np.zeros(dv.shape[0], np.int64) if lo is None \
        else ((dv < lo) & live).sum(axis=1)
    chi = (np.asarray(dn, np.int64) if hi is None
           else ((dv <= hi) & live).sum(axis=1)) - 1
    return clo.astype(np.int32), chi.astype(np.int32)


def plan_compressed_scan(db, q, plan, need, scan_pred: Optional[Expr],
                         as_of: int) -> Optional[CompressedScanPlan]:
    """Rewrite an eligible fused scan into the code domain, or None.

    Eligible: exec_mode allows it, the scan predicate decomposes into
    per-column integer intervals, and every interval column is INT-typed in
    every container (interval semantics are exact only for integers).  In
    "auto" mode the rewrite additionally requires that the decoded working
    set is NOT already device-resident and does NOT comfortably fit the
    cache budget -- a warm decoded scan is strictly faster than
    re-gathering, so unconstrained workloads keep the exact legacy path
    (same plan signature, cold and warm) and the compressed scan engages
    only when decoded residency is unattainable."""
    mode = getattr(db, "exec_mode", "auto")
    if mode == "decoded" or scan_pred is None:
        return None
    intervals = interval_decompose(scan_pred)
    if not intervals:
        return None
    need = sorted(set(need) | set(intervals))

    pairs = []
    for host, owner in plan.sources:
        store = db.nodes[host].stores[owner]
        for c in store.containers:
            pairs.append((store, c))
    if not pairs:
        return None
    for name in intervals:
        for _, c in pairs:
            col = c.columns.get(name)
            if col is None or col.sql_type != SQLType.INT:
                return None
    if mode != "compressed":
        cache = getattr(db, "block_cache", None)
        if cache is None:
            return None
        if all((c.id, name, KIND_DECODED) in cache
               for _, c in pairs for name in need):
            return None
        # budget comfortably fits the decoded working set: let the legacy
        # path decode-and-cache (identical plan signature cold and warm,
        # so repeats stay plan-cache hits); compressed is for budgets
        # where decoded residency is unattainable
        dec_bytes = sum(c.columns[nm].n_blocks * c.columns[nm].block_rows
                        * 4 for _, c in pairs for nm in need
                        if nm in c.columns)
        if cache.budget_bytes >= 2 * dec_bytes:
            return None

    # code-domain GROUP BY: a group col groups on union codes only when it
    # carries no other role in the program (agg input, join key, derived
    # input) -- those need the real values inside the fused closure
    used_as_value = {c for _, c, kind in q.aggs
                     if kind != "count" and c != "*"}
    for j in q.joins:
        used_as_value.add(j.fact_key)
    for _, e in q.derived:
        used_as_value |= e.columns()
    group_dicts: Dict[str, np.ndarray] = {}
    union_maps: Dict[Tuple[int, str], np.ndarray] = {}
    for g in q.group_by:
        if g in used_as_value:
            continue
        encs = [c.columns.get(g) for _, c in pairs]
        if not all(e is not None and e.encoding == Encoding.BLOCK_DICT
                   and "codes_packed" in e.arrays for e in encs):
            continue
        union = np.unique(np.concatenate([e.arrays["global_dict"]
                                          for e in encs]))
        for (_, c), e in zip(pairs, encs):
            umap = np.searchsorted(union, e.arrays["global_dict"]) \
                .astype(np.int32)[e.arrays["code_map"]]
            union_maps[(c.id, g)] = np.ascontiguousarray(umap)
        group_dicts[g] = union

    sig_suffix = (
        "cdom",
        tuple(sorted((c.id, name) + c.columns[name].width_signature()
                     for _, c in pairs for name in need
                     if name in c.columns)),
        tuple(sorted((g, len(u)) for g, u in group_dicts.items())),
    )
    return CompressedScanPlan(dict(intervals), pairs, list(need),
                              group_dicts, union_maps, as_of, sig_suffix)
