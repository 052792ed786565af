"""Vectorized execution-engine operators (paper §6.1), torch-based.

Mirrors ``src/repro/engine/operators.py``: the container scan
(SMA pruning, decode, predicate and SIP masks), ScanResult/concat_scans,
composite key packing, the dense, sort, RLE-direct and prepass GroupBys,
the N:1 hash join, and Sort, TopK and the running-sum analytic.  Every
operator keeps its tensors on the device of its inputs and computes in
the reference's 32-bit lanes: int32 keys, counts and int sums (wrapping),
f32 float sums.

The dense GroupBy is the ``seg_preagg`` kernel (its contract *is*
``groupby_dense``), the sort GroupBy sorts and then aggregates through the
same kernel over group ids, and the RLE-direct GroupBy is the
``rle_grouped_agg`` kernel -- on a CUDA device each launches its Hopper
kernel, on the CPU each runs its plain PyTorch version.  The prepass
GroupBy stays on ``groupby_dense``, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.encodings import decode_torch
from ..core.storage import ROSContainer
from ..kernels import ops as kops
from .expr import Expr

_INT = torch.int32
_INT_MAX = torch.iinfo(torch.int32).max


@dataclasses.dataclass
class ScanResult:
    columns: Dict[str, torch.Tensor]   # flat (n,) device tensors
    valid: torch.Tensor                # (n,) bool
    pruned_blocks: int = 0
    total_blocks: int = 0


def scan_container(c: ROSContainer, columns: Sequence[str],
                   predicate: Optional[Expr] = None,
                   deleted: Optional[np.ndarray] = None,
                   sip: Optional[Callable] = None,
                   device="cuda") -> Optional[ScanResult]:
    """Scan one ROS container: SMA-prune blocks, decode survivors on
    ``device``, apply the predicate (and any SIP filter) as a mask.
    ``deleted`` is a positional bool mask over the container's rows."""
    need = set(columns) | (predicate.columns() if predicate else set())
    first = c.columns[next(iter(need))]
    nb, br = first.n_blocks, first.block_rows

    # --- container/block pruning from predicate bounds (paper §3.5) ---
    keep = np.ones(nb, dtype=bool)
    if predicate is not None:
        for colname, (lo, hi) in predicate.bounds().items():
            if colname in c.smas:
                keep &= c.smas[colname].prune_blocks(lo, hi)
    if not keep.any():
        return None
    kept_idx = np.flatnonzero(keep)
    kept = torch.as_tensor(kept_idx, device=device)

    cols = {name: decode_torch(c.columns[name], device)[kept].reshape(-1)
            for name in need}
    # row validity: inside n_rows, not deleted
    counts = c.smas[next(iter(need))].counts
    valid_np = np.arange(br)[None, :] < counts[kept_idx][:, None]
    if deleted is not None:
        # deleted is positional over the container; spread over padded blocks
        flat = np.zeros(nb * br, bool)
        flat[np.flatnonzero(deleted)] = True
        valid_np &= ~flat.reshape(nb, br)[kept_idx]
    valid = torch.as_tensor(valid_np.reshape(-1), device=device)
    if predicate is not None:
        valid = valid & predicate(cols).to(torch.bool)
    if sip is not None:
        valid = valid & sip(cols)
    return ScanResult({k: v for k, v in cols.items() if k in columns},
                      valid, int(nb - kept_idx.size), int(nb))


def concat_scans(results: List[ScanResult]) -> Optional[ScanResult]:
    results = [r for r in results if r is not None]
    if not results:
        return None
    cols = {k: torch.cat([r.columns[k] for r in results])
            for k in results[0].columns}
    valid = torch.cat([r.valid for r in results])
    return ScanResult(cols, valid,
                      sum(r.pruned_blocks for r in results),
                      sum(r.total_blocks for r in results))


# ---------------------------------------------------------------------------
# GroupBy
# ---------------------------------------------------------------------------

# Composite group-by keys are key-packed into one dense non-negative domain
# -- mixed-radix, last column fastest -- so every single-key path below
# applies unchanged to multi-column grouping.

def pack_keys(key_cols: Sequence[torch.Tensor], domains: Sequence[int],
              lows: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Mix-radix pack: keys k_i in [lo_i, lo_i + d_i) -> one int32 key in
    [0, prod(d_i)).  Values outside their domain are clipped (callers
    guarantee domains via SMAs or a runtime min/max pass)."""
    lows = lows or (0,) * len(domains)
    packed = None
    for k, d, lo in zip(key_cols, domains, lows):
        k = torch.clamp(k.to(_INT) - lo, 0, d - 1)
        packed = k if packed is None else packed * d + k
    return packed


def unpack_keys(packed: np.ndarray, domains: Sequence[int],
                lows: Optional[Sequence[int]] = None) -> List[np.ndarray]:
    """Host-side inverse of pack_keys over the (small) group-key output."""
    lows = lows or (0,) * len(domains)
    packed = np.asarray(packed).astype(np.int64)
    out: List[np.ndarray] = []
    for d, lo in zip(reversed(domains), reversed(lows)):
        out.append(packed % d + lo)
        packed = packed // d
    out.reverse()
    return out


def groupby_dense(keys: torch.Tensor, valid: torch.Tensor,
                  values: Dict[str, torch.Tensor], domain: int,
                  aggs: Tuple[Tuple[str, str, str], ...]
                  ) -> Dict[str, torch.Tensor]:
    """Dense-hash GroupBy: keys are small non-negative ints (the paper's
    'few-valued' case / dictionary-encoded), run by the ``seg_preagg``
    kernel.  aggs: (out_name, in_col, agg_kind).  Returns per-key results
    over [0, domain) plus 'group_count'."""
    return kops.seg_preagg(keys, valid, values, domain, aggs)


def groupby_sort(keys: torch.Tensor, valid: torch.Tensor,
                 values: Dict[str, torch.Tensor], max_groups: int,
                 aggs: Tuple[Tuple[str, str, str], ...]
                 ) -> Dict[str, torch.Tensor]:
    """Sort-based GroupBy for arbitrary int keys (the paper's runtime
    fallback when the hash table would not fit): a stable sort assigns
    each valid row its group index, then the dense GroupBy aggregates over
    those indices.  Returns padded (group_keys, aggs, n_groups)."""
    big = _INT_MAX
    k = torch.where(valid, keys.to(_INT), big)
    order = torch.argsort(k, stable=True)
    ks = k[order]
    is_new = torch.cat([torch.ones(1, dtype=torch.bool, device=k.device),
                        ks[1:] != ks[:-1]])
    is_new &= ks != big
    gid = torch.cumsum(is_new, 0) - 1                 # (n,) group index
    gid = torch.where(ks == big, max_groups - 1,
                      torch.clamp(gid, 0, max_groups - 1))
    uniq = torch.full((max_groups,), big, dtype=_INT, device=k.device) \
        .scatter_reduce_(0, gid, ks, "amin")
    # per-group aggregates: exactly groupby_dense's contract over gid
    vsort = {c: v[order] for c, v in values.items()}
    out = groupby_dense(gid, valid[order], vsort, max_groups, aggs)
    out["group_keys"] = uniq
    out["n_groups"] = is_new.sum()
    return out


def groupby_rle_runs(runs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                     domain: int) -> Dict[str, torch.Tensor]:
    """COUNT(*) GROUP BY key directly on RLE runs: each run contributes
    (value, length) without decoding a single row -- the §6.1 'operate
    directly on encoded data' fast path.  ``runs`` holds the device
    (run_values, run_lengths) of many containers, folded by one
    ``rle_grouped_agg`` launch into one int32 count lane (the caller
    keeps the rows of one call below 2^31)."""
    count, _, _, _ = kops.rle_grouped_agg_many(
        [(rv, rl, None) for rv, rl in runs], domain=domain)
    return {"group_count": count}


def groupby_prepass(keys: torch.Tensor, valid: torch.Tensor,
                    values: Dict[str, torch.Tensor], domain: int,
                    aggs: Tuple[Tuple[str, str, str], ...],
                    block: int = 4096) -> Dict[str, torch.Tensor]:
    """Two-stage GroupBy mirroring the paper's prepass operators: partial
    per-block aggregation (the 'cache-sized hash table'), then a final
    combine; numerically ``groupby_dense`` up to the f32 summation order.

    The per-block partials are one ``groupby_dense`` over the keys of
    block b, clipped into [0, domain) as ``groupby_dense`` clips them,
    moved to ``b * domain + key``: the reference's vmap written out."""
    n = keys.shape[0]
    nb = max(1, -(-n // block))
    if nb * domain >= 2**31:
        raise ValueError(f"groupby_prepass: {nb} blocks x domain {domain} "
                         f"exceed the int32 key lane")
    pad = nb * block - n
    dev = keys.device
    k = torch.clamp(keys.to(_INT), 0, domain - 1)
    kp = torch.cat([k, k.new_zeros(pad)])
    vp = torch.cat([valid.to(torch.bool),
                    torch.zeros(pad, dtype=torch.bool, device=dev)])
    vals = {c: torch.cat([v, v.new_zeros(pad)]) for c, v in values.items()}
    offset = torch.arange(nb, dtype=_INT, device=dev).repeat_interleave(block)

    # avg does not distribute over blocks: aggregate partial SUMs instead
    # and divide by the combined counts at the end.
    part_aggs = tuple((name, col_, "sum" if agg == "avg" else agg)
                      for name, col_, agg in aggs)
    partials = groupby_dense(offset * domain + kp, vp, vals, nb * domain,
                             part_aggs)
    kinds = {name: agg for name, _, agg in part_aggs}   # group_count: sum
    out = {}
    for name, v in partials.items():
        v = v.reshape(nb, domain)
        kind = kinds.get(name, "sum")
        if kind in ("sum", "count"):
            # int32 partials sum in int32 (wrapping), as the reference's
            out[name] = v.sum(dim=0, dtype=v.dtype)
        elif kind == "min":
            out[name] = v.amin(dim=0)
        else:
            out[name] = v.amax(dim=0)
    for name, _, agg in aggs:
        if agg == "avg":
            out[name] = out[name] / torch.clamp(out["group_count"], min=1)
    return out


# ---------------------------------------------------------------------------
# Join (N:1 lookup = hash join; same primitive is a merge join on sorted)
# ---------------------------------------------------------------------------

def join_lookup(build_keys: torch.Tensor, probe_keys: torch.Tensor):
    """Returns (idx, matched): for each probe key, the position of the
    matching build key (build keys unique, pre-sorted by caller)."""
    dt = torch.promote_types(build_keys.dtype, probe_keys.dtype)
    bk, pk = build_keys.to(dt), probe_keys.to(dt)
    idx = torch.searchsorted(bk, pk)
    idx = torch.clamp(idx, 0, bk.shape[0] - 1)
    matched = bk[idx] == pk
    return idx, matched


def hash_join(build: Dict[str, torch.Tensor], build_key: str,
              probe: Dict[str, torch.Tensor], probe_key: str,
              probe_valid: torch.Tensor, how: str = "inner"
              ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """N:1 join: probe each fact row against the (small) build side.
    Build side is sorted once ('building the hash table'); the probe is one
    vectorized lookup. Returns (joined columns, valid mask)."""
    if how not in ("inner", "left"):
        raise ValueError(how)
    n = probe[probe_key].shape[0]
    dev = probe[probe_key].device
    out = dict(probe)
    if build[build_key].shape[0] == 0:
        # empty build side (dim predicate filtered everything, or the
        # dimension was truncated): no probe row can match
        for c, v in build.items():
            if c != build_key:
                out[c] = torch.full((n,) + tuple(v.shape[1:]), -1,
                                    dtype=v.dtype, device=dev)
        matched = torch.zeros(n, dtype=torch.bool, device=dev)
    else:
        order = torch.argsort(build[build_key], stable=True)
        idx, matched = join_lookup(build[build_key][order], probe[probe_key])
        for c, v in build.items():
            if c == build_key:
                continue
            joined = v[order][idx]
            if how == "left":
                # unmatched rows carry the NULL sentinel (-1), the engine's
                # NULL analog, instead of an arbitrary clipped build row
                joined = torch.where(matched, joined,
                                     torch.tensor(-1, dtype=joined.dtype,
                                                  device=dev))
            out[c] = joined
    if how == "inner":
        return out, probe_valid & matched
    out["_matched"] = matched
    return out, probe_valid


# ---------------------------------------------------------------------------
# Sort / TopK / Analytic
# ---------------------------------------------------------------------------

def sort_rows(cols: Dict[str, torch.Tensor], valid: torch.Tensor,
              by: Sequence[str], descending: bool = False):
    """Rows ordered by ``by[0]`` (stable; invalid rows last).  The key is
    f32, as the reference's 32-bit lanes make it: integer keys from 2^24
    up may tie and then keep their input order."""
    key = cols[by[0]].to(torch.float32)
    big = float("-inf") if descending else float("inf")
    key = torch.where(valid, key, big)
    order = torch.argsort(-key if descending else key, stable=True)
    return {c: v[order] for c, v in cols.items()}, valid[order]


def top_k(cols: Dict[str, torch.Tensor], valid: torch.Tensor, by: str,
          k: int) -> Dict[str, torch.Tensor]:
    """The ``k`` rows of largest ``by`` (f32), the lower index first among
    ties, as ``jax.lax.top_k`` orders them (``torch.topk`` promises no
    order among ties, so a stable descending sort stands in)."""
    key = torch.where(valid, cols[by].to(torch.float32), float("-inf"))
    idx = torch.argsort(key, descending=True, stable=True)[:k]
    return {c: v[idx] for c, v in cols.items()}


def analytic_running_sum(values: torch.Tensor,
                         partition_ids: torch.Tensor) -> torch.Tensor:
    """SQL-99 windowed SUM() OVER (PARTITION BY p ORDER BY input order):
    segmented cumulative sum (input pre-sorted by partition), in the
    32-bit lanes: int32 (wrapping) or f32."""
    v = values.to(torch.float32 if values.is_floating_point() else _INT)
    n = v.shape[0]
    if n == 0:
        return v
    # torch.cumsum of int32 widens to int64 unless told the dtype
    csum = torch.cumsum(v, 0, dtype=v.dtype)
    is_new = torch.cat([torch.ones(1, dtype=torch.bool, device=v.device),
                        partition_ids[1:] != partition_ids[:-1]])
    gid = torch.cumsum(is_new, 0) - 1
    # each group has exactly one start; record csum-before-start per group
    base_per_gid = torch.zeros(n, dtype=v.dtype, device=v.device) \
        .index_add_(0, gid, torch.where(is_new, csum - v, 0))
    return csum - base_per_gid[gid]
