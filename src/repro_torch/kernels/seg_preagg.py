"""Dense GROUP BY under a validity mask (the port's ``groupby_dense``).

Mirrors ``src/repro/kernels/seg_preagg.py``, whose stated contract is
``operators.groupby_dense`` under the reference's 32-bit runtime: keys clip
into [0, domain) (negative keys merge into group 0), counts and int sums
accumulate in int32 (wrapping), float sums in f32, min/max start from the
dtype's sentinels (int32 max/min, +-inf), ``avg`` is ``sum / max(count,
1)``.  Oracle: ``src/repro/kernels/ref.py::seg_preagg_ref``.

The reference's 1024-key cap is a TPU VMEM bound, not part of the
contract: the CUDA kernels (csrc/seg_preagg.cu) take any domain up to the
planner's dense limit, by one of two routes (``seg_preagg_route``): a
table privatised per CTA in shared memory where it fits, global atomics
where it does not (after each warp has folded its runs of equal keys).

* ``seg_preagg``       -- the wrapper: the CUDA kernel for CUDA tensors,
  the plain version for CPU tensors.
* ``seg_preagg_plain`` -- the same function in plain PyTorch, any device.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, Sequence, Tuple

import torch

from . import build

Aggs = Sequence[Tuple[str, str, str]]     # (out_name, in_col, kind)

_KINDS = {"sum": 0, "avg": 0, "min": 1, "max": 2}
_MAX_AGGS = 32                            # SEG_MAX_AGGS in the source

launches = 0    # kernel launches by ``seg_preagg`` (the main-path witness)

# seg_preagg_launch(keys, valid, n, domain, n_aggs, kinds, is_float, vals,
#                   out, replicas, stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p]
_fn = None      # the entry point, looked up at the first launch
# per thread: (kind codes, dtypes) -> the ctypes arrays of kind codes and
# f32 flags, and one the value pointers are written into
_SIGS = threading.local()
_LANES = (torch.int32, torch.float32)

# The shared route's budget: the dynamic shared memory one block may opt
# in to on an H100 (227 KB), and the replicas of the table per CTA of 16
# warps -- as many as keep the replicated table within 48 KB (four CTAs
# an SM), at most one per pair of warps.
SMEM_BYTES = 232_448
REPLICA_BYTES = 48 * 1024
MAX_REPLICAS = 8


def seg_preagg_route(domain: int, n_aggs: int) -> str:
    """"shared" when one (1 + n_aggs, domain) table of 4-byte words fits
    the shared-memory budget of a CTA, else "global"."""
    return "shared" if (1 + n_aggs) * domain * 4 <= SMEM_BYTES \
        else "global"


@functools.lru_cache(maxsize=1024)
def seg_preagg_replicas(domain: int, n_aggs: int) -> int:
    """Table replicas per CTA on the shared route (0 on the global one):
    the largest power of two up to MAX_REPLICAS whose tables fit
    REPLICA_BYTES, and at least one."""
    if seg_preagg_route(domain, n_aggs) == "global":
        return 0
    table = (1 + n_aggs) * domain * 4
    r = MAX_REPLICAS
    while r > 1 and r * table > REPLICA_BYTES:
        r //= 2
    return r


def _lane(v: torch.Tensor) -> torch.Tensor:
    """Value lane of an aggregate: f32 for floats, int32 otherwise."""
    return v.to(torch.float32 if v.is_floating_point() else torch.int32)


def _sentinel(dtype: torch.dtype, hi: bool):
    if dtype.is_floating_point:
        return float("inf") if hi else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if hi else info.min


def _finish(counts: torch.Tensor, accs: Dict[str, torch.Tensor],
            aggs: Aggs) -> Dict[str, torch.Tensor]:
    out = {"group_count": counts}
    for name, _col, kind in aggs:
        if kind == "count":
            out[name] = counts
        elif kind == "avg":
            out[name] = accs[name] / torch.clamp(counts, min=1)
        else:
            out[name] = accs[name]
    return out


def seg_preagg_plain(keys: torch.Tensor, valid: torch.Tensor,
                     values: Dict[str, torch.Tensor], domain: int,
                     aggs: Aggs) -> Dict[str, torch.Tensor]:
    """Plain PyTorch scatter version of the kernel, on any device."""
    dev = keys.device
    k = keys.to(torch.int64).clamp(0, domain - 1)
    counts = torch.zeros(domain, dtype=torch.int32, device=dev).index_add_(
        0, k, valid.to(torch.int32))
    accs = {}
    for name, col, kind in aggs:
        if kind == "count":
            continue
        v = _lane(values[col])
        if kind in ("sum", "avg"):
            accs[name] = torch.zeros(domain, dtype=v.dtype, device=dev) \
                .index_add_(0, k, torch.where(valid, v, 0))
        else:
            hi = kind == "min"
            sent = _sentinel(v.dtype, hi)
            accs[name] = torch.full((domain,), sent, dtype=v.dtype,
                                    device=dev).scatter_reduce_(
                0, k, torch.where(valid, v, sent),
                "amin" if hi else "amax")
    return _finish(counts, accs, aggs)


def _launch(keys, valid, values, domain: int, aggs: Aggs):
    global launches, _fn
    n = keys.shape[0]
    if keys.dtype != torch.int32:
        keys = keys.to(torch.int32)
    if valid.dtype != torch.bool:
        valid = valid.to(torch.bool)
    keys, valid = keys.contiguous(), valid.contiguous()
    lanes = []        # (name, kind code, value lane)
    for name, col, kind in aggs:
        if kind == "count":
            continue
        code = _KINDS.get(kind)
        if code is None:
            raise ValueError(f"seg_preagg: unknown aggregate {kind!r}")
        v = values[col]
        if v.dtype not in _LANES:
            v = _lane(v)
        v = v.contiguous()
        if v.shape != keys.shape:
            raise ValueError(f"seg_preagg: {col} has shape "
                             f"{tuple(v.shape)}, keys ({n},)")
        lanes.append((name, code, v))
    build.require_cuda("seg_preagg", keys, valid, *(v for _, _, v in lanes))
    dev = keys.device
    m = len(lanes)
    if m > _MAX_AGGS:
        raise ValueError(f"seg_preagg: {m} aggregates, the kernel "
                         f"takes at most {_MAX_AGGS}")
    # ctypes arrays per signature, per thread (the call releases the GIL)
    sigs = getattr(_SIGS, "by_sig", None)
    if sigs is None:
        sigs = _SIGS.by_sig = {}
    sig = tuple((code, v.dtype) for _, code, v in lanes)
    arrays = sigs.get(sig)
    if arrays is None:
        size = max(m, 1)
        arrays = sigs[sig] = (
            (ctypes.c_int * size)(*[code for code, _ in sig]),
            (ctypes.c_int * size)(*[int(dt == torch.float32)
                                    for _, dt in sig]),
            (ctypes.c_void_p * size)())
    kinds, is_float, ptrs = arrays
    for i, (_, _, v) in enumerate(lanes):
        ptrs[i] = v.data_ptr()
    if _fn is None:
        _fn = build.entry("seg_preagg", "seg_preagg_launch", _ARGTYPES)
    # one (1 + m, domain) buffer of 4-byte words, count first; the C call
    # writes every word (identities, then the aggregates)
    out = torch.empty((1 + m, domain), dtype=torch.int32, device=dev)
    build.check(_fn(keys.data_ptr(), valid.data_ptr(), n, domain, m, kinds,
                    is_float, ptrs, out.data_ptr(),
                    seg_preagg_replicas(domain, m), build.stream_ptr(dev)),
                "seg_preagg")
    launches += 1
    if not m:
        return _finish(out.view(domain), {}, aggs)
    rows = out.unbind(0)
    accs = {name: rows[1 + i] if v.dtype == torch.int32
            else rows[1 + i].view(torch.float32)
            for i, (name, _, v) in enumerate(lanes)}
    return _finish(rows[0], accs, aggs)


def seg_preagg(keys: torch.Tensor, valid: torch.Tensor,
               values: Dict[str, torch.Tensor], domain: int,
               aggs: Aggs) -> Dict[str, torch.Tensor]:
    """Dense GROUP BY over ``domain`` keys: ``group_count`` plus one
    ``(domain,)`` tensor per aggregate.  A CUDA tensor launches the
    kernel (or raises); a CPU tensor takes the plain version."""
    domain = int(domain)
    if domain < 1:
        raise ValueError(f"seg_preagg: domain {domain} < 1")
    if keys.dim() != 1 or valid.shape != keys.shape:
        raise ValueError(f"seg_preagg: keys {tuple(keys.shape)} and valid "
                         f"{tuple(valid.shape)} must be one (n,) shape")
    if keys.is_cuda:
        with torch.cuda.device(keys.device):
            return _launch(keys, valid, values, domain, aggs)
    return seg_preagg_plain(keys, valid, values, domain, aggs)
