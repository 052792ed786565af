"""Dense GROUP BY under a validity mask (the port's ``groupby_dense``).

Mirrors ``src/repro/kernels/seg_preagg.py``, whose stated contract is
``operators.groupby_dense`` under the reference's 32-bit runtime: keys clip
into [0, domain) (negative keys merge into group 0), counts and int sums
accumulate in int32 (wrapping), float sums in f32, min/max start from the
dtype's sentinels (int32 max/min, +-inf), ``avg`` is ``sum / max(count,
1)``.  Oracle: ``src/repro/kernels/ref.py::seg_preagg_ref``.

The reference's 1024-key cap is a TPU VMEM bound, not part of the
contract: the CUDA kernel (csrc/seg_preagg.cu) scatters with global
atomics and takes any domain up to the planner's dense limit.

* ``seg_preagg``       -- the wrapper: the CUDA kernel for CUDA tensors,
  the plain version for CPU tensors.
* ``seg_preagg_plain`` -- the same function in plain PyTorch, any device.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch

from . import build

Aggs = Sequence[Tuple[str, str, str]]     # (out_name, in_col, kind)

_KINDS = {"sum": 0, "avg": 0, "min": 1, "max": 2}
_MAX_AGGS = 32                            # SEG_MAX_AGGS in the source

launches = 0    # kernel launches by ``seg_preagg`` (the main-path witness)

# seg_preagg_launch(keys, valid, n, domain, counts, n_aggs, kinds,
#                   is_float, vals, outs, stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p]


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
    global launches
    n = keys.shape[0]
    dev = keys.device
    keys = keys.to(torch.int32).contiguous()
    valid = valid.to(torch.bool).contiguous()
    build.require_cuda("seg_preagg", keys, valid,
                       dtypes=(torch.int32, torch.bool))
    counts = torch.zeros(domain, dtype=torch.int32, device=dev)
    specs = []        # (name, kind code, value lane, output)
    for name, col, kind in aggs:
        if kind == "count":
            continue
        if kind not in _KINDS:
            raise ValueError(f"seg_preagg: unknown aggregate {kind!r}")
        v = _lane(values[col]).contiguous()
        build.require_cuda("seg_preagg", keys, v)
        if v.shape != (n,):
            raise ValueError(f"seg_preagg: {col} has shape "
                             f"{tuple(v.shape)}, keys ({n},)")
        o = torch.zeros(domain, dtype=v.dtype, device=dev) \
            if _KINDS[kind] == 0 else \
            torch.full((domain,), _sentinel(v.dtype, kind == "min"),
                       dtype=v.dtype, device=dev)
        specs.append((name, _KINDS[kind], v, o))
    if len(specs) > _MAX_AGGS:
        raise ValueError(f"seg_preagg: {len(specs)} aggregates, the kernel "
                         f"takes at most {_MAX_AGGS}")
    if n:
        m = len(specs)
        fn = build.entry("seg_preagg", "seg_preagg_launch", _ARGTYPES)
        kinds = (ctypes.c_int * max(m, 1))(*[s[1] for s in specs])
        is_float = (ctypes.c_int * max(m, 1))(
            *[int(s[2].is_floating_point()) for s in specs])
        vals = (ctypes.c_void_p * max(m, 1))(
            *[s[2].data_ptr() for s in specs])
        outs = (ctypes.c_void_p * max(m, 1))(
            *[s[3].data_ptr() for s in specs])
        build.check(fn(keys.data_ptr(), valid.data_ptr(), n, domain,
                       counts.data_ptr(), m, kinds, is_float, vals, outs,
                       build.stream_ptr(dev)), "seg_preagg")
        launches += 1
    return _finish(counts, {s[0]: s[3] for s in specs}, aggs)


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
        return _launch(keys, valid, values, domain, aggs)
    return seg_preagg_plain(keys, valid, values, domain, aggs)
