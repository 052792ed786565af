"""Aggregates straight from RLE runs: the grouped and the scalar kernel.

Mirrors ``src/repro/kernels/rle_scan_agg.py``.  ``rle_grouped_agg``: a
run of key k and length L contributes L rows of its value to key k; runs
whose key falls outside [lo, hi] or [0, domain), or whose length is 0,
drop out, so block padding runs never contribute.  Empty keys read count
0, sum 0, min +3.4e38, max -3.4e38.  The one departure: the count is
int32, not the TPU kernel's f32, so a key with more than 2^24 rows keeps
an exact count (the reference's own CPU path counts in int32 too).

* ``rle_grouped_agg``       -- the wrapper: the CUDA kernel
  (csrc/rle_grouped_agg.cu) for CUDA tensors, the plain version for CPU
  tensors.
* ``rle_grouped_agg_many``  -- the same over a list of run segments (one
  per container), as if concatenated: one kernel launch for every
  ``_MAX_SEGS`` segments, no concatenation on the card.
* ``rle_grouped_agg_plain`` / ``rle_grouped_agg_many_plain`` -- the same
  functions in plain PyTorch.

``rle_filter_agg``: per block row, the count, sum and max of the rows of
the runs whose value lies in [lo, hi] (and whose length is positive),
``(nb, 3)`` f32, evaluated in f32 as the reference does; a block with no
passing run reads ``[0, 0, -inf]``.

* ``rle_filter_agg``       -- the wrapper: the CUDA kernel
  (csrc/rle_filter_agg.cu) for CUDA tensors, the plain version for CPU
  tensors.
* ``rle_filter_agg_many``  -- the same over a list of run segments (one
  per container), their outputs concatenated in order: one kernel launch
  for every ``_MAX_SEGS`` segments.  ``rle_filter_agg`` is its
  one-segment case, through an entry point that takes that segment's
  pointers as scalars.
* ``rle_filter_agg_plain`` / ``rle_filter_agg_many_plain`` -- the same
  functions in plain PyTorch.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Sequence, Tuple

import torch

from . import build

_POS, _NEG = 3.4e38, -3.4e38      # finite sentinels, as in the reference
_MAX_SEGS = 64                    # RLE_MAX_SEGS and RLE_FILTER_MAX_SEGS

grouped_launches = 0    # kernel launches by ``rle_grouped_agg(_many)``
filter_launches = 0     # kernel launches by ``rle_filter_agg(_many)``

# rle_grouped_agg_launch(n_segs, keys[], lengths[], values[], n_runs[],
#                        domain, lo, hi, init, out, stream)
_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
             ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
# rle_filter_agg_launch(n_segs, values[], lengths[], flags[], nb[], runs[],
#                       lo, hi, out, stream)
_FILTER_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
                    ctypes.c_void_p]
# rle_filter_agg_launch1(values, lengths, flags, nb, runs, lo, hi, out,
#                        stream): one segment, no arrays
_FILTER1_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                     ctypes.c_int, ctypes.c_int, ctypes.c_float,
                     ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
_grouped_fn = None      # the entry points, looked up at the first launch
_filter_fn = None
_filter1_fn = None
_LANES = (torch.int32, torch.float32)   # the lanes the filter kernel reads
_ARRAYS = threading.local()     # the entry point's pointer arrays

Segment = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]


def _flat(run_values, run_lengths, values):
    """One segment as int32 keys, int32 lengths and f32 values (None: the
    key is the value), in their own shape: the kernel reads any
    contiguous tensor as flat, the plain version reshapes."""
    if run_values.is_floating_point():
        raise TypeError("rle_grouped_agg: run values (group keys) must be "
                        "an integer tensor")
    if run_lengths.shape != run_values.shape or (
            values is not None and values.shape != run_values.shape):
        raise ValueError("rle_grouped_agg: run values, lengths and values "
                         "must share one shape")
    keys = run_values if run_values.dtype == torch.int32 \
        else run_values.to(torch.int32)
    lengths = run_lengths if run_lengths.dtype == torch.int32 \
        else run_lengths.to(torch.int32)
    if values is not None and values.dtype != torch.float32:
        values = values.to(torch.float32)
    return keys, lengths, values


def _segments(segments) -> list:
    """Segments as (run_values, run_lengths, values or None)."""
    segments = [(seg[0], seg[1], seg[2] if len(seg) > 2 else None)
                for seg in segments]
    if not segments:
        raise ValueError("rle_grouped_agg: no run segments")
    return segments


def rle_grouped_agg_plain(run_values: torch.Tensor,
                          run_lengths: torch.Tensor,
                          values: Optional[torch.Tensor] = None, *,
                          domain: int, lo: float = -3.0e38,
                          hi: float = 3.0e38) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the kernel, on any device."""
    keys, lengths, vals = (None if t is None else t.reshape(-1)
                           for t in _flat(run_values, run_lengths, values))
    dev = keys.device
    kf = keys.to(torch.float32)
    vals = kf if vals is None else vals
    m = (kf >= lo) & (kf <= hi) & (lengths > 0) & (kf >= 0) & (kf < domain)
    k = keys.to(torch.int64).clamp(0, domain - 1)
    count = torch.zeros(domain, dtype=torch.int32, device=dev).index_add_(
        0, k, torch.where(m, lengths, 0))
    total = torch.zeros(domain, dtype=torch.float32, device=dev).index_add_(
        0, k, torch.where(m, vals * lengths.to(torch.float32), 0.0))
    mn = torch.full((domain,), _POS, dtype=torch.float32, device=dev) \
        .scatter_reduce_(0, k, torch.where(m, vals, _POS), "amin")
    mx = torch.full((domain,), _NEG, dtype=torch.float32, device=dev) \
        .scatter_reduce_(0, k, torch.where(m, vals, _NEG), "amax")
    return count, total, mn, mx


def rle_grouped_agg_many_plain(segments: Sequence[Segment], *, domain: int,
                               lo: float = -3.0e38, hi: float = 3.0e38
                               ) -> Tuple[torch.Tensor, ...]:
    """Plain version of the list form: ``rle_grouped_agg_plain`` over the
    concatenation of the segments (a segment without values takes its
    keys as values)."""
    flat = [[None if t is None else t.reshape(-1) for t in _flat(*seg)]
            for seg in _segments(segments)]
    keys = torch.cat([k for k, _, _ in flat])
    vals = torch.cat([k.to(torch.float32) if v is None else v
                      for k, _, v in flat])
    return rle_grouped_agg_plain(keys, torch.cat([n for _, n, _ in flat]),
                                 vals, domain=domain, lo=lo, hi=hi)


def _launch_many(segments: Sequence[Segment], domain: int, lo: float,
                 hi: float):
    global grouped_launches, _grouped_fn
    flat = []
    for seg in segments:
        keys, lengths, vals = (None if t is None else t.contiguous()
                               for t in _flat(*seg))
        build.require_cuda("rle_grouped_agg", keys, lengths,
                           *([] if vals is None else [vals]))
        flat.append((keys, lengths, vals))
    dev = flat[0][0].device
    if any(k.device != dev for k, _, _ in flat):
        raise ValueError("rle_grouped_agg: segments on different devices")
    if _grouped_fn is None:
        _grouped_fn = build.entry("rle_grouped_agg", "rle_grouped_agg_launch",
                                  _ARGTYPES)
    arrays = getattr(_ARRAYS, "segs", None)   # per thread: the call
    if arrays is None:                        # releases the GIL
        ptrs = ctypes.c_void_p * _MAX_SEGS
        arrays = _ARRAYS.segs = (ptrs(), ptrs(), ptrs(),
                                 (ctypes.c_longlong * _MAX_SEGS)())
    keys_p, lengths_p, vals_p, n_runs = arrays
    # one (4, domain) buffer of 4-byte words: count (int32), sum, min, max;
    # the kernel writes every word
    out = torch.empty((4, domain), dtype=torch.float32, device=dev)
    stream = build.stream_ptr(dev)
    for start in range(0, len(flat), _MAX_SEGS):
        part = flat[start:start + _MAX_SEGS]
        for i, (k, r, v) in enumerate(part):
            keys_p[i], lengths_p[i] = k.data_ptr(), r.data_ptr()
            vals_p[i] = None if v is None else v.data_ptr()
            n_runs[i] = k.numel()
        build.check(_grouped_fn(len(part), keys_p, lengths_p, vals_p, n_runs,
                                domain, lo, hi, int(start == 0),
                                out.data_ptr(), stream), "rle_grouped_agg")
        grouped_launches += 1
    count, total, mn, mx = out.unbind(0)
    return count.view(torch.int32), total, mn, mx


def rle_grouped_agg_many(segments: Sequence[Segment], *, domain: int,
                         lo: float = -3.0e38, hi: float = 3.0e38
                         ) -> Tuple[torch.Tensor, ...]:
    """``[(run_values, run_lengths[, values]), ...]`` -> (count
    int32, sum, min, max), each ``(domain,)``, over every segment's runs
    as if concatenated.  CUDA tensors launch the kernel once per
    ``_MAX_SEGS`` segments (or raise); CPU tensors take the plain
    version."""
    domain = int(domain)
    if domain < 1:
        raise ValueError(f"rle_grouped_agg: domain {domain} < 1")
    segments = _segments(segments)
    lo, hi = float(lo), float(hi)
    if segments[0][0].is_cuda:
        with torch.cuda.device(segments[0][0].device):
            return _launch_many(segments, domain, lo, hi)
    return rle_grouped_agg_many_plain(segments, domain=domain, lo=lo, hi=hi)


def rle_grouped_agg(run_values: torch.Tensor, run_lengths: torch.Tensor,
                    values: Optional[torch.Tensor] = None, *, domain: int,
                    lo: float = -3.0e38, hi: float = 3.0e38
                    ) -> Tuple[torch.Tensor, ...]:
    """(nb, R) runs -> (count int32, sum, min, max), each ``(domain,)``.

    ``run_values`` carries the group key per run; ``values`` the per-run
    aggregate value (defaults to the key itself).  A CUDA tensor launches
    the kernel (or raises); a CPU tensor takes the plain version."""
    domain = int(domain)
    if domain < 1:
        raise ValueError(f"rle_grouped_agg: domain {domain} < 1")
    if run_values.is_cuda:
        with torch.cuda.device(run_values.device):
            return _launch_many([(run_values, run_lengths, values)], domain,
                                float(lo), float(hi))
    return rle_grouped_agg_plain(run_values, run_lengths, values,
                                 domain=domain, lo=lo, hi=hi)


# ----------------------------------------------------------- rle_filter_agg --

def rle_filter_agg_plain(run_values: torch.Tensor, run_lengths: torch.Tensor,
                         *, lo: float, hi: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device."""
    rv = run_values.to(torch.float32)
    rl = run_lengths.to(torch.float32)
    m = (rv >= lo) & (rv <= hi) & (rl > 0)
    mf = m.to(torch.float32)
    cnt = (rl * mf).sum(dim=1)
    s = (rv * rl * mf).sum(dim=1)
    # amax of a zero-width row raises: pad one run that never passes
    mx = torch.cat([torch.where(m, rv, float("-inf")),
                    torch.full_like(cnt[:, None], float("-inf"))],
                   dim=1).amax(dim=1)
    return torch.stack([cnt, s, mx], dim=1)


def rle_filter_agg_many_plain(segments: Sequence[Tuple[torch.Tensor,
                                                      torch.Tensor]], *,
                              lo: float, hi: float) -> torch.Tensor:
    """Plain version of the list form: the segments' outputs concatenated
    in order."""
    segments = _filter_segments(segments)
    return torch.cat([rle_filter_agg_plain(rv, rl, lo=lo, hi=hi)
                      for rv, rl in segments])


def _filter_segments(segments) -> list:
    """Segments as (run_values, run_lengths) pairs of one (nb, R) shape."""
    segments = [(seg[0], seg[1]) for seg in segments]
    if not segments:
        raise ValueError("rle_filter_agg: no run segments")
    for rv, rl in segments:
        if rv.dim() != 2 or rl.shape != rv.shape:
            raise ValueError(f"rle_filter_agg: run values "
                             f"{tuple(rv.shape)} and lengths "
                             f"{tuple(rl.shape)} must be one (nb, R)")
    return segments


def _launch_filter_many(segments, lo: float, hi: float) -> torch.Tensor:
    global filter_launches, _filter_fn
    if _filter_fn is None:
        _filter_fn = build.entry("rle_filter_agg", "rle_filter_agg_launch",
                                 _FILTER_ARGTYPES)
    arrays = getattr(_ARRAYS, "filter", None)   # per thread: the call
    if arrays is None:                          # releases the GIL
        ptrs, ints = ctypes.c_void_p * _MAX_SEGS, ctypes.c_int * _MAX_SEGS
        arrays = _ARRAYS.filter = (ptrs(), ptrs(), ints(), ints(), ints())
    vals_p, lengths_p, flags, nbs, runs = arrays
    # int32 and f32 lanes pass as they are, anything else is read as f32
    # (the reference casts before it computes); one pass checks devices
    # and layout, as build.require_cuda does, at a few host us a segment
    dev = segments[0][0].device
    flat, total = [], 0
    for rv, rl in segments:
        if rv.dtype not in _LANES:
            rv = rv.to(torch.float32)
        if rl.dtype not in _LANES:
            rl = rl.to(torch.float32)
        if rv.device != dev or rl.device != dev:
            raise ValueError(f"rle_filter_agg: tensors on {rv.device}, "
                             f"{rl.device} and {dev}")
        if not (rv.is_contiguous() and rl.is_contiguous()):
            rv, rl = rv.contiguous(), rl.contiguous()
        flat.append((rv, rl))
        total += rv.size(0)
    out = torch.empty((total, 3), dtype=torch.float32, device=dev)
    stream = build.stream_ptr(dev)
    row = 0
    for start in range(0, len(flat), _MAX_SEGS):
        part = flat[start:start + _MAX_SEGS]
        rows = 0
        for i, (rv, rl) in enumerate(part):
            vals_p[i], lengths_p[i] = rv.data_ptr(), rl.data_ptr()
            flags[i] = (rv.dtype == torch.float32) | \
                (rl.dtype == torch.float32) << 1
            nbs[i], runs[i] = rv.shape
            rows += nbs[i]
        if rows:
            build.check(_filter_fn(len(part), vals_p, lengths_p, flags, nbs,
                                   runs, lo, hi,
                                   out.data_ptr() + row * 12, stream),
                        "rle_filter_agg")
            filter_launches += 1
        row += rows
    return out


def _launch_filter(run_values, run_lengths, lo: float, hi: float):
    """The one-segment call: its pointers pass as scalars, with no list
    and no segment arrays to fill."""
    global filter_launches, _filter1_fn
    rv, v_float = build.int32_or_f32(run_values)
    rl, l_float = build.int32_or_f32(run_lengths)
    build.require_cuda("rle_filter_agg", rv, rl)
    nb, n_runs = rv.shape
    out = torch.empty((nb, 3), dtype=torch.float32, device=rv.device)
    if nb:
        if _filter1_fn is None:
            _filter1_fn = build.entry("rle_filter_agg",
                                      "rle_filter_agg_launch1",
                                      _FILTER1_ARGTYPES)
        build.check(_filter1_fn(rv.data_ptr(), rl.data_ptr(),
                                v_float | l_float << 1, nb, n_runs, lo, hi,
                                out.data_ptr(), build.stream_ptr(rv.device)),
                    "rle_filter_agg")
        filter_launches += 1
    return out


def rle_filter_agg_many(segments: Sequence[Tuple[torch.Tensor,
                                                 torch.Tensor]], *,
                        lo: float, hi: float) -> torch.Tensor:
    """``[(run_values, run_lengths), ...]``, each (nb_i, R_i) -> the
    segments' (nb_i, 3) f32 ``[count, sum, max]`` rows concatenated in
    order, as ``torch.cat`` of ``rle_filter_agg`` over them.  CUDA
    tensors launch the kernel once per ``_MAX_SEGS`` segments (or raise);
    CPU tensors take the plain version."""
    segments = _filter_segments(segments)
    lo, hi = float(lo), float(hi)
    if segments[0][0].is_cuda:
        with torch.cuda.device(segments[0][0].device):
            return _launch_filter_many(segments, lo, hi)
    return rle_filter_agg_many_plain(segments, lo=lo, hi=hi)


def rle_filter_agg(run_values: torch.Tensor, run_lengths: torch.Tensor, *,
                   lo: float, hi: float) -> torch.Tensor:
    """(nb, R) runs -> (nb, 3) f32 ``[count, sum, max]`` per block of the
    rows with ``lo <= value <= hi``.  A CUDA tensor launches the kernel (or
    raises); a CPU tensor takes the plain version."""
    if run_values.dim() != 2 or run_lengths.shape != run_values.shape:
        raise ValueError(f"rle_filter_agg: run values "
                         f"{tuple(run_values.shape)} and lengths "
                         f"{tuple(run_lengths.shape)} must be one (nb, R)")
    lo, hi = float(lo), float(hi)
    if run_values.is_cuda:
        with torch.cuda.device(run_values.device):
            return _launch_filter(run_values, run_lengths, lo, hi)
    return rle_filter_agg_plain(run_values, run_lengths, lo=lo, hi=hi)
