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
* ``rle_grouped_agg_plain`` -- the same function in plain PyTorch.

``rle_filter_agg``: per block row, the count, sum and max of the rows of
the runs whose value lies in [lo, hi] (and whose length is positive),
``(nb, 3)`` f32, evaluated in f32 as the reference does; a block with no
passing run reads ``[0, 0, -inf]``.

* ``rle_filter_agg``       -- the wrapper: the CUDA kernel
  (csrc/rle_filter_agg.cu) for CUDA tensors, the plain version for CPU
  tensors.
* ``rle_filter_agg_plain`` -- the same function in plain PyTorch.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build

_POS, _NEG = 3.4e38, -3.4e38      # finite sentinels, as in the reference

grouped_launches = 0    # kernel launches by ``rle_grouped_agg``
filter_launches = 0     # kernel launches by ``rle_filter_agg``

# rle_grouped_agg_launch(keys, lengths, values, n_runs, domain, lo, hi,
#                        count, sum, min, max, stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_float,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p]
# rle_filter_agg_launch(values, lengths, values_float, lengths_float,
#                       n_blocks, n_runs, lo, hi, out, stream)
_FILTER_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                    ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]


def _prepare(run_values, run_lengths, values):
    if run_values.is_floating_point():
        raise TypeError("rle_grouped_agg: run values (group keys) must be "
                        "an integer tensor")
    if run_lengths.shape != run_values.shape or (
            values is not None and values.shape != run_values.shape):
        raise ValueError("rle_grouped_agg: run values, lengths and values "
                         "must share one shape")
    keys = run_values.reshape(-1).to(torch.int32)
    lengths = run_lengths.reshape(-1).to(torch.int32)
    vals = (run_values if values is None else values).reshape(-1) \
        .to(torch.float32)
    return keys, lengths, vals


def rle_grouped_agg_plain(run_values: torch.Tensor,
                          run_lengths: torch.Tensor,
                          values: Optional[torch.Tensor] = None, *,
                          domain: int, lo: float = -3.0e38,
                          hi: float = 3.0e38) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the kernel, on any device."""
    keys, lengths, vals = _prepare(run_values, run_lengths, values)
    dev = keys.device
    kf = keys.to(torch.float32)
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


def _launch(run_values, run_lengths, values, domain: int, lo: float,
            hi: float):
    global grouped_launches
    keys, lengths, vals = (t.contiguous() for t in
                           _prepare(run_values, run_lengths, values))
    build.require_cuda("rle_grouped_agg", keys, lengths, vals,
                       dtypes=(torch.int32, torch.int32, torch.float32))
    dev = keys.device
    count = torch.zeros(domain, dtype=torch.int32, device=dev)
    total = torch.zeros(domain, dtype=torch.float32, device=dev)
    mn = torch.full((domain,), _POS, dtype=torch.float32, device=dev)
    mx = torch.full((domain,), _NEG, dtype=torch.float32, device=dev)
    n = keys.shape[0]
    if n:
        fn = build.entry("rle_grouped_agg", "rle_grouped_agg_launch",
                         _ARGTYPES)
        build.check(fn(keys.data_ptr(), lengths.data_ptr(), vals.data_ptr(),
                       n, domain, lo, hi, count.data_ptr(),
                       total.data_ptr(), mn.data_ptr(), mx.data_ptr(),
                       build.stream_ptr(dev)), "rle_grouped_agg")
        grouped_launches += 1
    return count, total, mn, mx


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
        return _launch(run_values, run_lengths, values, domain, lo, hi)
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


def _launch_filter(run_values, run_lengths, lo: float, hi: float):
    global filter_launches
    rv, v_float = build.int32_or_f32(run_values)
    rl, l_float = build.int32_or_f32(run_lengths)
    build.require_cuda("rle_filter_agg", rv, rl)
    nb, n_runs = rv.shape
    out = torch.empty((nb, 3), dtype=torch.float32, device=rv.device)
    if nb:
        fn = build.entry("rle_filter_agg", "rle_filter_agg_launch",
                         _FILTER_ARGTYPES)
        build.check(fn(rv.data_ptr(), rl.data_ptr(), v_float, l_float, nb,
                       n_runs, lo, hi, out.data_ptr(),
                       build.stream_ptr(rv.device)), "rle_filter_agg")
        filter_launches += 1
    return out


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
        return _launch_filter(run_values, run_lengths, lo, hi)
    return rle_filter_agg_plain(run_values, run_lengths, lo=lo, hi=hi)
