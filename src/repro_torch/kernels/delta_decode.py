"""DELTA_RANGE block decode: a prefix sum per block row, in f32.

Mirrors ``delta_decode`` of ``src/repro/kernels/delta_decode.py``:
``first (nb, 1)`` and ``deltas (nb, B)``, cast to f32, give
``first + cumsum(deltas) - deltas[:, :1]``, i.e. ``first[b] + d[b, 1] +
... + d[b, i]``: the first delta drops out.  Integer-valued deltas whose
prefix sums stay below 2^24 decode bit for bit; float deltas differ from
the reference only by summation order.

* ``delta_decode``       -- the wrapper: the CUDA kernel
  (csrc/delta_decode.cu) for CUDA tensors, the plain version for CPU
  tensors.
* ``delta_decode_plain`` -- the same function in plain PyTorch.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

launches = 0    # kernel launches by ``delta_decode``

# delta_decode_launch(first, deltas, first_float, deltas_float, n_blocks,
#                     n_cols, out, stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def delta_decode_plain(first: torch.Tensor,
                       deltas: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: the reference's
    formula as written."""
    d = deltas.to(torch.float32)
    return first.to(torch.float32) + torch.cumsum(d, dim=1) - d[:, :1]


def _launch(first, deltas):
    global launches
    f, f_float = build.int32_or_f32(first)
    d, d_float = build.int32_or_f32(deltas)
    build.require_cuda("delta_decode", f, d)
    nb, B = d.shape
    out = torch.empty((nb, B), dtype=torch.float32, device=d.device)
    if nb and B:
        fn = build.entry("delta_decode", "delta_decode_launch", _ARGTYPES)
        build.check(fn(f.data_ptr(), d.data_ptr(), f_float, d_float, nb, B,
                       out.data_ptr(), build.stream_ptr(d.device)),
                    "delta_decode")
        launches += 1
    return out


def delta_decode(first: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """first ``(nb, 1)``, deltas ``(nb, B)`` -> values ``(nb, B)`` f32.  A
    CUDA tensor launches the kernel (or raises); a CPU tensor takes the
    plain version."""
    if deltas.dim() != 2 or tuple(first.shape) != (deltas.shape[0], 1):
        raise ValueError(f"delta_decode: first {tuple(first.shape)} and "
                         f"deltas {tuple(deltas.shape)} are not (nb, 1) "
                         f"and (nb, B)")
    if deltas.is_cuda:
        return _launch(first, deltas)
    return delta_decode_plain(first, deltas)
