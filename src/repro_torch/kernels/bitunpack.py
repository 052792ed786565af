"""Bit-unpack: packed uint32 word streams -> int32 symbol lanes.

Storage packs w-bit symbols (w = 1..32) into little-endian uint32 words with
a group structure of 32 symbols per 32*w bits (core/encodings.py format):
symbol s of a group starts at bit s*w, i.e. word (s*w)//32 bit (s*w)%32,
possibly straddling one word boundary.

Mirrors ``src/repro/kernels/bitunpack.py``.  The words travel as int32
tensors holding the uint32 bits (PyTorch's uint32 support is partial).

* ``bitunpack``       -- the wrapper: the CUDA kernel (csrc/bitunpack.cu)
  for a CUDA tensor, the plain version for a CPU tensor; optionally fused
  with the per-block base add of the delta reconstruction.
* ``bitunpack_plain`` -- the same function in plain PyTorch (int64
  shift/mask over static per-slot tables), on any device.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from . import build

_M32 = 0xFFFFFFFF

launches = 0    # kernel launches by ``bitunpack`` (the main-path witness)

# bitunpack_launch(words, base, out, n_blocks, n_words, width, block_rows,
#                  stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]


def _slot_tables(width: int):
    """Static per-slot (of 32) word index / shift tables for one width."""
    slot = np.arange(32)
    bit = slot * width
    lo = bit // 32
    sh = bit % 32
    straddle = sh + width > 32
    hi = np.minimum(lo + 1, width - 1)   # clipped: only read when straddling
    hi_shift = (32 - sh) % 32
    return lo, sh, hi, hi_shift, straddle


def bitunpack_plain(words: torch.Tensor, width: int, block_rows: int,
                    base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """words (nb, ng*width) int32 bits -> (nb, block_rows) int32 symbols;
    ``base`` (nb,) is added per block, wrapping in int32."""
    nb, nw = words.shape
    ng = nw // width
    dev = words.device
    lo, sh, hi, hi_shift, straddle = (torch.as_tensor(t, device=dev)
                                      for t in _slot_tables(width))
    g = (words.to(torch.int64) & _M32).reshape(nb, ng, width)
    v = g[:, :, lo] >> sh
    v = v | torch.where(straddle, (g[:, :, hi] << hi_shift) & _M32, 0)
    v = (v & ((1 << width) - 1)).reshape(nb, ng * 32)[:, :block_rows]
    if base is not None:
        v = (v + base.to(torch.int64)[:, None]) & _M32
    # values in [0, 2^32) land on int32 with two's-complement wrap
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def _launch(words: torch.Tensor, width: int, block_rows: int,
            base: Optional[torch.Tensor]) -> torch.Tensor:
    global launches
    build.require_cuda("bitunpack", words, dtypes=(torch.int32,))
    nb, nw = words.shape
    if base is not None:
        build.require_cuda("bitunpack", words, base,
                           dtypes=(torch.int32, torch.int32))
        if base.shape != (nb,):
            raise ValueError(f"bitunpack: base {tuple(base.shape)} for "
                             f"{nb} blocks")
    out = torch.empty((nb, block_rows), dtype=torch.int32,
                      device=words.device)
    fn = build.entry("bitunpack", "bitunpack_launch", _ARGTYPES)
    build.check(fn(words.data_ptr(),
                   base.data_ptr() if base is not None else None,
                   out.data_ptr(), nb, nw, width, block_rows,
                   build.stream_ptr(words.device)), "bitunpack")
    launches += 1
    return out


def bitunpack(words: torch.Tensor, width: int, block_rows: int,
              base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Unpack w-bit symbols -> (nb, block_rows) int32, plus ``base`` per
    block when given.  A CUDA tensor launches the kernel (or raises); a
    CPU tensor takes the plain version."""
    if not 1 <= width <= 32:
        raise ValueError(f"bitunpack: width {width} out of range 1..32")
    if words.dim() != 2 or words.shape[1] % width:
        raise ValueError(f"bitunpack: words {tuple(words.shape)} is not "
                         f"(n_blocks, n_groups * {width})")
    if (words.shape[1] // width) * 32 < block_rows:
        raise ValueError(f"bitunpack: {words.shape[1]} words hold fewer "
                         f"than {block_rows} symbols")
    if words.is_cuda:
        return _launch(words, width, block_rows, base)
    return bitunpack_plain(words, width, block_rows, base)
