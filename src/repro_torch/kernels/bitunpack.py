"""Bit-unpack: packed uint32 word streams -> int32 symbol lanes.

Storage packs w-bit symbols (w = 1..32) into little-endian uint32 words with
a group structure of 32 symbols per 32*w bits (core/encodings.py format):
symbol s of a group starts at bit s*w, i.e. word (s*w)//32 bit (s*w)%32,
possibly straddling one word boundary.

Mirrors ``src/repro/kernels/bitunpack.py``.  The words travel as int32
tensors holding the uint32 bits (PyTorch's uint32 support is partial).

* ``bitunpack``          -- one word stream: the CUDA kernel
  (csrc/bitunpack.cu) as a one-segment launch for a CUDA tensor, the plain
  version for a CPU tensor; optionally fused with the per-block base add
  of the delta reconstruction.
* ``bitunpack_segments`` -- a list of ``Segment``s (one per container of
  a scan: its words, width, base and kept blocks) unpacked by ONE launch
  into one (kept blocks of all segments, block_rows) tensor; the
  compressed scan's mask program (engine/compressed.py).
* ``bitunpack_plain`` / ``bitunpack_segments_plain`` -- the same functions
  in plain PyTorch (int64 shift/mask over static per-slot tables), on any
  device.
* ``gather_unpack``      -- random access to single symbols (torch
  indexing: the reference's is jnp, not Pallas), the late-materialization
  gather of survivor rows.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from . import build

_M32 = 0xFFFFFFFF
_SEG_FIELDS = 8     # int64 fields of a table entry (SEG_FIELDS in the source)

launches = 0    # kernel launches by both entries (the main-path witness)

# bitunpack_launch(words, base, out, n_blocks, row_stride, width,
#                  block_rows, stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]
# bitunpack_segments_launch(table, n_segs, n_out_blocks, out, block_rows,
#                           stream)
_SEG_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                 ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]


@dataclasses.dataclass
class Segment:
    """One word stream of a segment list: ``words`` (n_blocks, n_groups *
    width) int32 bits, rows may be strided; ``base`` (n_blocks,) int32 or
    None; ``kept`` host block indices to unpack, in order, or None for
    every block."""

    words: torch.Tensor
    width: int
    base: Optional[torch.Tensor] = None
    kept: Optional[np.ndarray] = None

    @property
    def n_out(self) -> int:
        return self.words.shape[0] if self.kept is None else len(self.kept)


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


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with two's-complement wrap."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


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
    return _wrap32(v)


def bitunpack_segments_plain(segs: Sequence[Segment],
                             block_rows: int) -> torch.Tensor:
    """The segment list in plain PyTorch: each segment's kept blocks
    unpacked (base added), concatenated in order."""
    parts = []
    for s in segs:
        words, base = s.words, s.base
        if s.kept is not None:
            idx = torch.as_tensor(np.asarray(s.kept, np.int64),
                                  device=words.device)
            words = words[idx]
            base = None if base is None else base[idx]
        parts.append(bitunpack_plain(words, s.width, block_rows, base))
    return torch.cat(parts)


def _check_stream(words: torch.Tensor, width: int, block_rows: int,
                  what: str = "bitunpack") -> None:
    if not 1 <= width <= 32:
        raise ValueError(f"{what}: width {width} out of range 1..32")
    if words.dim() != 2 or words.shape[1] % width:
        raise ValueError(f"{what}: words {tuple(words.shape)} is not "
                         f"(n_blocks, n_groups * {width})")
    if (words.shape[1] // width) * 32 < block_rows:
        raise ValueError(f"{what}: {words.shape[1]} words hold fewer "
                         f"than {block_rows} symbols")


def _check_cuda_stream(words: torch.Tensor, base: Optional[torch.Tensor],
                       what: str) -> None:
    """The kernel reads int32 words with unit column stride and any row
    stride, and a contiguous (n_blocks,) int32 base."""
    build.require_cuda(what, words, dtypes=(torch.int32,),
                       contiguous=False)
    if (words.shape[1] > 1 and words.stride(1) != 1) or \
            (words.shape[0] > 1 and words.stride(0) < words.shape[1]):
        raise ValueError(f"{what}: words strides {words.stride()} are not "
                         f"rows of consecutive words")
    if base is not None:
        build.require_cuda(what, words, base,
                           dtypes=(torch.int32, torch.int32),
                           contiguous=False)
        if base.shape != (words.shape[0],) or not base.is_contiguous():
            raise ValueError(f"{what}: base {tuple(base.shape)} for "
                             f"{words.shape[0]} blocks")


def _launch(words: torch.Tensor, width: int, block_rows: int,
            base: Optional[torch.Tensor]) -> torch.Tensor:
    global launches
    _check_cuda_stream(words, base, "bitunpack")
    nb = words.shape[0]
    out = torch.empty((nb, block_rows), dtype=torch.int32,
                      device=words.device)
    fn = build.entry("bitunpack", "bitunpack_launch", _ARGTYPES)
    build.check(fn(words.data_ptr(),
                   base.data_ptr() if base is not None else None,
                   out.data_ptr(), nb, words.stride(0), width, block_rows,
                   build.stream_ptr(words.device)), "bitunpack")
    launches += 1
    return out


def bitunpack(words: torch.Tensor, width: int, block_rows: int,
              base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Unpack w-bit symbols -> (nb, block_rows) int32, plus ``base`` per
    block when given.  A CUDA tensor launches the kernel (or raises); a
    CPU tensor takes the plain version."""
    _check_stream(words, width, block_rows)
    if words.is_cuda:
        return _launch(words, width, block_rows, base)
    return bitunpack_plain(words, width, block_rows, base)


def segment_table(segs: Sequence[Segment]) -> np.ndarray:
    """The kernel's segment table on the host: SEG_FIELDS int64 per
    segment (words pointer, row stride, base pointer, kept-list index or
    -1, output blocks, first output block, width, 0), then every kept
    list, indexed in int64 elements from the table's start."""
    n = len(segs)
    kept = [np.asarray(s.kept, np.int64) for s in segs if s.kept is not None]
    table = np.zeros(n * _SEG_FIELDS + sum(k.size for k in kept), np.int64)
    rows = table[: n * _SEG_FIELDS].reshape(n, _SEG_FIELDS)
    at, out_block = n * _SEG_FIELDS, 0
    for i, s in enumerate(segs):
        rows[i] = (s.words.data_ptr(), s.words.stride(0),
                   0 if s.base is None else s.base.data_ptr(), -1,
                   s.n_out, out_block, s.width, 0)
        if s.kept is not None:
            k = np.asarray(s.kept, np.int64)
            rows[i, 3] = at
            table[at: at + k.size] = k
            at += k.size
        out_block += s.n_out
    return table


def _launch_segments(segs: Sequence[Segment],
                     block_rows: int) -> torch.Tensor:
    global launches
    dev = segs[0].words.device
    for s in segs:
        _check_cuda_stream(s.words, s.base, "bitunpack_segments")
        if s.words.device != dev:
            raise ValueError(f"bitunpack_segments: segments on "
                             f"{s.words.device} and {dev}")
    n_out = sum(s.n_out for s in segs)
    out = torch.empty((n_out, block_rows), dtype=torch.int32, device=dev)
    if n_out == 0:
        return out
    # one host-to-device copy: the table and the kept lists behind it
    # (from pageable memory without a stream sync: CUDA stages the
    # buffer before the call returns)
    table = torch.from_numpy(segment_table(segs)).to(dev, non_blocking=True)
    fn = build.entry("bitunpack", "bitunpack_segments_launch",
                     _SEG_ARGTYPES)
    build.check(fn(table.data_ptr(), len(segs), n_out, out.data_ptr(),
                   block_rows, build.stream_ptr(dev)), "bitunpack_segments")
    launches += 1
    return out


def bitunpack_segments(segs: Sequence[Segment],
                       block_rows: int) -> torch.Tensor:
    """Unpack the kept blocks of every segment -> (sum of kept blocks,
    block_rows) int32, segments in order, each block plus its ``base``
    when given.  Widths may differ between segments.  CUDA tensors take
    ONE kernel launch (or raise); CPU tensors take the plain version."""
    if not segs:
        raise ValueError("bitunpack_segments: no segments")
    for s in segs:
        _check_stream(s.words, s.width, block_rows, "bitunpack_segments")
        if s.kept is not None and len(s.kept) and (
                int(np.min(s.kept)) < 0
                or int(np.max(s.kept)) >= s.words.shape[0]):
            raise ValueError(f"bitunpack_segments: kept blocks outside "
                             f"0..{s.words.shape[0] - 1}")
    if segs[0].words.is_cuda:
        return _launch_segments(segs, block_rows)
    return bitunpack_segments_plain(segs, block_rows)


def gather_unpack(words: torch.Tensor, width: int, b_idx: torch.Tensor,
                  r_idx: torch.Tensor) -> torch.Tensor:
    """Random-access unpack of symbols (b_idx[i], r_idx[i]) -> int32.

    The late-materialization path: per-element word index + shift, so
    survivor rows decode without touching the rest of the block."""
    nw = words.shape[1]
    b = b_idx.long()
    r = r_idx.long()
    bit = (r % 32) * width
    lo = (r // 32) * width + bit // 32
    sh = bit % 32
    w_lo = words[b, lo].to(torch.int64) & _M32
    w_hi = words[b, torch.clamp(lo + 1, max=nw - 1)].to(torch.int64) & _M32
    v = (w_lo >> sh) | torch.where(sh + width > 32,
                                   (w_hi << ((32 - sh) % 32)) & _M32, 0)
    return _wrap32(v & ((1 << width) - 1))
