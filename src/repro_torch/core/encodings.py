"""Block-structured column encodings (paper §3.4).

Vertica's six encoding types, adapted for TPU-friendly fixed shapes:

1. AUTO              -- empirically picks the smallest encoding (the same
                        machinery the Database Designer's storage-optimization
                        phase uses, §6.3).
2. RLE               -- (value, run_length) pairs; best for low-cardinality
                        sorted columns.
3. DELTA_VALUE       -- difference from the smallest value in the block; best
                        for many-valued unsorted integers.
4. BLOCK_DICT        -- per-block dictionary + codes; best for few-valued
                        unsorted columns.
5. DELTA_RANGE       -- ("Compressed Delta Range") delta from the previous
                        value; best for many-valued sorted/range-bound data.
6. COMMON_DELTA      -- ("Compressed Common Delta") dictionary of deltas +
                        bit-packed indexes; best for predictable sequences
                        (timestamps, primary keys).
(0. PLAIN            -- no encoding; the fallback.)

Encode runs host-side (numpy) at moveout/mergeout time, exactly as Vertica
encodes when writing ROS containers.  Decode has two implementations:

* ``decode()``       -- numpy, used by host-side storage management (mergeout).
* ``decode_torch()`` -- torch with static shapes, used by the execution engine
                        on device; packed streams are unpacked by the
                        bit-unpack kernel (kernels/bitunpack.py, dispatched via
                        kernels/ops.py) fused with the delta base add.

Packed storage is REAL (DESIGN.md §9): BLOCK_DICT codes, COMMON_DELTA code
streams, and integer DELTA_VALUE / DELTA_RANGE deltas are stored as packed
little-endian uint32 word streams at ``ceil(log2(domain))`` bits per symbol
(``pack_words`` / ``unpack_words``).  Each group of 32 consecutive symbols
occupies exactly ``width`` uint32 words (32*width bits), so a block of
``block_rows`` symbols is ``ceil(block_rows/32) * width`` words and every
bit offset within a group is static per width -- the device unpack is pure
shift/mask with constant indices.  ``storage_bytes`` charges the actual
``nbytes`` of the packed streams; variable-length per-block metadata (RLE
runs, dictionary entries) is charged at its true occupied size -- the
rectangular padding of the in-memory arrays exists only for fixed-shape
device upload, like the SMA index it is not part of the disk image.
Streams whose symbol width would exceed 32 bits (deltas spanning > 2^32)
fall back to byte-wide storage, charged at actual nbytes.

BLOCK_DICT additionally carries a container-global dictionary
(``global_dict``) and a per-block code remap (``code_map``: block code ->
global code), derived at encode time.  These enable compressed-domain
execution: predicates rewritten to code ranges via dictionary binary
search, and GROUP BY on a dict column using global codes directly as a
dense domain.  Like the SMA they are derived indexes, not charged to
``storage_bytes``.

Losslessness: every encoding must round-trip bit-exactly.  For FLOAT columns,
delta encodings verify exact reconstruction at encode time and fall back to
PLAIN when floating-point cancellation would lose bits -- this mirrors the
DBD's empirical "try it on sample data" approach.

Mirrors ``src/repro/core/encodings.py``: the numpy half (encoders,
``pack_words``/``unpack_words``, ``EncodedColumn``, ``encode``) is a verbatim
copy, so encoded payloads are byte-identical to the reference's; the
device half (``upload_torch``, ``decode_torch``, ``random_access_torch``,
``gather_decode_torch``) mirrors lines 558-697 of the reference.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Optional, Tuple

import numpy as np

from .types import BLOCK_ROWS, SQLType, num_blocks, pad_to_blocks


class Encoding(enum.Enum):
    PLAIN = "plain"
    RLE = "rle"
    DELTA_VALUE = "delta_value"
    BLOCK_DICT = "block_dict"
    DELTA_RANGE = "delta_range"
    COMMON_DELTA = "common_delta"
    # beyond the paper's six (EXPERIMENTS.md §Perf DB-1): decimal-quantized
    # floats (meter readings, prices) scale exactly to integers and reuse
    # the full integer encoding family; verified-exact with PLAIN fallback.
    FLOAT_SCALED = "float_scaled"
    AUTO = "auto"


def _narrowest_uint(max_value: int) -> np.dtype:
    """Narrowest unsigned dtype holding values in [0, max_value]."""
    if max_value < (1 << 8):
        return np.dtype(np.uint8)
    if max_value < (1 << 16):
        return np.dtype(np.uint16)
    if max_value < (1 << 32):
        return np.dtype(np.uint32)
    return np.dtype(np.uint64)


def _narrowest_int(min_value: int, max_value: int) -> np.dtype:
    for dt in (np.int8, np.int16, np.int32, np.int64):
        info = np.iinfo(dt)
        if info.min <= min_value and max_value <= info.max:
            return np.dtype(dt)
    return np.dtype(np.int64)


# ---------------------------------------------------------------------------
# Bit-packing: little-endian uint32 word streams (DESIGN.md §9).
#
# Group format: symbols are processed in groups of 32.  A group of 32 w-bit
# symbols is exactly 32*w bits = w uint32 words; symbol s of a group starts
# at bit s*w, i.e. word (s*w)//32 bit (s*w)%32, possibly straddling into the
# next word.  Because the group size equals the word width, the (word, shift)
# pair for each of the 32 slots is a compile-time constant per width -- both
# the XLA and Pallas unpack paths use static indices and shifts only.
# ---------------------------------------------------------------------------

MAX_PACK_BITS = 32


def symbol_width(max_value: int) -> int:
    """Bits per symbol for values in [0, max_value]: ceil(log2(domain)), >=1."""
    return max(1, int(max_value).bit_length())


def pack_words(symbols: np.ndarray, width: int) -> np.ndarray:
    """Pack (n_blocks, block_rows) non-negative symbols < 2**width into
    little-endian uint32 words, shape (n_blocks, ceil(block_rows/32)*width)."""
    if not 1 <= width <= MAX_PACK_BITS:
        raise ValueError(f"width {width} out of range 1..{MAX_PACK_BITS}")
    nb, br = symbols.shape
    ng = (br + 31) // 32
    s = symbols.astype(np.uint64, copy=False)
    if ng * 32 != br:
        s = np.concatenate([s, np.zeros((nb, ng * 32 - br), np.uint64)],
                           axis=1)
    # bit-expand (LSB first per symbol), then packbits -> bytes -> words
    shifts = np.arange(width, dtype=np.uint64)
    bits = ((s[..., None] >> shifts) & np.uint64(1)).astype(np.uint8)
    bits = bits.reshape(nb, ng, 32 * width)
    packed = np.packbits(bits, axis=-1, bitorder="little")  # (nb, ng, 4*width)
    words = np.ascontiguousarray(packed).view("<u4")
    return words.reshape(nb, ng * width).astype(np.uint32, copy=False)


def _slot_tables(width: int):
    """Static per-slot (of 32) word index / shift tables for one width."""
    slot = np.arange(32)
    bit = slot * width
    lo = bit // 32                      # word holding the symbol's low bits
    sh = (bit % 32).astype(np.uint64)   # shift within that word
    straddle = (bit % 32) + width > 32  # symbol continues into word lo+1
    hi = np.minimum(lo + 1, width - 1)  # clipped: only read when straddling
    hi_shift = ((32 - (bit % 32)) % 32).astype(np.uint64)
    return lo, sh, hi, hi_shift, straddle


def unpack_words(words: np.ndarray, width: int, block_rows: int) -> np.ndarray:
    """Inverse of pack_words -> (n_blocks, block_rows) int64 symbols."""
    nb, nw = words.shape
    ng = max(1, nw // max(width, 1))
    lo, sh, hi, hi_shift, straddle = _slot_tables(width)
    g = words.reshape(nb, ng, width).astype(np.uint64)
    vals = g[:, :, lo] >> sh
    vals |= np.where(straddle, g[:, :, hi] << hi_shift, np.uint64(0))
    mask = np.uint64((1 << width) - 1) if width < 64 else np.uint64(-1)
    syms = (vals & mask).reshape(nb, ng * 32)[:, :block_rows]
    return syms.astype(np.int64)


def _packed_width(arrays: Dict[str, np.ndarray], key: str,
                  block_rows: int) -> int:
    """Recover the symbol width of a packed stream from its word count."""
    ng = (block_rows + 31) // 32
    return arrays[key].shape[1] // ng


@dataclasses.dataclass
class EncodedColumn:
    """One column of one ROS container, encoded & block-structured.

    ``arrays`` hold scheme-specific payloads; every array has leading dim
    ``n_blocks`` so the whole container is a stack of fixed-shape blocks
    (TPU-friendly; see DESIGN.md hardware-adaptation table).  Packed streams
    (``*_packed`` keys) are uint32 word streams; ``widths`` maps each packed
    stream to its bits-per-symbol (part of the plan signature so dictionary
    domain growth misses the plan cache correctly).
    """

    encoding: Encoding
    sql_type: SQLType
    n_rows: int
    block_rows: int
    arrays: Dict[str, np.ndarray]
    # validity bitmap for SQL NULLs (None = column has no NULLs)
    valid: Optional[np.ndarray] = None
    # actual packed size in bytes (see module docstring)
    packed_bytes: float = 0.0
    # FLOAT_SCALED: the integer-encoded payload + decimal scale
    inner: Optional["EncodedColumn"] = None
    scale: float = 1.0
    # bits per symbol for each packed stream in ``arrays``
    widths: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def n_blocks(self) -> int:
        return num_blocks(self.n_rows, self.block_rows)

    def storage_bytes(self) -> float:
        b = self.packed_bytes
        if self.valid is not None:
            b += self.n_rows / 8.0  # 1-bit validity bitmap
        return b

    def width_signature(self) -> Tuple[Tuple[str, int], ...]:
        """Hashable (stream, bits) pairs for plan signatures."""
        inner = self.inner.width_signature() if self.inner is not None else ()
        return tuple(sorted(self.widths.items())) + inner

    def decode(self) -> np.ndarray:
        """Round-trip decode to a flat 1-D numpy array of n_rows values."""
        if self.encoding == Encoding.FLOAT_SCALED:
            return self.inner.decode().astype(np.float64) / self.scale
        flat = _DECODERS[self.encoding](self.arrays, self.block_rows)
        return flat.reshape(-1)[: self.n_rows]

    def decode_blocks(self) -> np.ndarray:
        """Decode to (n_blocks, block_rows); tail block padded."""
        if self.encoding == Encoding.FLOAT_SCALED:
            return self.inner.decode_blocks().astype(np.float64) / self.scale
        return _DECODERS[self.encoding](self.arrays, self.block_rows)

    def valid_mask(self) -> Optional[np.ndarray]:
        if self.valid is None:
            return None
        return self.valid.reshape(-1)[: self.n_rows]


# ---------------------------------------------------------------------------
# Encoders.  All take a 1-D numpy array and return
# (arrays, packed_bytes, widths).
# ---------------------------------------------------------------------------

def _encode_plain(values: np.ndarray, block_rows: int):
    isint = np.issubdtype(values.dtype, np.integer)
    if isint and values.size:
        store_dt = _narrowest_int(int(values.min()), int(values.max()))
    else:
        store_dt = values.dtype
    blocks = pad_to_blocks(values.astype(store_dt, copy=False), block_rows)
    return {"values": blocks}, float(blocks.nbytes), {}


def _decode_plain(arrays, block_rows):
    return arrays["values"].astype(
        np.int64 if np.issubdtype(arrays["values"].dtype, np.integer)
        else np.float64)


def _rle_runs(block: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Run-length encode one block -> (run_values, run_lengths)."""
    if block.size == 0:
        return block, np.zeros(0, np.int64)
    change = np.empty(block.size, dtype=bool)
    change[0] = True
    np.not_equal(block[1:], block[:-1], out=change[1:])
    starts = np.flatnonzero(change)
    lengths = np.diff(np.append(starts, block.size))
    return block[starts], lengths


def _encode_rle(values: np.ndarray, block_rows: int):
    blocks = pad_to_blocks(values, block_rows,
                           pad_value=values[-1] if values.size else 0)
    nb = blocks.shape[0]
    per_block = [_rle_runs(b) for b in blocks]
    max_runs = max(rv.size for rv, _ in per_block)
    run_values = np.zeros((nb, max_runs), dtype=values.dtype)
    run_lengths = np.zeros((nb, max_runs), dtype=np.int32)
    n_runs = np.zeros(nb, dtype=np.int32)
    packed = 0.0
    val_bytes = values.dtype.itemsize
    if np.issubdtype(values.dtype, np.integer) and values.size:
        val_bytes = _narrowest_int(int(values.min()), int(values.max())).itemsize
    for i, (rv, rl) in enumerate(per_block):
        run_values[i, : rv.size] = rv
        run_lengths[i, : rl.size] = rl
        n_runs[i] = rv.size
        packed += rv.size * (val_bytes +
                             _narrowest_uint(int(rl.max()) if rl.size else 0).itemsize)
    return ({"run_values": run_values, "run_lengths": run_lengths,
             "n_runs": n_runs}, packed, {})


def _decode_rle(arrays, block_rows):
    rv, rl = arrays["run_values"], arrays["run_lengths"]
    nb = rv.shape[0]
    out_dt = (np.int64 if np.issubdtype(rv.dtype, np.integer) else np.float64)
    out = np.zeros((nb, block_rows), dtype=out_dt)
    for i in range(nb):
        n = int(arrays["n_runs"][i])
        dec = np.repeat(rv[i, :n], rl[i, :n])
        out[i, : dec.size] = dec
    return out


def _encode_delta_value(values: np.ndarray, block_rows: int):
    # integer only (checked by choose/encode dispatcher)
    blocks = pad_to_blocks(values, block_rows)
    base = blocks.min(axis=1)
    deltas64 = blocks - base[:, None]
    dmax = int(deltas64.max()) if deltas64.size else 0
    w = symbol_width(dmax)
    if w <= MAX_PACK_BITS:
        words = pack_words(deltas64, w)
        return ({"base": base, "deltas_packed": words},
                float(words.nbytes + base.nbytes), {"deltas_packed": w})
    # deltas span more than 2^32: byte-wide fallback
    dt = _narrowest_uint(dmax)
    return ({"base": base, "deltas": deltas64.astype(dt)},
            float(deltas64.size * dt.itemsize + base.nbytes), {})


def _decode_delta_value(arrays, block_rows):
    if "deltas_packed" in arrays:
        w = _packed_width(arrays, "deltas_packed", block_rows)
        deltas = unpack_words(arrays["deltas_packed"], w, block_rows)
    else:
        deltas = arrays["deltas"].astype(np.int64)
    return arrays["base"][:, None].astype(np.int64) + deltas


def _encode_block_dict(values: np.ndarray, block_rows: int):
    blocks = pad_to_blocks(values, block_rows,
                           pad_value=values[-1] if values.size else 0)
    nb = blocks.shape[0]
    uniq_per_block = [np.unique(b) for b in blocks]
    dict_size = max(u.size for u in uniq_per_block)
    w = symbol_width(dict_size - 1)
    dict_values = np.zeros((nb, dict_size), dtype=values.dtype)
    codes = np.zeros((nb, block_rows), dtype=np.int64)
    dict_n = np.zeros(nb, dtype=np.int32)
    # container-global dictionary + per-block remap: derived indexes that
    # let the executor evaluate predicates and GROUP BY in the code domain
    global_dict = np.unique(blocks)
    code_map = np.zeros((nb, dict_size), dtype=np.int32)
    packed = 0.0
    for i, u in enumerate(uniq_per_block):
        dict_values[i, : u.size] = u
        codes[i] = np.searchsorted(u, blocks[i])
        dict_n[i] = u.size
        code_map[i, : u.size] = np.searchsorted(global_dict, u)
        packed += u.size * values.dtype.itemsize
    words = pack_words(codes, w)
    packed += words.nbytes + dict_n.nbytes
    return ({"dict_values": dict_values, "codes_packed": words,
             "dict_n": dict_n, "global_dict": global_dict,
             "code_map": code_map},
            packed, {"codes_packed": w})


def _decode_block_dict(arrays, block_rows):
    dv = arrays["dict_values"]
    if "codes_packed" in arrays:
        w = _packed_width(arrays, "codes_packed", block_rows)
        codes = unpack_words(arrays["codes_packed"], w, block_rows)
    else:
        codes = arrays["codes"].astype(np.int64)
    out = np.take_along_axis(dv, codes, axis=1)
    return out.astype(np.int64 if np.issubdtype(dv.dtype, np.integer)
                      else np.float64)


def _encode_delta_range(values: np.ndarray, block_rows: int):
    blocks = pad_to_blocks(values, block_rows,
                           pad_value=values[-1] if values.size else 0)
    first = blocks[:, 0].copy()
    deltas = np.diff(blocks, axis=1, prepend=first[:, None])
    if np.issubdtype(values.dtype, np.integer):
        delta_min = deltas.min(axis=1)
        rel = deltas - delta_min[:, None]
        w = symbol_width(int(rel.max()) if rel.size else 0)
        if w <= MAX_PACK_BITS:
            words = pack_words(rel, w)
            return ({"first": first, "delta_min": delta_min,
                     "deltas_packed": words},
                    float(words.nbytes + first.nbytes + delta_min.nbytes),
                    {"deltas_packed": w})
        dt = _narrowest_int(int(deltas.min()), int(deltas.max()))
        return ({"first": first, "deltas": deltas.astype(dt)},
                float(deltas.size * dt.itemsize + first.nbytes), {})
    # floats: try float32 deltas; verify exact round-trip, else reject
    d32 = deltas.astype(np.float32)
    recon = first[:, None] + np.cumsum(d32.astype(np.float64), axis=1) \
        - d32[:, :1].astype(np.float64)
    if not np.array_equal(recon, blocks):
        raise _Inexact()
    return ({"first": first, "deltas": d32},
            float(d32.nbytes + first.nbytes), {})


def _decode_delta_range(arrays, block_rows):
    if "deltas_packed" in arrays:
        w = _packed_width(arrays, "deltas_packed", block_rows)
        rel = unpack_words(arrays["deltas_packed"], w, block_rows)
        d = rel + arrays["delta_min"][:, None].astype(np.int64)
    else:
        d = arrays["deltas"].astype(
            np.int64 if np.issubdtype(arrays["deltas"].dtype, np.integer)
            else np.float64)
    first = arrays["first"][:, None].astype(d.dtype)
    return first + np.cumsum(d, axis=1) - d[:, :1]


def _encode_common_delta(values: np.ndarray, block_rows: int):
    # integer only: dictionary over the (few) distinct deltas + bit-packed
    # code stream at ceil(log2(dict size)) bits per symbol
    blocks = pad_to_blocks(values, block_rows,
                           pad_value=values[-1] if values.size else 0)
    nb = blocks.shape[0]
    first = blocks[:, 0].copy()
    deltas = np.diff(blocks, axis=1, prepend=first[:, None])
    uniq_per_block = [np.unique(d) for d in deltas]
    dict_size = max(u.size for u in uniq_per_block)
    w = symbol_width(dict_size - 1)
    delta_dict = np.zeros((nb, dict_size), dtype=np.int64)
    codes = np.zeros((nb, block_rows), dtype=np.int64)
    dict_n = np.zeros(nb, dtype=np.int32)
    packed = 0.0
    for i, u in enumerate(uniq_per_block):
        delta_dict[i, : u.size] = u
        codes[i] = np.searchsorted(u, deltas[i])
        dict_n[i] = u.size
        packed += u.size * 8
    words = pack_words(codes, w)
    packed += words.nbytes + first.nbytes + dict_n.nbytes
    return ({"first": first, "delta_dict": delta_dict,
             "codes_packed": words, "dict_n": dict_n},
            packed, {"codes_packed": w})


def _decode_common_delta(arrays, block_rows):
    if "codes_packed" in arrays:
        w = _packed_width(arrays, "codes_packed", block_rows)
        codes = unpack_words(arrays["codes_packed"], w, block_rows)
    else:
        codes = arrays["codes"].astype(np.int64)
    deltas = np.take_along_axis(arrays["delta_dict"], codes, axis=1)
    first = arrays["first"][:, None].astype(np.int64)
    return first + np.cumsum(deltas, axis=1) - deltas[:, :1]


class _Inexact(Exception):
    """Raised when a lossy-for-this-data encoding must be rejected."""


def _try_float_scaled(values: np.ndarray, sql_type, n_rows: int,
                      block_rows: int, valid) -> Optional["EncodedColumn"]:
    """Decimal-quantized floats -> scaled integers -> best int encoding.
    Exactness verified; returns None if any value fails round-trip."""
    if not np.issubdtype(values.dtype, np.floating) or values.size == 0:
        return None
    if not np.isfinite(values).all():
        return None
    for k in (0, 1, 2, 3):
        scale = 10.0 ** k
        scaled = values * scale
        ints = np.rint(scaled)
        if np.abs(ints).max() >= 2 ** 52:
            return None
        if not np.array_equal(ints.astype(np.int64) / scale, values):
            continue
        inner = encode(ints.astype(np.int64), SQLType.INT, Encoding.AUTO,
                       block_rows=block_rows)
        return EncodedColumn(Encoding.FLOAT_SCALED, sql_type, n_rows,
                             block_rows, {}, valid, inner.packed_bytes,
                             inner=inner, scale=scale)
    return None


_ENCODERS = {
    Encoding.PLAIN: _encode_plain,
    Encoding.RLE: _encode_rle,
    Encoding.DELTA_VALUE: _encode_delta_value,
    Encoding.BLOCK_DICT: _encode_block_dict,
    Encoding.DELTA_RANGE: _encode_delta_range,
    Encoding.COMMON_DELTA: _encode_common_delta,
}

_DECODERS = {
    Encoding.PLAIN: _decode_plain,
    Encoding.RLE: _decode_rle,
    Encoding.DELTA_VALUE: _decode_delta_value,
    Encoding.BLOCK_DICT: _decode_block_dict,
    Encoding.DELTA_RANGE: _decode_delta_range,
    Encoding.COMMON_DELTA: _decode_common_delta,
}

# Which encodings are even legal for a given dtype family
_INT_ENCODINGS = (Encoding.RLE, Encoding.COMMON_DELTA, Encoding.DELTA_VALUE,
                  Encoding.BLOCK_DICT, Encoding.DELTA_RANGE, Encoding.PLAIN)
_FLOAT_ENCODINGS = (Encoding.FLOAT_SCALED, Encoding.RLE,
                    Encoding.BLOCK_DICT, Encoding.DELTA_RANGE,
                    Encoding.PLAIN)


def encode(values: np.ndarray, sql_type: SQLType,
           encoding: Encoding = Encoding.AUTO,
           valid: Optional[np.ndarray] = None,
           block_rows: int = BLOCK_ROWS) -> EncodedColumn:
    """Encode a 1-D value array into an EncodedColumn.

    ``encoding=AUTO`` empirically tries every legal scheme and keeps the
    smallest (the DBD §6.3 storage-optimization step).  Explicit schemes that
    cannot represent the data exactly (float cancellation) or that do not
    apply to the dtype fall back to PLAIN.
    """
    values = np.ascontiguousarray(values)
    n_rows = int(values.size)
    if valid is not None:
        valid = pad_to_blocks(np.asarray(valid, dtype=bool), block_rows,
                              pad_value=False)

    isint = np.issubdtype(values.dtype, np.integer)
    values = values.astype(np.int64 if isint else np.float64, copy=False)

    def _try(enc: Encoding):
        if enc == Encoding.FLOAT_SCALED:
            return _try_float_scaled(values, sql_type, n_rows, block_rows,
                                     valid)
        try:
            arrays, packed, widths = _ENCODERS[enc](values, block_rows)
        except (_Inexact, ValueError, OverflowError):
            return None
        return EncodedColumn(enc, sql_type, n_rows, block_rows, arrays,
                             valid, packed, widths=widths)

    if encoding == Encoding.AUTO:
        candidates = _INT_ENCODINGS if isint else _FLOAT_ENCODINGS
        best = None
        for enc in candidates:
            col = _try(enc)
            if col is not None and (best is None or
                                    col.packed_bytes < best.packed_bytes):
                best = col
        assert best is not None
        return best

    legal = _INT_ENCODINGS if isint else _FLOAT_ENCODINGS
    if encoding not in legal:
        encoding = Encoding.PLAIN
    col = _try(encoding)
    if col is None:  # inexact for this data -> PLAIN (always succeeds)
        col = _try(Encoding.PLAIN)
    return col


# ---------------------------------------------------------------------------
# torch decode paths (static shapes) -- used by the execution engine.  The
# device lanes follow the reference's 32-bit runtime (DESIGN.md §10): ints
# are int32 (wrapping), floats float32.  torch is imported lazily so
# host-only storage code never pulls it in.
# ---------------------------------------------------------------------------

def to_device(values: np.ndarray, device):
    """Upload one host array as a device tensor in the 32-bit lanes:
    int64/uint64/uint16 wrap to int32, float64 rounds to float32, uint32
    packed words keep their bits as an int32 view (kernels reinterpret
    them as uint32); int8/int16/int32/uint8/bool/float32 keep their dtype."""
    import torch

    a = np.asarray(values)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype in (np.int64, np.uint64, np.uint16):
        a = a.astype(np.int32)
    elif a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def upload_torch(col: EncodedColumn, device) -> Dict[str, "object"]:
    """Upload the encoded payload arrays to ``device``, once.  The returned
    dict can be kept in the block cache (core/block_cache.py) and handed
    back to ``decode_torch(col, device, arrays=...)`` so repeat queries skip
    the host->device copy entirely.  Packed streams upload as 32-bit words,
    so the cache-resident footprint is the real packed size.  FLOAT_SCALED
    stores its payload on the inner integer column, so that is what gets
    uploaded."""
    if col.encoding == Encoding.FLOAT_SCALED:
        return upload_torch(col.inner, device)
    return {k: to_device(v, device) for k, v in col.arrays.items()}


def device_bytes(arrays) -> int:
    """Device-byte footprint of an uploaded payload dict (or one tensor)."""
    if isinstance(arrays, dict):
        return sum(device_bytes(v) for v in arrays.values())
    return int(arrays.numel()) * arrays.element_size()


def _stream_width(col: EncodedColumn, key: str) -> int:
    """Bits per symbol of the packed stream ``key``."""
    return col.widths.get(key) or _packed_width(col.arrays, key,
                                                col.block_rows)


def _unpack_torch(a, col: EncodedColumn, key: str, base=None):
    """Device bit-unpack of a packed stream via the kernel dispatcher."""
    from ..kernels import ops as kops

    return kops.bitunpack(a[key], _stream_width(col, key), col.block_rows,
                          base=base)


def _to_lane(t):
    """The reference's ``astype(int64/float64)`` under its 32-bit runtime:
    int32 for integer tensors, float32 for floating ones."""
    import torch

    return t.to(torch.float32 if t.is_floating_point() else torch.int32)


def decode_torch(col: EncodedColumn, device, arrays=None):
    """Decode to a (n_blocks, block_rows) tensor on ``device``.

    ``arrays`` may carry pre-uploaded device copies of the encoded payload
    (from ``upload_torch`` via the block cache); when omitted the payload
    is uploaded here, per call -- the cold path."""
    import torch

    if col.encoding == Encoding.FLOAT_SCALED:
        # a 0-d device tensor, not a Python scalar: CUDA divides by a host
        # scalar as a multiply by its reciprocal, which is 1 ULP off the
        # host decode (the same trap the reference documents for XLA)
        return _scale_div(decode_torch(col.inner, device, arrays),
                          col.scale)
    a = arrays if arrays is not None else upload_torch(col, device)
    br = col.block_rows
    enc = col.encoding
    if enc == Encoding.PLAIN:
        return _to_lane(a["values"])
    if enc == Encoding.RLE:
        # position p belongs to run r iff cum[r-1] <= p < cum[r]: a batched
        # binary search instead of the reference's (nb, R, br) comparison
        rl = a["run_lengths"]
        cum = torch.cumsum(rl, dim=1, dtype=torch.int32).contiguous()
        pos = torch.arange(br, dtype=torch.int32, device=rl.device)
        run_idx = torch.searchsorted(
            cum, pos.expand(rl.shape[0], br).contiguous(), right=True)
        run_idx = run_idx.clamp_(0, rl.shape[1] - 1)
        return _to_lane(torch.gather(a["run_values"], 1, run_idx))
    if enc == Encoding.DELTA_VALUE:
        if "deltas_packed" in col.arrays:
            # bit-unpack fused with the base-offset reconstruction
            return _unpack_torch(a, col, "deltas_packed",
                                 base=_to_lane(a["base"]))
        return _to_lane(a["base"])[:, None] + _to_lane(a["deltas"])
    if enc == Encoding.BLOCK_DICT:
        if "codes_packed" in col.arrays:
            codes = _unpack_torch(a, col, "codes_packed")
        else:
            codes = a["codes"]
        return _to_lane(torch.gather(a["dict_values"], 1, codes.long()))
    if enc == Encoding.DELTA_RANGE:
        if "deltas_packed" in col.arrays:
            d = _unpack_torch(a, col, "deltas_packed",
                              base=_to_lane(a["delta_min"]))
        else:
            d = _to_lane(a["deltas"])
        first = a["first"][:, None].to(d.dtype)
        # int32 cumsum wraps like the reference's (torch widens to int64
        # unless told otherwise)
        return first + torch.cumsum(d, dim=1, dtype=d.dtype) - d[:, :1]
    if enc == Encoding.COMMON_DELTA:
        if "codes_packed" in col.arrays:
            codes = _unpack_torch(a, col, "codes_packed")
        else:
            codes = a["codes"]
        deltas = _to_lane(torch.gather(a["delta_dict"], 1, codes.long()))
        first = _to_lane(a["first"])[:, None]
        return first + torch.cumsum(deltas, dim=1, dtype=torch.int32) \
            - deltas[:, :1]
    raise ValueError(f"cannot decode {enc}")


# ---------------------------------------------------------------------------
# Compressed-domain access helpers (executor late materialization).
# ---------------------------------------------------------------------------

def random_access_torch(col: EncodedColumn) -> bool:
    """True when single rows can be decoded on device without reconstructing
    whole blocks (no cumsum / run expansion)."""
    if col.encoding == Encoding.FLOAT_SCALED:
        return random_access_torch(col.inner)
    return col.encoding in (Encoding.PLAIN, Encoding.DELTA_VALUE,
                            Encoding.BLOCK_DICT)


def _scale_div(x, scale: float):
    """FLOAT_SCALED's division, as ``decode_torch`` does it: by a 0-d
    float32 tensor on ``x``'s device (CUDA turns a Python-scalar divisor
    into a multiply by its reciprocal, 1 ULP off the host decode)."""
    import torch

    return x.to(torch.float32) / torch.tensor(scale, dtype=torch.float32,
                                              device=x.device)


def gather_decode_torch(col: EncodedColumn, a, b_idx, r_idx):
    """Decode only the rows (block b_idx[i], row r_idx[i]) on device, in
    the 32-bit lanes of ``decode_torch``.

    The late-materialization path: survivor positions from a code-domain
    predicate gather straight out of the packed payload ``a`` (from
    ``upload_torch``), so non-predicate columns never materialize full
    blocks.  Only valid for encodings where ``random_access_torch`` is
    True."""
    import torch

    from ..kernels.bitunpack import gather_unpack

    enc = col.encoding
    if enc == Encoding.FLOAT_SCALED:
        return _scale_div(gather_decode_torch(col.inner, a, b_idx, r_idx),
                          col.scale)
    b, r = b_idx.long(), r_idx.long()
    if enc == Encoding.PLAIN:
        return _to_lane(a["values"][b, r])
    if enc == Encoding.DELTA_VALUE:
        if "deltas_packed" in col.arrays:
            d = gather_unpack(a["deltas_packed"],
                              _stream_width(col, "deltas_packed"), b, r)
        else:
            d = a["deltas"][b, r].to(torch.int32)
        return _to_lane(a["base"])[b] + d
    if enc == Encoding.BLOCK_DICT:
        if "codes_packed" in col.arrays:
            codes = gather_unpack(a["codes_packed"],
                                  _stream_width(col, "codes_packed"), b, r)
        else:
            codes = a["codes"][b, r]
        return _to_lane(a["dict_values"][b, codes.long()])
    raise ValueError(f"{enc} is not randomly accessible on device")


def choose_encoding_stats(values: np.ndarray) -> Dict[str, float]:
    """Data statistics the DBD reports alongside its empirical choice."""
    n = values.size
    if n == 0:
        return {"n": 0, "n_distinct": 0, "sortedness": 1.0, "run_ratio": 0.0}
    nd = int(np.unique(values).size)
    sortedness = float(np.mean(values[1:] >= values[:-1])) if n > 1 else 1.0
    runs = 1 + int(np.sum(values[1:] != values[:-1])) if n > 1 else 1
    return {"n": n, "n_distinct": nd, "sortedness": sortedness,
            "run_ratio": runs / n}
