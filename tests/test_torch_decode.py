"""The port's column encodings (src/repro_torch/core/encodings.py) against
the reference's.

* The numpy half is a verbatim copy: the port's encoders must produce
  payloads byte-identical to the reference's.
* The device half: ``decode_torch`` must equal ``decode_jnp`` (which runs
  the bit-unpack kernel path) and the host ``EncodedColumn.decode()``
  bit for bit, in the reference's 32-bit lanes -- int32 for integer
  columns, float32 for float columns -- for all seven encodings,
  including every packed-width family and FLOAT_SCALED.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
import hypothesis.strategies as st

from repro.core import encodings as ref_enc
from repro.core.types import SQLType as RefSQLType
from repro_torch.core import encodings as enc
from repro_torch.core.types import SQLType

BR = 64


def _int_data(kind, n, rng):
    if kind == "sorted":
        return np.sort(rng.integers(-5_000, 5_000, n))
    if kind == "runs":
        return np.repeat(rng.integers(-3, 20, n // 8 + 1), 8)[:n]
    if kind == "few":
        return rng.choice(np.array([-7, 3, 11, 2**20, -2**20]), n)
    if kind == "steps":
        return np.cumsum(rng.choice(np.array([1, 1, 1, 2, 5]), n)) - 40
    return rng.integers(-2**31, 2**31 - 1, n)          # "wide"


def _float_data(kind, n, rng):
    if kind == "cents":
        return np.round(rng.normal(1000, 200, n), 2)
    if kind == "runs":
        return np.repeat(np.round(rng.normal(size=n // 8 + 1), 1), 8)[:n]
    return np.cumsum(rng.integers(-4, 9, n)).astype(np.float64)  # "ints"


def _assert_payload_identical(a, b):
    assert a.encoding.value == b.encoding.value
    assert (a.n_rows, a.block_rows, a.packed_bytes, a.scale, a.widths) == \
        (b.n_rows, b.block_rows, b.packed_bytes, b.scale, b.widths)
    assert sorted(a.arrays) == sorted(b.arrays)
    for k in a.arrays:
        assert a.arrays[k].dtype == b.arrays[k].dtype, k
        assert a.arrays[k].tobytes() == b.arrays[k].tobytes(), k
    assert (a.inner is None) == (b.inner is None)
    if a.inner is not None:
        _assert_payload_identical(a.inner, b.inner)


def _check(values, sql, encoding, with_jnp=True):
    """Encode with both packages, then decode four ways (``decode_jnp``
    compiles per packed width, so the width sweep leaves it out: the
    kernel tests hold every width against the reference's unpack)."""
    col = enc.encode(values, sql, encoding, block_rows=BR)
    ref_col = ref_enc.encode(values, RefSQLType(sql.value),
                             ref_enc.Encoding(encoding.value), block_rows=BR)
    _assert_payload_identical(col, ref_col)
    got = enc.decode_torch(col, "cpu")
    assert got.shape == (col.n_blocks, BR)
    lane = np.float32 if sql == SQLType.FLOAT else np.int32
    assert got.numpy().dtype == lane
    got = got.numpy().reshape(-1)[: values.size]
    if with_jnp:
        jnp_dec = np.asarray(ref_enc.decode_jnp(ref_col)).reshape(-1)
        assert jnp_dec.dtype == lane
        np.testing.assert_array_equal(
            got.view(np.uint32), jnp_dec[: values.size].view(np.uint32))
    np.testing.assert_array_equal(got, col.decode().astype(lane))
    # the cached-payload route (upload once, decode from device arrays)
    again = enc.decode_torch(col, "cpu", enc.upload_torch(col, "cpu"))
    np.testing.assert_array_equal(again.numpy().reshape(-1)[: values.size],
                                  got)
    return col


@pytest.mark.parametrize("encoding", [
    enc.Encoding.PLAIN, enc.Encoding.RLE, enc.Encoding.DELTA_VALUE,
    enc.Encoding.BLOCK_DICT, enc.Encoding.DELTA_RANGE,
    enc.Encoding.COMMON_DELTA, enc.Encoding.AUTO])
@pytest.mark.parametrize("kind", ["sorted", "runs", "few", "steps", "wide"])
def test_int_encodings_decode_like_reference(encoding, kind):
    rng = np.random.default_rng(sum(map(ord, encoding.value + kind)))
    values = _int_data(kind, 333, rng).astype(np.int64)
    col = _check(values, SQLType.INT, encoding)
    if encoding != enc.Encoding.AUTO:
        assert col.encoding in (encoding, enc.Encoding.PLAIN)


@pytest.mark.parametrize("encoding", [
    enc.Encoding.FLOAT_SCALED, enc.Encoding.PLAIN, enc.Encoding.RLE,
    enc.Encoding.BLOCK_DICT, enc.Encoding.DELTA_RANGE, enc.Encoding.AUTO])
@pytest.mark.parametrize("kind", ["cents", "runs", "ints"])
def test_float_encodings_decode_like_reference(encoding, kind):
    rng = np.random.default_rng(sum(map(ord, encoding.value + kind)))
    _check(_float_data(kind, 300, rng), SQLType.FLOAT, encoding)


def test_every_packed_width_family_is_exercised():
    """DELTA_VALUE deltas at widths 1..32 (the bit-unpack with base) and
    BLOCK_DICT / COMMON_DELTA code streams (without base)."""
    rng = np.random.default_rng(0)
    for width in range(1, 33):
        hi = (1 << width) - 1
        values = rng.integers(0, hi + 1, 3 * BR).astype(np.int64)
        values[0], values[1] = 0, hi   # pin the range; no tail padding
        col = _check(values - 2**31 + 5, SQLType.INT,
                     enc.Encoding.DELTA_VALUE, with_jnp=width in (1, 32))
        assert col.widths == {"deltas_packed": width}
    col = _check(_int_data("few", 500, rng), SQLType.INT,
                 enc.Encoding.BLOCK_DICT)
    assert "codes_packed" in col.arrays
    col = _check(_int_data("steps", 500, rng), SQLType.INT,
                 enc.Encoding.COMMON_DELTA)
    assert "codes_packed" in col.arrays
    col = _check(np.round(rng.normal(50, 5, 400), 2), SQLType.FLOAT,
                 enc.Encoding.FLOAT_SCALED)
    assert col.encoding == enc.Encoding.FLOAT_SCALED and col.scale == 100.0


@settings(max_examples=20, deadline=None, database=None)
@given(st.lists(st.integers(-10**6, 10**6), min_size=1, max_size=200),
       st.sampled_from([e for e in enc.Encoding
                        if e not in (enc.Encoding.AUTO,
                                     enc.Encoding.FLOAT_SCALED)]))
def test_any_int_values_decode_like_reference(xs, encoding):
    _check(np.asarray(xs, dtype=np.int64), SQLType.INT, encoding)


def test_to_device_keeps_the_32_bit_lanes():
    words = np.array([[0xFFFFFFFF, 1]], np.uint32)
    t = enc.to_device(words, "cpu")
    assert t.dtype == torch.int32 and t.numpy().view(np.uint32)[0, 0] \
        == 0xFFFFFFFF
    assert enc.to_device(np.array([2**31 + 3]), "cpu").dtype == torch.int32
    assert enc.to_device(np.array([0.1]), "cpu").dtype == torch.float32
    assert enc.to_device(np.array([1], np.int8), "cpu").dtype == torch.int8


# ----------------------------------------------- compressed-domain access --

def _gather_case(encoding, kind, sql, rng):
    values = (_float_data(kind, 300, rng) if sql == SQLType.FLOAT
              else _int_data(kind, 333, rng).astype(np.int64))
    if kind == "span":                        # deltas wider than 32 bits
        values = rng.integers(-2**40, 2**40, 333)
    if kind == "tenths":                      # scale 10, wide deltas
        values = np.round(rng.uniform(-1e5, 1e5, 300), 1)
    col = enc.encode(values, sql, encoding, block_rows=BR)
    ref_col = ref_enc.encode(values, RefSQLType(sql.value),
                             ref_enc.Encoding(encoding.value), block_rows=BR)
    return col, ref_col


@pytest.mark.parametrize("encoding,kind,sql,packed", [
    (enc.Encoding.PLAIN, "wide", SQLType.INT, False),
    (enc.Encoding.PLAIN, "cents", SQLType.FLOAT, False),
    (enc.Encoding.DELTA_VALUE, "sorted", SQLType.INT, True),
    (enc.Encoding.DELTA_VALUE, "wide", SQLType.INT, True),
    (enc.Encoding.DELTA_VALUE, "span", SQLType.INT, False),
    (enc.Encoding.BLOCK_DICT, "few", SQLType.INT, True),
    (enc.Encoding.BLOCK_DICT, "runs", SQLType.FLOAT, True),
    (enc.Encoding.FLOAT_SCALED, "cents", SQLType.FLOAT, True),
    (enc.Encoding.FLOAT_SCALED, "tenths", SQLType.FLOAT, True),
])
def test_gather_decode_like_reference(encoding, kind, sql, packed):
    """gather_decode_torch == gather_decode_jnp == the full decode at the
    same (block, row) positions, bit for bit in the 32-bit lanes."""
    from repro.core.encodings import gather_decode_jnp, upload_jnp
    import jax.numpy as jnp
    rng = np.random.default_rng(sum(map(ord, encoding.value + kind)))
    col, ref_col = _gather_case(encoding, kind, sql, rng)
    _assert_payload_identical(col, ref_col)
    inner = col.inner if col.encoding == enc.Encoding.FLOAT_SCALED else col
    assert any(k.endswith("_packed") for k in inner.arrays) == packed
    assert enc.random_access_torch(col)
    b = rng.integers(0, col.n_blocks, 200)
    r = rng.integers(0, BR, 200)
    got = enc.gather_decode_torch(col, enc.upload_torch(col, "cpu"),
                                  torch.as_tensor(b), torch.as_tensor(r))
    lane = np.float32 if sql == SQLType.FLOAT else np.int32
    assert got.numpy().dtype == lane
    want = np.asarray(gather_decode_jnp(ref_col, upload_jnp(ref_col),
                                        jnp.asarray(b), jnp.asarray(r)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.astype(lane).view(np.uint32))
    full = enc.decode_torch(col, "cpu").numpy()[b, r]
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  full.view(np.uint32))


@pytest.mark.parametrize("encoding", [e for e in enc.Encoding
                                      if e != enc.Encoding.AUTO])
def test_random_access_like_reference(encoding):
    from repro.core.encodings import random_access_jnp
    sql = SQLType.FLOAT if encoding == enc.Encoding.FLOAT_SCALED \
        else SQLType.INT
    rng = np.random.default_rng(1)
    col, ref_col = _gather_case(encoding, "cents" if sql == SQLType.FLOAT
                                else "sorted", sql, rng)
    assert enc.random_access_torch(col) == random_access_jnp(ref_col)


@pytest.mark.parametrize("seed", range(4))
def test_code_range_like_reference(seed):
    """The vectorised per-block code ranges equal the reference's
    per-block searchsorted, on ragged block dictionaries (1 to 40
    distinct values a block) and open, empty and out-of-range bounds."""
    from repro.engine.compressed import _code_range as ref_code_range
    from repro_torch.engine.compressed import _code_range
    rng = np.random.default_rng(seed)
    blocks = [rng.choice(rng.integers(-60, 60, k), BR)
              for k in rng.integers(1, 41, 9)]
    values = np.concatenate(blocks).astype(np.int64)
    col = enc.encode(values, SQLType.INT, enc.Encoding.BLOCK_DICT,
                     block_rows=BR)
    ref_col = ref_enc.encode(values, RefSQLType.INT,
                             ref_enc.Encoding.BLOCK_DICT, block_rows=BR)
    assert len(set(col.arrays["dict_n"].tolist())) > 3     # ragged
    for lo, hi in [(None, None), (None, 0), (-5, None), (-10, 10),
                   (7, 7), (10, -10), (-1000, -900), (900, 1000),
                   (int(values.min()), int(values.max()))]:
        for got, want in zip(_code_range(col, lo, hi),
                             ref_code_range(ref_col, lo, hi)):
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want, err_msg=(lo, hi))
