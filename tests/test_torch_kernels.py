"""The port's kernels (src/repro_torch/kernels) against the reference.

On the CPU each wrapper runs its kernel's plain PyTorch version (the CUDA
kernels themselves are held against those on the card by chip_smoke.py).
Here the plain versions meet the reference's Pallas kernels, run in
interpret mode as tests/test_kernels*.py run them, and the ``ref.py``
oracles, on the same numpy inputs.  Integer outputs must be exactly
equal; f32 sums may differ by summation order only (rtol 1e-5).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.encodings import pack_words
from repro.engine import operators as ref_ops
from repro.kernels import ops as ref_kops
from repro.kernels import ref
from repro.kernels.bitunpack import bitunpack_pallas
from repro.kernels.rle_scan_agg import rle_grouped_agg as rle_pallas
from repro.kernels.seg_preagg import seg_preagg_pallas
from repro_torch.kernels import ops

AGGS = (("n", "*", "count"), ("sq", "qty", "sum"), ("mq", "qty", "min"),
        ("xq", "qty", "max"), ("sp", "price", "sum"),
        ("mp", "price", "min"), ("xp", "price", "max"),
        ("ap", "price", "avg"))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_agree(got, want, label):
    assert set(got) == set(want), label
    for name in want:
        g = got[name].numpy() if isinstance(got[name], torch.Tensor) \
            else np.asarray(got[name])
        w = np.asarray(want[name])
        assert g.shape == w.shape and g.dtype == w.dtype, (label, name)
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w, err_msg=f"{label}:{name}")
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5,
                                       err_msg=f"{label}:{name}")


# ------------------------------------------------------------- bitunpack --

@pytest.mark.parametrize("width", range(1, 33))
def test_bitunpack_matches_pallas_and_oracle(width):
    rng = np.random.default_rng(width)
    nb, br = 3, 96
    syms = rng.integers(0, 1 << width, (nb, br), dtype=np.uint64)
    words = pack_words(syms.astype(np.int64), width)
    base = rng.integers(-2**31, 2**31, nb, dtype=np.int64).astype(np.int32)
    for b in (None, base):
        want = np.asarray(ref.bitunpack_ref(words, width, br, b))
        got = ops.bitunpack(_t(words.view(np.int32)), width, br,
                            base=None if b is None else _t(b))
        assert got.dtype == torch.int32 and got.shape == (nb, br)
        np.testing.assert_array_equal(got.numpy(), want)
    # interpret-mode Pallas costs ~0.5 s a call: its two kernel bodies
    # (_kernel, _kernel_base) alternate over the widths
    b = base if width % 2 else None
    pallas = np.asarray(bitunpack_pallas(
        jnp.asarray(words), width, br,
        None if b is None else jnp.asarray(b), interpret=True))
    got = ops.bitunpack(_t(words.view(np.int32)), width, br,
                        base=None if b is None else _t(b))
    np.testing.assert_array_equal(got.numpy(), pallas)


def test_bitunpack_rejects_bad_shapes():
    words = torch.zeros((2, 5), dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.bitunpack(words, 3, 32)          # 5 words is not 3 * groups
    with pytest.raises(ValueError):
        ops.bitunpack(words, 5, 64)          # one group holds 32 symbols
    with pytest.raises(ValueError):
        ops.bitunpack(words, 33, 32)


@pytest.mark.parametrize("width", range(1, 33))
def test_gather_unpack_matches_reference(width):
    """Random access to single symbols == the reference's gather_unpack
    (jnp) and == the whole-block unpack at the same positions."""
    from repro.kernels.bitunpack import gather_unpack as ref_gather
    rng = np.random.default_rng(100 + width)
    nb, br = 4, 96
    syms = rng.integers(0, 1 << width, (nb, br), dtype=np.uint64)
    words = pack_words(syms.astype(np.int64), width)
    b = rng.integers(0, nb, 300)
    r = rng.integers(0, br, 300)
    got = ops.gather_unpack(_t(words.view(np.int32)), width, _t(b), _t(r))
    assert got.dtype == torch.int32
    want = np.asarray(ref_gather(jnp.asarray(words), width, jnp.asarray(b),
                                 jnp.asarray(r)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), ops.bitunpack(_t(words.view(np.int32)), width,
                                   br).numpy()[b, r])


def _segment_case(rng, br, widths, kept_lists, nb=5):
    """One segment per width: random symbols, a base that wraps (values
    near the int32 limits), and the given kept list."""
    segs, want = [], []
    for width, kept in zip(widths, kept_lists):
        syms = rng.integers(0, 1 << width, (nb, br), dtype=np.uint64)
        words = pack_words(syms.astype(np.int64), width)
        base = rng.choice(np.array([2**31 - 1, -2**31, 7, -1], np.int64),
                          nb).astype(np.int32)
        segs.append(ops.Segment(_t(words.view(np.int32)), width, _t(base),
                                None if kept is None
                                else np.asarray(kept, np.int64)))
        k = np.arange(nb) if kept is None else np.asarray(kept, np.int64)
        want.append(np.asarray(ref_kops.bitunpack(
            jnp.asarray(words[k]), width, br, jnp.asarray(base[k]),
            force_ref=True)).reshape(len(k), br))
    return segs, want


@pytest.mark.parametrize("br", [64, 96, 4096])
def test_bitunpack_segments_match_reference_per_segment(br):
    """The segment list's plain version, segment by segment, against the
    reference's bitunpack oracle on the kept blocks: mixed widths, an
    empty and partial kept lists, every block, a wrapping base."""
    rng = np.random.default_rng(br)
    widths = (1, 6, 21, 31, 32, 13)
    kept = ([4, 0, 2], [], None, [1], [0, 1, 2, 3, 4], [3, 3])
    segs, want = _segment_case(rng, br, widths, kept)
    got = ops.bitunpack_segments(segs, br)
    assert got.dtype == torch.int32 and got.shape == (
        sum(len(w) for w in want), br)
    np.testing.assert_array_equal(got.numpy(), np.concatenate(want))
    one = ops.bitunpack(segs[2].words, widths[2], br, base=segs[2].base)
    np.testing.assert_array_equal(one.numpy(), want[2])


def test_segment_table_is_what_the_kernel_reads():
    """The host-side segment table, read by the kernel's own rules (a
    binary search of the first-output-block column for the last entry at
    or below each output block, the kept list by index from the table's
    start), names the right words, stride, base, width and block for
    every output block -- empty segments first, inside and last."""
    from repro_torch.kernels.bitunpack import segment_table
    rng = np.random.default_rng(7)
    kept = ([], [2, 0], None, [], [1, 1, 3], [])
    segs, _ = _segment_case(rng, 64, (3, 5, 7, 9, 11, 13), kept)
    table = segment_table(segs)
    n = len(segs)
    fields = table[: n * 8].reshape(n, 8)
    out_blocks = []
    for si, s in enumerate(segs):
        out_blocks += [(si, k) for k in range(s.n_out)]
    for g, (si, k) in enumerate(out_blocks):
        lo, hi = 0, n - 1
        while lo < hi:
            mid = (lo + hi + 1) >> 1
            lo, hi = (mid, hi) if fields[mid, 5] <= g else (lo, mid - 1)
        assert lo == si, (g, lo, si)
        f = fields[lo]
        local = g - f[5]
        blk = local if f[3] < 0 else table[f[3] + local]
        want_blk = k if kept[si] is None else kept[si][k]
        assert (local, blk) == (k, want_blk)
        s = segs[si]
        assert (f[0], f[1], f[2], f[6]) == (
            s.words.data_ptr(), s.words.stride(0), s.base.data_ptr(),
            s.width)
    assert sum(s.n_out for s in segs) == len(out_blocks) == 10


def test_bitunpack_segments_rejects_bad_lists():
    words = torch.zeros((3, 6), dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.bitunpack_segments([], 64)
    with pytest.raises(ValueError):
        ops.bitunpack_segments([ops.Segment(words, 3, kept=np.array([3]))],
                               64)
    with pytest.raises(ValueError):
        ops.bitunpack_segments([ops.Segment(words, 4)], 64)


# ------------------------------------------------------------ seg_preagg --

def _mkdata(rng, n, domain, key_lo=0, p_valid=0.8):
    keys = rng.integers(key_lo, domain, n).astype(np.int32)
    valid = rng.random(n) < p_valid
    values = {"qty": rng.integers(-50, 50, n).astype(np.int32),
              "price": np.round(rng.normal(100, 10, n), 2)
              .astype(np.float32)}
    return keys, valid, values


def _both(keys, valid, values, domain, aggs=AGGS):
    got = ops.seg_preagg(_t(keys), _t(valid),
                         {c: _t(v) for c, v in values.items()}, domain, aggs)
    jv = {c: jnp.asarray(v) for c, v in values.items()}
    return got, jnp.asarray(keys), jnp.asarray(valid), jv


@pytest.mark.parametrize("n,domain", [(1000, 37), (777, 256), (77, 1),
                                      (513, 1024)])
def test_seg_preagg_matches_pallas_and_oracle(n, domain):
    rng = np.random.default_rng(n + domain)
    keys, valid, values = _mkdata(rng, n, domain)
    got, jk, jm, jv = _both(keys, valid, values, domain)
    kernel_aggs = tuple(a for a in AGGS if a[2] != "avg")
    pallas = seg_preagg_pallas(jk, jm, jv, domain, kernel_aggs,
                               interpret=True)
    _assert_agree({k: got[k] for k in pallas}, pallas, "pallas")
    _assert_agree(got, ref.seg_preagg_ref(jk, jm, jv, domain, AGGS), "ref")


@pytest.mark.parametrize("domain", [5_000, 150_000])
def test_seg_preagg_wide_domains_match_groupby_dense(domain):
    rng = np.random.default_rng(domain)
    keys, valid, values = _mkdata(rng, 20_000, domain)
    got, jk, jm, jv = _both(keys, valid, values, domain)
    _assert_agree(got, ref_ops.groupby_dense(jk, jm, jv, domain, AGGS),
                  "groupby_dense")


def test_seg_preagg_negative_keys_merge_into_group_zero():
    rng = np.random.default_rng(5)
    keys, valid, values = _mkdata(rng, 600, 40, key_lo=-10)
    got, jk, jm, jv = _both(keys, valid, values, 40)
    _assert_agree(got, ref_ops.groupby_dense(jk, jm, jv, 40, AGGS), "neg")
    assert int(got["n"][0]) == int((valid & (keys <= 0)).sum())


def test_seg_preagg_all_rows_invalid_keeps_sentinels():
    rng = np.random.default_rng(6)
    keys, valid, values = _mkdata(rng, 300, 16, p_valid=0.0)
    got, jk, jm, jv = _both(keys, valid, values, 16)
    _assert_agree(got, ref.seg_preagg_ref(jk, jm, jv, 16, AGGS), "invalid")
    assert int(got["group_count"].sum()) == 0
    assert int(got["mq"][0]) == np.iinfo(np.int32).max
    assert float(got["xp"][0]) == -np.inf


def test_seg_preagg_int32_sums_wrap():
    n = 64
    keys = np.zeros(n, np.int32)
    valid = np.ones(n, bool)
    values = {"qty": np.full(n, 2**30, np.int32),
              "price": np.ones(n, np.float32)}
    got, jk, jm, jv = _both(keys, valid, values, 1)
    _assert_agree(got, ref_ops.groupby_dense(jk, jm, jv, 1, AGGS), "wrap")
    assert int(got["sq"][0]) == 0            # 64 * 2^30 == 2^36 wraps to 0


# ------------------------------------------------------- rle_grouped_agg --

@pytest.mark.parametrize("nb,R,domain,bounded",
                         [(1, 128, 16, False), (3, 128, 50, True),
                          (2, 200, 300, False)])
def test_rle_grouped_agg_matches_pallas_and_oracle(nb, R, domain, bounded):
    rng = np.random.default_rng(nb * R + domain)
    # keys partly OUT of [0, domain): must be dropped, not clipped in
    rv = rng.integers(0, domain + 3, (nb, R)).astype(np.int32)
    rl = rng.integers(0, 20, (nb, R)).astype(np.int32)
    val = rng.normal(size=(nb, R)).astype(np.float32)
    lo, hi = (2.0, float(domain) - 5) if bounded else (-3.0e38, 3.0e38)
    count, total, mn, mx = ops.rle_grouped_agg(
        _t(rv), _t(rl), _t(val), domain=domain, lo=lo, hi=hi)
    assert count.dtype == torch.int32
    args = (jnp.asarray(rv), jnp.asarray(rl), jnp.asarray(val))
    want = np.asarray(ref.rle_grouped_agg_ref(*args, domain, lo, hi))
    pallas = np.asarray(rle_pallas(*args, domain=domain, lo=lo, hi=hi,
                                   interpret=True))
    for w in (want, pallas):
        np.testing.assert_array_equal(count.numpy(), w[0].astype(np.int64))
        np.testing.assert_allclose(total.numpy(), w[1], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(mn.numpy(), w[2])
        np.testing.assert_array_equal(mx.numpy(), w[3])


def test_rle_grouped_agg_default_values_is_key():
    rng = np.random.default_rng(9)
    rv = rng.integers(0, 8, (2, 128)).astype(np.int32)
    rl = rng.integers(0, 5, (2, 128)).astype(np.int32)
    count, total, _, _ = ops.rle_grouped_agg(_t(rv), _t(rl), domain=8)
    want = np.asarray(ref.rle_grouped_agg_ref(
        jnp.asarray(rv), jnp.asarray(rl), jnp.asarray(rv), 8,
        -3.0e38, 3.0e38))
    np.testing.assert_array_equal(count.numpy(), want[0].astype(np.int64))
    np.testing.assert_allclose(total.numpy(), want[1], rtol=1e-5)
    for k in range(8):
        assert int(count[k]) == rl[rv == k].sum()


@pytest.mark.parametrize("with_values,bounded", [(False, False),
                                                 (True, False),
                                                 (True, True)])
def test_rle_grouped_agg_many_matches_oracle(with_values, bounded):
    """The list form over segments -- some empty, runs of length 0, keys
    outside [lo, hi] and outside [0, domain) -- is the reference's oracle
    over their concatenation."""
    rng = np.random.default_rng(11 + 2 * with_values + bounded)
    domain = 40
    lo, hi = (3.0, float(domain) - 7) if bounded else (-3.0e38, 3.0e38)
    segs, flat = [], []
    for n in (50, 0, 300, 1, 0, 77):
        rv = rng.integers(-5, domain + 5, n).astype(np.int32)
        rl = rng.integers(0, 6, n).astype(np.int32)
        val = rng.normal(size=n).astype(np.float32) if with_values \
            else rv.astype(np.float32)
        segs.append((_t(rv), _t(rl), _t(val) if with_values else None))
        flat.append((rv, rl, val))
    count, total, mn, mx = ops.rle_grouped_agg_many(segs, domain=domain,
                                                    lo=lo, hi=hi)
    assert count.dtype == torch.int32 and count.shape == (domain,)
    rv, rl, val = (np.concatenate([f[i] for f in flat]) for i in range(3))
    want = np.asarray(ref.rle_grouped_agg_ref(
        jnp.asarray(rv), jnp.asarray(rl), jnp.asarray(val), domain, lo, hi))
    np.testing.assert_array_equal(count.numpy(), want[0].astype(np.int64))
    np.testing.assert_allclose(total.numpy(), want[1], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(mn.numpy(), want[2])
    np.testing.assert_array_equal(mx.numpy(), want[3])
    # the single-segment wrapper over the concatenation agrees exactly
    one = ops.rle_grouped_agg(_t(rv), _t(rl), _t(val), domain=domain,
                              lo=lo, hi=hi)
    for a, b in zip((count, total, mn, mx), one):
        assert torch.equal(a, b)


def test_rle_grouped_agg_many_rejects_bad_lists():
    with pytest.raises(ValueError):
        ops.rle_grouped_agg_many([], domain=4)
    with pytest.raises(TypeError):
        ops.rle_grouped_agg_many([(torch.zeros(3), torch.ones(3))],
                                 domain=4)
    with pytest.raises(ValueError):
        ops.rle_grouped_agg_many([(torch.zeros(3, dtype=torch.int32),
                                   torch.ones(2, dtype=torch.int32))],
                                 domain=4)


@pytest.mark.parametrize("n_aggs", [0, 1, 6, 32])
def test_seg_preagg_route_at_the_shared_limit(n_aggs):
    """"shared" while one (1 + n_aggs, domain) table of 4-byte words fits
    the 227 KB a CTA may opt in to, "global" one key past it; the
    replicas per CTA are a power of two up to 8 that keep the replicated
    table within 48 KB, and at least one."""
    from repro_torch.kernels.seg_preagg import (MAX_REPLICAS, REPLICA_BYTES,
                                                SMEM_BYTES,
                                                seg_preagg_replicas)
    limit = SMEM_BYTES // (4 * (1 + n_aggs))
    assert ops.seg_preagg_route(limit, n_aggs) == "shared"
    assert ops.seg_preagg_route(limit + 1, n_aggs) == "global"
    assert seg_preagg_replicas(limit, n_aggs) == 1
    assert seg_preagg_replicas(limit + 1, n_aggs) == 0
    for domain in (1, 100, 365, limit // 4, limit):
        r = seg_preagg_replicas(domain, n_aggs)
        table = (1 + n_aggs) * domain * 4
        assert 1 <= r <= MAX_REPLICAS and r & (r - 1) == 0
        assert r == 1 or r * table <= REPLICA_BYTES
        assert r == MAX_REPLICAS or 2 * r * table > REPLICA_BYTES
    # the main path's domains: 100 and 365 shared, 150,000 global
    assert ops.seg_preagg_route(100, 1) == ops.seg_preagg_route(365, 2) \
        == "shared"
    assert ops.seg_preagg_route(150_000, 1) == "global"
