"""The port's kernel entry point ``repro_torch.kernels.ops`` against the
reference's: ``rle_filter_agg``, ``onehot_groupby``, ``semijoin_probe``
and ``delta_decode``.

On the CPU each port wrapper runs its kernel's plain PyTorch version (the
CUDA kernels meet those on the card in chip_smoke.py).  Here the plain
versions meet the reference's Pallas kernels run in interpret mode, on the
same numpy inputs from a seed, at the shapes of tests/test_kernels.py and
on each contract's edge cases: an empty block's -inf max, out-of-domain
keys dropped, the -1 padding of the build side, the first delta ignored,
int32 and f32 inputs.  ``delta_decode`` goes straight to the Pallas
wrapper, because ``repro.kernels.ops.delta_decode`` takes its XLA path on
the CPU.  A slice-level test then runs all four kernels of both packages
on the containers of the same small database loaded into each.

Tolerances: ints and counts exactly equal; f32 sums of integer values
exactly equal (every partial sum stays below 2^24); f32 sums of float
values within rtol 1e-5 of the running magnitude (summation order).
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro_torch.core as port_core
from repro.data.synth import star_schema
from repro.kernels import ref
from repro.kernels.bitunpack import bitunpack_pallas
from repro.kernels.delta_decode import delta_decode as delta_pallas
from repro.kernels.hash_groupby import onehot_groupby as onehot_pallas
from repro.kernels.rle_scan_agg import rle_filter_agg as filter_pallas
from repro.kernels.sip_probe import semijoin_probe as probe_pallas
from repro_torch.kernels import ops


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close_to_magnitude(got, want, magnitude, rtol=1e-5):
    """|got - want| <= rtol * magnitude, elementwise: a float sum may differ
    by summation order, relative to the sum of the magnitudes it adds."""
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= rtol * np.asarray(magnitude)), \
        np.max(np.abs(got - want))


# --------------------------------------------------------- rle_filter_agg --

def _filter_both(rv, rl, lo, hi):
    got = ops.rle_filter_agg(_t(rv), _t(rl), lo=lo, hi=hi)
    want = np.asarray(filter_pallas(jnp.asarray(rv), jnp.asarray(rl),
                                    lo=lo, hi=hi, interpret=True))
    assert got.dtype == torch.float32 and got.shape == want.shape
    return got.numpy(), want


@pytest.mark.parametrize("nb,R", [(1, 128), (4, 128), (3, 384), (8, 130)])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_rle_filter_agg_matches_pallas(nb, R, dtype):
    rng = np.random.default_rng(nb * 1000 + R)
    rv = rng.integers(0, 100, (nb, R)).astype(dtype)
    rl = rng.integers(0, 20, (nb, R)).astype(dtype)
    got, want = _filter_both(rv, rl, 25.0, 75.0)
    np.testing.assert_array_equal(got, want)    # integer-valued: exact
    pad = (-R) % 128
    oracle = np.asarray(ref.rle_filter_agg_ref(
        jnp.pad(jnp.asarray(rv), ((0, 0), (0, pad))),
        jnp.pad(jnp.asarray(rl), ((0, 0), (0, pad))), 25.0, 75.0))
    np.testing.assert_array_equal(got, oracle)


def test_rle_filter_agg_edge_cases():
    # block 0: no run passes -> [0, 0, -inf]; block 1: a passing value
    # with length 0 drops out, and the max is the largest passing value;
    # block 2: float values, bounds inclusive on both sides
    rv = np.array([[1, 2, 99, 0], [30, 50, 40, 10],
                   [25, 75, 74.5, 75.5]], np.float32)
    rl = np.array([[3, 0, 4, 1], [2, 0, 5, 7], [1, 2, 2, 9]], np.float32)
    got, want = _filter_both(rv, rl, 25.0, 75.0)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, [[0, 0, -np.inf], [7, 260, 40], [5, 324, 75]])
    # int values with f32 lengths, and R below one lane
    got, want = _filter_both(rv.astype(np.int32)[:, :3], rl[:, :3],
                             2.0, 60.0)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        ops.rle_filter_agg(_t(rv), _t(rl[:, :2]), lo=0, hi=1)


# --------------------------------------------------------- onehot_groupby --

def _onehot_both(keys, vals, domain):
    got = ops.onehot_groupby(_t(keys), _t(vals), domain=domain)
    want = np.asarray(onehot_pallas(jnp.asarray(keys), jnp.asarray(vals),
                                    domain=domain, interpret=True))
    assert got.dtype == torch.float32 and got.shape == want.shape
    return got.numpy(), want


@pytest.mark.parametrize("nb,B,domain", [(1, 128, 16), (4, 256, 64),
                                         (2, 512, 128), (3, 128, 1000)])
def test_onehot_groupby_matches_pallas(nb, B, domain):
    rng = np.random.default_rng(nb * B + domain)
    # keys partly outside [0, domain): they drop out
    keys = rng.integers(-3, domain + 3, (nb, B)).astype(np.int32)
    ints = rng.integers(-50, 50, (nb, B)).astype(np.int32)
    got, want = _onehot_both(keys, ints, domain)
    np.testing.assert_array_equal(got, want)      # integer sums: exact
    oracle = np.asarray(ref.onehot_groupby_ref(
        jnp.asarray(keys), jnp.asarray(ints), domain))
    np.testing.assert_array_equal(got, oracle)
    floats = rng.normal(size=(nb, B)).astype(np.float32)
    got, want = _onehot_both(keys, floats, domain)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    magnitude = _np(ops.onehot_groupby(_t(keys), _t(np.abs(floats)),
                                       domain=domain))[..., 1]
    _close_to_magnitude(got[..., 1], want[..., 1], magnitude)


def test_onehot_groupby_drops_out_of_domain_keys():
    keys = np.array([[-1, 16, 3, 3, 15, 0, 17, -5]], np.int32)
    vals = np.array([[100, 200, 1, 2, 4, 8, 300, 400]], np.float32)
    got, want = _onehot_both(keys, vals, 16)
    np.testing.assert_array_equal(got, want)
    assert got[0, :, 0].sum() == 4 and got[0, :, 1].sum() == 15
    np.testing.assert_array_equal(got[0, [0, 3, 15]],
                                  [[1, 8], [2, 3], [1, 4]])
    with pytest.raises(ValueError):
        ops.onehot_groupby(_t(keys), _t(vals), domain=1025)


# --------------------------------------------------------- semijoin_probe --

def _probe_both(keys, build):
    got = ops.semijoin_probe(_t(keys), _t(build))
    want = np.asarray(probe_pallas(jnp.asarray(keys), jnp.asarray(build),
                                   interpret=True))
    assert got.dtype == torch.bool and got.shape == want.shape
    return got.numpy(), want


@pytest.mark.parametrize("nb,B,S", [(1, 128, 100), (3, 256, 128),
                                    (2, 512, 1000)])
def test_semijoin_probe_matches_pallas(nb, B, S):
    rng = np.random.default_rng(nb + B + S)
    keys = rng.integers(0, 2000, (nb, B)).astype(np.int32)
    build = rng.choice(2000, S, replace=False).astype(np.int32)
    got, want = _probe_both(keys, build)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.isin(keys, build))


@pytest.mark.parametrize("S,member", [(100, True), (128, False),
                                      (4000, True), (4096, False)])
def test_semijoin_probe_minus_one_padding(S, member):
    # the wrapper pads the build side with -1 to a multiple of 128: a
    # probe key of -1 is a member exactly when S % 128 != 0
    keys = np.array([[-1, 0, S - 1, S, 5000]], np.int32)
    build = np.arange(S, dtype=np.int32)
    got, want = _probe_both(keys, build)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [[member, True, True, False, False]])


def test_semijoin_probe_casts_and_limits():
    keys = np.array([[1, 2, 3, 4]], np.int64)
    got = ops.semijoin_probe(_t(keys), _t(np.array([2, 4], np.int64)))
    np.testing.assert_array_equal(got.numpy(), [[False, True, False, True]])
    with pytest.raises(ValueError):
        ops.semijoin_probe(_t(keys), torch.zeros(4097, dtype=torch.int32))


# ----------------------------------------------------------- delta_decode --

def _decode_both(first, deltas):
    got = ops.delta_decode(_t(first), _t(deltas))
    want = np.asarray(delta_pallas(jnp.asarray(first), jnp.asarray(deltas),
                                   interpret=True))
    assert got.dtype == torch.float32 and got.shape == want.shape
    return got.numpy(), want


@pytest.mark.parametrize("nb,B", [(1, 128), (5, 256), (2, 4096)])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_delta_decode_matches_pallas(nb, B, dtype):
    rng = np.random.default_rng(nb * B)
    first = rng.integers(0, 1000, (nb, 1)).astype(dtype)
    deltas = rng.integers(-5, 6, (nb, B)).astype(dtype)
    got, want = _decode_both(first, deltas)
    np.testing.assert_array_equal(got, want)      # integer-valued: exact
    np.testing.assert_array_equal(got, np.asarray(ref.delta_decode_ref(
        jnp.asarray(first), jnp.asarray(deltas))))


def test_delta_decode_ignores_the_first_delta():
    first = np.array([[10], [-4]], np.int32)
    deltas = np.array([[99, 1, 2, 3], [-7, 0, 0, 5]], np.int32)
    got, want = _decode_both(first, deltas)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [[10, 11, 13, 16], [-4, -4, -4, 1]])
    # int first with f32 deltas
    got, want = _decode_both(first, deltas.astype(np.float32))
    np.testing.assert_array_equal(got, want)


def test_delta_decode_float_deltas():
    rng = np.random.default_rng(11)
    first = rng.normal(size=(3, 1)).astype(np.float32) * 100
    deltas = rng.normal(size=(3, 1000)).astype(np.float32)
    got, want = _decode_both(first, deltas)
    magnitude = np.abs(first) + np.cumsum(np.abs(deltas), axis=1)
    _close_to_magnitude(got, want, magnitude)


# ------------------------------------------------------- the slice at once --

N_FACT, N_DIM = 20_000, 3_000


def _load(core, **kw):
    fact, dim = star_schema(N_FACT, N_DIM, seed=0)
    db = core.VerticaDB(n_nodes=2, k_safety=0, block_rows=512, **kw)
    schema = core.TableSchema("lineitem", (
        core.ColumnDef("l_orderkey"), core.ColumnDef("l_suppkey"),
        core.ColumnDef("l_shipdate"), core.ColumnDef("l_qty"),
        core.ColumnDef("l_extprice", core.SQLType.FLOAT)))
    db.catalog.add_table(schema)
    db.create_projection(core.super_projection(
        schema, ("l_shipdate", "l_suppkey"), ("l_orderkey",),
        encodings={"l_shipdate": core.Encoding.RLE}))
    db.create_table(core.TableSchema("orders", (
        core.ColumnDef("o_orderkey"), core.ColumnDef("o_custkey"),
        core.ColumnDef("o_orderdate"))), sort_order=("o_orderkey",),
        segment_by=())
    t = db.begin(direct_to_ros=True)
    db.insert(t, "lineitem", fact)
    db.insert(t, "orders", dim)
    db.commit(t)
    return db, fact, dim


def _containers(db, table):
    return db.nodes[0].stores[table].containers


@pytest.fixture(scope="module")
def dbs():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # jax's int64->int32 notices
        ref_db, fact, dim = _load(ref_core)
        port_db, _, _ = _load(port_core, device="cpu")
    return ref_db, port_db, fact, dim


def test_slice_kernels_on_the_databases_own_containers(dbs):
    ref_db, port_db, fact, dim = dbs
    ref_li = _containers(ref_db, "lineitem_super")
    port_li = _containers(port_db, "lineitem_super")
    assert len(ref_li) == len(port_li) >= 1
    build_keys = dim["o_orderkey"][dim["o_orderdate"] < 100].astype(np.int32)
    total = {"count": 0, "probe": 0}
    for rc, pc in zip(ref_li, port_li):
        # RLE sort-leader runs: the same payload on both sides
        rcol, pcol = rc.columns["l_shipdate"], pc.columns["l_shipdate"]
        rv, rl = pcol.arrays["run_values"], pcol.arrays["run_lengths"]
        np.testing.assert_array_equal(rv, rcol.arrays["run_values"])
        np.testing.assert_array_equal(rl, rcol.arrays["run_lengths"])
        got = ops.rle_filter_agg(_t(rv.astype(np.int32)),
                                 _t(rl.astype(np.int32)), lo=61, hi=119)
        want = filter_pallas(jnp.asarray(rcol.arrays["run_values"]),
                             jnp.asarray(rcol.arrays["run_lengths"]),
                             lo=61.0, hi=119.0, interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        # tail padding repeats the last run's value: subtract it
        sd = pcol.decode()
        pad = pcol.n_blocks * pcol.block_rows - pc.n_rows
        total["count"] += int(got[:, 0].sum()) \
            - pad * int(61 <= sd[-1] <= 119)
        assert total["count"] >= 0

        # dense keys: l_suppkey (domain 100) with l_qty, block by block
        keys = pc.columns["l_suppkey"].decode_blocks().astype(np.int32)
        qty = pc.columns["l_qty"].decode_blocks().astype(np.float32)
        valid = np.arange(keys.size).reshape(keys.shape) < pc.n_rows
        keys = np.where(valid, keys, -1)       # padding rows drop out
        got = ops.onehot_groupby(_t(keys), _t(qty), domain=100)
        want = onehot_pallas(jnp.asarray(keys), jnp.asarray(qty),
                             domain=100, interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            got.numpy()[..., 0].sum(0),
            np.bincount(keys[valid], minlength=100))

        # probe keys: l_orderkey against a few thousand o_orderkeys, the
        # build side cut into chunks of MAX_BUILD and the results OR-ed
        probe = pc.columns["l_orderkey"].decode_blocks().astype(np.int32)
        got = torch.zeros(probe.shape, dtype=torch.bool)
        want = np.zeros(probe.shape, bool)
        for s in range(0, build_keys.size, 256):
            chunk = build_keys[s:s + 256]
            got |= ops.semijoin_probe(_t(probe), _t(chunk))
            want |= np.asarray(probe_pallas(jnp.asarray(probe),
                                            jnp.asarray(chunk),
                                            interpret=True))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(),
                                      np.isin(probe, build_keys))
        total["probe"] += int(got.numpy()[valid].sum())
    li = fact["l_shipdate"]
    node0 = sum(c.n_rows for c in port_li)
    assert 0 < total["count"] <= ((li > 60) & (li < 120)).sum()
    assert 0 < total["probe"] <= node0

    # a DELTA_RANGE column: bit-unpack, then the prefix scan
    for rc, pc in zip(_containers(ref_db, "orders_super"),
                      _containers(port_db, "orders_super")):
        rcol, pcol = rc.columns["o_orderkey"], pc.columns["o_orderkey"]
        assert pcol.encoding.value == "delta_range"
        a = pcol.arrays
        w, br = pcol.widths["deltas_packed"], pcol.block_rows
        deltas = ops.bitunpack(_t(a["deltas_packed"].view(np.int32)), w, br,
                               base=_t(a["delta_min"].astype(np.int32)))
        got = ops.delta_decode(_t(a["first"].astype(np.int32)[:, None]),
                               deltas)
        ra = rcol.arrays
        rdeltas = bitunpack_pallas(
            jnp.asarray(ra["deltas_packed"]), w, br,
            jnp.asarray(ra["delta_min"].astype(np.int32)), interpret=True)
        want = delta_pallas(jnp.asarray(ra["first"].astype(np.int32))[:, None],
                            rdeltas, interpret=True)
        np.testing.assert_array_equal(deltas.numpy(), np.asarray(rdeltas))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            got.numpy(), pcol.decode_blocks().astype(np.float32))
