"""The port's remaining engine operators against the reference's
(``repro.engine.operators``): ``scan_container``, ``groupby_prepass``,
``sort_rows``, ``top_k`` and ``analytic_running_sum``.

The same numpy inputs from a seed go to both packages; the port runs on
the CPU.  Ints, counts, orders and masks must be exactly equal; f32 sums
within rtol 1e-5 (the prepass adds its block partials in another order).
The scan runs on a port database rebuilt from the reference's stored
state (``database_from_state(state_of(...))``), so both sides read the
same containers, SMAs and delete vectors.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro_torch.core as port_core
from repro.engine import col as ref_col
from repro.engine import operators as ref_ops
from repro_torch.engine import col as port_col
from repro_torch.engine import operators as port_ops

AGGS = (("n", "*", "count"), ("sq", "qty", "sum"), ("mq", "qty", "min"),
        ("xq", "qty", "max"), ("sp", "price", "sum"), ("ap", "price", "avg"),
        ("mp", "price", "min"), ("xp", "price", "max"), ("aq", "qty", "avg"))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_agree(got, want, label, rtol=1e-5):
    assert set(got) == set(want), label
    for name in want:
        g = got[name].numpy()
        w = np.asarray(want[name])
        assert g.shape == w.shape and g.dtype == w.dtype, (label, name,
                                                           g.dtype, w.dtype)
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w, err_msg=f"{label}:{name}")
        else:
            np.testing.assert_allclose(g, w, rtol=rtol,
                                       err_msg=f"{label}:{name}")


# ------------------------------------------------------- groupby_prepass --

@pytest.mark.parametrize("n,domain,block", [(1000, 37, 128), (4096, 100, 4096),
                                            (777, 1, 64), (5000, 365, 512)])
def test_groupby_prepass_matches_reference_and_groupby_dense(n, domain,
                                                             block):
    rng = np.random.default_rng(n + domain)
    keys = rng.integers(-2, domain + 2, n).astype(np.int32)  # clipped in
    valid = rng.random(n) < 0.8
    values = {"qty": rng.integers(-50, 50, n).astype(np.int32),
              "price": np.round(rng.normal(100, 10, n), 2)
              .astype(np.float32)}
    tv = {c: _t(v) for c, v in values.items()}
    got = port_ops.groupby_prepass(_t(keys), _t(valid), tv, domain, AGGS,
                                   block=block)
    want = ref_ops.groupby_prepass(
        jnp.asarray(keys), jnp.asarray(valid),
        {c: jnp.asarray(v) for c, v in values.items()}, domain, AGGS,
        block=block)
    _assert_agree(got, want, "reference")
    dense = port_ops.groupby_dense(_t(keys), _t(valid), tv, domain, AGGS)
    _assert_agree(got, {k: v.numpy() for k, v in dense.items()}, "dense")


def test_groupby_prepass_int_sums_wrap_like_the_reference():
    n = 3000
    keys = np.arange(n, dtype=np.int32) % 3
    big = np.full(n, 2**30, np.int32)          # per-key sums pass 2^31
    aggs = (("s", "v", "sum"),)
    got = port_ops.groupby_prepass(_t(keys), _t(np.ones(n, bool)),
                                   {"v": _t(big)}, 3, aggs, block=256)
    want = ref_ops.groupby_prepass(jnp.asarray(keys),
                                   jnp.asarray(np.ones(n, bool)),
                                   {"v": jnp.asarray(big)}, 3, aggs,
                                   block=256)
    _assert_agree(got, want, "wrap")


# --------------------------------------------------- sort / top-k / running --

def _rows(rng, n, base=0):
    return {"k": (base + rng.integers(0, 6, n)).astype(np.int32),  # ties
            "i": np.arange(n, dtype=np.int32),
            "f": rng.normal(size=n).astype(np.float32)}, rng.random(n) < 0.7


# keys from 2^24 up collapse into ties in the f32 key both sort on
@pytest.mark.parametrize("base", [0, 2**24])
@pytest.mark.parametrize("descending", [False, True])
def test_sort_rows_is_stable_like_the_reference(descending, base):
    cols, valid = _rows(np.random.default_rng(3), 300, base)
    got, gvalid = port_ops.sort_rows({c: _t(v) for c, v in cols.items()},
                                     _t(valid), ("k",), descending)
    want, wvalid = ref_ops.sort_rows(
        {c: jnp.asarray(v) for c, v in cols.items()}, jnp.asarray(valid),
        ("k",), descending)
    np.testing.assert_array_equal(gvalid.numpy(), np.asarray(wvalid))
    for c in cols:
        np.testing.assert_array_equal(got[c].numpy(), np.asarray(want[c]))
    # ties keep input order; invalid rows go last
    i, v = got["i"].numpy(), gvalid.numpy()
    k = got["k"].numpy().astype(np.float32)
    assert (np.diff(v.astype(np.int8)) <= 0).all()
    same = (k[1:] == k[:-1]) & v[1:] & v[:-1]
    assert (i[1:][same] > i[:-1][same]).all()


@pytest.mark.parametrize("k", [1, 7, 40, 300])
def test_top_k_breaks_ties_by_lower_index(k):
    cols, valid = _rows(np.random.default_rng(k), 300)
    got = port_ops.top_k({c: _t(v) for c, v in cols.items()}, _t(valid),
                         "k", k)
    want = ref_ops.top_k({c: jnp.asarray(v) for c, v in cols.items()},
                         jnp.asarray(valid), "k", k)
    for c in cols:
        np.testing.assert_array_equal(got[c].numpy(), np.asarray(want[c]))


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_analytic_running_sum_matches_reference(dtype):
    rng = np.random.default_rng(5)
    n = 500
    parts = np.sort(rng.integers(0, 12, n)).astype(np.int32)
    if dtype == np.int32:                  # sums wrap past 2^31 in int32
        values = rng.integers(2**28, 2**30, n).astype(np.int32)
    else:
        values = rng.integers(-100, 100, n).astype(np.float32)
    got = port_ops.analytic_running_sum(_t(values), _t(parts))
    want = np.asarray(ref_ops.analytic_running_sum(jnp.asarray(values),
                                                   jnp.asarray(parts)))
    assert got.dtype == torch.from_numpy(want).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    # the int64 input lands on the int32 lane, as the reference's does
    got64 = port_ops.analytic_running_sum(_t(values.astype(np.int64)),
                                          _t(parts))
    if dtype == np.int32:
        assert got64.dtype == torch.int32
        np.testing.assert_array_equal(got64.numpy(), want)


# ---------------------------------------------------------- scan_container --

@pytest.fixture(scope="module")
def scan_dbs():
    from repro.data.synth import star_schema
    fact, _ = star_schema(12_000, 1_000, seed=4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # jax's int64->int32 notices
        db = ref_core.VerticaDB(n_nodes=2, k_safety=0, block_rows=256)
        db.create_table(ref_core.TableSchema("lineitem", (
            ref_core.ColumnDef("l_orderkey"), ref_core.ColumnDef("l_suppkey"),
            ref_core.ColumnDef("l_shipdate"), ref_core.ColumnDef("l_qty"),
            ref_core.ColumnDef("l_extprice", ref_core.SQLType.FLOAT))),
            sort_order=("l_shipdate", "l_suppkey"),
            segment_by=("l_orderkey",))
        t = db.begin(direct_to_ros=True)
        db.insert(t, "lineitem", fact)
        db.commit(t)
        t = db.begin()
        db.delete(t, "lineitem", lambda r: r["l_suppkey"] == 7)
        db.commit(t)
    return db, port_core.database_from_state(port_core.state_of(db), "cpu")


def _scan_pair(scan_dbs, pred, sip_keys=None):
    ref_db, port_db = scan_dbs
    out = []
    for host in range(2):
        proj = next(iter(ref_db.nodes[host].stores))
        rs = ref_db.nodes[host].stores[proj]
        ps = port_db.nodes[host].stores[proj]
        for rc, pc in zip(rs.containers, ps.containers):
            deleted = rs.deleted_mask(rc)
            np.testing.assert_array_equal(ps.deleted_mask(pc), deleted)
            deleted = deleted if deleted.any() else None
            ref_sip = port_sip = None
            if sip_keys is not None:
                ref_sip = lambda c: jnp.isin(c["l_orderkey"],  # noqa: E731
                                             jnp.asarray(sip_keys))
                port_sip = lambda c: torch.isin(  # noqa: E731
                    c["l_orderkey"], _t(sip_keys))
            cols = ("l_orderkey", "l_suppkey", "l_qty", "l_extprice")
            r = ref_ops.scan_container(
                rc, cols, pred(ref_col) if pred else None, deleted, ref_sip)
            p = port_ops.scan_container(
                pc, cols, pred(port_col) if pred else None, deleted,
                port_sip, device="cpu")
            out.append((r, p, deleted))
    return out


def _assert_scan_equal(r, p):
    if r is None:
        assert p is None
        return
    assert (p.pruned_blocks, p.total_blocks) == (r.pruned_blocks,
                                                 r.total_blocks)
    np.testing.assert_array_equal(p.valid.numpy(), np.asarray(r.valid))
    assert set(p.columns) == set(r.columns)
    for c in r.columns:
        g, w = p.columns[c].numpy(), np.asarray(r.columns[c])
        assert g.dtype == w.dtype, c
        np.testing.assert_array_equal(g, w, err_msg=c)


def test_scan_container_prunes_blocks_like_the_reference(scan_dbs):
    pairs = _scan_pair(scan_dbs, lambda col: (col("l_shipdate") >= 100)
                       & (col("l_shipdate") < 140) & (col("l_qty") > 10))
    assert any(r is not None and r.pruned_blocks for r, _, _ in pairs)
    for r, p, _ in pairs:
        _assert_scan_equal(r, p)
    # a predicate no block can satisfy prunes the whole container
    for r, p, _ in _scan_pair(scan_dbs, lambda col: col("l_shipdate") > 999):
        assert r is None and p is None


def test_scan_container_masks_deletes_and_sip(scan_dbs):
    keys = np.arange(0, 12_000, 3, dtype=np.int32)
    pairs = _scan_pair(scan_dbs, None, sip_keys=keys)
    assert any(d is not None and d.any() for _, _, d in pairs)
    for r, p, _ in pairs:
        _assert_scan_equal(r, p)
        assert not p.columns["l_suppkey"][p.valid].eq(7).any()
    for r, p, _ in _scan_pair(scan_dbs, lambda col: col("l_suppkey") < 20):
        _assert_scan_equal(r, p)
