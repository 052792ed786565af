"""The port's compressed-domain execution (engine/compressed.py) against
the reference's and against its own decoded scan.

The 20-query seeded corpus of tests/test_packed_exec.py -- int-interval
filters on a BLOCK_DICT column, on it mixed with the sort column, and
equalities, 1-2 group keys, mixed aggregates, sometimes a join -- runs on
a reference ``repro.core.VerticaDB`` and a port one on the CPU holding the
same rows.  In the port every query must give the same bits with
``exec_mode = "decoded"`` and ``"compressed"`` (assert_array_equal, as the
reference asserts for itself), and at least 8 of them must take the
compressed scan; against the reference's compressed run, ints and counts
must be equal and float aggregates within rtol 1e-5 (summation order, the
North star's tolerance), with the same ``compressed_scan`` and
``rows_materialized``.
"""
import numpy as np
import pytest

import repro.core as ref_core
import repro.engine as ref_engine
import repro_torch.core as port_core
import repro_torch.engine as port_engine
from repro_torch.core.block_cache import KIND_DECODED
from repro_torch.core.encodings import encode, symbol_width
from repro_torch.engine.executor import PLAN_CACHE

N_ROWS = 3000
N_DIM = 120
MODULES = {"ref": (ref_core, ref_engine), "port": (port_core, port_engine)}


def _build_db(core):
    rng = np.random.default_rng(11)
    kw = {"device": "cpu"} if core is port_core else {}
    db = core.VerticaDB(n_nodes=4, k_safety=0, block_rows=64, **kw)
    schema = core.TableSchema("sales", (
        core.ColumnDef("sale_id"), core.ColumnDef("cid"),
        core.ColumnDef("day"), core.ColumnDef("qty"),
        core.ColumnDef("price", core.SQLType.FLOAT)))
    db.catalog.add_table(schema)
    db.create_projection(core.super_projection(
        schema, ("day",), ("sale_id",),
        encodings={"cid": core.Encoding.BLOCK_DICT}))
    db.create_table(core.TableSchema("customer", (
        core.ColumnDef("c_cid"), core.ColumnDef("c_nation"))),
        sort_order=("c_cid",), segment_by=())
    t = db.begin()
    db.insert(t, "sales", {
        "sale_id": np.arange(N_ROWS, dtype=np.int64),
        "cid": rng.integers(0, N_DIM, N_ROWS),
        "day": rng.integers(0, 365, N_ROWS),
        "qty": rng.integers(1, 50, N_ROWS),
        "price": np.round(rng.normal(100, 10, N_ROWS), 2)})
    db.insert(t, "customer", {
        "c_cid": np.arange(N_DIM, dtype=np.int64),
        "c_nation": rng.integers(0, 8, N_DIM)})
    db.commit(t)
    db.run_tuple_mover(force_moveout=True)
    return db


@pytest.fixture(scope="module")
def dbs():
    return {side: _build_db(core) for side, (core, _) in MODULES.items()}


def _corpus(db, col, rng):
    """One seeded corpus query (tests/test_packed_exec.py::_corpus)."""
    qb = db.query("sales")
    r = rng.random()
    if r < 0.4:                       # dict-column interval (code range)
        lo = int(rng.integers(0, 80))
        qb = qb.where((col("cid") >= lo)
                      & (col("cid") <= lo + int(rng.integers(5, 60))))
    elif r < 0.7:                     # mixed dict + sorted column
        qb = qb.where((col("cid") < int(rng.integers(20, 100)))
                      & (col("day") >= int(rng.integers(0, 200))))
    elif r < 0.9:                     # equality on the dict column
        qb = qb.where(col("cid") == int(rng.integers(0, N_DIM)))
    if rng.random() < 0.3:
        qb = qb.join("customer", on=("cid", "c_cid"), cols=("c_nation",))
        keys = ["c_nation"]
    else:
        keys = ["cid"] if rng.random() < 0.6 else ["day"]
        if rng.random() < 0.3:
            keys.append("qty")
    qb = qb.group_by(*keys).agg(n=("*", "count"))
    for name, spec in (("s", ("qty", "sum")), ("mn", ("price", "min")),
                       ("mx", ("price", "max")), ("a", ("price", "avg"))):
        if rng.random() < 0.4:
            qb = qb.agg(**{name: spec})
    return qb


def _run(db, engine, q, mode):
    db.exec_mode = mode
    try:
        return engine.execute(db, q)
    finally:
        db.exec_mode = "auto"


def _same_bits(a, b, label):
    assert set(a) == set(b), (label, sorted(a), sorted(b))
    for c in a:
        np.testing.assert_array_equal(np.asarray(a[c]), np.asarray(b[c]),
                                      err_msg=f"{label} column {c}")


def _like_reference(got, want, label):
    assert set(got) == set(want), (label, sorted(got), sorted(want))
    for c in want:
        g, w = np.asarray(got[c]), np.asarray(want[c])
        assert g.shape == w.shape, (label, c)
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w, err_msg=f"{label} {c}")
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5,
                                       err_msg=f"{label} {c}")


def test_differential_corpus_matches_decoded_and_reference(dbs):
    """Port decoded == port compressed bit for bit; port compressed ==
    reference compressed (ints exact, floats rtol 1e-5, same stats)."""
    rngs = {side: np.random.default_rng(5) for side in MODULES}
    n_compressed = 0
    for db in dbs.values():
        db.block_cache.clear()
    for i in range(20):
        qs = {side: _corpus(dbs[side], MODULES[side][1].col,
                            rngs[side]).to_ir() for side in MODULES}
        dec, _ = _run(dbs["port"], port_engine, qs["port"], "decoded")
        out, st = _run(dbs["port"], port_engine, qs["port"], "compressed")
        ref, rst = _run(dbs["ref"], ref_engine, qs["ref"], "compressed")
        _same_bits(dec, out, f"query {i}")
        _like_reference(out, ref, f"query {i}")
        assert (st.compressed_scan, st.rows_materialized, st.rows_scanned) \
            == (rst.compressed_scan, rst.rows_materialized,
                rst.rows_scanned), i
        n_compressed += bool(st.compressed_scan)
    assert n_compressed >= 8, n_compressed


def test_compressed_with_deleted_tail_blocks():
    """All-deleted tail blocks: survivors must respect delete vectors and
    the padded tail, bit for bit, and match the reference."""
    outs = {}
    for side, (core, engine) in MODULES.items():
        db = _build_db(core)
        t = db.begin()
        db.delete(t, "sales", lambda r: r["day"] >= 300)
        db.commit(t)
        q = (db.query("sales")
             .where((engine.col("cid") >= 10) & (engine.col("cid") <= 90))
             .group_by("cid").agg(n=("*", "count"), s=("qty", "sum"))
             .to_ir())
        dec, _ = _run(db, engine, q, "decoded")
        out, st = _run(db, engine, q, "compressed")
        assert st.compressed_scan
        _same_bits(dec, out, side)
        outs[side] = out
    _like_reference(outs["port"], outs["ref"], "deleted tail")


def test_zero_survivors(dbs):
    db = dbs["port"]
    q = (db.query("sales").where(port_engine.col("cid") == N_DIM + 5)
         .group_by("cid").agg(n=("*", "count")).to_ir())
    dec, _ = _run(db, port_engine, q, "decoded")
    out, st = _run(db, port_engine, q, "compressed")
    _same_bits(dec, out, "zero survivors")
    assert st.rows_materialized == 0
    ref_db = dbs["ref"]
    ref, rst = _run(ref_db, ref_engine, (
        ref_db.query("sales").where(ref_engine.col("cid") == N_DIM + 5)
        .group_by("cid").agg(n=("*", "count")).to_ir()), "compressed")
    _like_reference(out, ref, "zero survivors")
    assert st.compressed_scan == rst.compressed_scan


def test_auto_mode_prefers_warm_decoded(dbs):
    """auto: a budget too small for the decoded working set takes the
    compressed scan; a comfortable budget keeps the decoded scan, cold
    and warm."""
    db = dbs["port"]
    q = (db.query("sales")
         .where((port_engine.col("cid") >= 5) & (port_engine.col("cid") <= 50))
         .group_by("cid").agg(n=("*", "count")).to_ir())
    db.block_cache.clear()
    old_budget = db.block_cache.budget_bytes
    try:
        db.block_cache.budget_bytes = 1 << 14
        _, st_cold = port_engine.execute(db, q)
        assert st_cold.compressed_scan
        db.block_cache.budget_bytes = old_budget
        db.block_cache.clear()
        _, st_cold2 = port_engine.execute(db, q)
        assert not st_cold2.compressed_scan
        _, st_warm = port_engine.execute(db, q)
        assert not st_warm.compressed_scan
    finally:
        db.block_cache.budget_bytes = old_budget


def test_plan_signature_includes_symbol_width():
    """Dictionary growth changes the packed symbol width, which must be
    part of the compressed plan identity (width_signature)."""
    c = encode(np.arange(10, dtype=np.int64), port_core.SQLType.INT,
               port_core.Encoding.BLOCK_DICT, block_rows=64)
    c2 = encode(np.arange(40, dtype=np.int64) % 33, port_core.SQLType.INT,
                port_core.Encoding.BLOCK_DICT, block_rows=64)
    assert c.width_signature() != c2.width_signature()
    assert c.widths["codes_packed"] == symbol_width(9)


def test_grown_dictionary_misses_the_plan_cache():
    """A code-space GROUP BY hits the plan cache on a repeat; after rows
    with new dictionary values land in a new container, the union grows
    and the same query misses -- and the decoded and compressed runs of
    one query never share a plan."""
    db = _build_db(port_core)
    col = port_engine.col

    def query():
        return (db.query("sales").where((col("cid") >= 0)
                                        & (col("cid") <= 500))
                .group_by("cid").agg(n=("*", "count")).to_ir())

    _run(db, port_engine, query(), "compressed")
    _, st = _run(db, port_engine, query(), "compressed")
    assert st.compressed_scan and st.plan_cache == "hit"
    _, st = _run(db, port_engine, query(), "decoded")
    assert not st.compressed_scan and st.plan_cache == "miss"
    t = db.begin()
    db.insert(t, "sales", {
        "sale_id": np.arange(N_ROWS, N_ROWS + 200, dtype=np.int64),
        "cid": np.arange(200, 400, dtype=np.int64),
        "day": np.full(200, 7, np.int64), "qty": np.ones(200, np.int64),
        "price": np.ones(200)})
    db.commit(t)
    db.run_tuple_mover(force_moveout=True)
    out, st = _run(db, port_engine, query(), "compressed")
    assert st.compressed_scan and st.plan_cache == "miss"
    dec, _ = _run(db, port_engine, query(), "decoded")
    _same_bits(dec, out, "grown dictionary")
    assert PLAN_CACHE.stats.hits > 0


def test_compressed_scan_caches_no_decoded_blocks(dbs):
    """The compressed scan keeps only packed payloads (and visibility) in
    the block cache: no KIND_DECODED entry, cold or warm."""
    db = dbs["port"]
    col = port_engine.col
    q = (db.query("sales").where((col("cid") < 60) & (col("day") >= 100))
         .group_by("day").agg(n=("*", "count"), s=("price", "sum"))
         .to_ir())
    db.block_cache.clear()
    for _ in range(2):
        _, st = _run(db, port_engine, q, "compressed")
        assert st.compressed_scan and st.rows_materialized > 0
        assert not [k for k in db.block_cache.keys()
                    if k[2] == KIND_DECODED]


def _build_mixed(core):
    """Three direct-to-ROS batches whose AUTO encodings differ per
    container: ``a`` is DELTA_VALUE (packed) or RLE, ``b`` DELTA_RANGE or
    DELTA_VALUE (both packed)."""
    rng = np.random.default_rng(3)
    kw = {"device": "cpu"} if core is port_core else {}
    db = core.VerticaDB(n_nodes=2, k_safety=0, block_rows=64, **kw)
    schema = core.TableSchema("t", (
        core.ColumnDef("k"), core.ColumnDef("a"), core.ColumnDef("b"),
        core.ColumnDef("g"), core.ColumnDef("v", core.SQLType.FLOAT)))
    db.catalog.add_table(schema)
    db.create_projection(core.super_projection(schema, ("k",), ("k",)))
    n = 1000
    for i, (a, b) in enumerate([
            (rng.integers(0, 4, n), np.arange(n) * 3),
            (np.repeat(np.arange(10), n // 10),
             rng.integers(-10**6, 10**6, n)),
            (rng.integers(-2**20, 2**20, n),
             np.sort(rng.integers(0, 10**5, n)))]):
        t = db.begin(direct_to_ros=True)
        db.insert(t, "t", {"k": np.arange(n) + n * i, "a": a, "b": b,
                           "g": rng.integers(0, 7, n),
                           "v": np.round(rng.normal(50, 9, n), 2)})
        db.commit(t)
    return db


def test_mixed_encodings_across_containers(monkeypatch):
    """Packed and unpacked containers of one predicate column, and
    DELTA_VALUE beside DELTA_RANGE ones: each packed predicate column is
    unpacked by one segment call per query, and the result is the decoded
    scan's bit for bit and the reference's."""
    from repro_torch.engine import compressed

    dbs = {side: _build_mixed(core) for side, (core, _) in MODULES.items()}
    kinds = {(nm, c.columns[nm].encoding.value)
             for n in dbs["port"].nodes for st in n.stores.values()
             for c in st.containers for nm in "ab"}
    assert kinds == {("a", "delta_value"), ("a", "rle"),
                     ("b", "delta_range"), ("b", "delta_value")}
    calls = []
    real = compressed.kops.bitunpack_segments
    monkeypatch.setattr(compressed.kops, "bitunpack_segments",
                        lambda segs, br: calls.append(len(segs))
                        or real(segs, br))
    for lo, hi, bmax in ((0, 2, 2400), (-5000, 5000, 10**9), (3, 8, 10**6)):
        outs = {}
        for side, (_, engine) in MODULES.items():
            db, col = dbs[side], engine.col
            q = (db.query("t")
                 .where((col("a") >= lo) & (col("a") <= hi)
                        & (col("b") < bmax))
                 .group_by("g").agg(n=("*", "count"), s=("b", "sum"),
                                    m=("v", "max"), a=("a", "sum"))
                 .to_ir())
            if side == "port":
                dec, _ = _run(db, engine, q, "decoded")
                del calls[:]
            outs[side], st = _run(db, engine, q, "compressed")
            assert st.compressed_scan
        assert calls == [12, 18], calls      # a: 12 packed of 18; b: all
        _same_bits(dec, outs["port"], (lo, hi))
        _like_reference(outs["port"], outs["ref"], (lo, hi))
