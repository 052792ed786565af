"""The port's segmented execution (engine/segmented.py, engine/exchange.py,
distributed/mesh.py and the device hash twins) against the reference's.

The same rows -- the star layout of tests/test_segmented_exec.py::make_db
(sales 4,000 rows segmented by custkey; customer co-located, supplier
replicated, parts resegmented, promo broadcast; 4 nodes, K=1,
``block_rows`` 64) -- go into a reference ``repro.core.VerticaDB`` and a
port one on the CPU, and the same queries run on both.  The reference runs
segmented on its one CPU device; the port runs segmented at 1 and at 4
logical shards and single-node.  Port segmented == port single-node ==
reference segmented: ints and counts exactly, floats within the reference
test's rtol 1e-3 / atol 1e-2 (partial sums merge in another order).

The device hash and shard twins go bit for bit against numpy's
``hash_columns`` / ``shard_of`` and against the reference's jax twins, and
the port's ``resegment`` against a numpy model of the reference's slots
and overflow.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
import hypothesis.strategies as st

import repro.core as ref_core
import repro.engine as ref_engine
import repro_torch.core as port_core
import repro_torch.engine as port_engine
from repro.core.segmentation import hash_columns_jnp, shard_of_jnp
from repro_torch.core.block_cache import KIND_WOS
from repro_torch.core.recovery import recover_node as port_recover
from repro.core.recovery import recover_node as ref_recover
from repro_torch.core.segmentation import (hash_columns, hash_columns_torch,
                                           shard_of, shard_of_torch)
from repro_torch.distributed import (dp_size, make_query_mesh,
                                     mesh_axis_size, tp_size)
from repro_torch.engine import exchange, segmented
from repro_torch.engine import executor as port_exec
from repro.engine import executor as ref_exec
from repro.planner import plan_query as ref_plan_query
from repro_torch.planner import plan_query

N_FACT = 4000
N_CUST, N_SUPP, N_PART, N_PROMO = 300, 40, 2000, 30
SIDES = {"ref": (ref_core, ref_engine), "port": (port_core, port_engine)}

# -- join templates: (dim, on, carried col, expected exchange strategy) --
JOINS = {
    "customer": (("custkey", "c_custkey"), "c_nation", "local"),
    "supplier": (("suppkey", "s_suppkey"), "s_region", "local"),
    "parts": (("partkey", "p_partkey"), "p_cat", "resegment"),
    "promo": (("day", "pr_day"), "pr_kind", "broadcast"),
}


def make_db(core, k_safety=1, n_nodes=4, seed=7):
    """tests/test_segmented_exec.py::make_db on either package."""
    rng = np.random.default_rng(seed)
    kw = {"device": "cpu"} if core is port_core else {}
    db = core.VerticaDB(n_nodes=n_nodes, k_safety=k_safety, block_rows=64,
                        **kw)
    C = core.ColumnDef
    db.create_table(core.TableSchema("sales", (
        C("sale_id"), C("custkey"), C("suppkey"), C("partkey"), C("day"),
        C("qty"), C("delta"), C("price", core.SQLType.FLOAT))),
        sort_order=("day",), segment_by=("custkey",))
    db.create_table(core.TableSchema("customer", (
        C("c_custkey"), C("c_nation"))),
        sort_order=("c_custkey",), segment_by=("c_custkey",))
    db.create_table(core.TableSchema("supplier", (
        C("s_suppkey"), C("s_region"))),
        sort_order=("s_suppkey",), segment_by=())        # replicated
    db.create_table(core.TableSchema("parts", (
        C("p_partkey"), C("p_cat"))),
        sort_order=("p_partkey",), segment_by=("p_partkey",))
    db.create_table(core.TableSchema("promo", (
        C("pr_day"), C("pr_kind"))),
        sort_order=("pr_day",), segment_by=("pr_day",))
    t = db.begin()
    db.insert(t, "sales", {
        "sale_id": np.arange(N_FACT, dtype=np.int64),
        "custkey": rng.integers(0, N_CUST, N_FACT),
        "suppkey": rng.integers(0, N_SUPP, N_FACT),
        "partkey": rng.integers(0, N_PART, N_FACT),
        "day": rng.integers(0, 365, N_FACT),
        "qty": rng.integers(1, 50, N_FACT),
        "delta": rng.integers(-40, 40, N_FACT),      # negative group keys
        "price": np.round(rng.normal(100, 10, N_FACT), 2)})
    db.insert(t, "customer", {
        "c_custkey": np.arange(N_CUST, dtype=np.int64),
        "c_nation": rng.integers(0, 12, N_CUST)})
    db.insert(t, "supplier", {
        "s_suppkey": np.arange(N_SUPP, dtype=np.int64),
        "s_region": rng.integers(0, 5, N_SUPP)})
    db.insert(t, "parts", {
        "p_partkey": np.arange(N_PART, dtype=np.int64),
        "p_cat": rng.integers(0, 9, N_PART)})
    db.insert(t, "promo", {
        "pr_day": np.arange(N_PROMO, dtype=np.int64) * 12,
        "pr_kind": rng.integers(0, 4, N_PROMO)})
    db.commit(t)
    db.run_tuple_mover(force_moveout=True)
    return db


def make_pair(**kw):
    return {side: make_db(core, **kw) for side, (core, _) in SIDES.items()}


@pytest.fixture(scope="module")
def star():
    return make_pair()


def gen_query(db, col, rng):
    """tests/test_segmented_exec.py::gen_query with the side's ``col``:
    two generators seeded alike draw the same query on both sides."""
    qb = db.query("sales")
    if rng.random() < 0.7:
        lo = int(rng.integers(0, 280))
        hi = lo + int(rng.integers(30, 200))
        qb = qb.where((col("day") >= lo) & (col("day") < hi))
    if rng.random() < 0.3:
        qb = qb.where(col("qty") > int(rng.integers(1, 25)))
    dims = [d for d in JOINS if rng.random() < 0.45][:3]
    pool = ["suppkey", "delta", "day"]
    for d in dims:
        on, carried, _ = JOINS[d]
        where = None
        if d == "customer" and rng.random() < 0.5:
            where = col("c_nation") < int(rng.integers(4, 12))
        qb = qb.join(d, on=on, cols=(carried,), where=where)
        pool.append(carried)
    k = int(rng.integers(1, min(3, len(pool)) + 1))
    keys = [pool[i] for i in rng.choice(len(pool), size=k, replace=False)]
    qb = qb.group_by(*keys)
    qb = qb.agg(n=("*", "count"))
    for name, spec in (("s", ("qty", "sum")), ("mn", ("price", "min")),
                       ("mx", ("price", "max")), ("a", ("price", "avg"))):
        if rng.random() < 0.4:
            qb = qb.agg(**{name: spec})
    if rng.random() < 0.25:
        qb = qb.having(col("n") > int(rng.integers(1, 4)))
    if rng.random() < 0.4:
        qb = qb.order_by("-n", *keys).limit(int(rng.integers(5, 25)))
    return qb


def canon(out, ordered):
    cols = sorted(out)
    if not cols or len(next(iter(out.values()))) == 0 or ordered:
        return {c: np.asarray(out[c]) for c in cols}
    order = np.lexsort([np.asarray(out[c]) for c in cols])
    return {c: np.asarray(out[c])[order] for c in cols}


def assert_match(ref, got, ordered, label):
    a, b = canon(ref, ordered), canon(got, ordered)
    assert set(a) == set(b), (label, sorted(a), sorted(b))
    for c in a:
        av, bv = a[c], b[c]
        assert av.shape == bv.shape, (label, c, av.shape, bv.shape)
        if av.dtype.kind in "iub" and bv.dtype.kind in "iub":
            assert (av == bv).all(), (label, c, av[:8], bv[:8])
        else:
            assert np.allclose(np.asarray(av, np.float64),
                               np.asarray(bv, np.float64),
                               rtol=1e-3, atol=1e-2), \
                (label, c, av[:8], bv[:8])


def ref_seg(db, qb):
    """The reference, segmented on its one CPU device."""
    db.attach_mesh()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return ref_engine.execute(db, qb.to_ir())
    finally:
        db.detach_mesh()


def port_run(db, qb, n_shards=None):
    """The port at ``n_shards`` logical shards, or single-node (None)."""
    if n_shards is not None:
        db.attach_mesh(make_query_mesh(n_shards, device="cpu"))
    try:
        return port_engine.execute(db, qb.to_ir())
    finally:
        db.detach_mesh()


def both_queries(dbs, build):
    """The same query built on each side (``build(db, col)``)."""
    return {side: build(dbs[side], SIDES[side][1].col) for side in dbs}


def check_all(dbs, qs, label, *, ordered=False, shards=(1, 4),
              ref_segmented=False, ref=True):
    """reference == port single-node == port segmented at each width;
    returns the port's stats per width.  The reference runs single-node
    unless ``ref_segmented`` (its segmented path compiles several jax
    programs per query shape, seconds each on the CPU, so the corpus
    takes it and the rest lean on it), or not at all without ``ref``."""
    single, _ = port_run(dbs["port"], qs["port"])
    if ref_segmented:
        want, rstats = ref_seg(dbs["ref"], qs["ref"])
    elif ref:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want, rstats = ref_engine.execute(dbs["ref"],
                                              qs["ref"].to_ir())
    if ref:
        assert_match(want, single, ordered, f"{label}/single")
    out = {}
    for n in shards:
        got, stats = port_run(dbs["port"], qs["port"], n)
        assert stats.reseg_overflow == 0
        if stats.segmented:
            assert stats.n_shards == n
        if ref_segmented:
            assert stats.segmented == rstats.segmented, (label, n)
            assert stats.exchange == rstats.exchange, (label, n)
        assert_match(single, got, ordered, f"{label}/{n}")
        out[n] = stats
    return out


# ---------------------------------------------------------------------------
# the corpus and the exchange strategies
# ---------------------------------------------------------------------------

def test_differential_corpus(star):
    """20 seeded queries: port segmented (1 and 4 shards) == port
    single-node == reference segmented, and all three exchange strategies
    occur at 4 shards."""
    rngs = {side: np.random.default_rng(2024) for side in star}
    seen = set()
    for i in range(20):
        qs = {side: gen_query(star[side], SIDES[side][1].col, rngs[side])
              for side in star}
        ordered = bool(qs["port"].to_ir().order_by)
        stats = check_all(star, qs, f"q{i}", ordered=ordered,
                          ref_segmented=True)
        assert stats[4].segmented, i
        seen.update(e for e in stats[4].exchange.split(";") if e)
    assert {"local", "broadcast", "resegment"} <= seen, seen


@pytest.mark.parametrize("dim", list(JOINS))
def test_exchange_strategy_per_join(star, dim):
    on, carried, expected = JOINS[dim]
    qs = both_queries(star, lambda db, col: (
        db.query("sales").join(dim, on=on, cols=(carried,))
        .group_by(carried).agg(n=("*", "count"), s=("qty", "sum"))))
    plan = plan_query(star["port"], qs["port"].to_ir())
    assert plan.join_exchanges == (expected,), plan.join_strategy
    stats = check_all(star, qs, dim)
    assert stats[4].segmented and stats[4].exchange == expected


def test_scalar_aggregate(star):
    qs = both_queries(star, lambda db, col: (
        db.query("sales").where(col("day") > 200).agg(
            n=("*", "count"), s=("qty", "sum"), a=("price", "avg"),
            mn=("price", "min"), mx=("qty", "max"))))
    stats = check_all(star, qs, "scalar", ref_segmented=True)
    assert stats[4].segmented


def test_snowflake_demotes_to_broadcast():
    dbs = make_pair(seed=8)
    for side, (core, _) in SIDES.items():
        db = dbs[side]
        db.create_table(core.TableSchema("nation", (
            core.ColumnDef("n_nation"), core.ColumnDef("n_cont"))),
            sort_order=("n_nation",), segment_by=("n_nation",))
        t = db.begin()
        db.insert(t, "nation", {"n_nation": np.arange(12, dtype=np.int64),
                                "n_cont": np.arange(12, dtype=np.int64) % 3})
        db.commit(t)
        db.run_tuple_mover(force_moveout=True)
    qs = both_queries(dbs, lambda db, col: (
        db.query("sales")
        .join("customer", on=("custkey", "c_custkey"), cols=("c_nation",))
        .join("nation", on=("c_nation", "n_nation"), cols=("n_cont",))
        .group_by("n_cont").agg(n=("*", "count"))))
    plan = plan_query(dbs["port"], qs["port"].to_ir())
    assert plan.join_exchanges[1] == "broadcast", plan.join_strategy
    assert check_all(dbs, qs, "snowflake")[4].segmented


def test_repeat_resegment_key_becomes_local():
    """Two joins probing the SAME fact key: after the first exchange the
    probe side is placed by that key, so the second join runs local."""
    dbs = make_pair(seed=9)
    for side, (core, _) in SIDES.items():
        db = dbs[side]
        rng = np.random.default_rng(5)
        db.create_table(core.TableSchema("partsx", (
            core.ColumnDef("px_partkey"), core.ColumnDef("px_weight"))),
            sort_order=("px_partkey",), segment_by=("px_weight",))
        t = db.begin()
        db.insert(t, "partsx", {
            "px_partkey": np.arange(N_PART, dtype=np.int64),
            "px_weight": rng.integers(0, 7, N_PART)})
        db.commit(t)
        db.run_tuple_mover(force_moveout=True)
    qs = both_queries(dbs, lambda db, col: (
        db.query("sales")
        .join("parts", on=("partkey", "p_partkey"), cols=("p_cat",))
        .join("partsx", on=("partkey", "px_partkey"), cols=("px_weight",))
        .group_by("p_cat", "px_weight").agg(n=("*", "count"))))
    plan = plan_query(dbs["port"], qs["port"].to_ir())
    assert plan.join_exchanges == ("resegment", "local"), plan.join_strategy
    assert check_all(dbs, qs, "repeat-reseg")[4].segmented


def test_two_resegment_stages_and_stage_timing():
    """Two resegment joins on different fact keys (a dimension too large
    to broadcast, segmented off its key): three stages chained without a
    host sync -- the second exchange moves the rows the first placed --
    each timed when ``collect_stage_timing`` is on."""
    dbs = make_pair(seed=10)
    for side, (core, _) in SIDES.items():
        db = dbs[side]
        db.create_table(core.TableSchema("cust2", (
            core.ColumnDef("c2_custkey"), core.ColumnDef("c2_band"))),
            sort_order=("c2_custkey",), segment_by=("c2_band",))
        t = db.begin()
        db.insert(t, "cust2", {
            "c2_custkey": np.arange(1500, dtype=np.int64),
            "c2_band": np.arange(1500, dtype=np.int64) % 7})
        db.commit(t)
        db.run_tuple_mover(force_moveout=True)
    qs = both_queries(dbs, lambda db, col: (
        db.query("sales")
        .join("parts", on=("partkey", "p_partkey"), cols=("p_cat",))
        .join("cust2", on=("custkey", "c2_custkey"), cols=("c2_band",))
        .group_by("p_cat", "c2_band")
        .agg(n=("*", "count"), s=("qty", "sum"))))
    dbs["port"].collect_stage_timing = True
    stats = check_all(dbs, qs, "two-stage")[4]
    plan = plan_query(dbs["port"], qs["port"].to_ir())
    assert plan.join_exchanges == ("resegment", "resegment")
    assert stats.exchange == "resegment;resegment"
    assert {"slab_build", "exchange_join", "preagg",
            "final_merge"} <= set(stats.stage_ms), stats.stage_ms


def test_plan_cache_hit_keyed_by_mesh(star):
    qs = both_queries(star, lambda db, col: (
        db.query("sales").where(col("qty") > 10)
        .group_by("suppkey").agg(n=("*", "count"), s=("qty", "sum"))))
    db, qb = star["port"], qs["port"]
    ref, _ = port_run(db, qb)
    _, s1 = port_run(db, qb, 4)
    out2, s2 = port_run(db, qb, 4)
    assert s1.segmented and s2.segmented
    assert s2.plan_cache == "hit" and s2.seg_slab == "hit"
    assert_match(ref, out2, ordered=False, label="warm")
    # another mesh width is another program and another slab
    out3, s3 = port_run(db, qb, 2)
    assert s3.plan_cache == "miss" and s3.seg_slab == "miss"
    assert_match(ref, out3, ordered=False, label="2-shard")


@pytest.mark.parametrize("replicated", [False, True])
def test_plan_cache_distinguishes_build_placement(replicated):
    """Two databases with the same table names but a dimension segmented by
    its key vs replicated: the same logical signature and exchange
    ('local'), but a per-shard build partition vs one replicated build --
    the plan cache must not hand one the other's stage program."""
    for rep in (not replicated, replicated):
        dbs = {}
        for side, (core, _) in SIDES.items():
            rng = np.random.default_rng(3)
            kw = {"device": "cpu"} if core is port_core else {}
            db = core.VerticaDB(n_nodes=4, k_safety=0, block_rows=64, **kw)
            db.create_table(core.TableSchema("f", (
                core.ColumnDef("k"), core.ColumnDef("v"))),
                sort_order=("k",), segment_by=("k",))
            db.create_table(core.TableSchema("d", (
                core.ColumnDef("dk"), core.ColumnDef("attr"))),
                sort_order=("dk",), segment_by=() if rep else ("dk",))
            t = db.begin()
            db.insert(t, "f", {"k": rng.integers(0, 50, 1000),
                               "v": rng.integers(0, 100, 1000)})
            db.insert(t, "d", {"dk": np.arange(50, dtype=np.int64),
                               "attr": np.arange(50, dtype=np.int64) % 5})
            db.commit(t)
            db.run_tuple_mover(force_moveout=True)
            dbs[side] = db
        qs = both_queries(dbs, lambda db, col: (
            db.query("f").join("d", on=("k", "dk"), cols=("attr",))
            .group_by("attr").agg(n=("*", "count"), s=("v", "sum"))))
        stats = check_all(dbs, qs, f"placement-{rep}")
        assert stats[4].segmented and stats[4].exchange == "local"


def test_fallback_outside_segmented_subset(star):
    qs = both_queries(star, lambda db, col: (
        db.query("sales").where(col("day") == 17).select("sale_id", "qty")))
    stats = check_all(star, qs, "select", ref_segmented=True)
    assert not stats[4].segmented


def test_failover_to_buddy_shards():
    """fail_node(): scans route to buddy-projection shards and every
    shard's result is unchanged."""
    dbs = make_pair(seed=11)
    queries = [
        lambda db, col: db.query("sales").where(col("day") < 180)
        .group_by("suppkey").agg(n=("*", "count"), s=("qty", "sum")),
        lambda db, col: db.query("sales")
        .join("customer", on=("custkey", "c_custkey"), cols=("c_nation",))
        .group_by("c_nation").agg(n=("*", "count")),
        lambda db, col: db.query("sales")
        .join("parts", on=("partkey", "p_partkey"), cols=("p_cat",))
        .group_by("p_cat").agg(n=("*", "count"), mx=("price", "max")),
    ]
    before = [port_run(dbs["port"], q(dbs["port"], port_engine.col))[0]
              for q in queries]
    for db in dbs.values():
        db.fail_node(1)
    for q, ref in zip(queries, before):
        qs = both_queries(dbs, q)
        plan = plan_query(dbs["port"], qs["port"].to_ir())
        assert any(owner.endswith("_b1") for _, owner in plan.sources)
        assert check_all(dbs, qs, "failover")[4].segmented
        assert_match(ref, port_run(dbs["port"], qs["port"], 4)[0],
                     ordered=False, label="failover-vs-before")


# ---------------------------------------------------------------------------
# trickle load, the WOS buffers and the ROS slab cache
# ---------------------------------------------------------------------------

def _trickle(db, rng, n=60, base=100_000):
    t = db.begin()
    db.insert(t, "sales", {
        "sale_id": base + np.arange(n, dtype=np.int64),
        "custkey": rng.integers(0, N_CUST, n),
        "suppkey": rng.integers(0, N_SUPP, n),
        "partkey": rng.integers(0, N_PART, n),
        "day": rng.integers(0, 365, n),
        "qty": rng.integers(1, 50, n),
        "delta": rng.integers(-40, 40, n),
        "price": np.round(rng.normal(100, 10, n), 2)})
    return db.commit(t)


def test_trickle_load_interleaved_oracle():
    """The corpus with trickle commits BETWEEN queries and a moveout
    mid-stream: every result matches, and some query appends a WOS delta
    to a warm ROS slab."""
    dbs = make_pair(seed=31)
    rng_t = {side: np.random.default_rng(77) for side in dbs}
    rng_q = {side: np.random.default_rng(78) for side in dbs}
    base, wos_seen = 100_000, False
    for i in range(20):
        for side, db in dbs.items():
            if i % 2 == 1:
                _trickle(db, rng_t[side], base=base)
            if i == 13:
                db.run_tuple_mover(force_moveout=True)
        if i % 2 == 1:
            base += 1000
        qs = {side: gen_query(dbs[side], SIDES[side][1].col, rng_q[side])
              for side in dbs}
        ordered = bool(qs["port"].to_ir().order_by)
        # the reference at the last step only: its trickle path was held
        # against the port's by the single-node tests
        stats = check_all(dbs, qs, f"t{i}", ordered=ordered, shards=(4,),
                          ref=i == 19)
        assert stats[4].segmented
        wos_seen |= i >= 1 and "+wos" in stats[4].seg_slab
    assert wos_seen, "no query observed a WOS delta slab"


def test_trickle_commit_keeps_ros_slab_warm_and_prewarms_wos():
    """A commit that lands in the WOS keeps the ROS slab warm (its epoch
    ceiling is unchanged); with the mesh attached the commit builds the
    per-shard WOS buffer; a moveout evicts the slab precisely."""
    db = make_db(port_core, seed=32)
    rng = np.random.default_rng(5)
    qb = (db.query("sales").where(port_engine.col("qty") > 5)
          .group_by("suppkey").agg(n=("*", "count"), s=("qty", "sum")))
    db.attach_mesh(make_query_mesh(4, device="cpu"))
    try:
        _, s1 = port_engine.execute(db, qb.to_ir())
        assert s1.seg_slab == "miss"
        _trickle(db, rng)
        wos_keys = [k for k in db.block_cache.keys() if k[2] == KIND_WOS]
        assert wos_keys, "commit did not prewarm a WOS buffer"
        out, s2 = port_engine.execute(db, qb.to_ir())
        assert s2.seg_slab == "hit+wos", s2.seg_slab
        db.detach_mesh()
        ref, _ = port_engine.execute(db, qb.to_ir())
        assert_match(ref, out, ordered=False, label="warm-ros+wos")
        db.attach_mesh(make_query_mesh(4, device="cpu"))
        db.run_tuple_mover(force_moveout=True)
        out, s3 = port_engine.execute(db, qb.to_ir())
        assert s3.seg_slab == "miss", s3.seg_slab
        db.detach_mesh()
        ref, _ = port_engine.execute(db, qb.to_ir())
        assert_match(ref, out, ordered=False, label="post-moveout")
    finally:
        db.detach_mesh()


def test_fail_load_rejoin_recover_cycle():
    """Fail a node, trickle-load, rejoin, load again, recover: the
    differential oracle holds at every stage, and both packages recover
    the same way (epochs replayed, containers adopted, rows replayed)."""
    dbs = make_pair(seed=41)
    rngs = {side: np.random.default_rng(13) for side in dbs}
    queries = [
        lambda db, col: db.query("sales").where(col("day") < 250)
        .group_by("suppkey").agg(n=("*", "count"), s=("qty", "sum")),
        lambda db, col: db.query("sales")
        .join("customer", on=("custkey", "c_custkey"), cols=("c_nation",))
        .group_by("c_nation").agg(n=("*", "count")),
        lambda db, col: db.query("sales")
        .join("parts", on=("partkey", "p_partkey"), cols=("p_cat",))
        .group_by("p_cat").agg(n=("*", "count"), s=("qty", "sum")),
    ]

    def check(label):
        for qi, q in enumerate(queries):
            stats = check_all(dbs, both_queries(dbs, q), f"{label}-{qi}",
                              shards=(4,))
            assert stats[4].segmented

    for side, db in dbs.items():
        db.fail_node(1)
        _trickle(db, rngs[side], base=200_000)
    check("down")
    joins = {}
    for side, db in dbs.items():
        db.run_tuple_mover(force_moveout=True, do_mergeout=False)
        joins[side] = db.rejoin_node(1)
        assert db.nodes[1].up and db.nodes[1].recovering
        _trickle(db, rngs[side], base=300_000)
        assert db.nodes[1].stores["sales_super"].wos.n_rows > 0
    assert joins["ref"] == joins["port"]
    check("recovering")
    replayed = {"ref": ref_recover(dbs["ref"], 1),
                "port": port_recover(dbs["port"], 1)}
    assert replayed["port"] == replayed["ref"]
    assert replayed["port"].get("sales_super", 0) > 0
    rec = dbs["port"].nodes[1].last_recovery
    assert rec == dbs["ref"].nodes[1].last_recovery
    assert rec["replay_hi"] == joins["port"]
    assert rec["adopted_containers"] > 0
    check("recovered")
    for db in dbs.values():
        db.fail_node(2)
    check("buddy-down")


def test_segmented_fault_points_fire_like_the_reference():
    """The slab-build and buddy-read injection points fire once per source
    store through ``fire_with_retries``: the same hit counts as the
    reference, and transients retry in place."""
    from repro.core import Transient as RefTransient
    from repro_torch.core import Transient as PortTransient
    dbs = make_pair(seed=12)
    transient = {"ref": RefTransient, "port": PortTransient}
    for db in dbs.values():
        db.fail_node(1)
    qs = both_queries(dbs, lambda db, col: (
        db.query("sales").group_by("suppkey").agg(n=("*", "count"))))
    hits, outs = {}, {}
    for side, db in dbs.items():
        inj = db.enable_faults(seed=3)
        inj.on("segmented.slab_build", transient[side](), times=2)
        try:
            if side == "ref":
                outs[side], stats = ref_seg(db, qs[side])
            else:
                outs[side], stats = port_run(db, qs[side], 4)
            assert stats.fault_retries >= 2 and stats.failovers == 0
            hits[side] = (inj.hit_count("segmented.slab_build"),
                          inj.hit_count("segmented.buddy_read"),
                          inj.fired("segmented.slab_build"))
        finally:
            db.disable_faults()
    assert hits["port"] == hits["ref"]
    assert hits["port"][1] > 0                  # node 1's buddy was read
    assert_match(outs["ref"], outs["port"], ordered=False, label="faults")


# ---------------------------------------------------------------------------
# empty snapshots and slab pruning
# ---------------------------------------------------------------------------

def test_segmented_all_rows_deleted():
    dbs = make_pair(seed=51)
    for db in dbs.values():
        t = db.begin()
        db.delete(t, "sales", lambda r: r["sale_id"] >= 0)
        db.commit(t)
    qs = both_queries(dbs, lambda db, col: (
        db.query("sales").where(col("qty") > 0)
        .group_by("suppkey").agg(n=("*", "count"), s=("qty", "sum"))))
    check_all(dbs, qs, "all-deleted")
    assert len(port_run(dbs["port"], qs["port"], 4)[0]["n"]) == 0


def test_segmented_wos_only_snapshot():
    dbs = make_pair(seed=52)
    for db in dbs.values():
        rng = np.random.default_rng(9)
        t = db.begin()
        db.delete(t, "sales", lambda r: r["sale_id"] >= 0)
        db.commit(t)
        _trickle(db, rng, n=120)                # WOS-only visible rows
    qs = both_queries(dbs, lambda db, col: (
        db.query("sales").group_by("suppkey")
        .agg(n=("*", "count"), s=("qty", "sum"), a=("price", "avg"))))
    stats = check_all(dbs, qs, "wos-only")[4]
    assert stats.segmented and "+wos" in stats.seg_slab, stats.seg_slab


def test_segmented_pruned_to_empty():
    dbs = make_pair(seed=53)
    qs = both_queries(dbs, lambda db, col: (
        db.query("sales").where(col("day") >= 100_000)
        .group_by("suppkey").agg(n=("*", "count"))))
    stats = check_all(dbs, qs, "pruned-empty")[4]
    assert stats.segmented and stats.blocks_total > 0
    assert stats.blocks_pruned == stats.blocks_total


def test_segmented_pruning_differential(star):
    qs = both_queries(star, lambda db, col: (
        db.query("sales").where((col("day") >= 40) & (col("day") < 80))
        .group_by("suppkey").agg(n=("*", "count"), s=("qty", "sum"))))
    stats = check_all(star, qs, "pruned-range")[4]
    assert stats.segmented and stats.blocks_total > 0
    assert 0 < stats.blocks_pruned < stats.blocks_total


def test_rle_route_on_the_sort_leader(monkeypatch):
    """A count-only GROUP BY on an RLE sort leader aggregates the encoded
    runs on the segmented path too (the rle_grouped_agg route), with no
    slab and no exchange."""
    dbs = {}
    for side, (core, _) in SIDES.items():
        rng = np.random.default_rng(21)
        kw = {"device": "cpu"} if core is port_core else {}
        db = core.VerticaDB(n_nodes=4, k_safety=1, block_rows=64, **kw)
        schema = core.TableSchema("ev", (core.ColumnDef("eid"),
                                         core.ColumnDef("day"),
                                         core.ColumnDef("qty")))
        db.catalog.add_table(schema)
        db.create_projection(core.super_projection(
            schema, ("day",), ("eid",),
            encodings={"day": core.Encoding.RLE}))
        t = db.begin(direct_to_ros=True)
        db.insert(t, "ev", {"eid": np.arange(3000, dtype=np.int64),
                            "day": np.sort(rng.integers(0, 50, 3000)),
                            "qty": rng.integers(1, 9, 3000)})
        db.commit(t)
        dbs[side] = db
    qs = both_queries(dbs, lambda db, col: (
        db.query("ev").group_by("day").agg(n=("*", "count"))))
    calls = []
    real = segmented.kops.rle_grouped_agg_many

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(segmented.kops, "rle_grouped_agg_many", counted)
    stats = check_all(dbs, qs, "rle")[4]
    assert stats.segmented and stats.groupby_algorithm == "rle (segmented)"
    assert stats.seg_slab == "" and calls


# ---------------------------------------------------------------------------
# the pre-aggregation: one seg_preagg call over every shard
# ---------------------------------------------------------------------------

def _count_preagg(monkeypatch):
    calls = []
    real = segmented.kops.seg_preagg

    def counted(keys, valid, values, domain, aggs):
        calls.append((int(keys.shape[0]), int(domain)))
        return real(keys, valid, values, domain, aggs)

    monkeypatch.setattr(segmented.kops, "seg_preagg", counted)
    return calls


@pytest.mark.parametrize("one_call", [True, False])
def test_preagg_calls_over_the_shard_dimension(star, monkeypatch,
                                               one_call):
    """Keys ``shard * domain + key`` over ``n_shards * domain``: one call
    for every shard, or one per shard past the int32 key lane."""
    db = star["port"]
    qb = (db.query("sales").group_by("suppkey")
          .agg(n=("*", "count"), s=("qty", "sum"), mn=("price", "min")))
    ref, _ = port_run(db, qb)
    if not one_call:
        monkeypatch.setattr(segmented, "_PACK_LIMIT", 4 * N_SUPP)
    calls = _count_preagg(monkeypatch)
    out, stats = port_run(db, qb, 4)
    assert stats.segmented and stats.groupby_algorithm == "dense (segmented)"
    if one_call:
        assert [d for _, d in calls] == [4 * N_SUPP]
    else:
        assert [d for _, d in calls] == [N_SUPP] * 4
    assert_match(ref, out, ordered=False, label=f"preagg-{one_call}")


# ---------------------------------------------------------------------------
# the mesh, the exchange and the hash twins
# ---------------------------------------------------------------------------

def test_query_mesh():
    mesh = make_query_mesh(device="cpu")
    assert mesh.n_shards == 1 and mesh.shape == {"data": 1}
    m4 = make_query_mesh(4, axis="data", device="cpu")
    assert mesh_axis_size(m4, "data") == 4 and mesh_axis_size(m4, "pod") == 1
    assert dp_size(m4) == 4 and tp_size(m4) == 1
    assert m4.signature("data") == make_query_mesh(
        4, device="cpu").signature("data")
    assert m4.signature("data") != mesh.signature("data")
    with pytest.raises(ValueError):
        make_query_mesh(0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_query_mesh(4)                    # the default device


def _resegment_model(dest, vals, per, n_shards):
    """numpy model of the reference's resegment_local over every source:
    a row's slot is its rank among its source's rows bound for the same
    destination; rows at or past ``per`` are dropped and counted."""
    n_src, n_local = dest.shape
    out = [np.zeros((n_shards, n_src * per), v.dtype) for v in vals]
    valid = np.zeros((n_shards, n_src * per), bool)
    overflow = np.zeros(n_shards, np.int64)
    for s in range(n_src):
        seen = np.zeros(n_shards, np.int64)
        for i in range(n_local):
            d = dest[s, i]
            pos = seen[d]
            seen[d] += 1
            if pos >= per:
                overflow[d] += 1
                continue
            valid[d, s * per + pos] = True
            for o, v in zip(out, vals):
                o[d, s * per + pos] = v[s, i]
    return out, valid, overflow


@settings(max_examples=30, deadline=None)
@given(st.integers(1, 5), st.integers(0, 40), st.integers(1, 12),
       st.integers(0, 2 ** 31 - 1))
def test_resegment_matches_numpy_model(n_shards, n_local, per, seed):
    rng = np.random.default_rng(seed)
    dest = rng.integers(0, n_shards, (n_shards, n_local)).astype(np.int32)
    keys = rng.integers(-2 ** 31, 2 ** 31, (n_shards, n_local),
                        dtype=np.int64).astype(np.int32)
    price = rng.normal(size=(n_shards, n_local)).astype(np.float32)
    mesh = make_query_mesh(n_shards, device="cpu")
    out, valid, overflow = exchange.resegment(
        mesh, "data", {"k": torch.from_numpy(keys),
                       "p": torch.from_numpy(price)},
        torch.from_numpy(dest), per * n_shards)
    (mk, mp), mvalid, mover = _resegment_model(dest, (keys, price), per,
                                               n_shards)
    np.testing.assert_array_equal(valid.numpy(), mvalid)
    np.testing.assert_array_equal(out["k"].numpy(), mk)
    np.testing.assert_array_equal(out["p"].numpy(), mp)
    np.testing.assert_array_equal(overflow.numpy(), mover)


@pytest.mark.parametrize("n_shards", [1, 4])
def test_resegment_overflow_is_reported(n_shards):
    """tests/test_segmented_exec.py's overflow check at n logical shards:
    every row wants shard 0 and only half the slots exist."""
    n = 64 * n_shards
    keys = np.arange(n, dtype=np.int32)
    mesh = make_query_mesh(n_shards, device="cpu")
    cols = {"k": torch.from_numpy(keys).reshape(n_shards, -1)}
    dest = torch.zeros((n_shards, n // n_shards), dtype=torch.int32)
    capacity = (n // 2 // n_shards) * n_shards
    out, valid, overflow = exchange.resegment(mesh, "data", cols, dest,
                                              capacity)
    per = capacity // n_shards
    dropped = (n // n_shards - per) * n_shards
    ov = overflow.numpy()
    assert ov.shape == (n_shards,)
    assert int(ov[0]) == dropped and int(ov.sum()) == dropped
    assert out["k"][valid].numel() == n - dropped
    out2, valid2, overflow2 = exchange.resegment(mesh, "data", cols, dest,
                                                 n * n_shards)
    assert int(overflow2.sum()) == 0
    assert sorted(out2["k"][valid2].tolist()) == keys.tolist()


def test_broadcast_build_side_is_the_concatenation():
    mesh = make_query_mesh(3, device="cpu")
    v = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    got = exchange.broadcast_build_side(mesh, "data", {"v": v})
    assert torch.equal(got["v"], torch.arange(12, dtype=torch.int32))


_I32 = st.integers(-2 ** 31, 2 ** 31 - 1)
_EDGES = st.sampled_from([-2 ** 31, -2 ** 31 + 1, -65537, -65536, -1, 0, 1,
                          65535, 65536, 2 ** 31 - 1])


@settings(max_examples=60, deadline=None)
@given(st.lists(st.one_of(_I32, _EDGES), min_size=1, max_size=40),
       st.integers(1, 3), st.integers(0, 2), st.integers(0, 2 ** 31 - 1))
def test_hash_twins_bit_for_bit(ints, n_cols, n_bool, seed):
    """hash_columns_torch / shard_of_torch against numpy's hash_columns /
    shard_of and the reference's jax twins: int32 extremes, negatives
    (sign-extended words), bool columns, 1-3 columns hashed together."""
    rng = np.random.default_rng(seed)
    a = np.asarray(ints, np.int32)
    cols = [a] + [rng.permutation(a) for _ in range(n_cols - 1)]
    for i in range(min(n_bool, n_cols)):
        cols[n_cols - 1 - i] = rng.integers(0, 2, a.size).astype(bool)
    want = hash_columns(*cols).astype(np.int64)
    got = hash_columns_torch(*[torch.from_numpy(c) for c in cols]).numpy()
    np.testing.assert_array_equal(got, want)
    jx = np.asarray(hash_columns_jnp(*[jnp.asarray(c) for c in cols]))
    np.testing.assert_array_equal(jx.astype(np.int64), want)
    for n in (1, 2, 3, 4, 7, 8, 64, 1000):
        s = shard_of(want, n)
        np.testing.assert_array_equal(
            shard_of_torch(torch.from_numpy(want), n).numpy(), s)
        np.testing.assert_array_equal(
            np.asarray(shard_of_jnp(jnp.asarray(jx), n)), s)


def test_hash_twins_on_int64_and_uint8_columns():
    """Wider and unsigned columns hash as numpy's astype(np.int64) does."""
    rng = np.random.default_rng(0)
    wide = rng.integers(-2 ** 62, 2 ** 62, 1000)
    small = rng.integers(0, 256, 1000).astype(np.uint8)
    want = hash_columns(wide, small).astype(np.int64)
    got = hash_columns_torch(torch.from_numpy(wide),
                             torch.from_numpy(small)).numpy()
    np.testing.assert_array_equal(got, want)


def test_snapshot_scans_match_the_reference():
    """wos_scan_host / snapshot_scan_host / snapshot_scan_device: the same
    rows, visibility and ring values as the reference's."""
    from repro.engine.pipeline import ExecStats as RefStats
    from repro_torch.engine.pipeline import ExecStats as PortStats
    dbs = make_pair(seed=61)
    for db in dbs.values():
        _trickle(db, np.random.default_rng(3), n=90)
    need = ["custkey", "qty", "price"]
    got = {}
    for side, mod, stats, planner in (
            ("ref", ref_exec, RefStats(), ref_plan_query),
            ("port", port_exec, PortStats(), plan_query)):
        db = dbs[side]
        plan = planner(db, db.query("sales").agg(n=("*", "count")).to_ir())
        as_of = db.epochs.latest_queryable()
        got[side] = (mod.wos_scan_host(db, plan, need, as_of),
                     mod.snapshot_scan_host(db, plan, need, as_of, stats),
                     mod.snapshot_scan_host(db, plan, need, as_of, stats,
                                            include_wos=False),
                     mod.snapshot_scan_device(db, plan, need, as_of, stats))
    (rw, rh, rr, rd), (pw, ph, pr, pd) = got["ref"], got["port"]
    for c in need:
        np.testing.assert_array_equal(pw[0][c], rw[0][c])
    np.testing.assert_array_equal(pw[1], rw[1])
    np.testing.assert_array_equal(pw[2], rw[2])
    for (pc, pv), (rc, rv) in ((ph, rh), (pr, rr)):
        np.testing.assert_array_equal(pv, rv)
        for c in need:
            np.testing.assert_allclose(pc[c][pv], rc[c][rv], rtol=1e-6)
    np.testing.assert_array_equal(pd[1], rd[1])
    for c in need:
        np.testing.assert_allclose(pd[0][c].numpy()[pd[1]],
                                   np.asarray(rd[0][c])[rd[1]], rtol=1e-6)
