"""The port's recovery (core/recovery.py), Database Designer
(planner/designer.py) and legacy ``Query``/``JoinSpec`` shims against the
reference's.

Every scenario runs the same DML, failures and recovery steps on a
reference ``repro.core.VerticaDB`` and a port one on the CPU holding the
same rows -- the ``sales_db`` layout of tests/conftest.py (2,000 rows,
4 nodes, K=1, partitioned by date) -- and records what each step shows:
the visible rows as sorted tuples, aggregate query results, and any typed
error with its node, segments and projections.  The two records must be
equal (ints and counts exactly, float aggregates within rtol 1e-5, the
summation order).  The scenarios are those of tests/test_mvcc_recovery.py,
the recovery-path faults of tests/test_faults.py, and the crash-replay
property of tests/test_crash_replay_props.py.
"""
import dataclasses
import warnings

import numpy as np
import pytest
from hypothesis import given, settings
import hypothesis.strategies as st

import repro.core as ref_core
import repro.core.recovery as ref_recovery
import repro.engine as ref_engine
import repro.planner as ref_planner
import repro_torch.core as port_core
import repro_torch.core.recovery as port_recovery
import repro_torch.engine as port_engine
import repro_torch.planner as port_planner
from repro_torch.core.block_cache import KIND_SEG
from repro_torch.distributed import make_query_mesh

SIDES = {"ref": (ref_core, ref_recovery, ref_engine, ref_planner),
         "port": (port_core, port_recovery, port_engine, port_planner)}


def _kw(core):
    return {"device": "cpu"} if core is port_core else {}


def _sales_db(core, partitioned=True):
    """tests/conftest.py::sales_db on either package."""
    rng = np.random.default_rng(7)
    db = core.VerticaDB(n_nodes=4, k_safety=1, block_rows=64, **_kw(core))
    db.create_table(
        core.TableSchema("sales", (
            core.ColumnDef("sale_id"), core.ColumnDef("cid"),
            core.ColumnDef("date"),
            core.ColumnDef("price", core.SQLType.FLOAT))),
        sort_order=("date",), segment_by=("sale_id",),
        partition_by=("date", "div_1000") if partitioned else None)
    n = 2000
    t = db.begin()
    db.insert(t, "sales", {
        "sale_id": np.arange(n, dtype=np.int64),
        "cid": rng.integers(0, 20, n),
        "date": rng.integers(0, 3000, n),
        "price": np.round(rng.normal(100, 10, n), 2)})
    db.commit(t)
    db.run_tuple_mover(force_moveout=True)
    return db


def _tuples(rows):
    cols = sorted(rows)
    return sorted(zip(*[np.asarray(rows[c]).tolist() for c in cols]))


def _queries(db, col):
    s = db.query("sales")
    return [
        s.group_by("cid").agg(n=("*", "count"), p=("price", "sum"),
                              lo=("date", "min"), hi=("date", "max")),
        s.where(col("date") < 1500).agg(n=("*", "count"),
                                        a=("price", "avg")),
        s.where(col("cid") < 10).group_by("cid", "date")
        .agg(n=("*", "count")).order_by("-n", "cid", "date").limit(7),
    ]


class Record:
    """What one side's scenario showed, step by step."""

    def __init__(self, db, core, recovery, engine):
        self.db, self.core, self.rec, self.engine = db, core, recovery, engine
        self.steps = []

    def rows(self, label):
        self.steps.append((label, "rows", self._try(
            lambda: _tuples(self.db.read_table("sales")))))

    def queries(self, label):
        def run():
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                return [q.collect() for q in
                        _queries(self.db, self.engine.col)]
        self.steps.append((label, "queries", self._try(run)))

    def call(self, label, fn):
        self.steps.append((label, "call", self._try(fn)))

    @staticmethod
    def _try(fn):
        try:
            return ("ok", fn())
        except Exception as e:                    # a typed refusal
            return ("error", type(e).__name__,
                    getattr(e, "node", None),
                    sorted(getattr(e, "segments", None) or []),
                    sorted(getattr(e, "projections", None) or []))


def _same(a, b, label):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), label
        for k in a:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.shape == y.shape, (label, k)
            if x.dtype.kind in "iub":
                np.testing.assert_array_equal(y, x, err_msg=f"{label} {k}")
            else:
                np.testing.assert_allclose(y, x, rtol=1e-5,
                                           err_msg=f"{label} {k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), label
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{label}[{i}]")
    else:
        assert a == b, (label, a, b)


def run_both(scenario, make=_sales_db):
    recs = {}
    for side, (core, recovery, engine, _) in SIDES.items():
        db = make(core)
        recs[side] = Record(db, core, recovery, engine)
        scenario(recs[side])
    ref, port = recs["ref"].steps, recs["port"].steps
    assert [s[:2] for s in port] == [s[:2] for s in ref]
    for (label, kind, want), (_, _, got) in zip(ref, port):
        _same(want, got, f"{label}/{kind}")
    return recs


# ---------------------------------------------------------------------------
# the scenarios of tests/test_mvcc_recovery.py and tests/test_faults.py
# ---------------------------------------------------------------------------

def _insert(r, lo, hi, cid, date):
    n = hi - lo
    t = r.db.begin()
    r.db.insert(t, "sales", {"sale_id": np.arange(lo, hi),
                             "cid": np.full(n, cid, np.int64),
                             "date": np.full(n, date, np.int64),
                             "price": np.ones(n)})
    return r.db.commit(t)


def ksafety_read_through_buddy(r):
    r.rows("before")
    r.db.fail_node(2)
    r.rows("node 2 down")
    r.queries("node 2 down")


def two_failures_lose_segment(r):
    r.rows("before")
    r.db.fail_node(2)
    r.db.fail_node(3)                 # node 3 hosted node 2's buddy rows
    r.rows("two down")
    r.queries("two down")


def recovery_replays_missed_commits(r):
    r.db.fail_node(1)
    _insert(r, 9200, 9400, 11, 42)
    t = r.db.begin()
    r.db.delete(t, "sales", lambda row: row["cid"] == 7)
    r.db.commit(t)
    r.rows("down")
    r.call("recover", lambda: r.rec.recover_node(r.db, 1))
    r.call("last_recovery", lambda: r.db.nodes[1].last_recovery)
    r.rows("recovered")
    r.db.fail_node(2)                 # node 1 serves its own segment
    r.rows("buddy host down")
    r.queries("buddy host down")


def recovery_waits_for_buddy_source(r):
    r.db.fail_node(1)
    _insert(r, 9800, 9900, 13, 99)
    r.db.run_tuple_mover(force_moveout=True)
    r.rows("down")
    r.db.fail_node(2)                 # hosts node 1's buddy segments
    r.call("recover 1 without its source",
           lambda: r.rec.recover_node(r.db, 1))
    r.call("state", lambda: (r.db.nodes[1].up, r.db.nodes[1].recovering,
                             r.db.nodes[1].last_recovery["complete"]))
    r.rows("segment 1 has no serving copy")
    r.call("recover 2", lambda: r.rec.recover_node(r.db, 2))
    r.call("recover 1", lambda: r.rec.recover_node(r.db, 1))
    r.rows("recovered")
    r.db.fail_node(2)
    r.rows("node 1 serves its own segment")


def rebalance_preserves_data(r):
    r.call("rebalance 6", lambda: r.rec.rebalance(r.db, 6))
    r.rows("6 nodes")
    r.call("rebalance 3", lambda: r.rec.rebalance(r.db, 3))
    r.rows("3 nodes")
    r.queries("3 nodes")


def backup_restore(r):
    img = r.rec.backup(r.db)
    t = r.db.begin()
    r.db.delete(t, "sales", lambda row: row["cid"] >= 0)
    r.db.commit(t)
    r.rows("all deleted")
    r.rec.restore(r.db, img)
    r.rows("restored")
    r.queries("restored")


def lge_capped_by_wos_residue(r):
    _insert(r, 9500, 9700, 17, 7)
    r.db.run_tuple_mover()            # WOS below limit: LGE must not jump
    r.rows("in the WOS")
    r.db.fail_node(1)                 # loses node 1's WOS share
    r.call("recover", lambda: r.rec.recover_node(r.db, 1))
    r.rows("recovered")
    r.db.fail_node(0)
    r.rows("node 1 serves its segment")


def double_buddy_failure_is_typed(r):
    r.db.fail_node(1)
    r.db.fail_node(2)                 # node 2 hosted segment 1's buddy
    r.rows("both down")
    r.call("recover 2", lambda: r.rec.recover_node(r.db, 2))
    r.call("recover 1", lambda: r.rec.recover_node(r.db, 1))
    r.rows("recovered")
    r.db.fail_node(0)
    r.rows("node 0 down")


def replay_source_crash_is_typed(r):
    r.db.fail_node(1)
    _insert(r, 9900, 9950, 17, 77)
    r.db.run_tuple_mover(force_moveout=True)
    inj = r.db.enable_faults(seed=9)
    # the replay source (node 2 holds seg 1's buddy) dies mid-replay
    inj.on("recovery.buddy_read", r.core.CrashNode(), node=2, hit=1)
    r.call("recover 1", lambda: r.rec.recover_node(r.db, 1))
    r.call("fault hits", lambda: (inj.hit_count("recovery.buddy_read"),
                                  inj.hit_count("recovery.replay")))
    r.db.disable_faults()
    r.call("state", lambda: r.db.nodes[1].recovering)
    r.call("recover 2", lambda: r.rec.recover_node(r.db, 2))
    r.call("recover 1", lambda: r.rec.recover_node(r.db, 1))
    r.rows("recovered")


def rejoin_then_recover(r):
    r.db.fail_node(3)
    _insert(r, 9000, 9040, 3, 500)
    r.call("rejoin", lambda: r.db.rejoin_node(3))
    _insert(r, 9040, 9080, 4, 600)    # lands on node 3 live
    r.call("state", lambda: (r.db.nodes[3].up, r.db.nodes[3].recovering,
                             r.db.nodes[3].stores["sales_super"]
                             .wos.n_rows))
    r.rows("recovering")
    r.call("recover", lambda: r.rec.recover_node(r.db, 3))
    r.call("last_recovery", lambda: r.db.nodes[3].last_recovery)
    r.rows("recovered")
    r.queries("recovered")


SCENARIOS = [ksafety_read_through_buddy, two_failures_lose_segment,
             recovery_replays_missed_commits, recovery_waits_for_buddy_source,
             rebalance_preserves_data, backup_restore,
             lge_capped_by_wos_residue, double_buddy_failure_is_typed,
             replay_source_crash_is_typed, rejoin_then_recover]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_recovery_scenario(scenario):
    recs = run_both(scenario)
    # the port's step record is not vacuous: it read rows at some step
    assert any(kind == "rows" and res[0] == "ok"
               for _, kind, res in recs["port"].steps)


def test_replicated_routing_raises_when_no_serving_replica():
    def make(core):
        db = core.VerticaDB(n_nodes=2, k_safety=1, block_rows=32,
                            **_kw(core))
        db.create_table(core.TableSchema("dim", (
            core.ColumnDef("k"), core.ColumnDef("a"))),
            sort_order=("k",), segment_by=())            # replicated
        t = db.begin()
        db.insert(t, "dim", {"k": np.arange(10), "a": np.arange(10) % 3})
        db.commit(t)
        return db

    for side, (core, _, _, planner) in SIDES.items():
        db = make(core)
        db.fail_node(0)
        db.rejoin_node(0)                 # up but recovering: not serving
        db.fail_node(1)
        q = db.query("dim").group_by("a").agg(n=("*", "count")).to_ir()
        with pytest.raises(core.AvailabilityError):
            planner.plan_query(db, q)
        with pytest.raises(core.AvailabilityError):
            db.read_table("dim")


def test_fail_node_evicts_stale_seg_slabs():
    """fail_node evicts exactly the segmented slabs built over the dead
    node's stores; the rebuilt slab (buddy routing) answers correctly."""
    db = _sales_db(port_core)
    db.attach_mesh(make_query_mesh(4, device="cpu"))
    try:
        qb = db.query("sales").group_by("cid").agg(n=("*", "count"))
        port_engine.execute(db, qb.to_ir())      # warm a KIND_SEG slab

        def seg_keys_touching(node):
            return [key for key in db.block_cache.keys()
                    if key[2] == KIND_SEG and any(
                        host == node for host, _o, _ids in key[1][2][0])]

        assert seg_keys_touching(1), "warm slab should reference node 1"
        db.fail_node(1)
        assert not seg_keys_touching(1)
        out, stats = port_engine.execute(db, qb.to_ir())
        assert stats.segmented and stats.seg_slab == "miss"
        assert int(np.asarray(out["n"]).sum()) == 2000
    finally:
        db.detach_mesh()


# ---------------------------------------------------------------------------
# the crash-replay property (tests/test_crash_replay_props.py)
# ---------------------------------------------------------------------------

N_KEYS = 24


def _events_db(core):
    db = core.VerticaDB(n_nodes=4, k_safety=1, block_rows=32, **_kw(core))
    db.create_table(core.TableSchema("events", (
        core.ColumnDef("eid"), core.ColumnDef("key"),
        core.ColumnDef("bucket"), core.ColumnDef("val"))),
        sort_order=("bucket",), segment_by=("eid",))
    return db


def _commit_batch(db, seed, base):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 40))
    t = db.begin()
    db.insert(t, "events", {
        "eid": base + np.arange(n, dtype=np.int64),
        "key": rng.integers(0, N_KEYS, n),
        "bucket": rng.integers(0, 50, n),
        "val": rng.integers(-100, 100, n)})
    db.commit(t)


def _apply(db, op, base):
    kind = op[0]
    if kind == "commit":
        _commit_batch(db, op[1], base)
    elif kind == "delete":
        t = db.begin()
        k = op[1] % N_KEYS
        db.delete(t, "events", lambda r: r["key"] == k)
        db.commit(t)
    elif kind == "moveout":
        db.run_tuple_mover(force_moveout=True)
    elif kind == "mover":
        db.run_tuple_mover()


def _agg(db, col):
    out = (db.query("events").where(col("bucket") < 40).group_by("key")
           .agg(n=("*", "count"), s=("val", "sum"))).collect()
    order = np.argsort(np.asarray(out["key"]))
    return [(int(out["key"][i]), int(out["n"][i]), int(out["s"][i]))
            for i in order]


_OP = st.tuples(st.sampled_from(["commit", "commit", "delete", "moveout",
                                 "mover"]),
                st.integers(0, 2 ** 20))


@settings(max_examples=8, deadline=None)
@given(st.lists(_OP, min_size=3, max_size=10), st.integers(0, 3),
       st.integers(0, 2 ** 10), st.integers(0, 2 ** 10),
       st.integers(0, 2 ** 10))
def test_crash_replay_equals_never_failed(ops, node, p_fail, p_rejoin,
                                          p_recover):
    """The port's crashy cluster (fail, commits, rejoin, commits, recover
    at drawn points) ends with the rows and integer aggregates of the
    reference cluster that never failed -- and recovers as the reference's
    crashy cluster does."""
    ref_never = _events_db(ref_core)
    crashy = {side: _events_db(SIDES[side][0]) for side in SIDES}
    dbs = [ref_never] + list(crashy.values())
    base = 0
    for db in dbs:
        _commit_batch(db, 7, base)
        db.run_tuple_mover(force_moveout=True)
    base += 10 ** 6
    n_ops = len(ops)
    fail_at = p_fail % n_ops
    rejoin_at = fail_at + 1 + (p_rejoin % max(n_ops - fail_at, 1))
    recover_at = rejoin_at + (p_recover % max(n_ops - rejoin_at + 1, 1))
    for i, op in enumerate(ops):
        for side, db in crashy.items():
            rec = SIDES[side][1]
            if i == fail_at:
                db.fail_node(node)
            if i == rejoin_at:
                rec.rejoin_node(db, node)
            if i == recover_at:
                rec.recover_node(db, node)
        for db in dbs:
            _apply(db, op, base)
        base += 10 ** 6
    for side, db in crashy.items():
        if not db.nodes[node].serving():
            SIDES[side][1].recover_node(db, node)
    want = _tuples(ref_never.read_table("events"))
    assert _tuples(crashy["port"].read_table("events")) == want
    assert crashy["port"].nodes[node].last_recovery == \
        crashy["ref"].nodes[node].last_recovery
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert _agg(crashy["port"], port_engine.col) == \
            _agg(ref_never, ref_engine.col)
    buddy_host = (node + 1) % 4
    ref_never.fail_node(buddy_host)
    crashy["port"].fail_node(buddy_host)
    assert _tuples(crashy["port"].read_table("events")) == \
        _tuples(ref_never.read_table("events"))


# ---------------------------------------------------------------------------
# the Database Designer and create_projection(populate=True)
# ---------------------------------------------------------------------------

def _workload(db, col):
    s = db.query("sales")
    return [s.where(col("cid") < 5).group_by("cid")
            .agg(n=("*", "count"), p=("price", "sum")),
            s.group_by("cid").agg(n=("*", "count")),
            s.where(col("date") < 800).agg(n=("*", "count"))]


def _proj_dict(p):
    return dataclasses.asdict(p)


def _projection_rows(db, name):
    return _tuples(db.read_projection(name))


@pytest.mark.parametrize("deploy", [False, True])
def test_design_matches_the_reference(deploy):
    """``design`` proposes, scores, keeps and reports the same physical
    design on both packages (its candidates are created with
    ``populate=True``); a deployed design answers the workload alike.
    The table is not partitioned: a candidate leaves out columns the
    workload does not read, and both packages' tuple movers need the
    partition column in every projection."""
    reports, dbs = {}, {}
    for side, (core, _, engine, planner) in SIDES.items():
        db = _sales_db(core, partitioned=False)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            reports[side] = planner.design(db, _workload(db, engine.col),
                                           deploy=deploy)
        dbs[side] = db
    ref, port = reports["ref"], reports["port"]
    assert [_proj_dict(p) for p in port.proposed] == \
        [_proj_dict(p) for p in ref.proposed]
    assert port.encoding_choices == ref.encoding_choices
    assert port.sort_choices == ref.sort_choices
    assert [d for d, _, _ in port.per_query] == \
        [d for d, _, _ in ref.per_query]
    np.testing.assert_allclose([(b, a) for _, b, a in port.per_query],
                               [(b, a) for _, b, a in ref.per_query])
    assert sorted(dbs["port"].catalog.projections) == \
        sorted(dbs["ref"].catalog.projections)
    if deploy:
        assert port.proposed, "the balanced policy keeps a projection"
        name = port.proposed[0].name
        assert _projection_rows(dbs["port"], name) == \
            _projection_rows(dbs["ref"], name)
        qs = {side: _workload(dbs[side], SIDES[side][2].col)
              for side in SIDES}
        routed = 0
        for qr, qp in zip(qs["ref"], qs["port"]):
            plan = port_planner.plan_query(dbs["port"], qp.to_ir())
            routed += plan.projection == name
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                _same(qr.collect(), qp.collect(), "designed")
        assert routed >= 1


def test_create_projection_populate_copies_the_rows():
    """A projection created with ``populate=True`` (and its buddy) holds
    every visible row, on both packages alike, and serves queries."""
    recs = {}
    for side, (core, _, engine, planner) in SIDES.items():
        db = _sales_db(core)
        t = db.begin()
        db.delete(t, "sales", lambda r: r["cid"] == 4)
        db.commit(t)
        proj = core.ProjectionDef(
            name="sales_by_cid", anchor="sales",
            columns=("cid", "date", "price", "sale_id"),
            sort_order=("cid", "date"),
            segmentation=core.SegmentationSpec("hash", ("cid",)))
        db.create_projection(proj, populate=True)
        qb = (db.query("sales").where(engine.col("cid") < 6)
              .group_by("cid").agg(n=("*", "count"), p=("price", "sum")))
        plan = planner.plan_query(db, qb.to_ir())
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            recs[side] = (_projection_rows(db, "sales_by_cid"),
                          _projection_rows(db, "sales_by_cid_b1"),
                          _tuples(db.read_table("sales")),
                          plan.projection, qb.collect())
    ref, port = recs["ref"], recs["port"]
    assert port[0] == ref[0] and port[1] == ref[1]
    assert sorted(port[0]) == sorted(port[2])      # every visible row
    assert port[3] == ref[3] == "sales_by_cid"
    _same(ref[4], port[4], "populated")


# ---------------------------------------------------------------------------
# the legacy Query / JoinSpec shims
# ---------------------------------------------------------------------------

def test_query_and_joinspec_shims_through_execute():
    from test_torch_segmented import make_pair
    dbs = make_pair(seed=71)
    outs = {}
    for side, (_, _, engine, _) in SIDES.items():
        q = engine.Query(
            table="sales", predicate=engine.col("day") < 200,
            join=engine.JoinSpec("customer", "custkey", "c_custkey",
                                 ("c_nation",)),
            group_by="c_nation",
            aggs=(("n", "*", "count"), ("s", "qty", "sum"),
                  ("a", "price", "avg")),
            order_by="n", descending=True, limit=5)
        assert engine.JoinSpec is engine.LogicalJoin
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            outs[side] = engine.execute(dbs[side], q)[0]
            plain = engine.execute(dbs[side], engine.Query(
                table="sales", columns=("sale_id", "qty"),
                predicate=engine.col("qty") > 47))[0]
        outs[side + "-select"] = {c: np.sort(v) for c, v in plain.items()}
    _same(outs["ref"], outs["port"], "shim")
    _same(outs["ref-select"], outs["port-select"], "shim-select")
    assert len(outs["port"]["n"]) == 5
    # the shim lowers to the IR and runs segmented on a mesh too
    q = port_engine.Query(table="sales", group_by="suppkey",
                          aggs=(("n", "*", "count"),))
    seg, stats = port_engine.execute(
        dbs["port"], q, mesh=make_query_mesh(4, device="cpu"))
    single, _ = port_engine.execute(dbs["port"], q)
    assert stats.segmented and stats.n_shards == 4
    _same(single, seg, "shim-segmented")
