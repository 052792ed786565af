"""The port's single-node aggregate query path, end to end, against the
reference.

The same rows go into a reference ``repro.core.VerticaDB`` and a port
``repro_torch.core.VerticaDB(device="cpu")`` -- ``star_schema`` at 40,000
lineitem / 2,000 orders rows in the layout of
``benchmarks/cstore_queries.py`` (RLE l_shipdate sort leader), 4 nodes,
``block_rows=512``, K-safety 0 and 1 -- and the same DML and maintenance
then runs on both.  At each step the same queries run on both sides:
Q1-Q7, a composite-key GROUP BY with HAVING / ORDER BY / LIMIT, and a
derived-column aggregate.  Steps: the bulk load; pending WOS rows (the
general path); after a delete; after the tuple mover; with a node failed
(its buddy serves it at K=1, both refuse at K=0); and a port database
rebuilt by ``database_from_state(state_of(reference_db))``.

Ints and counts must be equal exactly, float sums within rtol 1e-5
(summation order); the ExecStats routes (``groupby_algorithm``,
``fused``) must agree; no query may leave an epoch pinned.
"""
import warnings

import numpy as np
import pytest

import repro.core as ref_core
import repro.engine as ref_engine
import repro_torch.core as port_core
import repro_torch.engine as port_engine
from repro.data.synth import star_schema
from repro_torch.planner import plan_query

N_FACT, N_DIM = 40_000, 2_000


def _load(core, k, **kw):
    fact, dim = star_schema(N_FACT, N_DIM, seed=0)
    db = core.VerticaDB(n_nodes=4, k_safety=k, block_rows=512, **kw)
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
    return db


def _queries(db, col):
    li = db.query("lineitem")
    by_cust = ("l_orderkey", "o_orderkey")
    return {
        "Q1": li.where(col("l_shipdate") == 180).agg(c=("*", "count")),
        "Q2": li.where(col("l_shipdate") == 180)
                .group_by("l_suppkey").agg(c=("*", "count")),
        "Q3": li.where((col("l_shipdate") > 60) & (col("l_shipdate") < 120))
                .group_by("l_suppkey").agg(s=("l_qty", "sum")),
        "Q4": li.group_by("l_shipdate").agg(c=("*", "count")),
        "Q5": li.join("orders", on=by_cust, cols=("o_custkey",),
                      where=col("o_orderdate") < 60)
                .group_by("o_custkey").agg(s=("l_extprice", "sum")),
        "Q6": li.where(col("l_shipdate") > 300)
                .group_by("l_suppkey").agg(a=("l_extprice", "avg")),
        "Q7": li.where(col("l_suppkey") < 10)
                .join("orders", on=by_cust, cols=("o_custkey",))
                .group_by("o_custkey").agg(c=("*", "count")),
        "composite": li.where(col("l_suppkey") < 30)
                       .join("orders", on=by_cust, cols=("o_orderdate",))
                       .group_by("l_suppkey", "o_orderdate")
                       .agg(n=("*", "count"), q=("l_qty", "sum"),
                            lo=("l_qty", "min"), hi=("l_extprice", "max"))
                       .having(col("n") > 1)
                       .order_by("-q", "l_suppkey", "o_orderdate")
                       .limit(25),
        "derived": li.select(rev=col("l_extprice") * col("l_qty"))
                     .where(col("l_qty") > 40)
                     .group_by("l_shipdate")
                     .agg(r=("rev", "sum"), m=("l_qty", "min")),
    }


def _run(db, col, names):
    out = {}
    for name, qb in _queries(db, col).items():
        if name not in names:
            continue
        try:
            res = qb.collect()
        except ref_core.AvailabilityError as e:     # reference refusal
            res = ("refused", type(e).__name__)
        except port_core.AvailabilityError as e:    # port refusal
            res = ("refused", type(e).__name__)
        out[name] = (res, qb.stats, db.epochs.n_pinned())
    return out


ALL = ("Q1", "Q2", "Q3", "Q4", "Q5", "Q6", "Q7", "composite", "derived")


def _step(records, step, ref_db, port_db, names=ALL):
    records[step] = (_run(ref_db, ref_engine.col, names),
                     _run(port_db, port_engine.col, names))


def _both(ref_db, port_db, fn):
    fn(ref_db)
    fn(port_db)


@pytest.fixture(scope="module", params=[0, 1], ids=["k0", "k1"])
def chain(request):
    """Run every step on both sides once; tests then read the records."""
    k = request.param
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # jax's int64->int32 notices
        return k, _run_chain(k)


def _run_chain(k):
    ref_db, port_db = _load(ref_core, k), _load(port_core, k, device="cpu")
    records = {}
    _step(records, "load", ref_db, port_db)

    more, _ = star_schema(2_000, N_DIM, seed=1)

    def trickle(db):
        t = db.begin()
        db.insert(t, "lineitem", more)
        db.commit(t)
    _both(ref_db, port_db, trickle)
    _step(records, "wos", ref_db, port_db, ("Q3", "Q5", "composite", "Q4"))

    def delete(db):
        t = db.begin()
        db.delete(t, "lineitem", lambda r: r["l_suppkey"] == 7)
        db.commit(t)
    _both(ref_db, port_db, delete)
    _step(records, "delete", ref_db, port_db, ("Q2", "Q3", "Q6", "Q4"))

    carried = port_core.database_from_state(port_core.state_of(ref_db),
                                            "cpu")
    records["carried"] = (records["delete"][0],
                          _run(carried, port_engine.col,
                               ("Q2", "Q3", "Q6", "Q4")))

    _both(ref_db, port_db,
          lambda db: db.run_tuple_mover(force_moveout=True))
    _step(records, "moved", ref_db, port_db)

    _both(ref_db, port_db, lambda db: db.fail_node(1))
    _step(records, "failed", ref_db, port_db, ("Q3", "Q5", "Q7", "Q4"))
    if k == 1:
        ir = _queries(port_db, port_engine.col)["Q3"].to_ir()
        records["failed_sources"] = plan_query(port_db, ir).sources
    return records


def _assert_same(ref_rec, port_rec, label):
    (r, rs, rpin), (p, ps, ppin) = ref_rec, port_rec
    assert rpin == 0 and ppin == 0, f"{label}: epoch pin leaked"
    if isinstance(r, tuple) or isinstance(p, tuple):
        assert r == p, label                # both refused, same type
        return
    assert (rs.groupby_algorithm, rs.fused) == \
        (ps.groupby_algorithm, ps.fused), label
    assert sorted(r) == sorted(p), label
    for c in r:
        a, b = np.asarray(r[c]), np.asarray(p[c])
        assert a.shape == b.shape, (label, c)
        if a.dtype.kind in "iub":
            np.testing.assert_array_equal(a.astype(np.int64),
                                          b.astype(np.int64),
                                          err_msg=f"{label}:{c}")
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5,
                                       err_msg=f"{label}:{c}")


def _check_step(records, step):
    ref_runs, port_runs = records[step]
    assert sorted(ref_runs) == sorted(port_runs)
    for name in ref_runs:
        _assert_same(ref_runs[name], port_runs[name], f"{step}:{name}")
    return ref_runs, port_runs


def test_q1_to_q7_after_bulk_load(chain):
    _, records = chain
    ref_runs, _ = _check_step(records, "load")
    routes = {n: ref_runs[n][1].groupby_algorithm for n in ref_runs}
    assert routes["Q1"] == "rle-scalar" and routes["Q4"] == "rle"
    assert all(ref_runs[n][1].fused for n in ("Q2", "Q3", "Q5", "Q6", "Q7"))


def test_composite_having_order_limit(chain):
    _, records = chain
    ref_runs, port_runs = records["load"]
    _assert_same(ref_runs["composite"], port_runs["composite"], "composite")
    _assert_same(ref_runs["derived"], port_runs["derived"], "derived")
    out = port_runs["composite"][0]
    assert len(out["n"]) == 25 and (out["n"] > 1).all()
    assert (np.diff(out["q"]) <= 0).all()


def test_pending_wos_rows_take_the_general_path(chain):
    _, records = chain
    ref_runs, _ = _check_step(records, "wos")
    assert not any(ref_runs[n][1].fused for n in ("Q3", "Q5", "composite"))


def test_queries_after_delete(chain):
    _, records = chain
    _check_step(records, "delete")


def test_queries_after_tuple_mover(chain):
    _, records = chain
    ref_runs, _ = _check_step(records, "moved")
    assert ref_runs["Q3"][1].fused


def test_node_failure_served_by_buddy(chain):
    k, records = chain
    ref_runs, port_runs = _check_step(records, "failed")
    if k == 0:
        assert port_runs["Q3"][0] == ("refused", "SegmentUnavailableError")
    else:
        assert isinstance(port_runs["Q3"][0], dict)
        assert any(owner.endswith("_b1")
                   for _, owner in records["failed_sources"])


def test_database_rebuilt_from_reference_state(chain):
    _, records = chain
    _check_step(records, "carried")


def test_state_of_is_plain_python_and_numpy():
    db = _load(port_core, 1, device="cpu")
    t = db.begin()
    db.insert(t, "lineitem", star_schema(100, N_DIM, seed=2)[0])
    db.commit(t)
    allowed = (str, int, float, bool, type(None), np.ndarray)

    def walk(x):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(k)
                walk(v)
        elif isinstance(x, tuple):
            for v in x:
                walk(v)
        else:
            assert isinstance(x, allowed), type(x)
    state = port_core.state_of(db)
    walk(state)
    again = port_core.state_of(port_core.database_from_state(state, "cpu"))
    assert again.keys() == state.keys()
    assert len(again["nodes"][0]["stores"]["lineitem_super"]["containers"]) \
        == len(state["nodes"][0]["stores"]["lineitem_super"]["containers"])


def test_port_only_entry_points_raise_until_ported():
    # every entry point is ported now: serve() (tests/test_torch_serving.py),
    # attach_mesh() and rejoin_node() (tests/test_torch_segmented.py,
    # test_torch_recovery.py)
    db = _load(port_core, 0, device="cpu")
    svc = db.serve()
    assert isinstance(svc, port_engine.QueryService)
    qb = _queries(db, port_engine.col)["Q3"]
    ticket = svc.submit(qb)
    svc.drain()
    want = qb.collect()
    got = ticket.result()
    assert sorted(got) == sorted(want)
    for c in want:
        np.testing.assert_array_equal(got[c], want[c])
    assert svc.stats.device_transfers == svc.stats.drains == 1
    mesh = db.attach_mesh()
    assert db.mesh is mesh and mesh.n_shards == 1
    assert mesh.device.type == "cpu"
    db.detach_mesh()
    assert db.mesh is None
    db.fail_node(0)
    db.rejoin_node(0)
    assert db.nodes[0].up and db.nodes[0].recovering
    assert db.epochs.n_pinned() == 0


def _load_batches(core, sizes, **kw):
    """Lineitem bulk-loaded in several direct-to-ROS commits: several
    containers per node, none a whole number of 512-row blocks."""
    db = core.VerticaDB(n_nodes=4, k_safety=0, block_rows=512, **kw)
    schema = core.TableSchema("lineitem", (
        core.ColumnDef("l_orderkey"), core.ColumnDef("l_suppkey"),
        core.ColumnDef("l_shipdate"), core.ColumnDef("l_qty"),
        core.ColumnDef("l_extprice", core.SQLType.FLOAT)))
    db.catalog.add_table(schema)
    db.create_projection(core.super_projection(
        schema, ("l_shipdate", "l_suppkey"), ("l_orderkey",),
        encodings={"l_shipdate": core.Encoding.RLE}))
    for seed, n in enumerate(sizes):
        t = db.begin(direct_to_ros=True)
        db.insert(t, "lineitem", star_schema(n, N_DIM, seed=seed)[0])
        db.commit(t)
    return db


def _q4(db, col):
    qb = db.query("lineitem").group_by("l_shipdate").agg(c=("*", "count"))
    return qb.collect(), qb.stats


def _rle_run_ids(db):
    return {key[0] for key in db.block_cache.keys() if key[2] == "rle_runs"}


def _live_ids(db):
    return {c.id for node in db.nodes
            for c in node.stores["lineitem_super"].containers}


@pytest.mark.parametrize("call_rows", [1 << 31, 3_000])
def test_q4_batched_rle_route_against_reference(monkeypatch, call_rows):
    """Q4 off the runs of every container in as few ``rle_grouped_agg``
    calls as the row limit of a call allows (lowered here, so the route
    makes several), the tail padding subtracted on the host, equal to the
    reference exactly."""
    from repro_torch.engine import operators, pipeline
    sizes = (7_001, 5_003, 3_333)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref_db = _load_batches(ref_core, sizes)
        want, ref_stats = _q4(ref_db, ref_engine.col)
    port_db = _load_batches(port_core, sizes, device="cpu")
    conts = [c for node in port_db.nodes
             for c in node.stores["lineitem_super"].containers]
    per_node = [len(node.stores["lineitem_super"].containers)
                for node in port_db.nodes]
    assert min(per_node) >= len(sizes)
    assert any(c.n_rows % 512 for c in conts)          # tail padding
    calls = []
    inner = operators.groupby_rle_runs

    def counted(runs, domain):
        calls.append(len(runs))
        return inner(runs, domain)
    monkeypatch.setattr(operators, "groupby_rle_runs", counted)
    monkeypatch.setattr(pipeline, "_RLE_CALL_ROWS", call_rows)
    got, stats = _q4(port_db, port_engine.col)
    assert stats.groupby_algorithm == ref_stats.groupby_algorithm == "rle"
    n_containers = len(conts)
    assert sum(calls) == n_containers
    if call_rows == 1 << 31:
        assert calls == [n_containers]
    else:
        assert len(calls) > 1
    assert sorted(got) == sorted(want)
    for c in want:
        np.testing.assert_array_equal(np.asarray(got[c]).astype(np.int64),
                                      np.asarray(want[c]).astype(np.int64))
    assert int(np.sum(got["c"])) == sum(sizes)
    assert port_db.epochs.n_pinned() == 0


def test_rle_runs_cache_follows_the_tuple_mover():
    """The runs cache holds exactly the live containers' ids: after a
    mergeout the merged-away containers' runs are gone and Q4 still
    matches the reference."""
    sizes = (4_001, 3_001, 2_001)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref_db = _load_batches(ref_core, sizes)
    port_db = _load_batches(port_core, sizes, device="cpu")
    _q4(port_db, port_engine.col)
    before = _live_ids(port_db)
    assert _rle_run_ids(port_db) == before
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for db in (ref_db, port_db):
            assert db.run_tuple_mover()["mergeouts"] > 0
        want, _ = _q4(ref_db, ref_engine.col)
    after = _live_ids(port_db)
    assert after != before
    assert _rle_run_ids(port_db) == before & after   # retired ones gone
    got, stats = _q4(port_db, port_engine.col)
    assert stats.groupby_algorithm == "rle"
    assert _rle_run_ids(port_db) == after
    for c in want:
        np.testing.assert_array_equal(np.asarray(got[c]).astype(np.int64),
                                      np.asarray(want[c]).astype(np.int64))


@pytest.mark.parametrize("mode", ["decoded", "compressed"])
def test_fused_deferred_then_to_host_equals_execute_fused(mode):
    """``execute_fused`` is the synchronous wrapper of
    ``execute_fused_deferred``: launching, fetching the result with
    ``to_host`` (also as a one-entry flight) and finishing it gives the
    same arrays, bit for bit, over the decoded and the compressed scan.
    A single-table query run by ``execute_shared_fused`` over the
    unpruned scan a serving group shares gives them too."""
    from repro_torch.engine import executor
    from repro_torch.engine.pipeline import ExecStats
    db = _load(port_core, 0, device="cpu")
    db.exec_mode = mode
    compressed = 0
    for name, qb in _queries(db, port_engine.col).items():
        q = qb.to_ir()
        plan = plan_query(db, q)
        if plan.groupby_algorithm == "rle" or plan.scalar_rle:
            continue                      # the RLE routes are not fused
        as_of = db.epochs.latest_queryable()
        want = executor.execute_fused(db, q, plan, as_of, ExecStats())
        assert want is not None, name
        for flight in (False, True):
            es = ExecStats()
            res, finish = executor.execute_fused_deferred(db, q, plan,
                                                          as_of, es)
            host = executor.to_host([res])[0] if flight \
                else executor.to_host(res)
            got = finish(host)
            assert sorted(got) == sorted(want), name
            for c in want:
                assert got[c].dtype == want[c].dtype, (name, c)
                np.testing.assert_array_equal(got[c], want[c])
            compressed += es.compressed_scan
        if q.joins:
            continue
        proj = db.catalog.projections[plan.projection]
        scan = executor.scan_stores_batched(
            db, plan, sorted(q.scan_columns(proj)), None, None, as_of,
            ExecStats())
        got = executor.execute_shared_fused(db, q, plan, scan.columns,
                                            scan.valid, ExecStats())
        assert sorted(got) == sorted(want), name
        for c in want:
            np.testing.assert_array_equal(got[c].astype(want[c].dtype),
                                          want[c])
    assert bool(compressed) == (mode == "compressed")
