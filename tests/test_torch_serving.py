"""The port's serving layer (``repro_torch.engine.serving``) against the
reference's, scenario by scenario.

Every test of tests/test_serving.py and tests/test_serving_async.py is
ported here: the same rows (``make_db``/``wave_rows``, seed 7, numpy) go
into a reference ``repro.core.VerticaDB`` and a port one with
``device="cpu"``, and the same schedule -- submits, priorities, sessions,
clocks, faults, trickle commits -- is served on both.  Each side makes
the reference test's own assertions, and then the two are held against
each other:

* per ticket, the port's served result equals the port's solo
  ``execute`` byte for byte (``assert_identical``) and equals the
  reference's served result exactly -- the corpus's quarter-valued
  prices keep f32 sums exact in any order;
* per ticket, its state, rejection kind, ``share_group``,
  ``shared_scan`` role, dispatch order, pinned epoch, SMA price and
  failovers are the reference's;
* per run, every ``ServiceStats`` counter but ``peak_in_flight``
  (``shared_scans``, ``deduped``, ``drains``, ``device_transfers``,
  ``batch_boosts``, the rejection counts, ...) is the reference's; the
  port's peaks are held against its bulkheads.

On the CPU the port's flights carry no CUDA event and are ready when
parked, as the reference's are when jax computes eagerly; the drain
stage still fetches each flight with one ``to_host``, so
``device_transfers == drains`` holds here as it does on the card.
"""
import dataclasses
import time
import warnings

import numpy as np
import pytest
from hypothesis import given, settings
import hypothesis.strategies as st

import repro.core as ref_core
import repro.engine as ref_engine
import repro.engine.serving as ref_serving
import repro_torch.core as port_core
import repro_torch.engine as port_engine
import repro_torch.engine.serving as port_serving
from repro.core.recovery import recover_node as ref_recover_node
from repro_torch.core.recovery import recover_node as port_recover_node

from test_serving import assert_identical, wave_rows


@dataclasses.dataclass(frozen=True)
class Side:
    name: str
    core: object
    engine: object
    serving: object
    recover_node: object

    @property
    def col(self):
        return self.engine.col


REF = Side("ref", ref_core, ref_engine, ref_serving, ref_recover_node)
PORT = Side("port", port_core, port_engine, port_serving, port_recover_node)


def make_db(side, n_nodes=4, k_safety=1, block_rows=64, n_per_wave=1000,
            waves=3, seed=7, n_cids=50):
    """tests/test_serving.py::make_db on either package: a K-safe cluster
    with one ROS container per trickle wave per store."""
    core = side.core
    kw = {"device": "cpu"} if side is PORT else {}
    rng = np.random.default_rng(seed)
    db = core.VerticaDB(n_nodes=n_nodes, k_safety=k_safety,
                        block_rows=block_rows, **kw)
    db.create_table(
        core.TableSchema("sales", (
            core.ColumnDef("sale_id"), core.ColumnDef("cid"),
            core.ColumnDef("day"), core.ColumnDef("qty"),
            core.ColumnDef("price", core.SQLType.FLOAT))),
        sort_order=("day",), segment_by=("sale_id",))
    off = 0
    for _ in range(waves):
        t = db.begin()
        db.insert(t, "sales", wave_rows(rng, off, n_per_wave, n_cids))
        db.commit(t)
        off += n_per_wave
        db.run_tuple_mover(force_moveout=True, do_mergeout=False)
    return db


def corpus(db, col):
    """tests/test_serving.py::corpus with either package's ``col``."""
    q = db.query
    return [
        q("sales").group_by("cid").agg(n=("*", "count")).to_ir(),
        q("sales").where(col("day") < 180).group_by("cid")
        .agg(rev=("price", "sum"), n=("*", "count")).to_ir(),
        q("sales").where((col("cid") >= 10) & (col("cid") < 40))
        .group_by("day").agg(mx=("price", "max")).to_ir(),
        q("sales").agg(total=("qty", "sum")).to_ir(),
        q("sales").where(col("qty") > 5).agg(n=("*", "count"),
                                             lo=("price", "min")).to_ir(),
        q("sales").group_by("cid", "qty").agg(s=("price", "sum")).to_ir(),
        q("sales").where(col("day") >= 300).group_by("cid")
        .agg(avg_p=("price", "avg")).having(col("avg_p") > 40)
        .order_by("-avg_p").limit(7).to_ir(),
        q("sales").select(margin=col("price") * col("qty"))
        .group_by("cid").agg(m=("margin", "sum")).to_ir(),
        q("sales").where(col("day") == 33)
        .select("sale_id", "cid", "price").to_ir(),
        q("sales").where(col("cid") == 7).group_by("day")
        .agg(n=("*", "count")).order_by("day").to_ir(),
        q("sales").where(col("day") > 9000).group_by("cid")
        .agg(s=("price", "sum")).to_ir(),
        q("sales").where(col("day") > 9000).agg(lo=("price", "min")).to_ir(),
    ]


def repair_all(side, db, suspend=True):
    """tests/test_fault_chaos.py::repair_all with either package's
    ``recover_node``: bring every node back, retrying so interdependent
    buddy pairs recover in whatever order works."""
    import contextlib
    cm = db.faults.suspended() if suspend else contextlib.nullcontext()
    with cm:
        for _ in range(6):
            pending = [n.id for n in db.nodes if not n.serving()]
            if not pending:
                return
            for nid in pending:
                try:
                    side.recover_node(db, nid)
                except side.core.RecoverySourceLostError:
                    continue
    assert all(n.serving() for n in db.nodes), "cluster unrepairable"


# ---------------------------------------------------------------------------
# the two-sided harness
# ---------------------------------------------------------------------------

def _ticket(t):
    s = t.stats
    err = t.error
    return {"state": t.state, "rejected_reason": s.rejected_reason,
            "shared_scan": s.shared_scan, "share_group": s.share_group,
            "dispatch_seq": s.dispatch_seq,
            "snapshot_epoch": s.snapshot_epoch, "cost_bytes": s.cost_bytes,
            "cost_boosted": s.cost_boosted, "oversized": s.oversized,
            "async_dispatch": s.async_dispatch, "failovers": s.failovers,
            "reserved_bytes": s.reserved_bytes,
            "error": None if err is None else type(err).__name__}


# ``peak_in_flight`` is left out: the reference harvests a flight only
# once jax reports its arrays ready, and jax's CPU dispatch is
# asynchronous too, so how many flights it holds at once varies from run
# to run.  The port's own peaks are checked against the bulkheads.
COUNTERS = tuple(f.name for f in dataclasses.fields(ref_serving.ServiceStats)
                 if f.name != "peak_in_flight")


def counters(stats):
    return {name: getattr(stats, name) for name in COUNTERS}


def record(svc, tickets, order=True, **extra):
    """What one side's run shows: its ServiceStats counters, each
    ticket's serving record and its rows.  ``order=False`` leaves out
    the dispatch order, which a bulkhead makes depend on when the
    reference finds its flights ready."""
    recs = [_ticket(t) for t in tickets]
    if not order:
        for r in recs:
            del r["dispatch_seq"]
    return {"stats": counters(svc.stats), "tickets": recs,
            "rows": [t._result for t in tickets], **extra}


def both(scenario, *args):
    """Run ``scenario(side, *args)`` on the reference, then on the port,
    and hold the port's record against the reference's."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = scenario(REF, *args)
    port = scenario(PORT, *args)
    same_record(ref, port)
    return ref, port


def same_record(ref, port):
    assert ref.keys() == port.keys()
    for key in ref:
        if key == "rows":
            assert len(ref["rows"]) == len(port["rows"])
            for i, (a, b) in enumerate(zip(ref["rows"], port["rows"])):
                assert (a is None) == (b is None), i
                if a is not None:
                    assert_identical(a, b, label=f"ticket {i}")
        else:
            assert ref[key] == port[key], (key, ref[key], port[key])


@pytest.fixture(scope="module")
def serving_dbs():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = make_db(REF)
    return {"ref": ref, "port": make_db(PORT)}


@pytest.fixture(scope="module")
def async_dbs():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = make_db(REF)
    return {"ref": ref, "port": make_db(PORT)}


def _transfer_meter(monkeypatch, serving):
    """tests/test_serving_async.py's ``transfer_meter`` on one package:
    counts the drain stage's batched copies and any entry into
    ``_shared_general`` (the only serving code that syncs per member)."""
    class Meter:
        def __init__(self):
            self.t0 = serving.device_transfer_count()
            self.stray_syncs = []

        def transfers(self):
            return serving.device_transfer_count() - self.t0

    meter = Meter()
    real = serving.QueryService._shared_general

    def spy(self, q, plan, cols, valid, es):
        meter.stray_syncs.append(getattr(q, "table", "?"))
        return real(self, q, plan, cols, valid, es)

    monkeypatch.setattr(serving.QueryService, "_shared_general", spy)
    return meter


# ---------------------------------------------------------------------------
# tests/test_serving.py
# ---------------------------------------------------------------------------

def test_shared_scan_differential_byte_identical(serving_dbs):
    def run(side):
        db = serving_dbs[side.name]
        qs = corpus(db, side.col)
        refs = [side.engine.execute(db, q)[0] for q in qs]
        svc = db.serve(queue_depth=len(qs) + 1, max_coalesce=len(qs),
                       max_concurrent=2)
        with svc.session("interactive") as s:
            tickets = [s.submit(q) for q in qs]
        svc.drain()
        shared = 0
        for ref, t in zip(refs, tickets):
            assert_identical(ref, t.result(), label=str(t.id))
            shared += bool(t.stats.shared_scan)
        assert shared >= len(qs) - 2
        assert svc.stats.shared_scans >= 1
        assert svc.stats.shared_hit_rate() > 0
        assert svc.stats.device_transfers == svc.stats.drains
        assert db.epochs.n_pinned() == 0
        return record(svc, tickets)
    both(run)


def test_shared_scan_differential_with_pending_wos(serving_dbs):
    def run(side):
        db = serving_dbs[side.name]
        rng = np.random.default_rng(99)
        t = db.begin()
        db.insert(t, "sales", wave_rows(rng, 50_000, 120))
        db.commit(t)
        try:
            qs = corpus(db, side.col)
            refs = [side.engine.execute(db, q)[0] for q in qs]
            svc = db.serve(queue_depth=len(qs) + 1, max_coalesce=len(qs))
            tickets = [svc.submit(q) for q in qs]
            svc.drain()
            for ref, tk in zip(refs, tickets):
                assert_identical(ref, tk.result(), label=str(tk.id))
                assert not (tk.stats.exec_stats
                            and tk.stats.exec_stats.fused)
            assert db.epochs.n_pinned() == 0
            return record(svc, tickets)
        finally:
            db.run_tuple_mover(force_moveout=True, do_mergeout=False)
    both(run)


def test_shared_plan_cache_hits_across_services(serving_dbs):
    def run(side):
        db = serving_dbs[side.name]
        qs = [q for q in corpus(db, side.col) if q.aggs]
        for _ in range(2):
            svc = db.serve(queue_depth=len(qs) + 1, max_coalesce=len(qs))
            tickets = [svc.submit(q) for q in qs]
            svc.drain()
        hits = [t.stats.exec_stats.plan_cache == "hit" for t in tickets
                if t.stats.exec_stats is not None
                and t.stats.exec_stats.fused]
        assert hits and all(hits)
        return record(svc, tickets, hits=hits)
    both(run)


def test_queue_flood_leaves_zero_stray_pins(serving_dbs):
    def run(side):
        db = serving_dbs[side.name]
        assert db.epochs.n_pinned() == 0
        svc = db.serve(queue_depth=3, max_coalesce=1, max_concurrent=1)
        q = db.query("sales").group_by("cid").agg(n=("*", "count")).to_ir()
        accepted, rejected = [], 0
        for _ in range(20):
            try:
                accepted.append(svc.submit(q))
            except side.core.QueryRejectedError:
                rejected += 1
        assert rejected == 20 - 3
        assert db.epochs.n_pinned() == len(accepted) == 3
        svc.drain()
        assert all(t.done for t in accepted)
        assert db.epochs.n_pinned() == 0
        assert svc.stats.rejected_queue_full == rejected
        return record(svc, accepted)
    both(run)


def test_queue_timeout_rejects_typed_and_unpins(serving_dbs):
    def run(side):
        db = serving_dbs[side.name]
        svc = db.serve(queue_depth=8, default_timeout_s=0.0)
        q = db.query("sales").agg(n=("*", "count")).to_ir()
        t = svc.submit(q)
        assert db.epochs.n_pinned() == 1
        time.sleep(0.01)
        svc.step()
        assert t.state == "rejected"
        assert t.stats.rejected_reason == "timeout"
        with pytest.raises(side.core.QueryRejectedError):
            t.result()
        assert db.epochs.n_pinned() == 0
        assert svc.stats.rejected_timeout == 1
        return record(svc, [t])
    both(run)


def test_ahm_unblocked_after_flood(serving_dbs):
    def run(side):
        db = serving_dbs[side.name]
        svc = db.serve(queue_depth=4)
        q = db.query("sales").agg(n=("*", "count")).to_ir()
        tickets = []
        for _ in range(10):
            try:
                tickets.append(svc.submit(q))
            except side.core.QueryRejectedError:
                pass
        svc.drain()
        assert db.epochs.n_pinned() == 0
        db.epochs.advance_ahm(db.epochs.latest_queryable())
        assert db.epochs.ahm == db.epochs.latest_queryable()
        return record(svc, tickets, ahm=db.epochs.ahm)
    both(run)


def test_priority_ordering_with_batch_boost(serving_dbs):
    def run(side):
        db = serving_dbs[side.name]
        svc = db.serve(queue_depth=16, max_coalesce=1, max_concurrent=1,
                       batch_boost_after=2)
        q = db.query("sales").agg(n=("*", "count")).to_ir()
        batch = [svc.submit(q, priority="batch") for _ in range(4)]
        inter = [svc.submit(q, priority="interactive") for _ in range(4)]
        svc.drain()
        iseq = [t.stats.dispatch_seq for t in inter]
        bseq = [t.stats.dispatch_seq for t in batch]
        assert max(iseq) < max(bseq)
        assert min(bseq) < max(iseq)
        assert svc.stats.batch_boosts >= 1
        assert db.epochs.n_pinned() == 0
        return record(svc, batch + inter)
    both(run)


def test_snapshot_consistency_under_trickle_commits():
    def run(side):
        db = make_db(side, waves=2, n_per_wave=500)
        rng = np.random.default_rng(5)
        svc = db.serve(queue_depth=16)
        q = db.query("sales").agg(n=("*", "count")).to_ir()
        execute = side.engine.execute
        t_before = svc.submit(q)
        n_before = int(execute(db, q, as_of=t_before.pinned)[0]["n"][0])
        tickets = [t_before]
        for k in range(3):
            t = db.begin()
            db.insert(t, "sales", wave_rows(rng, 10_000 + 100 * k, 100))
            db.commit(t)
            t_mid = svc.submit(q)
            tickets.append(t_mid)
            got = int(execute(db, q, as_of=t_mid.pinned)[0]["n"][0])
            assert (got - n_before) % 100 == 0
        t_after = svc.submit(q)
        tickets.append(t_after)
        svc.drain()
        assert int(t_before.result()["n"][0]) == n_before
        assert int(t_after.result()["n"][0]) == n_before + 300
        assert db.epochs.n_pinned() == 0
        return record(svc, tickets)
    both(run)


def test_session_pool_bounded(serving_dbs):
    def run(side):
        db = serving_dbs[side.name]
        svc = db.serve(max_sessions=2)
        s1, s2 = svc.session(), svc.session("batch")
        with pytest.raises(side.core.QueryRejectedError):
            svc.session()
        s1.close()
        s3 = svc.session()
        with pytest.raises(side.core.QueryRejectedError):
            s1.submit(db.query("sales").agg(n=("*", "count")))
        s2.close(), s3.close()
        return record(svc, [], sessions=len(svc._sessions))
    both(run)


def test_memory_budget_bounds_coalescing_and_concurrency(serving_dbs):
    def run(side):
        db = serving_dbs[side.name]
        qs = [db.query("sales").group_by("cid").agg(n=("*", "count"))
              .to_ir(),
              db.query("sales").group_by("cid")
              .agg(s=("price", "sum")).to_ir()] * 3
        svc = db.serve(queue_depth=16, memory_budget_bytes=1 << 30)
        tickets = [svc.submit(q) for q in qs]
        svc.drain()
        assert all(t.stats.share_group >= 2 for t in tickets)
        assert db.block_cache.stats.reserved_bytes == 0
        assert db.block_cache.stats.peak_reserved_bytes > 0
        assert all(not t.stats.oversized for t in tickets)

        ref = side.engine.execute(db, qs[0])[0]
        svc2 = db.serve(queue_depth=16, memory_budget_bytes=1024)
        tickets2 = [svc2.submit(q) for q in qs]
        svc2.drain()
        assert all(t.stats.share_group == 1 for t in tickets2)
        assert all(t.stats.oversized for t in tickets2)
        assert_identical(ref, tickets2[0].result())
        assert db.block_cache.stats.reserved_bytes == 0
        assert db.epochs.n_pinned() == 0
        return record(svc, tickets + tickets2,
                      stats2=counters(svc2.stats))
    both(run)


def test_admit_transient_exhaustion_rejects_typed():
    def run(side):
        db = make_db(side, waves=1, n_per_wave=400)
        inj = db.enable_faults(seed=3)
        inj.on("serving.admit", side.core.Transient(),
               times=inj.max_attempts)
        svc = db.serve(queue_depth=8)
        q = db.query("sales").agg(n=("*", "count")).to_ir()
        with pytest.raises(side.core.QueryRejectedError):
            svc.submit(q)
        assert db.epochs.n_pinned() == 0
        assert svc.stats.rejected_admission == 1
        t = svc.submit(q)
        svc.drain()
        assert int(t.result()["n"][0]) == 400
        db.disable_faults()
        return record(svc, [t])
    both(run)


def test_admit_transient_blip_retries_through():
    def run(side):
        db = make_db(side, waves=1, n_per_wave=400)
        inj = db.enable_faults(seed=3)
        inj.on("serving.admit", side.core.Transient(), times=1)
        svc = db.serve(queue_depth=8)
        t = svc.submit(db.query("sales").agg(n=("*", "count")))
        svc.drain()
        assert int(t.result()["n"][0]) == 400
        assert inj.fired("serving.admit") == 1
        db.disable_faults()
        return record(svc, [t], fired=inj.fired("serving.admit"))
    both(run)


def test_mid_shared_scan_crash_fails_over_once():
    def run(side):
        db = make_db(side)
        col = side.col
        qs = [db.query("sales").group_by("cid").agg(n=("*", "count"))
              .to_ir(),
              db.query("sales").where(col("day") < 180).group_by("cid")
              .agg(rev=("price", "sum")).to_ir(),
              db.query("sales").agg(total=("qty", "sum")).to_ir()]
        refs = [side.engine.execute(db, q)[0] for q in qs]
        inj = db.enable_faults(seed=11)
        inj.on("serving.shared_scan", side.core.CrashNode(node=1), hit=1)
        svc = db.serve(queue_depth=8, max_coalesce=8)
        tickets = [svc.submit(q) for q in qs]
        svc.drain()
        assert not db.nodes[1].up
        for ref, t in zip(refs, tickets):
            assert_identical(ref, t.result(), label=str(t.id))
            assert t.stats.failovers == 1
        assert db.epochs.n_pinned() == 0
        db.disable_faults()
        repair_all(side, db)
        return record(svc, tickets)
    both(run)


@pytest.mark.parametrize("seed", [7, 19])
def test_serving_chaos_right_answer_or_typed(seed):
    """Seeded chaos over both serving points at once: every ticket
    matches the post-repair oracle at its own pinned epoch or rejected
    typed -- and the port's faults fire, and its tickets settle, exactly
    as the reference's do."""
    def run(side):
        db = make_db(side, waves=2, n_per_wave=600)
        qs = corpus(db, side.col)[:6]
        core = side.core
        inj = db.enable_faults(seed=seed)
        inj.chaos(("serving.admit", "serving.shared_scan"), p=0.25,
                  action=core.CrashNode(respect_k_safety=True))
        inj.chaos(("serving.admit", "serving.shared_scan"), p=0.15,
                  action=core.Transient())
        svc = db.serve(queue_depth=32, max_coalesce=4, max_concurrent=2)
        tickets, refused = [], 0
        for _ in range(2):
            for q in qs:
                try:
                    tickets.append((q, svc.submit(q)))
                except core.QueryRejectedError:
                    refused += 1
            svc.drain()
        fired = {p: inj.fired(p)
                 for p in ("serving.admit", "serving.shared_scan")}
        db.disable_faults()
        repair_all(side, db)
        done = 0
        for q, t in tickets:
            assert t.done
            if t.state == "rejected":
                assert isinstance(t.error, Exception), t.error
                continue
            oracle = side.engine.execute(
                db, q, as_of=t.stats.snapshot_epoch)[0]
            assert_identical(oracle, t._result, label=f"seed{seed}:{t.id}")
            done += 1
        assert done >= 1
        assert db.epochs.n_pinned() == 0
        return record(svc, [t for _, t in tickets], refused=refused,
                      fired=fired)
    both(run)


def test_injection_point_registry_covers_serving():
    from repro.core import INJECTION_POINTS as ref_points
    from repro_torch.core import INJECTION_POINTS
    assert "serving.admit" in INJECTION_POINTS
    assert "serving.shared_scan" in INJECTION_POINTS
    assert INJECTION_POINTS == ref_points


# ---------------------------------------------------------------------------
# tests/test_serving_async.py
# ---------------------------------------------------------------------------

def test_overlapped_differential_byte_identical_ros(async_dbs):
    def run(side):
        db = async_dbs[side.name]
        qs = corpus(db, side.col)
        refs = [side.engine.execute(db, q)[0] for q in qs]
        svc = db.serve(queue_depth=len(qs) + 1, max_coalesce=4,
                       max_concurrent=3, max_in_flight=8,
                       clock=side.serving.VirtualClock())
        tickets = [svc.submit(q) for q in qs]
        svc.drain()
        for ref, t in zip(refs, tickets):
            assert_identical(ref, t.result(), label=str(t.id))
        assert svc.stats.async_units >= 1
        assert svc.stats.drains == svc.stats.async_units
        assert svc.stats.device_transfers == svc.stats.drains
        assert any(t.stats.async_dispatch for t in tickets)
        assert db.epochs.n_pinned() == 0
        return record(svc, tickets)
    both(run)


def test_overlapped_differential_byte_identical_with_pending_wos():
    def run(side):
        db = make_db(side, waves=2, n_per_wave=800)
        rng = np.random.default_rng(21)
        t = db.begin()
        db.insert(t, "sales", wave_rows(rng, 50_000, 300))
        db.commit(t)
        qs = corpus(db, side.col)
        refs = [side.engine.execute(db, q)[0] for q in qs]
        svc = db.serve(queue_depth=len(qs) + 1, max_coalesce=len(qs),
                       max_concurrent=2, clock=side.serving.VirtualClock())
        tickets = [svc.submit(q) for q in qs]
        svc.drain()
        for ref, t in zip(refs, tickets):
            assert_identical(ref, t.result(), label=str(t.id))
        assert db.epochs.n_pinned() == 0
        return record(svc, tickets)
    both(run)


def test_shared_collect_one_transfer_per_group(async_dbs, monkeypatch):
    def run(side):
        db = async_dbs[side.name]
        meter = _transfer_meter(monkeypatch, side.serving)
        col = side.col
        q = db.query
        selects = [
            q("sales").where(col("day") == 33)
            .select("sale_id", "cid", "price").to_ir(),
            q("sales").where(col("day") == 33).select("sale_id", "qty")
            .to_ir(),
            q("sales").where((col("day") > 100) & (col("day") < 104))
            .select("sale_id", "day", "price").to_ir(),
            q("sales").select(margin=col("price") * col("qty"))
            .where(col("day") == 200).to_ir(),
        ]
        refs = [side.engine.execute(db, s)[0] for s in selects]
        svc = db.serve(queue_depth=8, max_coalesce=8, max_concurrent=1,
                       clock=side.serving.VirtualClock())
        tickets = [svc.submit(s) for s in selects]
        svc.drain()
        for ref, t in zip(refs, tickets):
            assert_identical(ref, t.result(), label=str(t.id))
        assert all(t.stats.share_group == len(selects) for t in tickets)
        assert svc.stats.drains == 1
        assert meter.transfers() == 1
        assert meter.stray_syncs == []
        assert db.epochs.n_pinned() == 0
        return record(svc, tickets, transfers=meter.transfers())
    both(run)


def test_bulkhead_bounds_in_flight_under_flood(async_dbs):
    def run(side):
        db = async_dbs[side.name]
        caps = {"interactive": 3, "batch": 2}
        svc = db.serve(queue_depth=64, max_coalesce=1, max_concurrent=8,
                       max_in_flight=caps,
                       clock=side.serving.VirtualClock())
        rng = np.random.default_rng(50)
        q = db.query("sales").group_by("cid").agg(n=("*", "count")).to_ir()
        tickets = []
        for _ in range(50):
            pr = "batch" if rng.random() < 0.5 else "interactive"
            tickets.append(svc.submit(q, priority=pr))
            svc.step()
            for cls, cap in caps.items():
                assert svc.in_flight(cls) <= cap
        while svc.pending() or svc._inflight:
            svc.step()
            for cls, cap in caps.items():
                assert svc.in_flight(cls) <= cap
        assert svc.stats.completed == 50
        assert svc.stats.peak_in_flight.get("interactive", 0) >= 1
        assert all(svc.stats.peak_in_flight.get(c, 0) <= cap
                   for c, cap in caps.items())
        ref = side.engine.execute(db, q)[0]
        assert_identical(ref, tickets[0].result())
        assert db.epochs.n_pinned() == 0
        return record(svc, tickets, order=False)
    both(run)


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 20), st.integers(1, 10),
       st.lists(st.integers(0, 30), min_size=1, max_size=60))
def test_token_bucket_deterministic_and_bounded(rate, burst, gaps):
    """The port's bucket makes the reference bucket's every decision on
    the same virtual-time schedule; tokens stay within [0, burst]; total
    acceptances never exceed burst + rate x elapsed."""
    c_ref, c_port = ref_serving.VirtualClock(), port_serving.VirtualClock()
    b_ref = ref_serving.TokenBucket(rate, burst, clock=c_ref)
    b_port = port_serving.TokenBucket(rate, burst, clock=c_port)
    accepted = 0
    for g in gaps:
        dt = g * 0.1
        c_ref.advance(dt)
        c_port.advance(dt)
        r_ref, r_port = b_ref.try_consume(), b_port.try_consume()
        assert r_port == r_ref
        assert b_port.tokens == b_ref.tokens
        assert -1e-9 <= b_port.tokens <= burst + 1e-9
        accepted += r_port
    elapsed = sum(gaps) * 0.1
    assert accepted <= burst + rate * elapsed + 1e-6


def test_rate_limited_rejection_is_typed_and_never_pins():
    def run(side):
        db = make_db(side, waves=1, n_per_wave=400)
        inj = db.enable_faults(seed=9)
        clock = side.serving.VirtualClock()
        svc = db.serve(queue_depth=16, clock=clock)
        q = db.query("sales").agg(n=("*", "count")).to_ir()
        s = svc.session("interactive", rate_limit=(1.0, 2.0))
        accepted, reasons = [], []
        for _ in range(5):
            try:
                accepted.append(s.submit(q))
            except side.core.QueryRejectedError as e:
                assert e.reason.startswith("rate_limited")
                reasons.append(e.reason)
        assert len(accepted) == 2 and len(reasons) == 3
        assert svc.stats.rejected_rate_limited == 3
        assert db.epochs.n_pinned() == len(accepted)
        assert inj.hit_count("serving.rate_limit") == 3
        clock.advance(1.5)
        accepted.append(s.submit(q))
        with pytest.raises(side.core.QueryRejectedError):
            s.submit(q)
        svc.drain()
        for t in accepted:
            assert int(t.result()["n"][0]) == 400
        assert db.epochs.n_pinned() == 0
        s.close()
        return record(svc, accepted, reasons=reasons,
                      hits=inj.hit_count("serving.rate_limit"))
    both(run)


def _prices(db, q):
    """(sma, raw) admission prices of q, read off a free-running serve."""
    svc = db.serve(queue_depth=4)
    t = svc.submit(q)
    svc.drain()
    t.result()
    return t.stats.cost_bytes, svc._raw_working_set_bytes(t.plan,
                                                          t.scan_need)


def test_cost_model_rejects_padded_scan_raw_rows_would_admit():
    def run(side):
        db = make_db(side, waves=6, n_per_wave=30, block_rows=256)
        q = db.query("sales").group_by("cid").agg(n=("*", "count")).to_ir()
        sma, raw = _prices(db, q)
        assert sma > raw * 2, (sma, raw)
        ceiling = (raw + sma) // 2
        svc = db.serve(queue_depth=4, max_cost_bytes=ceiling)
        t = svc.submit(q)
        svc.drain()
        with pytest.raises(side.core.QueryRejectedError) as ei:
            t.result()
        assert "max_cost_bytes" in ei.value.reason
        assert t.stats.rejected_reason == "cost"
        assert svc.stats.rejected_cost == 1
        assert raw <= ceiling
        assert db.epochs.n_pinned() == 0
        return record(svc, [t], prices=(sma, raw))
    both(run)


def test_cost_model_admits_pruned_scan_raw_rows_would_reject():
    def run(side):
        db = make_db(side, waves=3, n_per_wave=2000, block_rows=64)
        q = db.query("sales").where(side.col("day") < 5).group_by("cid") \
            .agg(n=("*", "count")).to_ir()
        sma, raw = _prices(db, q)
        assert sma * 2 < raw, (sma, raw)
        ceiling = (sma + raw) // 2
        svc = db.serve(queue_depth=4, max_cost_bytes=ceiling)
        t = svc.submit(q)
        svc.drain()
        ref = side.engine.execute(db, q)[0]
        assert_identical(ref, t.result())
        assert raw > ceiling
        assert db.epochs.n_pinned() == 0
        return record(svc, [t], prices=(sma, raw))
    both(run)


def test_cheap_batch_query_boosted_into_interactive_queue():
    def run(side):
        db = make_db(side, waves=3, n_per_wave=2000, block_rows=64)
        heavy = db.query("sales").group_by("cid") \
            .agg(s=("price", "sum")).to_ir()
        cheap = db.query("sales").where(side.col("day") < 5) \
            .group_by("cid").agg(n=("*", "count")).to_ir()
        heavy_price, _ = _prices(db, heavy)
        cheap_price, _ = _prices(db, cheap)
        assert cheap_price < heavy_price
        svc = db.serve(queue_depth=16, max_coalesce=1, max_concurrent=1,
                       boost_cost_bytes=(cheap_price + heavy_price) // 2,
                       clock=side.serving.VirtualClock())
        t_heavy = [svc.submit(heavy, priority="batch") for _ in range(3)]
        t_cheap = svc.submit(cheap, priority="batch")
        svc.drain()
        assert t_cheap.stats.cost_boosted
        assert svc.stats.cost_boosts == 1
        assert t_cheap.stats.dispatch_seq < max(t.stats.dispatch_seq
                                                for t in t_heavy)
        assert db.epochs.n_pinned() == 0
        return record(svc, t_heavy + [t_cheap])
    both(run)


def test_drain_crash_fails_over_once_byte_identical():
    def run(side):
        db = make_db(side)
        qs = corpus(db, side.col)[:6]
        refs = [side.engine.execute(db, q)[0] for q in qs]
        inj = db.enable_faults(seed=11)
        inj.on("serving.drain", side.core.CrashNode(node=2), hit=1)
        svc = db.serve(queue_depth=len(qs) + 1, max_coalesce=len(qs),
                       max_concurrent=2, clock=side.serving.VirtualClock())
        tickets = [svc.submit(q) for q in qs]
        svc.drain()
        for ref, t in zip(refs, tickets):
            assert_identical(ref, t.result(), label=str(t.id))
        crashed = [t for t in tickets if t.stats.failovers]
        assert crashed and all(t.stats.failovers == 1 for t in crashed)
        assert inj.fired("serving.drain") == 1
        assert db.epochs.n_pinned() == 0
        return record(svc, tickets)
    both(run)


def test_drain_transient_exhaustion_rejects_typed():
    def run(side):
        db = make_db(side, waves=1, n_per_wave=400)
        inj = db.enable_faults(seed=13)
        inj.on("serving.drain", side.core.Transient(),
               times=inj.max_attempts)
        svc = db.serve(queue_depth=8, max_coalesce=1,
                       clock=side.serving.VirtualClock())
        q = db.query("sales").agg(n=("*", "count")).to_ir()
        t = svc.submit(q)
        svc.drain()
        with pytest.raises(side.core.QueryRejectedError):
            t.result()
        assert t.stats.rejected_reason == "unavailable"
        assert db.epochs.n_pinned() == 0
        t2 = svc.submit(q)
        svc.drain()
        assert int(t2.result()["n"][0]) == 400
        return record(svc, [t, t2])
    both(run)


def test_hang_at_dispatch_and_drain_advances_virtual_clock_only():
    def run(side):
        db = make_db(side, waves=1, n_per_wave=400)
        inj = db.enable_faults(seed=5)
        inj.on("serving.dispatch", side.core.Hang(2.5), hit=1)
        inj.on("serving.drain", side.core.Hang(1.25), hit=1)
        clock = side.serving.VirtualClock()
        svc = db.serve(queue_depth=8, max_coalesce=1, clock=clock)
        q = db.query("sales").agg(n=("*", "count")).to_ir()
        wall0 = time.time()
        t = svc.submit(q)
        svc.drain()
        assert int(t.result()["n"][0]) == 400
        assert clock.now() >= 3.75
        assert t.stats.exec_s >= 1.25
        assert time.time() - wall0 < 2.0
        assert db.epochs.n_pinned() == 0
        return record(svc, [t], now=clock.now(), exec_s=t.stats.exec_s,
                      queue_wait_s=t.stats.queue_wait_s)
    both(run)


def test_virtual_clock_timeout_expiry_is_deterministic():
    def run(side):
        db = make_db(side, waves=1, n_per_wave=400)
        clock = side.serving.VirtualClock()
        svc = db.serve(queue_depth=8, default_timeout_s=10.0, clock=clock)
        q = db.query("sales").agg(n=("*", "count")).to_ir()
        stale = svc.submit(q)
        clock.advance(11.0)
        fresh = svc.submit(q)
        svc.drain()
        with pytest.raises(side.core.QueryRejectedError):
            stale.result()
        assert stale.stats.rejected_reason == "timeout"
        assert int(fresh.result()["n"][0]) == 400
        assert db.epochs.n_pinned() == 0
        return record(svc, [stale, fresh],
                      total_s=[stale.stats.total_s, fresh.stats.total_s])
    both(run)


def test_injection_point_registry_covers_async_serving():
    from repro_torch.core import INJECTION_POINTS
    for pt in ("serving.dispatch", "serving.drain", "serving.rate_limit"):
        assert pt in INJECTION_POINTS


# ---------------------------------------------------------------------------
# the port's own: events, the one copy per flight
# ---------------------------------------------------------------------------

def test_cpu_flights_carry_no_event_and_fetch_in_one_copy(async_dbs,
                                                          monkeypatch):
    """On the CPU a parked flight has no CUDA event (ready at once); the
    drain fetches each flight with ONE ``to_host`` over its entries --
    dicts, ``(mask, columns)`` pairs and Nones -- which returns host
    arrays in the same structure, the mask as bool."""
    from repro_torch.engine import executor
    db = async_dbs["port"]
    calls = []
    real = executor.to_host

    def spy(tree):
        calls.append(type(tree))
        out = real(tree)
        if isinstance(tree, list):
            assert len(out) == len(tree)
            for entry, got in zip(tree, out):
                if entry is None:
                    assert got is None
                elif isinstance(entry, tuple):
                    assert got[0].dtype == np.bool_
                    assert sorted(got[1]) == sorted(entry[1])
                else:
                    assert sorted(got) == sorted(entry)
        return out

    monkeypatch.setattr(executor, "to_host", spy)
    parked = []
    real_park = port_serving.QueryService._park

    def park(self, flight):
        parked.append(flight)
        assert flight.event is None and flight.ready()
        return real_park(self, flight)

    monkeypatch.setattr(port_serving.QueryService, "_park", park)
    qs = corpus(db, port_engine.col)
    svc = db.serve(queue_depth=len(qs) + 1, max_coalesce=len(qs),
                   max_concurrent=2)
    tickets = [svc.submit(q) for q in qs]
    svc.drain()
    assert all(t.state == "done" for t in tickets)
    flights = [c for c in calls if c is list]
    assert len(flights) == len(parked) == svc.stats.drains \
        == svc.stats.device_transfers
    assert db.epochs.n_pinned() == 0
