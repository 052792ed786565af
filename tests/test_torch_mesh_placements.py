"""The port's query mesh of placements (distributed/mesh.py) and its
collectives (engine/exchange.py) against the reference's.

A placement is one device holding a contiguous block of a mesh's shards;
on the CPU, ``make_query_mesh(n, devices=["cpu"] * p)`` gives ``p``
placements, the port's counterpart of the reference's placeholder devices.

* ``resegment`` and ``broadcast_build_side`` on 8 CPU placements go bit
  for bit against the reference's on 8 placeholder devices -- the input of
  tests/test_multidevice.py::test_resegment_8_shards, run in one
  subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=8``:
  columns, ``valid`` and ``overflow``, with room for every row and with a
  capacity too small;
* the segmented executor on 4 placements: the shard-local pre-aggregation
  runs once per placement with global shard ids, answers equal 4 logical
  shards on one placement bit for bit, the plan cache and the slabs never
  mix the two layouts, a slab's bytes count every placement, and
  ``fail_node`` evicts a slab from every placement.

The star corpus, the join templates, the failure cycle and the pruning
differential on 4 placements are cases of tests/test_torch_segmented.py
(its ``PLACED`` layout).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch.core as port_core
import repro_torch.engine as port_engine
from repro_torch.core.block_cache import KIND_SEG
from repro_torch.distributed import QueryMesh, make_query_mesh
from repro_torch.engine import exchange, segmented
from repro_torch.engine.executor import PLAN_CACHE

N = 8192                  # tests/test_multidevice.py::test_resegment_8_shards
SHARDS = 8
TIGHT = 8 * 100           # capacity: 100 slots per (source, destination)

_REFERENCE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
assert jax.device_count() == 8, jax.device_count()
from repro.launch.mesh import make_host_mesh
from repro.engine.exchange import broadcast_build_side, resegment
mesh = make_host_mesh(data=8, model=1)
rng = np.random.default_rng(0)
n = 8192
keys = jnp.asarray(rng.integers(0, 10_000, n), jnp.int32)
vals = jnp.asarray(rng.normal(size=n), jnp.float32)
dest = keys % 8
out = {"keys": np.asarray(keys), "vals": np.asarray(vals)}
for name, cap in (("ample", 4 * n), ("tight", int(sys.argv[2]))):
    moved, valid, overflow = resegment(mesh, "data", {"k": keys, "v": vals},
                                       dest, capacity=cap)
    out[name + "_k"] = np.asarray(moved["k"])
    out[name + "_v"] = np.asarray(moved["v"])
    out[name + "_valid"] = np.asarray(valid)
    out[name + "_overflow"] = np.asarray(overflow)
out["gathered"] = np.asarray(broadcast_build_side(mesh, "data",
                                                  {"k": keys})["k"])
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's collectives on 8 placeholder devices, once."""
    path = tmp_path_factory.mktemp("mesh") / "reference.npz"
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", _REFERENCE, str(path),
                          str(TIGHT)], capture_output=True, text=True,
                         timeout=600, env=env)
    assert run.returncode == 0, run.stderr[-4000:]
    with np.load(path) as got:
        return dict(got)


def _blocks(a: np.ndarray):
    """A global (N,) array as its 8 placements' ``[1, N / 8]`` blocks."""
    return list(torch.from_numpy(a).reshape(SHARDS, 1, -1))


@pytest.mark.parametrize("case", ["ample", "tight"])
def test_resegment_on_8_placements_is_the_reference(reference, case):
    mesh = make_query_mesh(SHARDS, devices=["cpu"] * SHARDS)
    keys, vals = reference["keys"], reference["vals"]
    dest = keys % SHARDS
    cap = 4 * N if case == "ample" else TIGHT
    moved, valid, overflow = exchange.resegment(
        mesh, "data", {"k": _blocks(keys), "v": _blocks(vals)},
        _blocks(dest), cap)
    assert len(valid) == SHARDS and all(b.shape[0] == 1 for b in valid)
    for name, got in (("k", moved["k"]), ("v", moved["v"]),
                      ("valid", valid)):
        want = reference[f"{case}_{name}"]
        flat = torch.cat(got).reshape(-1).numpy()
        assert flat.dtype == want.dtype and flat.shape == want.shape, name
        assert np.array_equal(flat.view(np.uint8), want.view(np.uint8)), \
            (case, name)
    assert np.array_equal(overflow.numpy(), reference[f"{case}_overflow"])
    assert (int(overflow.sum()) == 0) == (case == "ample")
    # the same rows as one whole [8, N / 8] tensor: the concatenation
    whole, wvalid, wover = exchange.resegment(
        mesh, "data", {"k": torch.from_numpy(keys).reshape(SHARDS, -1)},
        torch.from_numpy(dest).reshape(SHARDS, -1), cap)
    assert torch.equal(whole["k"], torch.cat(moved["k"]))
    assert torch.equal(wvalid, torch.cat(valid))
    assert torch.equal(wover, overflow)


def test_broadcast_on_8_placements_is_the_reference(reference):
    mesh = make_query_mesh(SHARDS, devices=["cpu"] * SHARDS)
    got = exchange.broadcast_build_side(
        mesh, "data", {"k": _blocks(reference["keys"])})["k"]
    assert len(got) == SHARDS
    for g in got:
        assert np.array_equal(g.numpy(), reference["gathered"])


def test_query_mesh_of_placements():
    m = make_query_mesh(8, devices=["cpu"] * 4)
    assert m.n_shards == 8 and m.shards_per_placement == 2
    assert m.placements() == [(0, torch.device("cpu")), (2, m.device),
                              (4, m.device), (6, m.device)]
    assert m.cards() == (torch.device("cpu"),) and m.device.type == "cpu"
    assert make_query_mesh(devices=["cpu"] * 4).n_shards == 4
    t = torch.arange(24).reshape(8, 3)
    assert torch.equal(m.gather(list(t.split(2))), t)
    # the layout is part of the identity; width and device alone are not
    sigs = {make_query_mesh(8, device="cpu").signature("data"),
            m.signature("data"),
            make_query_mesh(8, devices=["cpu"] * 2).signature("data")}
    assert len(sigs) == 3
    with pytest.raises(ValueError, match="multiple"):
        make_query_mesh(6, devices=["cpu"] * 4)
    with pytest.raises(ValueError):
        make_query_mesh(4, device="cpu", devices=["cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_query_mesh(4, devices=["cuda:0"] * 4)
    db = port_core.VerticaDB(n_nodes=2, k_safety=0, device="cpu")
    with pytest.raises(ValueError, match="attach_mesh"):
        db.attach_mesh(QueryMesh(4, (torch.device("cpu"),
                                     torch.device("cuda", 0))))


# ---------------------------------------------------------------------------
# the segmented executor on placements
# ---------------------------------------------------------------------------

def _db(seed=7, n=3000):
    """A small sales/parts pair on the port: sales segmented by custkey,
    parts by its key (a join on it resegments)."""
    rng = np.random.default_rng(seed)
    db = port_core.VerticaDB(n_nodes=4, k_safety=1, block_rows=64,
                             device="cpu")
    C = port_core.ColumnDef
    db.create_table(port_core.TableSchema("sales", (
        C("custkey"), C("partkey"), C("day"), C("qty"),
        C("price", port_core.SQLType.FLOAT))),
        sort_order=("day",), segment_by=("custkey",))
    db.create_table(port_core.TableSchema("parts", (C("p_partkey"),
                                                    C("p_cat"))),
                    sort_order=("p_partkey",), segment_by=("p_partkey",))
    t = db.begin()
    db.insert(t, "sales", {"custkey": rng.integers(0, 300, n),
                           "partkey": rng.integers(0, 2000, n),
                           "day": rng.integers(0, 365, n),
                           "qty": rng.integers(1, 50, n),
                           "price": np.round(rng.normal(100, 10, n), 2)})
    db.insert(t, "parts", {"p_partkey": np.arange(2000),
                           "p_cat": rng.integers(0, 9, 2000)})
    db.commit(t)
    db.run_tuple_mover(force_moveout=True)
    return db


def _queries(db):
    col = port_engine.col
    return {
        "grouped": db.query("sales").where(col("day") < 200)
        .group_by("qty").agg(n=("*", "count"), s=("qty", "sum"),
                             mx=("price", "max")),
        "resegment": db.query("sales")
        .join("parts", on=("partkey", "p_partkey"), cols=("p_cat",))
        .group_by("p_cat").agg(n=("*", "count"), s=("qty", "sum")),
        "scalar": db.query("sales").agg(n=("*", "count"),
                                        a=("price", "avg")),
    }


def _run(db, qb, mesh):
    db.attach_mesh(mesh)
    try:
        return port_engine.execute(db, qb.to_ir())
    finally:
        db.detach_mesh()


def _match(want, got, key, what):
    """A single-node answer against a segmented one, rows ordered by the
    group key: ints exactly, floats within rtol 1e-5."""
    assert sorted(want) == sorted(got), what
    ow, og = np.argsort(want[key]), np.argsort(got[key])
    for c in want:
        x, y = np.asarray(want[c])[ow], np.asarray(got[c])[og]
        if x.dtype.kind in "iub":
            assert np.array_equal(x, y), (what, c)
        else:
            assert np.allclose(x, y, rtol=1e-5, atol=0), (what, c)


def _equal(a, b, what):
    assert sorted(a) == sorted(b), what
    for c in a:
        x, y = np.asarray(a[c]), np.asarray(b[c])
        assert x.dtype == y.dtype and np.array_equal(x, y), (what, c)


def test_placements_equal_logical_shards_and_miss_the_plan_cache():
    """4 placements == 4 logical shards bit for bit (the plain partials
    sum each shard's rows in the same order), each layout with its own
    stage programs and slabs: the first run of a layout misses, its
    repeat hits."""
    db = _db()
    logical = make_query_mesh(4, device="cpu")
    placed = make_query_mesh(4, devices=["cpu"] * 4)
    PLAN_CACHE.clear()        # another test may have built these programs
    for name, qb in _queries(db).items():
        want, s0 = _run(db, qb, logical)
        got, s1 = _run(db, qb, placed)
        assert s0.segmented and s1.segmented and s1.n_shards == 4, name
        assert s1.exchange == s0.exchange
        if name != "scalar":
            assert s1.plan_cache == "miss" and s1.seg_slab == "miss", name
        _equal(want, got, name)
        again, s2 = _run(db, qb, placed)
        assert s2.plan_cache == "hit" and s2.seg_slab == "hit", name
        _equal(want, again, name)
        back, s3 = _run(db, qb, logical)
        assert s3.plan_cache == "hit" and s3.seg_slab == "hit", name
        _equal(want, back, name)


def test_preagg_once_per_placement_with_global_shard_ids(monkeypatch):
    """Each placement launches seg_preagg once, over the mesh's whole
    ``n_shards * domain`` key space, with keys only in its own shards'
    rows of it."""
    db = _db(seed=9)
    qb = _queries(db)["grouped"]
    single, _ = port_engine.execute(db, qb.to_ir())
    calls = []
    real = segmented.kops.seg_preagg

    def counted(keys, valid, values, domain, aggs):
        calls.append((int(keys.min()), int(keys.max()), int(domain)))
        return real(keys, valid, values, domain, aggs)

    monkeypatch.setattr(segmented.kops, "seg_preagg", counted)
    got, stats = _run(db, qb, make_query_mesh(8, devices=["cpu"] * 4))
    assert stats.groupby_algorithm == "dense (segmented)"
    assert len(calls) == 4
    per_shard = calls[0][2] // 8
    for p, (lo, hi, domain) in enumerate(calls):
        assert domain == 8 * per_shard
        assert 2 * p * per_shard <= lo <= hi < 2 * (p + 1) * per_shard
    _match(single, got, "qty", "preagg")


def _slab_bytes(db):
    """Cached ROS slab bytes by mesh signature (the key's last item)."""
    return {key[1][2][4]: nb
            for key, (_, nb) in db.block_cache._entries.items()
            if key[2] == KIND_SEG}


def test_slab_bytes_count_every_placement_and_fail_node_evicts_them():
    db = _db(seed=11)
    qb = _queries(db)["grouped"]
    logical = make_query_mesh(4, device="cpu")
    placed = make_query_mesh(4, devices=["cpu"] * 4)
    _run(db, qb, logical)
    _run(db, qb, placed)
    slabs = _slab_bytes(db)
    one = slabs[logical.signature("data")]
    assert one > 0 and slabs[placed.signature("data")] == one
    db.fail_node(1)
    assert not _slab_bytes(db)
    got, stats = _run(db, qb, placed)
    assert stats.seg_slab == "miss" and stats.segmented
    want, _ = port_engine.execute(db, qb.to_ir())
    _match(want, got, "qty", "after fail_node")


def test_exchange_counts_bytes_between_placements():
    """An exchange on placements of one device hands bytes between
    placements and copies none between devices."""
    db = _db(seed=13)
    qb = _queries(db)["resegment"]
    exchange.reset_transfer_bytes()
    _run(db, qb, make_query_mesh(4, devices=["cpu"] * 4))
    moved = exchange.transfer_bytes()
    assert moved["between_placements"] > 0 and moved["cross_card"] == 0
    exchange.reset_transfer_bytes()
    assert exchange.transfer_bytes() == {"between_placements": 0,
                                         "cross_card": 0}


def test_wos_buffers_on_placements():
    """A trickle commit with a mesh of placements attached prewarms the
    WOS buffer as the placements' blocks, and the next query appends them
    shard-locally on each placement."""
    db = _db(seed=17)
    qb = _queries(db)["grouped"]
    placed = make_query_mesh(4, devices=["cpu"] * 4)
    _run(db, qb, placed)
    rng = np.random.default_rng(3)
    db.attach_mesh(placed)
    t = db.begin()
    db.insert(t, "sales", {"custkey": rng.integers(0, 300, 50),
                           "partkey": rng.integers(0, 2000, 50),
                           "day": rng.integers(0, 365, 50),
                           "qty": rng.integers(1, 50, 50),
                           "price": np.round(rng.normal(100, 10, 50), 2)})
    db.commit(t)
    db.detach_mesh()
    got, stats = _run(db, qb, placed)
    assert stats.seg_slab == "hit+wos", stats.seg_slab
    want, _ = _run(db, qb, make_query_mesh(4, device="cpu"))
    _equal(want, got, "wos")
