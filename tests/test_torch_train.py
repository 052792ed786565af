"""The port's training path (``repro_torch.train``, ``Model.loss``, the
token store and ``launch/train.py``) against the reference's, on the CPU.

Both packages start from the reference's TINY config (2 layers, d 64, 4
heads over 2 kv heads, head dim 16, vocab 128) and its initial train
state, carried across by ``train_state_from_numpy``; batches come from a numpy
seed.  The reference runs one jitted function per step: the loss and
gradients at the first chain's state, and one step each of a chain with
``microbatches=1`` and one with ``microbatches=2``.

Tolerances (both packages compute in bf16 from f32 master weights):
* loss: ``LOSS_TOL`` nats.  The port's attention keeps P.V in f32 (the
  flash path) where ``attend_full`` casts P to bf16, and XLA's CPU backend
  skips some bf16 roundings inside fused chains; 8.5e-4 is what they
  leave at this size.
* every gradient leaf: ``GRAD_TOL`` times the leaf's largest reference
  element.  bf16 activations round each product at 2^-8; the gaps seen
  here are 0.7-2.4 % with either attention route.
* after three AdamW steps, parameters within twice the summed learning
  rates: AdamW normalises each element's step, so an element whose
  gradient is near zero moves by up to about lr either way on either
  side.  That bound alone would pass a step that never reached the
  parameters, so each leaf's change over the three steps is also held
  against the reference's: the norm of their difference within
  ``UPDATE_RTOL`` of the reference change's norm (no update reads 1; the
  leaves read 0.009-0.078 here).  Moments within ``GRAD_TOL`` (m) and
  twice that (v, squared) of their largest element; losses and grad
  norms as above.
* AdamW and the schedule on the same f32 inputs: 1e-6 relative.
Checkpoints, token-store batches and the fault-tolerance helpers are
compared exactly, and a resume after a failure is bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs.base import ArchConfig as RefArchConfig
from repro.configs.base import RunConfig as RefRunConfig
from repro.data import TokenStore as RefTokenStore
from repro.data import token_corpus as ref_token_corpus
from repro.data import zipf_tokens as ref_zipf_tokens
from repro.models import build_model as ref_build_model
from repro.models import layers as ref_layers
from repro.train import checkpoint as ref_ckpt
from repro.train import fault_tolerance as ref_ft
from repro.train import optim as ref_optim
from repro.train.train_step import init_train_state as ref_init_train_state
from repro.train.train_step import make_train_step as ref_make_train_step
from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.data import TokenStore, token_corpus, zipf_tokens
from repro_torch.kernels import ops
from repro_torch.launch import train as train_launch
from repro_torch.models import build_model, layers
from repro_torch.train import checkpoint, fault_tolerance, optim
from repro_torch.train.train_step import (init_train_state, loss_and_grads,
                                          make_train_step, stack_layers,
                                          train_state_from_numpy,
                                          train_state_to_numpy)
from repro_torch.train.tree import (tree_flatten, tree_leaves, tree_map,
                                    tree_unflatten)

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=128, head_dim=16)
RC = dict(total_steps=20, warmup_steps=2)
B, S, N_STEPS = 4, 32, 3
LOSS_TOL, GRAD_TOL, UPDATE_RTOL = 5e-3, 5e-2, 0.1


def _batch(seed=0):
    tok = np.random.default_rng(seed).integers(
        0, TINY["vocab_size"], (B, S + 1)).astype(np.int32)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def _leaves_np(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.fixture(scope="module")
def ref_run():
    """The reference on TINY: its initial state (numpy), the loss and
    gradients at it, and three steps of each microbatch chain."""
    model = ref_build_model(RefArchConfig(**TINY), tp=1)
    state = ref_init_train_state(model, jax.random.key(0))
    rc = RefRunConfig(**RC)
    steps = {nm: ref_make_train_step(
        model, dataclasses.replace(rc, microbatches=nm)) for nm in (1, 2)}

    @jax.jit
    def both(s1, s2, batch):
        vg = jax.value_and_grad(model.loss)(s1["params"], batch)
        return vg, steps[1](s1, batch), steps[2](s2, batch)

    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    out = {"init": jax.tree.map(np.asarray, state), "metrics": {1: [], 2: []}}
    s1 = s2 = state
    for i in range(N_STEPS):
        (loss, grads), (s1, m1), (s2, m2) = both(s1, s2, batch)
        if i == 0:
            out["loss"] = float(loss)
            out["grads"] = jax.tree.map(np.asarray, grads)
        for nm, m in ((1, m1), (2, m2)):
            out["metrics"][nm].append({k: float(v) for k, v in m.items()})
    out["final"] = {1: jax.tree.map(np.asarray, s1),
                    2: jax.tree.map(np.asarray, s2)}
    return out


def stack_grads(model, params, grads):
    """Per-layer gradients (``loss_and_grads``) as a tree of the
    parameters' stacked layout, as jax returns them."""
    return stack_layers(model, params, grads)


def _port(remat="minimal"):
    return build_model(ArchConfig(**TINY), tp=1, remat=remat, device="cpu")


def _tbatch(seed=0):
    return {k: torch.as_tensor(v) for k, v in _batch(seed).items()}


def test_model_loss_and_every_gradient_leaf_match_the_reference(ref_run):
    model = _port()
    state = train_state_from_numpy(ref_run["init"], "cpu")
    loss, grads = loss_and_grads(model, state["params"], _tbatch())
    assert abs(float(loss) - ref_run["loss"]) <= LOSS_TOL
    got = stack_grads(model, state["params"], grads)
    want_leaves = _leaves_np(ref_run["grads"])
    got_leaves = tree_leaves(got)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max())


def test_loss_sends_attention_through_the_autograd_flash_function(
        monkeypatch):
    """Each layer's self-attention goes through
    ``ops.flash_attention_train`` (the kernels on a card), once forward
    and, under remat "minimal", once more in the backward's recompute;
    its backward runs once per layer."""
    from repro_torch.kernels import flash_attention as fa
    calls = {"fwd": 0, "bwd": 0}
    inner_fwd, inner_bwd = fa.flash_attention, fa.flash_attention_bwd

    def fwd(*a, **k):
        calls["fwd"] += 1
        return inner_fwd(*a, **k)

    def bwd(*a, **k):
        calls["bwd"] += 1
        return inner_bwd(*a, **k)
    monkeypatch.setattr(fa, "flash_attention", fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd", bwd)
    model = _port()
    state = init_train_state(model, seed=0)
    loss_and_grads(model, state["params"], _tbatch())
    assert calls == {"fwd": 2 * TINY["n_layers"], "bwd": TINY["n_layers"]}


def test_remat_policies_give_the_same_loss_and_gradients():
    results = []
    for remat in ("minimal", "dots", "none"):
        model = _port(remat)
        state = init_train_state(model, seed=3)
        results.append(loss_and_grads(model, state["params"], _tbatch(1)))
    for loss, grads in results[1:]:
        assert torch.equal(loss, results[0][0])
        assert all(torch.equal(a, b) for a, b in zip(grads, results[0][1]))


@pytest.mark.parametrize("microbatches", [1, 2])
def test_three_train_steps_match_the_reference(ref_run, microbatches):
    model = _port()
    state = train_state_from_numpy(ref_run["init"], "cpu")
    step = make_train_step(model, RunConfig(**RC, microbatches=microbatches))
    batch = _tbatch()
    for want in ref_run["metrics"][microbatches]:
        state, met = step(state, batch)
        assert abs(float(met["loss"]) - want["loss"]) <= LOSS_TOL
        assert float(met["grad_norm"]) == pytest.approx(want["grad_norm"],
                                                        rel=GRAD_TOL)
        assert float(met["lr"]) == pytest.approx(want["lr"], rel=1e-6)
    lr_sum = sum(m["lr"] for m in ref_run["metrics"][microbatches])
    got = train_state_to_numpy(state)
    want = ref_run["final"][microbatches]
    assert int(got["opt"].step) == int(want["opt"].step) == N_STEPS
    p0 = _leaves_np(ref_run["init"]["params"])
    for g, w, x0 in zip(tree_leaves(got["params"]),
                        _leaves_np(want["params"]), p0):
        np.testing.assert_allclose(g, w, rtol=0, atol=2 * lr_sum)
        # the update itself, which the atol above cannot tell from none
        moved, want_moved = g - x0, w - x0
        assert np.linalg.norm(moved - want_moved) <= \
            UPDATE_RTOL * np.linalg.norm(want_moved)
    for part, tol in ((0, GRAD_TOL), (1, 2 * GRAD_TOL)):
        for g, w in zip(tree_leaves(got["opt"][part]),
                        _leaves_np(want["opt"][part])):
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=tol * np.abs(w).max())


def test_lr_schedule_matches_the_reference():
    for rc in (dict(learning_rate=1e-3, warmup_steps=10, total_steps=100),
               dict(learning_rate=3e-4, warmup_steps=1, total_steps=7),
               dict(learning_rate=2e-4, warmup_steps=0, total_steps=0)):
        for step in (0, 1, 5, 10, 11, 50, 99, 100, 130):
            want = float(ref_optim.lr_schedule(RefRunConfig(**rc),
                                               jnp.asarray(step)))
            got = float(optim.lr_schedule(RunConfig(**rc),
                                          torch.tensor(step)))
            assert got == pytest.approx(want, rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])   # clip off, on
def test_adamw_update_matches_the_reference(grad_scale):
    rng = np.random.default_rng(7)
    shapes = {"a": (8, 16), "b": {"c": (5,), "d": (3, 2, 4)}}

    def tree(scale=1.0, positive=False):
        def leaf(shape):
            x = rng.normal(size=shape) * scale
            return (np.abs(x) if positive else x).astype(np.float32)
        return {"a": leaf(shapes["a"]),
                "b": {k: leaf(s) for k, s in shapes["b"].items()}}
    params, grads = tree(), tree(grad_scale)
    m, v = tree(0.01), tree(1e-4, positive=True)
    rc = dict(total_steps=50, warmup_steps=5, weight_decay=0.1)
    new_p, new_opt, met = ref_optim.adamw_update(
        RefRunConfig(**rc), jax.tree.map(jnp.asarray, params),
        jax.tree.map(jnp.asarray, grads),
        ref_optim.OptState(jax.tree.map(jnp.asarray, m),
                           jax.tree.map(jnp.asarray, v),
                           jnp.asarray(3, jnp.int32)))
    t = lambda tr: jax.tree.map(torch.as_tensor, tr)
    p_t, g_t = t(params), t(grads)
    opt = optim.OptState(t(m), t(v), torch.tensor(3, dtype=torch.int32))
    got_p, got_opt, got_met = optim.adamw_update(RunConfig(**rc), p_t, g_t,
                                                 opt)
    assert got_p is p_t                               # updated in place
    assert int(got_opt.step) == 4 == int(new_opt.step)
    for a, b in ((got_p, new_p), (got_opt.m, new_opt.m),
                 (got_opt.v, new_opt.v)):
        for x, y in zip(tree_leaves(a), _leaves_np(b)):
            np.testing.assert_allclose(x.numpy(), y, rtol=1e-6, atol=1e-9)
    for k in ("lr", "grad_norm"):
        assert float(got_met[k]) == pytest.approx(float(met[k]), rel=1e-6)


def test_softmax_xent_matches_the_reference():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(3, 7, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32)
    for m in (None, mask):
        want = float(ref_layers.softmax_xent(
            jnp.asarray(logits), jnp.asarray(labels),
            None if m is None else jnp.asarray(m)))
        got = float(layers.softmax_xent(
            torch.as_tensor(logits), torch.as_tensor(labels),
            None if m is None else torch.as_tensor(m)))
        assert got == pytest.approx(want, rel=1e-6)


_keys = st.text(alphabet="abcxyz_", min_size=1, max_size=4)
_trees = st.recursive(
    st.integers(0, 5).map(lambda n: np.arange(n, dtype=np.float32)),
    lambda sub: st.dictionaries(_keys, sub, min_size=1, max_size=4)
    | st.lists(sub, min_size=1, max_size=3), max_leaves=12)


@settings(max_examples=40, deadline=None)
@given(_trees)
def test_tree_flatten_is_jax_leaf_order(tree):
    leaves, treedef = tree_flatten(tree)
    want = jax.tree.leaves(tree)
    assert len(leaves) == len(want)
    assert all(a is b for a, b in zip(leaves, want))
    back = tree_unflatten(treedef, leaves)
    assert all(a is b for a, b in zip(jax.tree.leaves(back), want))


def test_checkpoint_roundtrip_buddy_restore_and_gc(tmp_path, ref_run):
    state = train_state_to_numpy(train_state_from_numpy(ref_run["init"],
                                                        "cpu"))
    assert all(np.array_equal(a, b) for a, b in zip(
        tree_leaves(state), _leaves_np(ref_run["init"])))
    ck = checkpoint.CheckpointStore(tmp_path / "a", n_shards=4)
    for s in range(4):
        ck.save_shard(7, s, checkpoint.shard_state(state, s, 4))
    ck.commit_epoch(7)
    assert ck.last_good_epoch() == 7
    for lost in ((), (2,)):     # node 2 lost: its shard's buddy on node 3
        shards = [ck.restore_shard(7, s, checkpoint.shard_state(state, s, 4),
                                   lost_nodes=lost) for s in range(4)]
        full = checkpoint.unshard_state(shards, state)
        for a, b in zip(tree_leaves(full), tree_leaves(state)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        ck.restore_shard(7, 2, checkpoint.shard_state(state, 2, 4),
                         lost_nodes=(2, 3))
    ck2 = checkpoint.CheckpointStore(tmp_path / "b", n_shards=2)
    for e in (1, 2, 3):
        for s in range(2):
            ck2.save_shard(e, s, checkpoint.shard_state(state, s, 2))
        ck2.commit_epoch(e)
    assert ck2.advance_ahm(3) == [1, 2]
    assert ck2.last_good_epoch() == 3


def test_each_package_restores_the_others_checkpoint(tmp_path, ref_run):
    ref_state = ref_run["init"]
    port_state = train_state_from_numpy(ref_state, "cpu")  # tensors
    ref_store = ref_ckpt.CheckpointStore(tmp_path / "ref", n_shards=2)
    port_store = checkpoint.CheckpointStore(tmp_path / "port", n_shards=2)
    for s in range(2):
        ref_store.save_shard(4, s, ref_ckpt.shard_state(ref_state, s, 2))
        port_store.save_shard(4, s, checkpoint.shard_state(port_state, s, 2))
    ref_store.commit_epoch(4)
    port_store.commit_epoch(4)
    template = train_state_to_numpy(port_state)
    # the port reads the reference's files, and the reference the port's
    for store, restore, shard, unshard, tmpl, tree_of in (
            (ref_store, checkpoint.CheckpointStore.restore_shard,
             checkpoint.shard_state, checkpoint.unshard_state, template,
             tree_leaves),
            (port_store, ref_ckpt.CheckpointStore.restore_shard,
             ref_ckpt.shard_state, ref_ckpt.unshard_state, ref_state,
             _leaves_np)):
        shards = [restore(store, 4, s, shard(tmpl, s, 2), lost_nodes=(0,))
                  for s in range(2)]
        full = unshard(shards, tmpl)
        got = tree_of(full)
        assert len(got) == len(_leaves_np(ref_state))
        for a, b in zip(got, _leaves_np(ref_state)):
            np.testing.assert_array_equal(a, b)
    back = train_state_from_numpy(template, "cpu")
    assert back["opt"].step.shape == () and back["opt"].step.dtype == \
        torch.int32


def test_fault_tolerance_matches_the_reference():
    rng = np.random.default_rng(4)
    grads = [{"w": rng.normal(0, 0.1, (16, 8)).astype(np.float32),
              "b": {"x": rng.normal(0, 2.0, (9,)).astype(np.float32)}}
             for _ in range(4)]
    for ranks in (grads, [grads[0], None, grads[2], grads[3]]):
        got, n = fault_tolerance.quorum_combine(ranks)
        want, m = ref_ft.quorum_combine(ranks)
        assert n == m
        for a, b in zip(tree_leaves(got), _leaves_np(want)):
            np.testing.assert_array_equal(a, b)
    for mod in (fault_tolerance, ref_ft):
        with pytest.raises(RuntimeError, match="quorum lost"):
            mod.quorum_combine([grads[0], None, None, None])
    p, s = fault_tolerance.compress_grads_int8(grads[1])
    rp, rs = ref_ft.compress_grads_int8(grads[1])
    assert s["s"] == rs["s"]
    assert all(np.array_equal(a, b) for a, b in zip(p["q"], rp["q"]))
    for a, b in zip(tree_leaves(fault_tolerance.decompress_grads_int8(p, s)),
                    _leaves_np(ref_ft.decompress_grads_int8(rp, rs))):
        np.testing.assert_array_equal(a, b)
    torch_grads = {"w": torch.as_tensor(grads[1]["w"]),
                   "b": {"x": torch.as_tensor(grads[1]["b"]["x"])}}
    tp, ts = fault_tolerance.compress_grads_int8(torch_grads)
    assert ts["s"] == rs["s"]
    for a, b in zip(tree_leaves(fault_tolerance.compressed_allreduce(grads)),
                    _leaves_np(ref_ft.compressed_allreduce(grads))):
        np.testing.assert_array_equal(a, b)
    batch = {"x": np.arange(64), "y": np.arange(64) * 2}
    sims = fault_tolerance.DPSimulator(4), ref_ft.DPSimulator(4)
    for step in (None, 2, 0):
        if step is not None:
            for sim in sims:
                sim.fail(step)
        got, want = (sim.split_batch(batch) for sim in sims)
        assert sims[0].n_up == sims[1].n_up
        for a, b in zip(got, want):
            assert (a is None) == (b is None)
            if a is not None:
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k])


def test_token_store_batches_are_the_references_and_pin_the_epoch():
    rows = token_corpus(16, 65, 100, seed=0)
    want_rows = ref_token_corpus(16, 65, 100, seed=0)
    for k in want_rows:
        np.testing.assert_array_equal(rows[k], want_rows[k])
    np.testing.assert_array_equal(
        zipf_tokens(np.random.default_rng(3), 50, 30),
        ref_zipf_tokens(np.random.default_rng(3), 50, 30))
    port = TokenStore.create(n_nodes=2, block_rows=128, device="cpu")
    ref = RefTokenStore.create(n_nodes=2, block_rows=128)
    e1, r1 = port.ingest(rows), ref.ingest(want_rows)
    assert e1 == r1
    assert port.storage_stats() == pytest.approx(ref.storage_stats())
    b1 = list(port.batches(2, 16, as_of=e1, seed=0))
    rb = list(ref.batches(2, 16, as_of=r1, seed=0))
    assert len(b1) == len(rb) > 0
    for x, y in zip(b1, rb):
        for k in ("tokens", "labels"):
            assert x[k].dtype == np.int32
            np.testing.assert_array_equal(x[k], y[k])
    shard = list(port.shard_batches(1, 3, 2, 16, as_of=e1, seed=0))
    want_shard = list(ref.shard_batches(1, 3, 2, 16, as_of=r1, seed=0))
    assert len(shard) == len(want_shard)
    for x, y in zip(shard, want_shard):
        np.testing.assert_array_equal(x["tokens"], y["tokens"])
    # more data later; the epoch-e1 stream is bit for bit the same
    port.ingest(token_corpus(16, 65, 100, seed=9))
    b2 = list(port.batches(2, 16, as_of=e1, seed=0))
    assert len(b1) == len(b2)
    for x, y in zip(b1, b2):
        np.testing.assert_array_equal(x["tokens"], y["tokens"])
    assert port.n_tokens() == 2 * port.n_tokens(as_of=e1)


def test_train_checkpoint_resume_bit_identical(tmp_path):
    """tests/test_integration.py's check on the port: a crash after step
    5, a buddy restore with node 0 lost and a replay end in the state of
    a straight run, bit for bit."""
    cfg = ArchConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                     n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
                     head_dim=16)
    model = build_model(cfg, tp=1, device="cpu")
    step = make_train_step(model, RunConfig(total_steps=20, warmup_steps=2))
    store = TokenStore.create(n_nodes=2, block_rows=256, device="cpu")
    epoch = store.ingest(token_corpus(32, 65, cfg.vocab_size, seed=0))
    batches = [{k: torch.as_tensor(v) for k, v in b.items()}
               for b in list(store.batches(4, 32, as_of=epoch, seed=0))[:10]]

    state = init_train_state(model, seed=0)
    for b in batches:
        state, _ = step(state, b)
    final_a = train_state_to_numpy(state)

    state = init_train_state(model, seed=0)
    ck = checkpoint.CheckpointStore(tmp_path, n_shards=2)
    for b in batches[:5]:
        state, _ = step(state, b)
    np_state = train_state_to_numpy(state)
    for s in range(2):
        ck.save_shard(5, s, checkpoint.shard_state(np_state, s, 2))
    ck.commit_epoch(5)
    del state
    shards = [ck.restore_shard(5, s, checkpoint.shard_state(np_state, s, 2),
                               lost_nodes=(0,)) for s in range(2)]
    state = train_state_from_numpy(
        checkpoint.unshard_state(shards, np_state), "cpu")
    for b in batches[5:]:
        state, _ = step(state, b)
    final_b = train_state_to_numpy(state)
    for a, b in zip(tree_leaves(final_a), tree_leaves(final_b)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_launch_train_replays_a_failure_bit_for_bit(tmp_path, capsys):
    """``python -m repro_torch.launch.train --device cpu``: a run with
    ``--fail-at-step`` (node 1 lost, buddy restore from the last good
    epoch, replay) ends with the final checkpoint of a straight run."""
    args = ["--device", "cpu", "--d-model", "64", "--layers", "2",
            "--vocab", "256", "--steps", "8", "--batch", "4", "--seq", "32",
            "--ckpt-every", "3", "--n-docs", "16", "--doc-len", "65"]
    straight = train_launch.main(args + ["--ckpt-dir", str(tmp_path / "a")])
    failed = train_launch.main(args + ["--ckpt-dir", str(tmp_path / "b"),
                                       "--fail-at-step", "5"])
    out = capsys.readouterr().out
    assert "recovered from LGE 3, replaying" in out
    assert len(straight) == 8 and len(failed) == 8 + 2     # 4, 5 replayed
    assert all(np.isfinite(straight))
    assert failed[-1] == straight[-1]
    for s in range(4):
        files = [np.load(tmp_path / run / "custom-2L-64d" / "epoch_00000008" /
                         f"node_{s}" / f"primary_shard_{s}" / "state.npz")
                 for run in ("a", "b")]
        assert sorted(files[0]) == sorted(files[1])
        for key in files[0]:
            np.testing.assert_array_equal(files[0][key], files[1][key])
    assert ops.launch_counts()["flash_attention_bwd"] == 0   # the CPU
