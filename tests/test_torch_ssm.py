"""The port's SSD mixer (``repro_torch.models.ssm``) and the SSM and hybrid
families' training loss against the reference's, on the CPU.

Module cases run on the reduced mamba2-130m config's layout (d 64, 8 heads
of P 16, N 16, chunk 32) with seeded numpy weights and inputs; the
leaves the reference initialises to ones or zeros (``A_log``, ``D``,
``norm``, ``dt_bias``) are drawn around those values instead, so every
term of the recurrence is exercised.  At tp = 3 the 8 heads pad to 9: the
dead head is masked by ``_finish`` and sent to group 0.

Tolerances:
* ``softplus`` against ``jax.nn.softplus`` on an f32 grid: within
  ``SOFTPLUS_ULPS`` f32 ulps, and bit for bit from 20 up, where
  ``torch.nn.functional.softplus`` switches to ``x``.  Both compute
  max(x, 0) + log1p(exp(-|x|)), but XLA's CPU ``exp`` and ``log1p``
  round differently from PyTorch's in about one point in twenty (each
  within an ulp; tests/test_torch_moe.py measures the same of ``exp``),
  and the composition moves the result by up to 3 ulps on this grid;
  where the result is subnormal XLA flushes it to zero.
* ``_causal_conv``, ``_conv_step``, ``_project``, ``_finish``: f32 within
  1e-5, bf16 within 2 ulps (``test_torch_models._close``).
* ``ssd_apply`` against the reference's and against the port's own
  sequential ``ssd_reference``, f32 inputs of shape (2, 96, 64): within
  1e-4, the reference's own bound (tests/test_models.py).
* ``ssm_decode_step`` on a carried cache, three steps: the state within
  rtol 1e-5, the conv rings bit for bit, the output within 2 bf16 ulps,
  and the cache written in place.
* The families' loss and every gradient leaf against
  ``jax.value_and_grad`` of the reference's loss (XLA's excess precision
  off), within ``LOSS_TOL`` nats and ``GRAD_TOL`` times the leaf's
  largest element, as tests/test_torch_moe.py holds the MoE family;
  hymba's ``ln_ssm``, declared and never read, has a zero gradient in
  both packages.  One kind of leaf is noisier than that in both: ``D``,
  whose gradient sums dy * x over (batch, sequence, head dim) terms that
  cancel to a tenth of their size.  On hymba's windowed layers both
  packages' bf16 values sit 7-8 % of the leaf's largest element from the
  same model's gradient with f32 activations, and 9 % from each other.
  So a ``D`` leaf is held within ``GRAD_TOL`` plus the reference's own
  gap between its bf16 and its f32-activation gradient, measured in the
  same test: the allowance comes from the reference, not from the port.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import build_model as ref_build_model
from repro.models import model as ref_model_module
from repro.models import ssm as ref_ssm
from repro_torch import configs
from repro_torch.models import build_model, ssm
from repro_torch.models.carry import params_from_numpy, tensor_from_numpy
from repro_torch.models.transformer import segments
from repro_torch.train.train_step import loss_and_grads
from test_torch_models import JDT, _close
from test_torch_moe import GRAD_TOL, LOSS_TOL, _exact, _np_params
from test_torch_train import stack_grads

SOFTPLUS_ULPS = 4
CFG = configs.get("mamba2-130m").reduced()
REF_CFG = ref_configs.get("mamba2-130m").reduced()


def _layout(tp):
    lo = ssm.resolve_ssm_layout(CFG.d_model, CFG.ssm, tp)
    assert dataclasses.astuple(lo) == dataclasses.astuple(
        ref_ssm.resolve_ssm_layout(REF_CFG.d_model, REF_CFG.ssm, tp))
    return lo


def _weights(lo, seed=0):
    """Seeded f32 weights for ``ssm_decls``; the leaves declared as ones or
    zeros drawn around them."""
    decls = ref_ssm.ssm_decls(CFG.d_model, lo)
    assert {k: dataclasses.astuple(d) for k, d in decls.items()} == {
        k: dataclasses.astuple(d)
        for k, d in ssm.ssm_decls(CFG.d_model, lo).items()}
    p = _np_params(decls, seed)
    rng = np.random.default_rng(seed + 100)
    for name, mean, std in (("dt_bias", 0.0, 0.5), ("A_log", 0.0, 0.5),
                            ("D", 1.0, 0.3), ("norm", 1.0, 0.3)):
        p[name] = (mean + std * rng.normal(size=p[name].shape)
                   ).astype(np.float32)
    return p


def _both(p, dtype):
    """``p`` as the reference's arrays and the port's tensors of dtype."""
    ref = jax.tree.map(lambda a: jnp.asarray(a, JDT[dtype]), p)
    return ref, params_from_numpy(p, "cpu", getattr(torch, dtype))


def _arr(rng, shape, dtype, scale=1.0):
    j = jnp.asarray(rng.normal(size=shape) * scale, JDT[dtype])
    return j, tensor_from_numpy(np.asarray(j), "cpu")


# --------------------------------------------------------------- softplus --

def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def test_softplus_is_jax_nn_softplus():
    x = np.concatenate([np.linspace(-40, 40, 200_001, dtype=np.float32),
                        np.float32([0.0, -0.0, 1e-8, -1e-8, 20.0, 20.5,
                                    -20.5, 88.0, -88.0, 1e4, -1e4])])
    want = np.asarray(jax.jit(jax.nn.softplus)(jnp.asarray(x)))
    # PyTorch 2.13's CPU exp on an AVX-512 host: the first multi-threaded
    # call of a process gave one thread's chunk up to 1.5e-4 off (2 of 20
    # fresh processes; later calls exact), so the grid is read after one
    # call
    ssm.softplus(torch.from_numpy(x))
    got = ssm.softplus(torch.from_numpy(x)).numpy()
    # XLA's CPU backend flushes subnormal results to zero (x <= -87.4)
    tiny = np.finfo(np.float32).tiny
    normal = want >= tiny
    assert _ulps(got[normal], want[normal]).max() <= SOFTPLUS_ULPS
    assert (got[~normal] < tiny).all() and (want[~normal] == 0).all()
    big = x >= 20
    np.testing.assert_array_equal(got[big], want[big])
    assert np.isfinite(got).all() and (got >= 0).all()


# ------------------------------------------------------------ the pieces --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_conv_step_and_project(dtype):
    lo = _layout(1)
    p, tp = _both(_weights(lo), dtype)
    rng = np.random.default_rng(1)
    u, tu = _arr(rng, (2, 11, CFG.d_model), dtype)
    want = ref_ssm._project(p, u, lo)
    got = ssm._project(tp, tu, lo)
    for g, w in zip(got, want):
        _close(g, w, dtype)
    x, tx = want[1], got[1]
    _close(ssm._causal_conv(tx, tp["conv_x"]),
           ref_ssm._causal_conv(x, p["conv_x"]), dtype)
    ring, tring = _arr(rng, (2, lo.d_conv, lo.h_eff, lo.head_dim), dtype)
    w_ring, w_out = ref_ssm._conv_step(ring, x[:, 0], p["conv_x"])
    g_ring, g_out = ssm._conv_step(tring, tx[:, 0], tp["conv_x"])
    np.testing.assert_array_equal(g_ring.to(torch.float32).numpy(),
                                  np.asarray(w_ring, np.float32))
    _close(g_out, w_out, dtype)


@pytest.mark.parametrize("tp", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_finish_masks_dead_heads(tp, dtype):
    """At tp = 3 head 8 is dead: whatever y, x and z hold there, it adds
    nothing to the output."""
    lo = _layout(tp)
    assert lo.h_eff == (9 if tp == 3 else 8)
    p, tpp = _both(_weights(lo), dtype)
    rng = np.random.default_rng(2)
    y, x, z = (_arr(rng, (2, 5, lo.h_eff, lo.head_dim), dtype)
               for _ in range(3))
    got = ssm._finish(tpp, y[1], x[1], z[1], lo)
    _close(got, ref_ssm._finish(p, y[0], x[0], z[0], lo), dtype)
    if tp == 3:
        y2 = y[1].clone()
        y2[:, :, 8] = 1e3
        assert torch.equal(ssm._finish(tpp, y2, x[1], z[1], lo), got)
    np.testing.assert_array_equal(ssm._head_groups(lo).numpy(),
                                  np.asarray(ref_ssm._head_groups(lo)))
    # one group: the reference's gather is the port's broadcast
    assert not ssm._head_groups(lo).any()


# --------------------------------------------------------------- ssd_apply --

def _ref_ssd(p, u, lo, **kw):
    return jax.jit(partial(ref_ssm.ssd_apply, lo=lo, chunk=CFG.ssm.chunk,
                           **kw))(p, u)


@pytest.mark.parametrize("tp,S", [(1, 96), (1, 33), (3, 96)])
def test_ssd_apply_matches_the_reference_and_the_sequential_oracle(tp, S):
    """(2, 96, 64) in f32 over three chunks of 32; S = 33 pads to 64 (dt
    zeroed on the padding, so the state is that of 33 tokens); at tp = 3
    with a dead head.  Output and final state against the reference's,
    the output against the port's sequential oracle too."""
    lo = _layout(tp)
    p, tpp = _both(_weights(lo, seed=tp), "float32")
    u, tu = _arr(np.random.default_rng(3), (2, S, CFG.d_model), "float32")
    want, want_s = _ref_ssd(p, u, lo, return_state=True)
    got, got_s = ssm.ssd_apply(tpp, tu, lo, CFG.ssm.chunk, return_state=True)
    assert tuple(got_s.shape) == (2, lo.h_eff, lo.d_state, lo.head_dim)
    assert got_s.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=0,
                               atol=1e-4)
    seq = ssm.ssd_reference(tpp, tu, lo)
    assert float((got - seq).abs().max()) < 1e-4


def test_ssd_apply_state_handoff_through_initial_state():
    """A random initial state against the reference's; and with the conv
    reduced to its current tap (no look-back across the cut), two halves
    handed over through ``initial_state`` equal one pass, output and
    state."""
    lo = _layout(1)
    w = _weights(lo, seed=4)
    p, tpp = _both(w, "float32")
    rng = np.random.default_rng(5)
    u, tu = _arr(rng, (2, 96, CFG.d_model), "float32")
    s0, ts0 = _arr(rng, (2, lo.h_eff, lo.d_state, lo.head_dim), "float32")
    want = _ref_ssd(p, u, lo, initial_state=s0)
    got = ssm.ssd_apply(tpp, tu, lo, CFG.ssm.chunk, initial_state=ts0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    for name in ("conv_x", "conv_B", "conv_C"):
        w[name][:-1] = 0.0
    _, tpp = _both(w, "float32")
    whole, s_whole = ssm.ssd_apply(tpp, tu, lo, CFG.ssm.chunk,
                                   return_state=True)
    first, s1 = ssm.ssd_apply(tpp, tu[:, :64], lo, CFG.ssm.chunk,
                              return_state=True)
    second, s2 = ssm.ssd_apply(tpp, tu[:, 64:], lo, CFG.ssm.chunk,
                               initial_state=s1, return_state=True)
    torch.testing.assert_close(torch.cat([first, second], 1), whole,
                               rtol=0, atol=1e-4)
    torch.testing.assert_close(s2, s_whole, rtol=0, atol=1e-4)


# ---------------------------------------------------------------- decode --

def test_ssm_decode_step_writes_the_carried_cache_in_place():
    """Three steps from a random bf16 cache (f32 state), bf16 weights and
    tokens: the port's cache leaves stay the same tensors (same storage)
    and hold the reference's returned cache after every step."""
    lo = _layout(1)
    p, tpp = _both(_weights(lo, seed=6), "bfloat16")
    rng = np.random.default_rng(7)
    shapes = ssm.ssm_cache_shapes(2, lo)
    assert shapes == ref_ssm.ssm_cache_shapes(2, lo)
    cache, tcache = {}, {}
    for name, (shape, _) in shapes.items():
        dt = "float32" if name == "state" else "bfloat16"
        cache[name], tcache[name] = _arr(rng, shape, dt, 0.5)
    ptrs = {k: t.data_ptr() for k, t in tcache.items()}
    for _ in range(3):
        u, tu = _arr(rng, (2, 1, CFG.d_model), "bfloat16")
        want, cache = ref_ssm.ssm_decode_step(p, cache, u, lo)
        got, out_cache = ssm.ssm_decode_step(tpp, tcache, tu, lo)
        assert out_cache is tcache
        assert {k: t.data_ptr() for k, t in tcache.items()} == ptrs
        _close(got, want, "bfloat16")
        np.testing.assert_allclose(tcache["state"].numpy(),
                                   np.asarray(cache["state"]), rtol=1e-5,
                                   atol=1e-7)
        for name in ("conv_x", "conv_B", "conv_C"):
            np.testing.assert_array_equal(
                tcache[name].to(torch.float32).numpy(),
                np.asarray(cache[name], np.float32))


# ----------------------------------------------- the families' training --

def _paths(tree, prefix=""):
    """(path, leaf) pairs of a nested dict, in sorted key order (jax's)."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _paths(tree[k], f"{prefix}{k}/")
        else:
            yield prefix + k, tree[k]


@pytest.mark.parametrize("arch", ["mamba2-130m", "hymba-1.5b"])
def test_ssm_and_hybrid_loss_and_gradients_match_the_reference(
        arch, monkeypatch):
    """The reduced configs from the reference's f32 weights (hymba: window
    16, global layer 0, so both attention routes train): the loss and
    every gradient leaf.  Hymba's hybrid blocks declare ``ln_ssm`` and
    normalise with ``ln1``; its gradient is exactly zero in both
    packages, and the port's training step does not raise on it."""
    ref_model = ref_build_model(ref_configs.get(arch).reduced(), tp=1)
    cfg = configs.get(arch).reduced()
    ref_params = _np_params(ref_model.decls)
    tok = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 41)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = _exact(jax.value_and_grad(ref_model.loss), ref_params,
                         jbatch)
    # the reference's gradient with f32 activations, for ``D``'s allowance
    with monkeypatch.context() as m:
        m.setattr(ref_model_module, "CACHE_DTYPE", jnp.float32)
        grads32 = _exact(jax.grad(ref_model.loss), ref_params, jbatch)
    model = build_model(cfg, tp=1, device="cpu")
    params = model.load_params(params_from_numpy(ref_params, "cpu",
                                                 torch.float32))
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    got_loss, got = loss_and_grads(model, params, tbatch)
    assert abs(float(got_loss) - float(loss)) <= LOSS_TOL
    tree = stack_grads(model, params, got)
    names = [p for p, _ in _paths(grads)]
    want, want32 = ([np.asarray(w) for _, w in _paths(x)]
                    for x in (grads, grads32))
    got = [t for _, t in _paths(tree)]
    assert len(got) == len(want) == len(want32)
    for name, g, w, w32 in zip(names, got, want, want32):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        atol = GRAD_TOL * np.abs(w).max()
        if name.endswith("ssm/D"):
            atol += float(np.abs(w - w32).max())
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=atol,
                                   err_msg=name)
    unused = cfg.family == "hybrid"
    for seg in segments(cfg):
        assert (float(jnp.abs(grads[seg.name]["ln_ssm"]).max()) == 0) \
            == unused
        assert (float(tree[seg.name]["ln_ssm"].abs().max()) == 0) == unused
