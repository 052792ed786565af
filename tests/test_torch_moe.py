"""The port's MoE layer (``repro_torch.models.moe``) and the MoE family's
training loss against the reference's, on the CPU.

Each case carries the reference's own weights across and feeds both
packages the same seeded numpy inputs, on the reduced olmoe-1b-7b config
(d 64, 4 experts, top 2, expert width 64).  The reference's functions are
compiled with XLA's excess precision off, so it rounds every bf16 op as
written, as PyTorch does: with it on, a router logit may differ by one
bf16 ulp and flip a near-tie in top-k, which moves that token's whole
output.

Tolerances:
* ``_route`` in f32: the experts chosen exactly, ties included (the lower
  expert index first, as ``jax.lax.top_k``); gates and the aux loss
  within ``F32_RTOL``, four f32 ulps.  Bit for bit is out of reach in
  f32: XLA's CPU ``exp`` and its sum over the experts round differently
  from PyTorch's (measured here: one ulp in 419 of 4,096 exps and 39 of
  64 sums, on logits that were equal), and so does an f32 product's
  summation order.
* ``_moe_apply_scatter`` in bf16: within 2 bf16 ulps of the larger
  magnitude (the expert products' summation order differs between XLA's
  CPU dots and PyTorch's); in f32 within 1e-5; the aux loss within
  ``F32_RTOL``.
* ``Model.loss`` and its gradients: the loss within ``LOSS_TOL`` nats and
  every gradient leaf within ``GRAD_TOL`` times the leaf's largest
  reference element, as tests/test_torch_train.py holds the dense family
  (the port's training attention keeps P.V in f32 where ``attend_full``
  casts P to bf16).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import build_model as ref_build_model
from repro.models import moe as ref_moe
from repro_torch import configs
from repro_torch.models import attention as attn
from repro_torch.models import build_model, layers, moe, transformer
from repro_torch.models.carry import params_from_numpy, tensor_from_numpy
from repro_torch.models.transformer import run_decoder
from repro_torch.train.train_step import loss_and_grads
from repro_torch.train.tree import tree_leaves
from test_torch_models import _close
from test_torch_train import stack_grads

ARCH = "olmoe-1b-7b"
LOSS_TOL, GRAD_TOL = 5e-3, 5e-2
F32_RTOL = 1e-5
EXACT = {"xla_allow_excess_precision": False}


def _np_params(decls, seed=0):
    """Seeded f32 weights for the reference's declarations, drawn with
    numpy (the reference's own ``init_params`` takes seconds eagerly),
    at the reference's scales."""
    rng = np.random.default_rng(seed)

    def one(d):
        if isinstance(d, dict):
            return {k: one(v) for k, v in d.items()}
        if d.init in ("ones", "zeros"):
            return getattr(np, d.init)(d.shape, np.float32)
        std = 0.02 if d.init == "embed" else \
            max(1, int(np.prod(d.shape[:-1]))) ** -0.5
        return (rng.normal(size=d.shape) * std).astype(np.float32)
    return one(decls)


def _exact(fn, *args):
    """``fn(*args)`` compiled with XLA's excess precision off."""
    return jax.jit(fn).lower(*args).compile(compiler_options=EXACT)(*args)


def _cfgs(**moe_kw):
    ref = ref_configs.get(ARCH).reduced()
    port = configs.get(ARCH).reduced()
    if moe_kw:
        ref = dataclasses.replace(ref, moe=dataclasses.replace(ref.moe,
                                                               **moe_kw))
        port = dataclasses.replace(port, moe=dataclasses.replace(port.moe,
                                                                 **moe_kw))
    return ref, port


@pytest.fixture(scope="module")
def layer():
    """Seeded f32 weights (numpy) for the reduced MoE layer, whose
    declarations are the reference's."""
    ref, port = _cfgs()
    decls = ref_moe.moe_decls(ref.d_model, ref.moe)
    assert {k: dataclasses.astuple(d) for k, d in decls.items()} == {
        k: dataclasses.astuple(d)
        for k, d in moe.moe_decls(port.d_model, port.moe).items()}
    return _np_params(decls)


def _x(n, d, dtype, seed=1):
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    j = jnp.asarray(x, dtype)
    return j, tensor_from_numpy(np.asarray(j), "cpu")


@pytest.mark.parametrize("experts,top_k", [(4, 2), (64, 8)])
def test_route_matches_the_reference_in_f32_ties_included(experts, top_k):
    """The reduced config's router (4 experts, top 2) and olmoe's
    published one (64, top 8) at d 64, on 64 tokens.  Rows 0-3 are zero,
    so every probability ties; experts 1 and 2 share a router column, so
    they tie on every row."""
    m = dataclasses.replace(configs.get(ARCH).moe, num_experts=experts,
                            top_k=top_k)
    ref_m = dataclasses.replace(ref_configs.get(ARCH).moe,
                                num_experts=experts, top_k=top_k)
    p = _np_params(ref_moe.moe_decls(64, ref_m))
    x, tx = _x(64, 64, jnp.float32)
    x = x.at[:4].set(0.0)
    tx[:4] = 0.0
    router = np.array(p["router"])
    router[:, 1] = router[:, 2]
    p = {"router": router}
    want = _exact(lambda p, x: ref_moe._route(p, x, ref_m), p, x)
    gates, chosen, aux = moe._route(params_from_numpy(p, "cpu",
                                                      torch.float32), tx, m)
    np.testing.assert_array_equal(chosen.numpy(), np.asarray(want[1]))
    assert chosen[:4].tolist() == [list(range(top_k))] * 4
    np.testing.assert_allclose(gates.numpy(), np.asarray(want[0]),
                               rtol=F32_RTOL, atol=0)
    np.testing.assert_allclose(aux.numpy(), np.asarray(want[2]),
                               rtol=F32_RTOL, atol=0)


def test_route_ties_take_the_lower_index_where_torch_topk_does_not():
    """16 equal probabilities: ``jax.lax.top_k`` takes experts 0-7; the
    port must too (``torch.topk`` returned 12, 9, 10, ... here)."""
    m = dataclasses.replace(configs.get(ARCH).moe, num_experts=16)
    p = {"router": torch.zeros(8, 16)}
    gates, experts, _ = moe._route(p, torch.ones(3, 8), m)
    want = jax.lax.top_k(jnp.full((3, 16), 1 / 16, jnp.float32), 8)[1]
    np.testing.assert_array_equal(experts.numpy(), np.asarray(want))
    assert torch.equal(gates, torch.full((3, 8), 1 / 8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity_factor", [0.5, 1.25])
def test_moe_apply_scatter_matches_the_reference(layer, dtype,
                                                 capacity_factor):
    """64 tokens over 4 experts, top 2: at the published capacity factor
    (1.25, 40 slots an expert) and at 0.5 (16 slots), where pairs are
    dropped: each dropped pair's zero must leave the kept token in slot
    cap - 1 as it was."""
    ref, port = _cfgs(capacity_factor=capacity_factor)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    x, tx = _x(64, port.d_model, jdt, seed=2)
    x, tx = x.reshape(2, 32, -1), tx.reshape(2, 32, -1)
    p = jax.tree.map(lambda a: jnp.asarray(a, jdt), layer)
    want, want_aux = _exact(
        lambda p, x: ref_moe._moe_apply_scatter(p, x, ref.moe), p, x)
    tp = params_from_numpy(layer, "cpu", getattr(torch, dtype))
    got, aux = moe.moe_apply(tp, tx, port.moe)
    _close(got, want, dtype)
    np.testing.assert_allclose(aux.numpy(), np.asarray(want_aux),
                               rtol=F32_RTOL, atol=0)
    cap = moe.capacity(64, port.moe)
    assert cap == max(4, int(np.ceil(64 * 2 * capacity_factor / 4)))
    _, experts, _ = moe._route(tp, tx.reshape(64, -1), port.moe)
    _, keep = moe.dispatch_plan(experts, port.moe, cap)
    dropped = int((~keep).sum())
    if capacity_factor < 1:
        assert dropped > 0                  # the case this test is for
    else:
        assert dropped == 0


def test_capacity_is_the_references():
    m = configs.get(ARCH).moe
    for n in (1, 4, 7, 64, 2048, 4096):
        want = max(4, int(np.ceil(n * m.top_k * m.capacity_factor
                                  / m.num_experts)))
        assert moe.capacity(n, m) == want
    assert moe.capacity(2048, m) == 320          # a 4 x 512 prefill


def test_moe_family_loss_and_gradients_match_the_reference(monkeypatch):
    """Reduced olmoe from the reference's f32 weights: the loss (cross
    entropy plus both layers' load-balance losses) and every gradient
    leaf, against ``jax.value_and_grad`` of the reference's loss.  The
    port's training attention (the flash contract, P.V in f32) moves the
    router's inputs by an ulp, which flips near-ties in top-k: with it
    the loss stays within ``LOSS_TOL``, but single gradient elements of
    the expert weights moved by up to 30 % of their leaf's largest here.
    So the gradients are held with the reference's attention route
    (``attend_full``) swapped in, where the loss is bit for bit the
    reference's."""
    ref_cfg, cfg = _cfgs()
    ref_model = ref_build_model(ref_cfg, tp=1)
    ref_params = _np_params(ref_model.decls)
    tok = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 33)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    loss, grads = _exact(jax.value_and_grad(ref_model.loss), ref_params,
                         {k: jnp.asarray(v) for k, v in batch.items()})
    model = build_model(cfg, tp=1, device="cpu")
    params = model.load_params(params_from_numpy(ref_params, "cpu",
                                                 torch.float32))
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    with torch.no_grad():
        assert abs(float(model.loss(params, tbatch)) - float(loss)) \
            <= LOSS_TOL
        # the aux term is large enough that leaving it out would show
        x = layers.embed_lookup(params, tbatch["tokens"], torch.bfloat16)
        _, _, aux = run_decoder(cfg, 1, params, x, mode="train",
                                positions=torch.arange(32).expand(2, 32))
        assert float(aux) > 4 * LOSS_TOL

    def plain(q, k, v, causal=True):
        pos = torch.arange(q.shape[1])
        return attn.attend_full(q, k, v, pos, pos, causal=causal,
                                window=None)
    monkeypatch.setattr(transformer, "flash_train", plain)
    got_loss, got = loss_and_grads(model, params, tbatch)
    assert float(got_loss) == float(loss)
    want = [np.asarray(w) for w in jax.tree.leaves(grads)]
    got = tree_leaves(stack_grads(model, params, got))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max())
