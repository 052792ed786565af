"""Training the port's enc-dec (seamless-m4t-medium) and VLM
(llama-3.2-vision-11b) families against the reference's, on the CPU.

Reduced configs: seamless (2 bidirectional encoder layers over 24 frames,
2 decoder layers each with a cross branch) and the VLM at 2 groups of 2
self layers and 1 cross layer over its 16 image embeddings (the reduced
config's 1 group of 1 + 1 cannot reach the second level of its doubly
stacked parameters).  Seeded f32 numpy weights at the reference's scales
cross to both packages, with every ``cross/gate`` leaf opened to 1.0: the
gate is declared zero, and ``tanh(0)`` would leave the cross weights and
seamless's whole encoder with zero gradients, so the comparison would
hold nothing of them.  One jitted reference gradient per family, compiled
with XLA's excess precision off, is shared by the tests
(``tests/test_torch_moe.py:_exact``).

Tolerances (both packages compute in bf16 from f32 master weights):
* loss: ``LOSS_TOL`` nats (``tests/test_torch_moe.py``).
* every gradient leaf: ``GRAD_TOL`` times the leaf's largest reference
  element (the leaves other than the gates use at most 0.52 of it).
* the ``cross/gate`` leaves, one scalar a layer, each the sum over every
  position of the branch's output times the loss's gradient: also the
  reference's own gap between its gradients with bf16 and with f32
  activations (``CACHE_DTYPE`` patched), as ``tests/test_torch_ssm.py``
  allows for ``ssm/D``.  The port's attention keeps P.V in f32 (the flash
  contract) where ``attend_full`` casts P to bf16, and the sum carries
  that noise: seamless's gates use 1.67x ``GRAD_TOL`` alone, 0.64 of the
  limit with the gap.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import build_model as ref_build_model
from repro.models import model as ref_model_module
from repro_torch import configs
from repro_torch.configs.base import RunConfig
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.models.carry import params_from_numpy, tensor_from_numpy
from repro_torch.train.train_step import (loss_and_grads, make_train_step,
                                          stack_layers,
                                          train_state_from_numpy)
from test_torch_crossattn import _open_gates
from test_torch_moe import GRAD_TOL, LOSS_TOL, _exact, _np_params
from test_torch_ssm import _paths

CASES = {"seamless": ("seamless-m4t-medium", {}),
         "vlm-2x3": ("llama-3.2-vision-11b",
                     {"n_layers": 6, "cross_attn_every": 3})}
B, S, ENC_LEN = 2, 16, 24


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """One family: both models, the opened f32 weights in both packages, a
    batch with its memory, and the reference's loss and gradients with
    bf16 activations (as it trains) and with f32 activations."""
    arch, kw = CASES[request.param]
    ref_cfg = dataclasses.replace(ref_configs.get(arch).reduced(), **kw)
    cfg = dataclasses.replace(configs.get(arch).reduced(), **kw)
    ref_model = ref_build_model(ref_cfg, tp=1)
    model = build_model(cfg, tp=1, device="cpu")
    np_params = _open_gates(_np_params(ref_model.decls, seed=2))
    rng = np.random.default_rng(9)
    tok = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    T = ENC_LEN if cfg.family == "audio" else cfg.n_frontend_tokens
    mem = np.asarray(jnp.asarray(rng.normal(size=(B, T, cfg.d_model)),
                                 jnp.bfloat16))
    key = model.memory_key
    jbatch = {"tokens": jnp.asarray(tok[:, :-1]),
              "labels": jnp.asarray(tok[:, 1:]), key: jnp.asarray(mem)}
    ref_params = jax.tree.map(jnp.asarray, np_params)
    loss, grads = _exact(jax.value_and_grad(ref_model.loss), ref_params,
                         jbatch)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(ref_model_module, "CACHE_DTYPE", jnp.float32)
        grads32 = _exact(jax.grad(ref_model.loss), ref_params, jbatch)
    finally:
        mp.undo()
    batch = {"tokens": torch.from_numpy(tok[:, :-1]),
             "labels": torch.from_numpy(tok[:, 1:]),
             key: tensor_from_numpy(mem, "cpu")}
    return dict(name=request.param, cfg=cfg, model=model,
                np_params=np_params, batch=batch, loss=float(loss),
                grads=jax.tree.map(np.asarray, grads),
                grads32=jax.tree.map(np.asarray, grads32))


def _params(c):
    return c["model"].load_params(params_from_numpy(c["np_params"], "cpu",
                                                    torch.float32))


def _flash_calls(monkeypatch):
    """Counts ``ops.flash_attention_train`` calls by ``causal``."""
    calls = {True: 0, False: 0}
    inner = ops.flash_attention_train

    def counted(q, k, v, *, causal=True):
        calls[causal] += 1
        return inner(q, k, v, causal=causal)
    monkeypatch.setattr(ops, "flash_attention_train", counted)
    return calls


def test_loss_takes_the_train_route_and_matches_the_reference(
        case, monkeypatch):
    """The loss within ``LOSS_TOL``; every attention over full context
    goes through the flash kernel's autograd route in train mode, the
    encoder's and the cross layers' with ``causal=False``."""
    cfg, model = case["cfg"], case["model"]
    calls = _flash_calls(monkeypatch)
    loss = model.loss(_params(case), case["batch"])
    assert abs(float(loss) - case["loss"]) <= LOSS_TOL
    if cfg.family == "audio":
        want = {True: cfg.n_layers,
                False: cfg.n_encoder_layers + cfg.n_layers}
    else:
        groups = cfg.n_layers // cfg.cross_attn_every
        want = {True: groups * (cfg.cross_attn_every - 1), False: groups}
    assert calls == want


def test_every_gradient_leaf_matches_the_reference(case):
    """Every leaf of the stacked gradient tree (f32, the parameters'
    shapes) within ``GRAD_TOL`` of its largest reference element; a
    ``cross/gate`` leaf also within the reference's own
    bf16-vs-f32-activation gap of that leaf."""
    model = case["model"]
    params = _params(case)
    _, got = loss_and_grads(model, params, case["batch"])
    tree = stack_layers(model, params, got)
    names = [p for p, _ in _paths(case["grads"])]
    want = [w for _, w in _paths(case["grads"])]
    want32 = [w for _, w in _paths(case["grads32"])]
    got = [t for _, t in _paths(tree)]
    assert names == [p for p, _ in _paths(tree)]
    for name, g, w, w32 in zip(names, got, want, want32):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        atol = GRAD_TOL * np.abs(w).max()
        if name.endswith("cross/gate"):
            atol += float(np.abs(w - w32).max())
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=atol,
                                   err_msg=name)


def test_memory_side_gradients_are_non_zero_and_adamw_steps(case):
    """With the gates open the memory's side trains: seamless's encoder
    and ``frontend_proj`` and every cross layer's wq, wk and wv have
    non-zero gradients in both packages, and one AdamW step of the port's
    train step (on per-layer views of the encoder and the groups) gives
    them non-zero first moments and a finite loss."""
    cfg, model = case["cfg"], case["model"]
    params = _params(case)
    _, got = loss_and_grads(model, params, case["batch"])
    tree = stack_layers(model, params, got)
    cross = "layers" if cfg.family == "audio" else "groups_cross"
    leaves = [(cross, "cross", w) for w in ("wq", "wk", "wv")]
    if cfg.family == "audio":
        leaves += [("encoder", "attn", w) for w in ("wq", "wk", "wv")]
        leaves += [("encoder", "mlp", k) for k in tree["encoder"]["mlp"]]
        assert float(tree["frontend_proj"].abs().max()) > 0
        assert np.abs(case["grads"]["frontend_proj"]).max() > 0
    for seg, sub, w in leaves:
        g = tree[seg][sub][w]
        for i in range(g.shape[0]):
            assert float(g[i].abs().max()) > 0, (seg, sub, w, i)
        assert np.abs(case["grads"][seg][sub][w]).max(
            axis=tuple(range(1, g.dim()))).min() > 0
    zeros = jax.tree.map(np.zeros_like, case["np_params"])
    state = train_state_from_numpy({"params": case["np_params"],
                                    "opt": (zeros, zeros, np.int32(0))},
                                   "cpu")
    state, met = make_train_step(model, RunConfig(warmup_steps=1))(
        state, case["batch"])
    assert np.isfinite(float(met["loss"]))
    m = state["opt"].m
    for seg, sub, w in leaves:
        for i in range(m[seg][sub][w].shape[0]):
            assert float(m[seg][sub][w][i].abs().max()) > 0, (seg, w, i)
