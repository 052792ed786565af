"""The port's enc-dec (seamless-m4t-medium) and VLM (llama-3.2-vision-11b)
serving paths against the reference's, on the CPU.

Three reduced configs: seamless (2 encoder + 2 decoder layers, each
decoder block with a cross branch), the VLM (1 group of 1 self layer and
1 cross layer) and the VLM at 2 groups of 2 self layers and 1 cross
layer, which alone reaches the second level of its doubly stacked
parameters and cache.  Seeded numpy weights at the reference's scales
cross to both packages (the reference's in f32, the port's cast to bf16
once, as serving holds them), and every ``cross/gate`` leaf is opened to
1.0 in that numpy tree: the gate is declared zero, and ``tanh(0)`` times
the branch leaves the logits blind to the memory, so a test with closed
gates would pass with a broken encoder or cross branch.  The memory is
seamless's frames (24, not the prompt's 16) or the VLM's image embeddings
(its ``n_frontend_tokens``, 16), bf16.

Tolerances:
* ``_cross_branch`` in prefill: the output within 2 bf16 ulps of its
  largest magnitude (the port's prefill attention is the flash contract,
  P.V in f32, where the reference's ``attend_full`` casts P to bf16: the
  context moves by about an ulp before the output projection); its cache
  (the memory's k and v, no attention in between) within 1 bf16 ulp
  elementwise.  In decode both packages take ``attend_full``: within 2
  bf16 ulps elementwise (``test_torch_models._close``), the cache handed
  back as it came.
* seamless's ``encode``: within 0.06 (the flash contract in 2
  bidirectional layers, as the slice's prefill logits).
* prefill logits within 0.06 with the same argmax; the cache's tree,
  shapes and dtypes as both packages declare them; the VLM's cross k/v (a
  product of the image embeddings alone) within 1 bf16 ulp elementwise.
* decode from the reference's carried cache: bit for bit against the
  reference's decode compiled with XLA's excess precision off (with it
  on, XLA skips bf16 roundings inside fused chains and lands 1.5-2.25
  bf16 ulps of the largest logit away, as for the dense slice).
* the port's decode against its prefill of S + 1 tokens on the same
  memory: within 0.5 (tests/test_models.py's tolerance).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import build_model as ref_build_model
from repro.models import transformer as ref_transformer
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import build_model, transformer
from repro_torch.models.carry import (cache_from_numpy, params_from_numpy,
                                      tensor_from_numpy)
from test_torch_models import _close
from test_torch_moe import _exact, _np_params

CASES = {"seamless": ("seamless-m4t-medium", {}),
         "vlm": ("llama-3.2-vision-11b", {}),
         "vlm-2x3": ("llama-3.2-vision-11b",
                     {"n_layers": 6, "cross_attn_every": 3})}
B, S, ENC_LEN = 2, 16, 24


def _cfgs(case):
    arch, kw = CASES[case]
    return (dataclasses.replace(ref_configs.get(arch).reduced(), **kw),
            dataclasses.replace(configs.get(arch).reduced(), **kw))


def _open_gates(tree, value=1.0):
    """``tree`` with every ``cross/gate`` leaf set to ``value``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            v = _open_gates(v, value)
            if k == "cross":
                v["gate"] = np.full_like(v["gate"], value)
        out[k] = v
    return out


def _bf16(a):
    """A numpy array through bf16: (jax array, torch tensor)."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, tensor_from_numpy(np.asarray(j), "cpu")


def _ulp(x):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """One config: both models, the opened weights in both packages, a
    prompt of S + 1 tokens and a memory, and the reference's jitted
    prefill of S tokens, its cache and one decode step from it (compiled
    with XLA's excess precision off)."""
    ref_cfg, cfg = _cfgs(request.param)
    ref_model = ref_build_model(ref_cfg, tp=1)
    model = build_model(cfg, tp=1, device="cpu")
    assert model.n_params == ref_model.n_params
    np_params = _open_gates(_np_params(ref_model.decls, seed=1))
    ref_params = jax.tree.map(jnp.asarray, np_params)
    params = model.load_params(params_from_numpy(np_params, "cpu"))
    rng = np.random.default_rng(5)
    tok = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    T = ENC_LEN if cfg.family == "audio" else cfg.n_frontend_tokens
    mem_j, mem = _bf16(rng.normal(size=(B, T, cfg.d_model)))
    key = model.memory_key
    prefill = jax.jit(ref_model.prefill, static_argnames="max_len")
    want, ref_cache = prefill(ref_params, {"tokens": jnp.asarray(tok[:, :S]),
                                           key: mem_j}, max_len=S + 4)
    ref_ld, _ = _exact(ref_model.decode_step, ref_params, ref_cache,
                       jnp.asarray(tok[:, S:]), jnp.asarray(S, jnp.int32))
    return dict(name=request.param, cfg=cfg, ref_cfg=ref_cfg,
                ref_model=ref_model, model=model, np_params=np_params,
                ref_params=ref_params, params=params, tok=tok,
                ttok=torch.from_numpy(tok), mem=mem, mem_j=mem_j, key=key,
                want=np.asarray(want), ref_cache=ref_cache,
                ref_ld=np.asarray(ref_ld))


def _decl(model, case_name):
    if case_name == "seamless":
        return model.cache_decls(B, S + 4, enc_len=ENC_LEN)
    return model.cache_decls(B, S + 4)


def _cross_params(c):
    """The first cross layer's parameters (numpy)."""
    p = c["np_params"]
    src = p["layers"] if "layers" in p else p["groups_cross"]
    return {"ln_cross": src["ln_cross"][0],
            "cross": {k: v[0] for k, v in src["cross"].items()}}


def test_cross_branch_matches_the_reference_in_prefill_and_decode(case):
    """The first cross layer, bf16 weights and inputs: prefill (k/v
    projected from the memory and cached) and decode from that cache."""
    cfg, ref_cfg = case["cfg"], case["ref_cfg"]
    p = _cross_params(case)
    p_j = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
    p_t = params_from_numpy(p, "cpu")
    x_j, x = _bf16(np.random.default_rng(6).normal(size=(B, S,
                                                          cfg.d_model)))
    want, want_c = ref_transformer._cross_branch(
        ref_cfg, 1, p_j, x_j, mode="prefill", memory=case["mem_j"],
        cache=None)
    got, got_c = transformer._cross_branch(
        cfg, 1, p_t, x, mode="prefill", memory=case["mem"], cache=None)
    w = np.asarray(jnp.asarray(want, jnp.float32))
    g = got.to(torch.float32).numpy()
    assert np.abs(g - w).max() <= 2 * _ulp(np.abs(w).max())
    assert np.abs(w).max() > 0
    for n in ("k", "v"):
        assert got_c[n].dtype == torch.bfloat16
        wc = np.asarray(jnp.asarray(want_c[n], jnp.float32))
        gc = got_c[n].to(torch.float32).numpy()
        assert gc.shape == wc.shape
        assert (np.abs(gc - wc) <= _ulp(np.maximum(np.abs(gc),
                                                   np.abs(wc)))).all(), n

    x1_j, x1 = _bf16(np.random.default_rng(7).normal(size=(B, 1,
                                                           cfg.d_model)))
    want, _ = ref_transformer._cross_branch(
        ref_cfg, 1, p_j, x1_j, mode="decode", memory=None, cache=want_c)
    got, out_c = transformer._cross_branch(
        cfg, 1, p_t, x1, mode="decode", memory=None, cache=got_c)
    _close(got, want, "bfloat16")
    assert out_c is got_c


def test_encode_matches_the_reference(monkeypatch):
    """seamless's encoder (frontend projection, 2 bidirectional blocks
    through the flash route with ``causal=False``, ``ln_enc``) within
    0.06 of the reference's."""
    ref_cfg, cfg = _cfgs("seamless")
    ref_model = ref_build_model(ref_cfg, tp=1)
    model = build_model(cfg, tp=1, device="cpu")
    np_params = _np_params(ref_model.decls, seed=2)
    frames_j, frames = _bf16(np.random.default_rng(8).normal(
        size=(B, ENC_LEN, cfg.d_model)))
    seen = []
    inner = transformer.flash_prefill

    def spy(q, k, v, causal=True):
        seen.append(causal)
        return inner(q, k, v, causal=causal)
    monkeypatch.setattr(transformer, "flash_prefill", spy)
    got = model.encode(params_from_numpy(np_params, "cpu"), frames)
    assert seen == [False] * cfg.n_encoder_layers
    # ``encode`` is a closure of the reference's ``_build_encdec``
    names = ref_model.prefill.__code__.co_freevars
    ref_encode = ref_model.prefill.__closure__[names.index("encode")] \
        .cell_contents
    want = ref_encode(jax.tree.map(jnp.asarray, np_params), frames_j)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    assert np.abs(got.to(torch.float32).numpy() - want).max() < 0.06


def test_prefill_logits_and_cache_match_the_reference(case):
    """Prefill of S tokens with the memory: logits within 0.06 with the
    same argmax; every cache leaf of the shape and dtype both packages'
    ``cache_decls`` declare (seamless at ``enc_len`` = the frames'
    length); the VLM's cross k/v within 1 bf16 ulp of the reference's."""
    model, ref_model = case["model"], case["ref_model"]
    got, cache = model.prefill(case["params"], {
        "tokens": case["ttok"][:, :S], case["key"]: case["mem"]},
        max_len=S + 4)
    want = case["want"]
    assert np.abs(got.numpy() - want).max() < 0.06
    np.testing.assert_array_equal(got.numpy()[:, -1].argmax(-1),
                                  want[:, -1].argmax(-1))
    decl = _decl(model, case["name"])
    ref_decl = _decl(ref_model, case["name"])
    ref_cache = case["ref_cache"]

    def walk(t, d, w, r, path):
        if isinstance(t, dict):
            assert set(t) == set(d) == set(w) == set(r), path
            for k in t:
                walk(t[k], d[k], w[k], r[k], f"{path}/{k}")
            return
        assert tuple(t.shape) == d[0] == w[0] == r.shape, path
        assert t.dtype == d[2] == torch.bfloat16, path
        assert np.dtype(w[2]).name == r.dtype.name == "bfloat16", path
    walk(cache, decl, ref_decl, ref_cache, "")
    if "groups_cross" in cache:
        for n in ("k", "v"):
            g = cache["groups_cross"]["cross"][n].to(torch.float32).numpy()
            w = np.asarray(jnp.asarray(ref_cache["groups_cross"]["cross"][n],
                                       jnp.float32))
            assert (np.abs(g - w) <= _ulp(np.maximum(np.abs(g),
                                                     np.abs(w)))).all(), n


def test_decode_from_the_carried_reference_cache(case):
    """One decode step from the reference's prefill cache, carried across:
    bit for bit the reference's without XLA's excess precision (the cross
    layers' k/v read from the cache, attended with ``attend_full``)."""
    carried = cache_from_numpy(jax.tree.map(np.asarray, case["ref_cache"]),
                               "cpu")
    ld, _ = case["model"].decode_step(case["params"], carried,
                                      case["ttok"][:, S:], S)
    np.testing.assert_array_equal(ld.numpy(), case["ref_ld"])


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def test_decode_matches_the_prefill_of_one_more_token(case):
    """The port's decode step from its own prefill cache against its
    prefill of S + 1 tokens on the same memory (whose length does not
    grow with the prompt): within 0.5.  The step writes the self cache in
    place and leaves the cross cache as it was."""
    model, params, ttok = case["model"], case["params"], case["ttok"]
    batch = {"tokens": ttok[:, :S], case["key"]: case["mem"]}
    _, cache = model.prefill(params, batch, max_len=S + 4)
    ptrs = [t.data_ptr() for t in _leaves(cache)]
    cross = {k: v.clone() for k, v in _cross_leaves(cache).items()}
    ld, out = model.decode_step(params, cache, ttok[:, S:], S)
    assert [t.data_ptr() for t in _leaves(out)] == ptrs
    for k, v in _cross_leaves(out).items():
        assert torch.equal(v, cross[k]), k
    lf, _ = model.prefill(params, {"tokens": ttok,
                                   case["key"]: case["mem"]})
    assert float((ld - lf).abs().max()) < 0.5


def _cross_leaves(cache):
    seg = cache["layers"] if "layers" in cache else cache["groups_cross"]
    return seg["cross"]


def test_zeroed_memory_moves_the_logits_only_with_open_gates(case):
    """With the gates open, the prefill's logits with the memory zeroed
    differ from those with the real memory, so the cross path acts; with
    the declared zero gates they are the same bit for bit (``tanh(0)``
    times the branch), which is why every other test opens them."""
    model, ttok = case["model"], case["ttok"]
    zero = torch.zeros_like(case["mem"])
    for gate, params in ((1.0, case["params"]),
                         (0.0, params_from_numpy(
                             _open_gates(case["np_params"], 0.0), "cpu"))):
        real, _ = model.prefill(params, {"tokens": ttok[:, :S],
                                         case["key"]: case["mem"]})
        blind, _ = model.prefill(params, {"tokens": ttok[:, :S],
                                          case["key"]: zero})
        gap = float((real - blind).abs().max())
        assert gap > 0.01 if gate else gap == 0.0, (gate, gap)


def test_serve_generate_first_token_is_the_references(case):
    """``serve.generate`` hands the memory to the prefill (under the
    model's ``memory_key``): its first token is the reference's prefill
    argmax, and its decode steps run from the cross cache."""
    gen = serve.generate(case["model"], case["params"],
                         case["ttok"][:, :S], 3, memory=case["mem"])
    assert gen.tokens.shape == (B, 3) and gen.decode_steps == 2
    np.testing.assert_array_equal(gen.tokens[:, 0].numpy(),
                                  case["want"][:, -1].argmax(-1))
