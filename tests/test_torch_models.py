"""The port's LM serving path against the reference's, on the CPU.

Each module meets its counterpart in ``repro.models`` on the same numpy
inputs from a seed: layers (``rmsnorm``, ``apply_rope``, ``mlp_apply``,
``logits_fn``), attention (``resolve_head_layout``, ``project_qkv``, the
``attend_full``/``attend_chunked`` cores, the KV cache), then the whole
slice on the reduced dense configs, the reduced MoE config (olmoe-1b-7b)
and the int8 KV cache (``kv_quant``), with the reference's f32 weights
carried across (``repro_torch.models.carry``) and cast to bf16 once, as
serving holds them: its own ``init_params`` for the dense configs, and
for the bit-exact runs numpy draws at its scales (``init_params`` takes
seconds a config when run eagerly).

Tolerances: f32 within 1e-5; bf16 within 2 ulps of the working type
(summation order differs between XLA's CPU dots and PyTorch's, and XLA
may keep a fused chain in f32 where PyTorch rounds per op).  The whole
slice: prefill logits within 0.06 with the same argmax (the port's
prefill attention is the flash contract, P.V in f32, where the
reference's ``attend_full`` casts P to bf16 first: measured gaps 0.0052,
0.0039 and 0.027 on qwen3, granite and phi3); decode from the carried
reference cache within two bf16 ulps at the largest logit (both take the
plain ``attend_full``; measured 0.0039, 0.0039 and 0.0234, all of it
XLA's excess precision inside fused chains: with that off the port's
decode is bit for bit the reference's, a test of its own); the port's
own decode against its prefill of S + 1 tokens within 0.5, the
reference's tolerance (tests/test_models.py; 0.6 with the int8 cache, as
tests/test_perf_features.py holds it).  The int8 cache's codes and scales
are compared bit for bit (``quantize_kv`` alone, and layer 0 of a
prefill, whose k and v do not depend on the attention route).

The SSM and hybrid families (reduced mamba2-130m; reduced hymba-1.5b,
window 16 with global layer 0, so its ring cache wraps): prefill logits
within 0.06 with the same argmax, the cache as the reference declares it
(an f32 state and bf16 conv rings beside the KV cache), layer 0's conv
rings bit for bit, decode from the carried reference cache bit for bit
without XLA's excess precision, the port's decode against its prefill of
S + 1 tokens (33, which pads the chunked scan to two chunks of 32) within
0.05 for mamba2 (tests/test_models.py) and 0.5 for hymba, and four decode
steps, the cache written in place, against a prefill of S + 4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import attention as ref_attn
from repro.models import build_model as ref_build_model
from repro.models import init_params as ref_init_params
from repro.models import layers as ref_layers
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import attention as attn
from repro_torch.models import build_model, layers
from repro_torch.models.carry import (cache_from_numpy, params_from_numpy,
                                      tensor_from_numpy)

DENSE = ("qwen3-4b", "granite-3-8b", "phi3-mini-3.8b", "starcoder2-7b")
MOE_INT8 = ("olmoe-1b-7b", "qwen3-4b:kv_quant")
SSM = ("mamba2-130m", "hymba-1.5b")
# the decode runs held bit for bit: every dense config, the MoE family,
# qwen3-4b with the int8 KV cache ("arch:kv_quant"), the SSM and hybrid
# families, and those two with the int8 cache (hymba's on its windowed
# ring too; mamba2 has no attention, so its flag must change nothing)
EXACT = DENSE + MOE_INT8 + SSM + ("hymba-1.5b:kv_quant",
                                  "mamba2-130m:kv_quant")
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _pair(rng, shape, dtype, scale=1.0):
    """One seeded numpy array as (jax array, torch tensor) of ``dtype``."""
    j = jnp.asarray(rng.normal(size=shape) * scale, JDT[dtype])
    return j, tensor_from_numpy(np.asarray(j), "cpu")


def _close(got, want, dtype):
    """f32: within 1e-5.  bf16: within 2 ulps of the larger magnitude."""
    g = got.to(torch.float32).numpy().astype(np.float64)
    w = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    if dtype == "float32":
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        return
    mag = np.maximum(np.maximum(np.abs(g), np.abs(w)), 1e-30)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    bad = np.abs(g - w) > 2 * ulp
    assert not bad.any(), (np.abs(g - w)[bad].max(), int(bad.sum()))


# ------------------------------------------------------------ head layout --

@pytest.mark.parametrize("tp", [1, 2, 4, 8, 16])
def test_resolve_head_layout_is_the_reference(tp):
    """Every head case of tests/test_models.py's property test."""
    for hq in (1, 2, 4, 5, 8, 16, 25, 32, 36):
        for hkv in (1, 2, 4, 8, 16):
            if hq % hkv:
                hkv = 1
            want = ref_attn.resolve_head_layout(hq, hkv, 64, tp)
            got = attn.resolve_head_layout(hq, hkv, 64, tp)
            assert dataclasses.astuple(got) == dataclasses.astuple(want)
            np.testing.assert_array_equal(got.alive_mask(),
                                          want.alive_mask())


# ----------------------------------------------------------------- layers --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    rng = np.random.default_rng(1)
    x, tx = _pair(rng, (2, 5, 64), dtype, 3.0)
    s, ts = _pair(rng, (64,), "float32")
    _close(layers.rmsnorm(ts, tx), ref_layers.rmsnorm(s, x), dtype)


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope(theta, dtype):
    rng = np.random.default_rng(2)
    x, tx = _pair(rng, (2, 7, 3, 2, 16), dtype)
    pos = rng.integers(0, 600, (2, 7)).astype(np.int32)
    _close(layers.apply_rope(tx, torch.from_numpy(pos), theta),
           ref_layers.apply_rope(x, jnp.asarray(pos), theta), dtype)


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_apply(kind, dtype):
    rng = np.random.default_rng(3)
    x, tx = _pair(rng, (2, 5, 32), dtype)
    names = ("wi_gate", "wi_up", "wo") if kind == "swiglu" else ("wi", "wo")
    p, tp = {}, {}
    for n in names:
        shape = (64, 32) if n == "wo" else (32, 64)
        p[n], tp[n] = _pair(rng, shape, dtype, 0.2)
    _close(layers.mlp_apply(tp, tx, kind),
           ref_layers.mlp_apply(p, x, kind), dtype)


@pytest.mark.parametrize("tie", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_fn_masks_the_padded_vocab(tie, dtype):
    rng = np.random.default_rng(4)
    vocab, d = 250, 32
    vp = layers.pad_vocab(vocab)
    assert vp == ref_layers.pad_vocab(vocab) == 256
    x, tx = _pair(rng, (2, 3, d), dtype)
    p, tp = {}, {}
    p["embedding"], tp["embedding"] = _pair(rng, (vp, d), "float32", 0.1)
    if not tie:
        p["unembed"], tp["unembed"] = _pair(rng, (d, vp), "float32", 0.1)
    got = layers.logits_fn(tp, tx, vocab, tie)
    assert got.dtype == torch.float32
    assert torch.all(got[..., vocab:] == -1e9)
    _close(got, ref_layers.logits_fn(p, x, vocab, tie), dtype)
    tok = rng.integers(0, vocab, (2, 3)).astype(np.int32)
    _close(layers.embed_lookup(tp, torch.from_numpy(tok), torch.bfloat16),
           ref_layers.embed_lookup(p, jnp.asarray(tok), jnp.bfloat16),
           "bfloat16")


# -------------------------------------------------------------- attention --

@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_project_qkv_and_output_proj(tp, dtype):
    rng = np.random.default_rng(5)
    layout = attn.resolve_head_layout(4, 1, 16, tp)   # kv_map (0, 0) at 2
    decls = ref_attn.attention_decls(32, layout, qk_norm=True)
    assert {k: dataclasses.astuple(d) for k, d in decls.items()} == {
        k: dataclasses.astuple(d)
        for k, d in attn.attention_decls(32, layout, qk_norm=True).items()}
    p, tpp = {}, {}
    for n, dcl in decls.items():
        p[n], tpp[n] = _pair(rng, dcl.shape, "float32", 0.3)
    x, tx = _pair(rng, (2, 6, 32), dtype)
    pos = np.tile(np.arange(6, dtype=np.int32), (2, 1))
    want = ref_attn.project_qkv(p, x, layout, positions=jnp.asarray(pos),
                                rope_theta=1e4, qk_norm=True)
    got = attn.project_qkv(tpp, tx, layout, positions=torch.from_numpy(pos),
                           rope_theta=1e4, qk_norm=True)
    for g, w in zip(got, want):
        _close(g, w, dtype)
    _close(attn.output_proj(tpp, got[0], layout),
           ref_attn.output_proj(p, want[0], layout), dtype)


def _qkv(rng, B, S, T, K, G, H, dtype):
    q = _pair(rng, (B, S, K, G, H), dtype)
    k = _pair(rng, (B, T, K, H), dtype)
    v = _pair(rng, (B, T, K, H), dtype)
    return q, k, v


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attend_full(causal, window, dtype):
    rng = np.random.default_rng(6)
    (q, tq), (k, tk), (v, tv) = _qkv(rng, 2, 20, 20, 2, 2, 16, dtype)
    pos = np.arange(20, dtype=np.int32)
    _close(attn.attend_full(tq, tk, tv, torch.from_numpy(pos),
                            torch.from_numpy(pos), causal=causal,
                            window=window),
           ref_attn.attend_full(q, k, v, jnp.asarray(pos), jnp.asarray(pos),
                                causal=causal, window=window), dtype)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attend_chunked_with_a_small_chunk(causal, window, dtype):
    """T = 20 over chunks of 8: two full chunks and a padded third."""
    rng = np.random.default_rng(7)
    (q, tq), (k, tk), (v, tv) = _qkv(rng, 2, 20, 20, 2, 2, 16, dtype)
    pos = np.arange(20, dtype=np.int32)
    want = ref_attn.attend_chunked(q, k, v, jnp.asarray(pos),
                                   jnp.asarray(pos), causal=causal,
                                   window=window, chunk=8)
    got = attn.attend_chunked(tq, tk, tv, torch.from_numpy(pos),
                              torch.from_numpy(pos), causal=causal,
                              window=window, chunk=8)
    _close(got, want, dtype)


@pytest.mark.parametrize("window", [None, 8])
def test_cache_positions(window):
    for T in (8, 12):
        for pos in (0, 3, 7, 8, 11, 20):
            want = np.asarray(ref_attn.cache_positions(
                jnp.asarray(pos, jnp.int32), T, window))
            got = attn.cache_positions(pos, T, window).numpy()
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("window", [None, 8])
def test_cache_update_and_attend_decode(window):
    """A step written into a cache (in place in the port; a ring slot under
    a window; a start past the end clamped as dynamic_update_slice does)
    and the query attended against it."""
    rng = np.random.default_rng(8)
    T = 8 if window else 12
    ck, tck = _pair(rng, (2, T, 2, 16), "bfloat16")
    cv, tcv = _pair(rng, (2, T, 2, 16), "bfloat16")
    for pos in (5, 9, 13):
        (q, tq), (k, tk), (v, tv) = _qkv(rng, 2, 1, 1, 2, 2, 16, "bfloat16")
        ck, cv = ref_attn.cache_update(ck, cv, k, v,
                                       jnp.asarray(pos, jnp.int32), window)
        out_k, out_v = attn.cache_update(tck, tcv, tk, tv, pos, window)
        assert out_k is tck and out_v is tcv               # in place
        np.testing.assert_array_equal(tck.to(torch.float32).numpy(),
                                      np.asarray(ck, np.float32))
        np.testing.assert_array_equal(tcv.to(torch.float32).numpy(),
                                      np.asarray(cv, np.float32))
        _close(attn.attend_decode(tq, tck, tcv, pos, window),
               ref_attn.attend_decode(q, ck, cv, jnp.asarray(pos, jnp.int32),
                                      window), "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_and_dequantize_kv_are_the_references(dtype):
    """Codes, scales and the dequantized cache bit for bit.  Row 0 is
    zero (the 1e-8 scale floor); row 1 puts values exactly half-way
    between codes (scale 1: 0.5, 1.5, 2.5, -0.5 and -2.5 round half to
    even)."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32) * 3
    x[0, 0, 0] = 0.0
    x[0, 1, 0] = 0.0
    x[0, 1, 0, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]
    j = jnp.asarray(x, JDT[dtype])
    t = tensor_from_numpy(np.asarray(j), "cpu")
    # compiled, as the reference's model runs it (models/attention.py's
    # quantize_kv says why that matters)
    want_q, want_s = jax.jit(ref_attn.quantize_kv)(j)
    got_q, got_s = attn.quantize_kv(t)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    assert tuple(got_s.shape) == (2, 7, 3, 1)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_q[0, 1, 0, :6].tolist() == [127, 0, 2, 2, 0, -2]
    _close(attn.dequantize_kv(got_q, got_s, t.dtype),
           ref_attn.dequantize_kv(want_q, want_s, JDT[dtype]), dtype)
    np.testing.assert_array_equal(
        attn.dequantize_kv(got_q, got_s, t.dtype).to(torch.float32).numpy(),
        np.asarray(ref_attn.dequantize_kv(want_q, want_s, JDT[dtype]),
                   np.float32))


# -------------------------------------------------------------- the slice --

def _models(arch, window=None):
    cfg = ref_configs.get(arch).reduced()
    port_cfg = configs.get(arch).reduced()
    if window:
        cfg = dataclasses.replace(cfg, window=window)
        port_cfg = dataclasses.replace(port_cfg, window=window)
    ref_model = ref_build_model(cfg, tp=1)
    ref_params = ref_init_params(ref_model.decls, jax.random.key(0))
    model = build_model(port_cfg, tp=1, device="cpu")
    params = model.load_params(params_from_numpy(
        jax.tree.map(np.asarray, ref_params), "cpu"))
    assert model.n_params == ref_model.n_params
    return cfg, ref_model, ref_params, model, params


@pytest.mark.parametrize("arch,window", [(a, None) for a in DENSE]
                         + [("qwen3-4b", 16)])
def test_slice_prefill_and_decode_match_the_reference(arch, window):
    """The reduced dense configs; qwen3-4b also with a sliding window of
    16 (no published dense config has one), whose prefill takes attend
    and whose cache is the reference's ring buffer."""
    cfg, ref_model, ref_params, model, params = _models(arch, window)
    rng = np.random.default_rng(3)
    B, S = 2, 32
    tok = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    ttok = torch.from_numpy(tok)

    # prefill: the port's flash contract against the reference's attend
    want, ref_cache = ref_model.prefill(
        ref_params, {"tokens": jnp.asarray(tok[:, :S])}, max_len=S + 4)
    got, cache = model.prefill(params, {"tokens": ttok[:, :S]},
                               max_len=S + 4)
    want = np.asarray(want)
    gap = np.abs(got.numpy() - want).max()
    assert gap < 0.06, gap
    np.testing.assert_array_equal(got.numpy()[:, -1].argmax(-1),
                                  want[:, -1].argmax(-1))
    decl = model.cache_decls(B, S + 4)
    for seg, entry in cache.items():
        for n, t in entry["attn"].items():
            shape, _, dtype = decl[seg]["attn"][n]
            assert tuple(t.shape) == shape == ref_cache[seg]["attn"][n].shape
            assert t.dtype == dtype == torch.bfloat16

    # decode from the reference's own cache, carried across: the logits
    # come out of a bf16 product, so two bf16 ulps at the largest logit
    ref_ld, _ = ref_model.decode_step(ref_params, ref_cache,
                                      jnp.asarray(tok[:, S:]),
                                      jnp.asarray(S, jnp.int32))
    carried = cache_from_numpy(jax.tree.map(np.asarray, ref_cache), "cpu")
    ld, _ = model.decode_step(params, carried, ttok[:, S:], S)
    ref_ld = np.asarray(ref_ld)
    gap = np.abs(ld.numpy() - ref_ld).max()
    top = np.abs(ref_ld[..., :cfg.vocab_size]).max()
    assert gap <= 2 * 2.0 ** (np.floor(np.log2(top)) - 7), (gap, top)

    # the port's own decode against its prefill of S + 1 tokens
    ld, _ = model.decode_step(params, cache, ttok[:, S:], S)
    lf, _ = model.prefill(params, {"tokens": ttok})
    assert float((ld - lf).abs().max()) < 0.5


def test_windowed_prefill_shorter_than_the_window_holds_its_declared_cache():
    """A prompt of 32 under a window of 64 (hymba's 4 x 512 under 1,024):
    the port's ring holds the slots ``cache_decls`` declares, min(max_len,
    window) = 36, where the reference's prefill pads to 64 (more than it
    declares); decode attends the same tokens either way, so the logits
    from the two caches agree within two bf16 ulps at the largest logit,
    and four steps from the port's cache agree with a prefill of S + 4."""
    cfg, ref_model, ref_params, model, params = _models("qwen3-4b", 64)
    rng = np.random.default_rng(10)
    B, S = 2, 32
    tok = rng.integers(0, cfg.vocab_size, (B, S + 4)).astype(np.int32)
    ttok = torch.from_numpy(tok)
    _, ref_cache = ref_model.prefill(
        ref_params, {"tokens": jnp.asarray(tok[:, :S])}, max_len=S + 4)
    _, cache = model.prefill(params, {"tokens": ttok[:, :S]}, max_len=S + 4)
    shape = model.cache_decls(B, S + 4)["layers"]["attn"]["k"][0]
    assert shape == ref_model.cache_decls(B, S + 4)["layers"]["attn"]["k"][0]
    assert shape[2] == S + 4
    assert tuple(cache["layers"]["attn"]["k"].shape) == shape
    assert ref_cache["layers"]["attn"]["k"].shape[2] == 64
    ref_ld, _ = ref_model.decode_step(ref_params, ref_cache,
                                      jnp.asarray(tok[:, S:S + 1]),
                                      jnp.asarray(S, jnp.int32))
    ld, _ = model.decode_step(params, cache, ttok[:, S:S + 1], S)
    ref_ld = np.asarray(ref_ld)
    gap = np.abs(ld.numpy() - ref_ld).max()
    top = np.abs(ref_ld[..., :cfg.vocab_size]).max()
    assert gap <= 2 * 2.0 ** (np.floor(np.log2(top)) - 7), (gap, top)
    for i in range(1, 4):
        ld, _ = model.decode_step(params, cache, ttok[:, S + i:S + i + 1],
                                  S + i)
    lf, _ = model.prefill(params, {"tokens": ttok})
    assert float((ld - lf).abs().max()) < 0.5


_EXACT_REFERENCE = """
import sys, jax, jax.numpy as jnp, numpy as np
from repro import configs
from repro.models import build_model
def init(decls, rng):
    if isinstance(decls, dict):
        return {k: init(v, rng) for k, v in decls.items()}
    if decls.init in ("ones", "zeros"):
        return getattr(np, decls.init)(decls.shape, np.float32)
    std = 0.02 if decls.init == "embed" else \\
        max(1, int(np.prod(decls.shape[:-1]))) ** -0.5
    return (rng.normal(size=decls.shape) * std).astype(np.float32)
def put(flat, prefix, tree):
    for k, v in tree.items():
        if isinstance(v, dict):
            put(flat, prefix + k + "/", v)
        else:
            a = np.asarray(v)       # bf16 crosses as f32; int8 as itself
            flat[prefix + k] = a.astype(np.float32) \\
                if a.dtype.name == "bfloat16" else a
for spec in sys.argv[2:]:
    arch, _, opt = spec.partition(":")
    cfg = configs.get(arch).reduced()
    model = build_model(cfg, tp=1, kv_quant=opt == "kv_quant")
    params = jax.tree.map(jnp.asarray,
                          init(model.decls, np.random.default_rng(0)))
    tok = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 33))
    tok = jnp.asarray(tok, jnp.int32)
    first, cache = jax.jit(model.prefill, static_argnames="max_len")(
        params, {"tokens": tok[:, :32]}, max_len=36)
    logits, _ = jax.jit(model.decode_step)(params, cache, tok[:, 32:],
                                           jnp.asarray(32, jnp.int32))
    flat = {}
    put(flat, "p/", params)
    put(flat, "c/", cache)
    np.savez(f"{sys.argv[1]}/{spec}.npz", tok=np.asarray(tok),
             prefill=np.asarray(first), logits=np.asarray(logits), **flat)
"""


@pytest.fixture(scope="module")
def exact_reference(tmp_path_factory):
    """The reference's params, prefill logits and cache and decode logits
    for every config of ``EXACT``, computed once (jitted, as the
    reference's model runs) in a process whose XLA rounds every bf16 op as
    written (excess precision off)."""
    import os
    import subprocess
    import sys
    out = tmp_path_factory.mktemp("exact")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    run = subprocess.run([sys.executable, "-c", _EXACT_REFERENCE, str(out),
                          *EXACT], env=env, capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-2000:]
    return out


def _unflatten(npz, prefix):
    tree = {}
    for name in npz.files:
        if name.startswith(prefix):
            *path, leaf = name[len(prefix):].split("/")
            node = tree
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = npz[name]
    return tree


def _exact_model(spec):
    arch, _, opt = spec.partition(":")
    return build_model(configs.get(arch).reduced(), tp=1,
                       kv_quant=opt == "kv_quant", device="cpu")


def _exact_cache(npz, model):
    """The reference's prefill cache from ``npz``, each leaf in the dtype
    the port declares for it (bf16 crossed the file as f32)."""
    decl = model.cache_decls(2, 36)

    def cast(tree, d):
        if isinstance(tree, dict):
            return {k: cast(v, d[k]) for k, v in tree.items()}
        assert tuple(tree.shape) == d[0]
        return tree.to(d[2])
    return cast(cache_from_numpy(_unflatten(npz, "c/"), "cpu"), decl)


@pytest.mark.parametrize("arch", EXACT)
def test_slice_decode_is_bit_exact_without_xla_excess_precision(
        arch, exact_reference):
    """The decode gap above is XLA's, not the port's: XLA may skip a bf16
    rounding inside a fused chain (excess precision).  With that off, the
    reference rounds every op as written, as PyTorch does, and the port's
    decode_step from the carried cache gives the same logits bit for bit:
    every dense config, the MoE family (its router included), the int8
    cache (the step's codes and scales written, the whole cache
    dequantized), and the SSM and hybrid families (the recurrent step's
    conv rings, state and f32 products; hymba's windowed ring too)."""
    npz = np.load(exact_reference / f"{arch}.npz")
    model = _exact_model(arch)
    params = model.load_params(params_from_numpy(_unflatten(npz, "p/"),
                                                  "cpu"))
    cache = _exact_cache(npz, model)
    tok = torch.from_numpy(npz["tok"])
    got, _ = model.decode_step(params, cache, tok[:, 32:], 32)
    np.testing.assert_array_equal(got.numpy(), npz["logits"])


@pytest.mark.parametrize("arch", MOE_INT8)
def test_moe_and_int8_cache_prefill_match_the_reference(arch,
                                                        exact_reference):
    """The prefill of the MoE family and of the int8 cache: logits within
    0.06 with the same argmax (the flash contract, as the dense prefill),
    the cache as the reference declares it (shapes and dtypes), and the
    port's decode from its own cache against its prefill of S + 1 tokens.
    With the int8 cache, layer 0's codes and scales (whose k and v do not
    depend on attention) are the reference's bit for bit."""
    npz = np.load(exact_reference / f"{arch}.npz")
    model = _exact_model(arch)
    ref_model = ref_build_model(ref_configs.get(arch.split(":")[0])
                                .reduced(), tp=1, kv_quant=model.kv_quant)
    params = model.load_params(params_from_numpy(_unflatten(npz, "p/"),
                                                  "cpu"))
    tok = torch.from_numpy(npz["tok"])
    got, cache = model.prefill(params, {"tokens": tok[:, :32]}, max_len=36)
    want = npz["prefill"]
    assert np.abs(got.numpy() - want).max() < 0.06
    np.testing.assert_array_equal(got.numpy()[:, -1].argmax(-1),
                                  want[:, -1].argmax(-1))
    decl = model.cache_decls(2, 36)
    ref_decl = ref_model.cache_decls(2, 36)
    carried = _exact_cache(npz, model)

    def walk(t, d, w, c, path):
        if isinstance(t, dict):
            assert set(t) == set(d) == set(w) == set(c), path
            for k in t:
                walk(t[k], d[k], w[k], c[k], path + "/" + k)
            return
        assert tuple(t.shape) == d[0] == w[0] == tuple(c.shape), path
        assert t.dtype == d[2] == c.dtype, path
        assert str(d[2]).split(".")[-1] == np.dtype(w[2]).name, path
        if model.kv_quant:
            np.testing.assert_array_equal(t[0].numpy(), c[0].numpy(),
                                          err_msg=path)
    walk(cache, decl, ref_decl, carried, "")
    ld, _ = model.decode_step(params, cache, tok[:, 32:], 32)
    lf, _ = model.prefill(params, {"tokens": tok})
    limit = 0.6 if model.kv_quant else 0.5
    assert float((ld - lf).abs().max()) < limit


@pytest.mark.parametrize("arch", SSM)
def test_ssm_and_hybrid_slices_match_the_reference(arch, exact_reference):
    """Reduced mamba2-130m (attention-free: no ``attn`` cache entry) and
    hymba-1.5b (window 16, global layer 0: two windowed layers whose ring
    of 16 slots a 32-token prefill wraps).  The prefill against the
    reference's, its cache against the declarations, layer 0's conv rings
    (pre-conv projections of the last 4 tokens, no scan in between) bit
    for bit; the port's decode against its prefill of S + 1 (33 tokens,
    the chunked scan padded to 64); four decode steps, every cache leaf
    written in place, against a prefill of S + 4; and ``serve.generate``'s
    first token."""
    from repro_torch.models.transformer import segments
    npz = np.load(exact_reference / f"{arch}.npz")
    model = _exact_model(arch)
    cfg = model.cfg
    ref_model = ref_build_model(ref_configs.get(arch).reduced(), tp=1)
    params = model.load_params(params_from_numpy(_unflatten(npz, "p/"),
                                                  "cpu"))
    tok = torch.from_numpy(npz["tok"])
    got, cache = model.prefill(params, {"tokens": tok[:, :32]}, max_len=36)
    want = npz["prefill"]
    assert np.abs(got.numpy() - want).max() < 0.06
    np.testing.assert_array_equal(got.numpy()[:, -1].argmax(-1),
                                  want[:, -1].argmax(-1))
    decl, ref_decl = model.cache_decls(2, 36), ref_model.cache_decls(2, 36)
    carried = _exact_cache(npz, model)

    def walk(t, d, w, c, path):
        if isinstance(t, dict):
            assert set(t) == set(d) == set(w) == set(c), path
            for k in t:
                walk(t[k], d[k], w[k], c[k], path + "/" + k)
            return
        assert tuple(t.shape) == d[0] == w[0] == tuple(c.shape), path
        assert t.dtype == d[2] == c.dtype, path
        assert str(d[2]).split(".")[-1] == np.dtype(w[2]).name, path
    walk(cache, decl, ref_decl, carried, "")
    first = segments(cfg)[0]
    assert ("attn" in cache[first.name]) == (cfg.family == "hybrid")
    assert cache[first.name]["ssm"]["state"].dtype == torch.float32
    for name in ("conv_x", "conv_B", "conv_C"):
        g, w = (c[first.name]["ssm"][name] for c in (cache, carried))
        if first.scanned:
            g, w = g[0], w[0]
        assert torch.equal(g, w), name

    # the port's own decode against its prefill of S + 1 tokens
    limit = 0.05 if cfg.family == "ssm" else 0.5
    ld, _ = model.decode_step(params, _exact_cache(npz, model),
                              tok[:, 32:], 32)
    lf, _ = model.prefill(params, {"tokens": tok})
    assert float((ld - lf).abs().max()) < limit

    # four steps from the port's own prefill cache, written in place
    extra = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 3))
    tok4 = torch.cat([tok, torch.as_tensor(extra, dtype=tok.dtype)], 1)
    leaves = lambda c: [t for seg in c.values() for t in _leaf_list(seg)]
    ptrs = [t.data_ptr() for t in leaves(cache)]
    for i in range(4):
        ld, out = model.decode_step(params, cache, tok4[:, 32 + i:33 + i],
                                    32 + i)
        assert [t.data_ptr() for t in leaves(out)] == ptrs
    lf, _ = model.prefill(params, {"tokens": tok4})
    assert float((ld - lf).abs().max()) < limit

    gen = serve.generate(model, params, tok[:, :32], 2)
    np.testing.assert_array_equal(gen.tokens[:, 0].numpy(),
                                  want[:, -1].argmax(-1))


def _leaf_list(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaf_list(v)]
    return [tree]


def test_serve_generate_first_token_is_the_references():
    cfg, ref_model, ref_params, model, params = _models("qwen3-4b")
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    gen = serve.generate(model, params, torch.from_numpy(tok), 4)
    assert gen.tokens.shape == (4, 4) and gen.decode_steps == 3
    logits, _ = ref_model.prefill(ref_params, {"tokens": jnp.asarray(tok)},
                                  max_len=36)
    np.testing.assert_array_equal(gen.tokens[:, 0].numpy(),
                                  np.asarray(logits)[:, -1].argmax(-1))


def _astuples(decls):
    """A declaration tree with each ``ParamDecl`` (either package's) as a
    tuple of its fields."""
    if isinstance(decls, dict):
        return {k: _astuples(v) for k, v in decls.items()}
    return dataclasses.astuple(decls)


def test_families_not_yet_ported_raise():
    """Every family now builds.  The audio (enc-dec) and VLM families
    build with the reference's parameter counts and cache bytes (at full
    width too, from the declarations alone; seamless's cross cache at
    ``enc_len``), cross-attention blocks declare what the reference's do,
    the two families' stacked parameter entries are those their training
    splits into layers (their ``loss`` is held against the reference's
    in tests/test_torch_crossattn_train.py), and the int8 cache on them
    raises; the SSM and hybrid families build with the
    reference's parameter counts, as do the MoE family and the int8
    cache; an unknown mode and remat policy raise."""
    from repro.models.transformer import block_decls as ref_block_decls
    from repro_torch.models.transformer import block_decls, run_decoder
    for arch in ("qwen3-4b", "seamless-m4t-medium", "llama-3.2-vision-11b"):
        for cfg, ref_cfg in ((configs.get(arch), ref_configs.get(arch)),
                             (configs.get(arch).reduced(),
                              ref_configs.get(arch).reduced())):
            assert _astuples(block_decls(cfg, 1, cross=True)) == \
                _astuples(ref_block_decls(ref_cfg, 1, cross=True))
    def nbytes(tree):
        """Bytes a cache declaration holds (torch or numpy dtypes)."""
        if isinstance(tree, dict):
            return sum(nbytes(v) for v in tree.values())
        shape, _, dt = tree
        size = dt.itemsize if isinstance(dt, torch.dtype) \
            else np.dtype(dt).itemsize
        return int(np.prod(shape)) * size

    for arch, n, cache in (("mamba2-130m", 129_057_216,
                            (76_873_728, 19_218_432)),
                           ("hymba-1.5b", 1_641_738_496,
                            (118_652_928, 61_128_192))):
        for cfg, ref_cfg in ((configs.get(arch), ref_configs.get(arch)),
                             (configs.get(arch).reduced(),
                              ref_configs.get(arch).reduced())):
            model = build_model(cfg, device="cpu")
            ref_model = ref_build_model(ref_cfg, tp=1)
            assert model.n_params == ref_model.n_params
            for shape in ((4, 544), (1, 4098)):
                assert nbytes(model.cache_decls(*shape)) \
                    == nbytes(ref_model.cache_decls(*shape))
        model = build_model(configs.get(arch), device="cpu")
        assert model.n_params == n
        assert (nbytes(model.cache_decls(4, 544)),
                nbytes(model.cache_decls(1, 4098))) == cache
    for arch, n, cache in (("seamless-m4t-medium", 878_245_900,
                            207_618_048),
                           ("llama-3.2-vision-11b", 9_775_157_256,
                            1_124_597_760)):
        kw = {"enc_len": 512} if arch.startswith("seamless") else {}
        for cfg, ref_cfg in ((configs.get(arch), ref_configs.get(arch)),
                             (configs.get(arch).reduced(),
                              ref_configs.get(arch).reduced())):
            model = build_model(cfg, device="cpu")
            ref_model = ref_build_model(ref_cfg, tp=1)
            assert model.n_params == ref_model.n_params
            for shape in ((4, 544), (1, 4098)):
                assert nbytes(model.cache_decls(*shape, **kw)) \
                    == nbytes(ref_model.cache_decls(*shape, **kw))
            assert model.stacked() == (
                {"layers": 1, "encoder": 1} if kw else
                {"groups_self": 2, "groups_cross": 1})
            with pytest.raises(NotImplementedError, match="int8"):
                build_model(cfg, kv_quant=True, device="cpu")
        model = build_model(configs.get(arch), device="cpu")
        assert model.n_params == n
        assert nbytes(model.cache_decls(4, 544, **kw)) == cache
    vlm = build_model(configs.get("llama-3.2-vision-11b"), device="cpu")
    assert nbytes(vlm.cache_decls(4, 544)["groups_cross"]) == 839_385_088
    moe = build_model(configs.get("olmoe-1b-7b").reduced(), device="cpu")
    assert "moe" in moe.decls["layers"] and "mlp" not in moe.decls["layers"]
    model = build_model(configs.get("qwen3-4b").reduced(), kv_quant=True,
                        device="cpu")
    assert model.kv_quant
    assert model.cache_decls(2, 8)["layers"]["attn"]["k"]["q"][2] \
        == torch.int8
    with pytest.raises(NotImplementedError, match="mode='sample'"):
        run_decoder(model.cfg, 1, {}, torch.zeros(1, 1, 64), mode="sample")
    with pytest.raises(ValueError, match="remat"):
        build_model(configs.get("qwen3-4b").reduced(), remat="all",
                    device="cpu")


def test_init_params_is_seeded_per_path():
    """One generator per leaf, seeded from (seed, crc32 of its path): the
    same seed gives the same weights, a leaf does not depend on the others,
    and the stddevs are the reference's (_init_one)."""
    from repro_torch.models import init_params
    from repro_torch.models.params import ParamDecl
    decls = {"a": ParamDecl((64, 256), ("embed", "mlp")),
             "b": {"e": ParamDecl((512, 32), ("vocab", "embed"),
                                  init="embed"),
                   "n": ParamDecl((32,), (None,), init="ones"),
                   "z": ParamDecl((4,), (None,), init="zeros")}}
    p1 = init_params(decls, 3, device="cpu")
    p2 = init_params(decls, 3, device="cpu")
    alone = init_params({"a": decls["a"]}, 3, device="cpu")
    other = init_params(decls, 4, device="cpu")
    assert torch.equal(p1["a"], p2["a"]) and torch.equal(p1["a"], alone["a"])
    assert not torch.equal(p1["a"], other["a"])
    assert abs(float(p1["a"].std()) - 64 ** -0.5) < 0.01
    assert abs(float(p1["b"]["e"].std()) - 0.02) < 0.002
    assert torch.equal(p1["b"]["n"], torch.ones(32))
    assert torch.equal(p1["b"]["z"], torch.zeros(4))
    assert init_params(decls, 3, torch.bfloat16, "cpu")["a"].dtype \
        == torch.bfloat16
