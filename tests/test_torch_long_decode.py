"""A decode step at the last slot of a long cache, the port's against the
reference's, on the CPU.

The reference's one-card decode cells (``decode_32k``, ``long_500k``)
take no prefill: the step runs against a cache of the cell's declared
length at ``pos = max_len - 1``, as the dry-run counts it.  Here the same
happens at the reduced SSM and hybrid configs (mamba2-130m; hymba-1.5b
with window 16 and global layer 0, so two layers are rings): a cache of
``MAX_LEN`` slots, more than eight windows, drawn from a seed with numpy
at the reference's declarations and carried into both packages
(``models.carry.cache_from_numpy``).  With XLA's excess precision off
(``test_torch_moe._exact``) the reference rounds every bf16 op as
written, and the port's logits and every bf16 leaf of its written cache
are the reference's bit for bit; the f32 SSM state is within 1e-5 (f32,
as tests/test_torch_models.py holds f32), since its decay ``exp(dt * A)``
is XLA's ``exp`` in one package and PyTorch's in the other, which round
apart by an ulp (tests/test_torch_ssm.py).  Then the step's own
footprint: the global
layer's slot ``pos``, each ring's slot ``pos % window`` and the SSM
state change; each conv ring shifts by one; every other slot keeps its
bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import build_model as ref_build_model
from repro_torch import configs
from repro_torch.models import build_model
from repro_torch.models.carry import cache_from_numpy, params_from_numpy
from test_torch_moe import _exact, _np_params

B = 2
WINDOW = 16                     # the reduced hymba's window
MAX_LEN = 8 * WINDOW + 8        # pos % WINDOW = 7: ring slots on both sides


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _np_cache(decls, seed=5):
    """A cache of ``decls``' shapes and dtypes, normal(0, 1) from numpy
    (bf16 leaves rounded once, as the reference stores them)."""
    rng = np.random.default_rng(seed)

    def one(d):
        if isinstance(d, dict):
            return {k: one(v) for k, v in d.items()}
        shape, _, dtype = d
        return np.asarray(jnp.asarray(rng.normal(size=shape), dtype))
    return one(decls)


def _f32(a):
    return np.asarray(a).astype(np.float32)


@pytest.fixture(scope="module", params=["mamba2-130m", "hymba-1.5b"])
def stepped(request):
    """One decode step of each package from the same cache and weights:
    (model, the cache's declarations, the numpy cache before the step,
    the port's logits and cache, the reference's logits and cache)."""
    arch = request.param
    ref_model = ref_build_model(ref_configs.get(arch).reduced(), tp=1)
    model = build_model(configs.get(arch).reduced(), tp=1, device="cpu")
    assert model.cfg.window in (None, WINDOW)
    decls = ref_model.cache_decls(B, MAX_LEN)
    params = _np_params(ref_model.decls)
    cache = _np_cache(decls)
    tok = np.random.default_rng(6).integers(
        0, model.cfg.vocab_size, (B, 1)).astype(np.int32)
    pos = MAX_LEN - 1
    want, want_cache = _exact(
        ref_model.decode_step, jax.tree.map(jnp.asarray, params),
        jax.tree.map(jnp.asarray, cache), jnp.asarray(tok),
        jnp.asarray(pos, jnp.int32))
    carried = cache_from_numpy(cache, "cpu")
    got, got_cache = model.decode_step(
        model.load_params(params_from_numpy(params, "cpu")), carried,
        torch.from_numpy(tok), pos)
    # written in place: the returned leaves are the carried ones
    assert {p: t.data_ptr() for p, t in _flat(got_cache).items()} == \
        {p: t.data_ptr() for p, t in _flat(carried).items()}
    return (model, _flat(model.cache_decls(B, MAX_LEN)), _flat(cache), got,
            _flat(got_cache), np.asarray(want), _flat(want_cache))


def test_decode_at_the_last_slot_is_bit_exact(stepped):
    """Logits and every bf16 cache leaf after the step bit for bit
    (compared as f32, which holds every bf16 value); the f32 state within
    1e-5."""
    model, decls, _, got, got_cache, want, want_cache = stepped
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(got_cache) == set(want_cache) == set(decls)
    for path, t in got_cache.items():
        assert tuple(t.shape) == decls[path][0] and t.dtype == decls[path][2]
        if t.dtype == torch.float32:
            np.testing.assert_allclose(t.numpy(), _f32(want_cache[path]),
                                       rtol=1e-5, atol=1e-5, err_msg=path)
        else:
            np.testing.assert_array_equal(t.float().numpy(),
                                          _f32(want_cache[path]),
                                          err_msg=path)


def test_only_the_steps_slots_move(stepped):
    """The step writes slot ``pos`` of the global layer and ``pos %
    window`` of each ring, shifts each conv ring by one and moves the SSM
    state; every other slot keeps its bits, and every written leaf
    moved."""
    model, decls, before, _, after, _, _ = stepped
    pos = MAX_LEN - 1
    kinds = set()
    for path, new in after.items():
        new, old, axes = new.float().numpy(), _f32(before[path]), \
            decls[path][1]
        assert not np.array_equal(new, old), path
        if "kv_seq" in axes:
            d = axes.index("kv_seq")
            i = pos % new.shape[d]
            kinds.add("global" if new.shape[d] == MAX_LEN else "ring")
            keep = np.ones(new.shape[d], bool)
            keep[i] = False
            np.testing.assert_array_equal(np.compress(keep, new, d),
                                          np.compress(keep, old, d),
                                          err_msg=path)
        elif "conv" in axes:
            d = axes.index("conv")
            K = new.shape[d]
            np.testing.assert_array_equal(np.take(new, range(K - 1), d),
                                          np.take(old, range(1, K), d),
                                          err_msg=path)
            kinds.add("conv")
        else:
            assert path.endswith("ssm/state"), path
            kinds.add("state")
    want = {"conv", "state"} | ({"global", "ring"} if model.cfg.n_heads
                                else set())
    assert kinds == want
