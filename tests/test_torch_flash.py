"""The port's ``flash_attention`` against the reference's contract.

On the CPU the wrapper runs its plain PyTorch version (the CUDA kernel
meets that version on the card in chip_smoke.py).  Here it meets
``repro.kernels.ref.flash_attention_ref`` -- not the reference's Pallas
``ops.flash_attention``, whose body calls ``pl.load``, which this image's
jax no longer has -- on the same numpy inputs from a seed: the cases of
tests/test_kernels.py, ragged lengths the reference's tiling refuses, the
head dim of phi3-mini (96), the batched ``(..., S, d)`` form, and the
grouped-query form the LM's prefill uses (k and v with a group dim of 1).

Tolerances are the reference's own test's: 2e-3 in f32 (summation order)
and 2e-2 in bf16 (one rounding of the output, plus order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import kernel_layout
from repro_torch.models.carry import tensor_from_numpy

RNG = np.random.default_rng(0)
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-3),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(shape_q, shape_kv, dtype, seed):
    rng = np.random.default_rng(seed)
    jdt, tdt, tol = DTYPES[dtype]
    arrs = [np.asarray(jnp.asarray(rng.normal(size=s), jdt))
            for s in (shape_q, shape_kv, shape_kv)]
    return arrs, [tensor_from_numpy(a, "cpu") for a in arrs], tol


def _ref(q, k, v, causal):
    fn = lambda a, b, c: ref.flash_attention_ref(a, b, c, causal=causal)
    for _ in range(q.ndim - 2):
        fn = jax.vmap(fn)
    return np.asarray(fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)),
                      np.float32)


def _check(got, want, tol, dtype):
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want,
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("S,T,d", [(128, 128, 64), (256, 256, 128),
                                   (128, 384, 64)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_reference_oracle(S, T, d, causal, dtype):
    """The cases of tests/test_kernels.py::test_flash_attention (the
    reference skips causal with S != T there; the contract's top-left
    mask defines it, so it is checked here too)."""
    (q, k, v), (tq, tk, tv), tol = _inputs((S, d), (T, d), dtype, S + T + d)
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    _check(got, _ref(q, k, v, causal), tol, dtype)


@pytest.mark.parametrize("S,d", [(32, 128), (500, 128), (77, 96),
                                 (500, 96), (33, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_ragged_lengths_and_head_dims(S, d, dtype):
    """S not a multiple of any tile (serve.py's 32-token prompt, 500) and
    the head dims the kernel is built for (64, 96, 128)."""
    (q, k, v), (tq, tk, tv), tol = _inputs((S, d), (S, d), dtype, S * d)
    got = ops.flash_attention(tq, tk, tv, causal=True)
    _check(got, _ref(q, k, v, True), tol, dtype)


def test_flash_attention_batched():
    """tests/test_kernels.py::test_flash_attention_batched: (..., S, d)."""
    (q, k, v), (tq, tk, tv), tol = _inputs((2, 3, 128, 64), (2, 3, 128, 64),
                                           "float32", 5)
    got = ops.flash_attention(tq, tk, tv)
    _check(got, _ref(q, k, v, True), tol, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_grouped_kv_equals_expanded(dtype):
    """q (B, K, G, S, d) against k, v (B, K, 1, T, d): each kv head serves
    its G query heads, exactly as with k and v expanded over G."""
    (q, k, v), (tq, tk, tv), tol = _inputs((2, 2, 3, 40, 64),
                                           (2, 2, 1, 40, 64), dtype, 9)
    got = ops.flash_attention(tq, tk, tv)
    expand = lambda a: np.broadcast_to(a, q.shape)
    _check(got, _ref(q, expand(k), expand(v), True), tol, dtype)
    torch.testing.assert_close(
        got, ops.flash_attention(tq, tk.expand_as(tq), tv.expand_as(tq)),
        rtol=0, atol=0)


def test_flash_attention_kv_group_contract():
    """k and v broadcast over q's leading dims, and the kernel takes the
    model's prefill views as they are: q (B, S, K, G, H) permuted to
    (B, K, G, S, H), k (B, S, K, H) to (B, K, 1, S, H), read through their
    strides with stride 0 over the group, the output in q's memory order."""
    q = torch.zeros((2, 4, 64))
    with pytest.raises(ValueError, match="no keys"):
        ops.flash_attention(q, q[:, :0], q[:, :0])
    with pytest.raises(ValueError, match="not"):
        ops.flash_attention(q, q[..., :32], q[..., :32])
    q5, k5 = torch.zeros((4, 8, 4, 16, 64)), torch.zeros((4, 2, 1, 16, 64))
    with pytest.raises(ValueError, match="broadcast"):
        ops.flash_attention(q5, k5, k5)
    B, S, K, G, H = 2, 24, 3, 4, 64
    qv = torch.zeros((B, S, K, G, H)).permute(0, 2, 3, 1, 4)
    kv = torch.zeros((B, S, K, H)).permute(0, 2, 1, 3).unsqueeze(2)
    out = torch.empty_like(qv)
    dims, strides = kernel_layout(qv, kv, kv, out)
    assert dims == [B, K, G]
    assert strides[:4] == [S * K * G * H, G * H, H, K * G * H]     # q
    assert strides[4:8] == strides[8:12] == [S * K * H, H, 0, K * H]
    assert strides[12:] == strides[:4]                             # out
    assert out.permute(0, 3, 1, 2, 4).is_contiguous()
    c = torch.zeros((2, 3, S, H))          # contiguous dims merge into one
    assert kernel_layout(c, c, c, c) == ([1, 1, 6], [0, 0, S * H, H] * 4)
    z = torch.zeros((3, 2, 7, 5, S, H)).permute(1, 0, 3, 2, 4, 5)
    with pytest.raises(ValueError, match="kernel takes"):
        kernel_layout(z, z, z, z)
    r = torch.zeros((S, 66))[:, :H]
    with pytest.raises(ValueError, match="multiples of 4"):
        kernel_layout(r, r, r, r)
