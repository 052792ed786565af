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

The bf16 kernel's arithmetic (tiles of 128 keys, online softmax in base
2, P split into two bf16 halves for the tensor cores) is modelled here in
plain PyTorch and held to chip_smoke.py's per-element limit: 2 bf16 ulps
of the larger of the two values plus 1e-5.  Its TMA maps' description
(``tensor_maps``) is checked on CPU tensors.  The lse the forward saves
for training is held against jax's logsumexp of the oracle's scores.

The backward: its plain version against jax.vjp of the oracle, the bf16
kernels' arithmetic (single bf16 P and dS into f32 sums, the forward's
lse) modelled and held to chip_smoke.py's phase-11a limit, and its
layout (``bwd_layout``: the model's views handed over uncopied).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.kernels import ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.flash_attention import kernel_layout, tensor_maps
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


def _ref_lse(q, k, causal):
    """jax.nn.logsumexp of the oracle's masked scores
    (ref.flash_attention_ref's first lines), k broadcast to q's leading
    dims."""
    def lse(a, b):
        s = (a.astype(jnp.float32) @ b.astype(jnp.float32).T) \
            / np.sqrt(a.shape[-1])
        if causal:
            S, T = s.shape
            s = jnp.where(jnp.arange(S)[:, None] >= jnp.arange(T)[None, :],
                          s, -1e30)
        return jax.nn.logsumexp(s, axis=-1)
    fn = lse
    for _ in range(q.ndim - 2):
        fn = jax.vmap(fn)
    kb = np.broadcast_to(k, q.shape[:-2] + k.shape[-2:])
    return np.asarray(fn(jnp.asarray(q), jnp.asarray(kb)), np.float32)


LSE_CASES = [((128, 64), (128, 64), True), ((128, 64), (128, 64), False),
             ((37, 128), (53, 128), True), ((130, 96), (250, 96), False),
             ((2, 2, 3, 40, 64), (2, 2, 1, 40, 64), True)]


@pytest.mark.parametrize("shape_q,shape_kv,causal", LSE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_lse_matches_reference(shape_q, shape_kv, causal,
                                               dtype):
    """``return_lse``: each row's logsumexp of its scaled, masked f32
    scores (what the backward takes), against jax's logsumexp of the
    oracle's scores within 1e-5 (f32 summation order); the output is the
    one without it."""
    (q, k, v), (tq, tk, tv), _ = _inputs(shape_q, shape_kv, dtype, 13)
    out, lse = ops.flash_attention(tq, tk, tv, causal=causal,
                                   return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == tq.shape[:-1]
    np.testing.assert_allclose(lse.numpy(), _ref_lse(q, k, causal),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(out, ops.flash_attention(tq, tk, tv, causal=causal))


# ----------------------------------------------- the bf16 kernel's model --

BK = 128                  # keys per tile of the bf16 kernel
ULPS, FLOOR = 2, 1e-5     # chip_smoke.py's FLASH_ULPS, FLASH_FLOOR


def _bf16_bits(x):
    """The bf16 the kernel packs from f32 ``x`` by its bits: half a bf16
    ulp added, the low 16 bits dropped (to nearest, ties away from 0)."""
    bits = (x.view(torch.int32) + 0x8000) & -0x10000
    return bits.view(torch.float32)


def _kernel_model(q, k, v, causal, split=True):
    """The bf16 kernel's arithmetic in plain PyTorch: f32 scores of the
    bf16 inputs (products exact, as on the tensor cores), masked at -1e30,
    an online softmax over tiles of BK keys with the running max of the
    raw scores and P = exp2(fma(S, c, -max * c)) for c = log2(e)/sqrt(d)
    in f32, the normaliser summed from the unrounded f32 P, and P.V as
    P_hi V + P_lo V in f32 (P_hi = bf16(P), P_lo = P - P_hi rounded by
    its bits); with ``split=False`` a single bf16 P."""
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    S, d = q.shape[-2:]
    T = k.shape[-2]
    c = torch.tensor(1.4426950408889634, dtype=torch.float32) \
        / torch.sqrt(torch.tensor(float(d), dtype=torch.float32))
    m = torch.full((*q.shape[:-1], 1), -1e30)
    l = torch.zeros_like(m)
    o = torch.zeros(qf.shape)
    rows = torch.arange(S)[:, None]
    for k0 in range(0, T, BK):
        kt, vt = kf[..., k0:k0 + BK, :], vf[..., k0:k0 + BK, :]
        s = torch.matmul(qf, kt.transpose(-1, -2))
        if causal:
            keys = torch.arange(k0, k0 + kt.shape[-2])[None, :]
            s = torch.where(keys <= rows, s, torch.tensor(-1e30))
        mx = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2((m - mx) * c)
        m = mx
        neg = -mx * c
        # fma(s, c, neg): one rounding, as float64 holds s * c exactly
        p = torch.exp2((s.double() * c.double() + neg.double()).float())
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.to(torch.bfloat16).to(torch.float32)
        lo = _bf16_bits(p - hi) if split else torch.zeros_like(p)
        o = o * alpha + torch.matmul(hi, vt) + torch.matmul(lo, vt)
    return (o * (1 / l)).to(q.dtype)


def _limit_share(got, want):
    """The largest share of chip_smoke's per-element limit (ULPS bf16 ulps
    of max(|got|, |want|) plus FLOOR) that an element's error uses."""
    g, w = got.to(torch.float32), want.to(torch.float32)
    _, ex = torch.frexp(torch.maximum(g.abs(), w.abs()))
    ulp = torch.ldexp(torch.full_like(g, torch.finfo(got.dtype).eps / 2), ex)
    return float(((g - w).abs() / (ULPS * ulp + FLOOR)).max())


MODEL_CASES = [  # q shape, kv shape, causal, input scale
    ((256, 128), (256, 128), True, 1.0),
    ((256, 128), (256, 128), True, 0.25),
    ((256, 128), (256, 128), True, 3.0),
    ((200, 64), (200, 64), True, 1.0),
    ((300, 96), (300, 96), True, 1.0),
    ((128, 128), (384, 128), False, 1.0),
    ((130, 96), (250, 96), False, 1.0),
    ((1, 2, 3, 257, 128), (1, 2, 1, 257, 128), True, 1.0),
    ((2, 2, 2, 150, 64), (2, 2, 1, 150, 64), False, 1.0),
]


@pytest.mark.parametrize("shape_q,shape_kv,causal,scale", MODEL_CASES)
def test_kernel_model_within_the_element_limit(shape_q, shape_kv, causal,
                                               scale):
    """The bf16 kernel's arithmetic against the plain version and the
    reference oracle: every element within 2 bf16 ulps plus 1e-5, at head
    dims 64, 96 and 128, causal and not, ragged S and T, S != T, and the
    grouped (B, K, G, S, d) form."""
    rng = np.random.default_rng(len(shape_q) * 1000 + shape_q[-2])
    arrs = [np.asarray(jnp.asarray(scale * rng.normal(size=sh),
                                   jnp.bfloat16))
            for sh in (shape_q, shape_kv, shape_kv)]
    tq, tk, tv = (tensor_from_numpy(a, "cpu") for a in arrs)
    got = _kernel_model(tq, tk, tv, causal)
    assert got.dtype == torch.bfloat16
    assert _limit_share(got, ops.flash_attention_plain(
        tq, tk, tv, causal=causal)) <= 1
    expand = lambda a: np.broadcast_to(a, arrs[0].shape[:-2] + a.shape[-2:])
    want = torch.from_numpy(_ref(arrs[0], expand(arrs[1]), expand(arrs[2]),
                                 causal)).to(torch.bfloat16)
    assert _limit_share(got, want) <= 1


def test_single_bf16_p_exceeds_the_element_limit():
    """Why the kernel splits P: with one bf16 P in the P.V product (what a
    plain bf16 flash kernel does), the same inputs go over the limit."""
    rng = np.random.default_rng(3)
    tq, tk, tv = (torch.from_numpy(rng.normal(size=(512, 128)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3))
    want = ops.flash_attention_plain(tq, tk, tv)
    assert _limit_share(_kernel_model(tq, tk, tv, True), want) <= 1
    assert _limit_share(_kernel_model(tq, tk, tv, True, split=False),
                        want) > 1


# --------------------------------------------- the bf16 kernel's TMA maps --

def lead_coords(lead, dims, n):
    """The coordinates (leading dims 2, 1, 0) of the boxes that the
    kernel loads from each map for leading index ``n`` of q, by its rule:
    a dim of size 1 in a map is read at 0."""
    idx = (n // (lead[2] * lead[1]), n // lead[2] % lead[1], n % lead[2])
    return [[idx[i] if dims[5 * t + 4 - i] > 1 else 0 for i in (2, 1, 0)]
            for t in range(3)]


def test_tensor_maps_of_the_model_views():
    """q (B, S, K, G, H) as the view (B, K, G, S, H) and k (B, S, K, H) as
    (B, K, 1, S, H): each map is (H, S, G, K, B) over the tensor's own
    strides in bytes; k's group dim has size 1 (read at coordinate 0, so
    each kv head serves its G query heads), with a stride past the rest."""
    B, S, K, G, H = 2, 24, 3, 4, 128
    qv = torch.zeros((B, S, K, G, H), dtype=torch.bfloat16).permute(
        0, 2, 3, 1, 4)
    kv = torch.zeros((B, S, K, H), dtype=torch.bfloat16).permute(
        0, 2, 1, 3).unsqueeze(2)
    out = torch.empty_like(qv)
    lead, dims, strides, out_strides = tensor_maps(qv, kv, kv, out)
    assert lead == [B, K, G]
    assert dims[:5] == [H, S, G, K, B]
    assert strides[:4] == [2 * K * G * H, 2 * H, 2 * G * H, 2 * S * K * G * H]
    assert dims[5:10] == dims[10:] == [H, S, 1, K, B]
    assert strides[4:8] == strides[8:] == [2 * K * H, 2 * S * K * H, 2 * H,
                                           2 * S * K * H]
    assert out_strides == [S * K * G * H, G * H, H, K * G * H]
    n = (1 * K + 2) * G + 3                   # batch 1, kv head 2, group 3
    assert lead_coords(lead, dims, n) == [[3, 2, 1], [0, 2, 1], [0, 2, 1]]


@pytest.mark.parametrize("S,T", [(500, 500), (1, 7), (130, 384)])
def test_tensor_maps_of_dense_tensors(S, T):
    """Contiguous (B, heads, S, d) tensors merge into one leading dim;
    ragged S and T stay the maps' row counts (TMA zero-fills past them,
    the kernel masks); a dim of size 1 gets a stride past the dims before
    it, and the leading index runs over the merged dim."""
    q = torch.zeros((2, 3, S, 96), dtype=torch.bfloat16)
    k = torch.zeros((2, 3, T, 96), dtype=torch.bfloat16)
    lead, dims, strides, out_strides = tensor_maps(q, k, k, q)
    assert lead == [1, 1, 6]
    assert dims == [96, S, 6, 1, 1] + [96, T, 6, 1, 1] * 2
    for rows, st in ((S, strides[:4]), (T, strides[4:8]), (T, strides[8:])):
        assert st == [2 * 96, 2 * 96 * rows] + [2 * 96 * rows * 6] * 2
    assert out_strides == [0, 0, S * 96, 96]
    assert lead_coords(lead, dims, 4) == [[4, 0, 0]] * 3


def test_tensor_maps_raise_on_unaligned_bf16_strides():
    """TMA takes strides in multiples of 16 bytes: 8 bf16 elements."""
    base = torch.zeros((64, 132), dtype=torch.bfloat16)
    bad = base[:, :128]                      # rows 264 bytes apart
    with pytest.raises(ValueError, match="multiples of 8"):
        tensor_maps(bad, bad, bad, torch.empty_like(bad))
    good = torch.zeros((64, 136), dtype=torch.bfloat16)[:, :128]
    lead, dims, strides, _ = tensor_maps(good, good, good, good)
    assert dims[:2] == [128, 64] and strides[0] == 272


def test_bf16_bits_round_to_nearest():
    """The kernel's P_lo rounding by bits (half an ulp added, low half
    dropped) is round to nearest, away from zero only at exact ties."""
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=100_000).astype(np.float32) * 1e-3)
    tie = (x.view(torch.int32) & 0xFFFF) == 0x8000
    got = _bf16_bits(x)
    assert torch.equal(got[~tie], x[~tie].to(torch.bfloat16).float())
    assert torch.equal(got.to(torch.bfloat16).float(), got)


# ------------------------------------------------------------- backward --
# flash_attention_bwd has no Pallas counterpart (the reference trains
# through attend, which jax differentiates); its plain version is held
# against jax.vjp of the reference's oracle and against torch autograd of
# flash_attention_plain, both with k and v expanded over the query group
# and the group's gradients summed.  Tolerances: 1e-4 relative to the
# largest gradient in f32 (summation order: the oracle's vjp and the
# recompute formulas sum in different orders), 2e-2 in bf16 (one rounding
# of each gradient; the inputs are the same bf16 numbers on both sides).

def _ref_vjp(q, k, v, dout, causal):
    """jax.vjp of ref.flash_attention_ref over q's leading dims, k and v
    broadcast to them; dk, dv summed back to k's shape."""
    lead = q.shape[:-2]
    kb = np.broadcast_to(k, lead + k.shape[-2:])
    vb = np.broadcast_to(v, lead + v.shape[-2:])
    fn = lambda a, b, c: ref.flash_attention_ref(a, b, c, causal=causal)
    for _ in range(len(lead)):
        fn = jax.vmap(fn)
    _, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, kb, vb)))
    dq, dk, dv = (np.asarray(g, np.float32) for g in vjp(jnp.asarray(dout)))
    axes = tuple(i for i, (n, m) in enumerate(zip(lead, k.shape[:-2]))
                 if m == 1 and n != 1)
    return dq, dk.sum(axes, keepdims=True), dv.sum(axes, keepdims=True)


BWD_CASES = [((64, 16), (64, 16), True), ((37, 16), (53, 16), True),
             ((37, 16), (53, 16), False), ((2, 3, 4, 29, 32),
                                           (2, 3, 1, 29, 32), True),
             ((2, 4, 21, 16), (1, 4, 21, 16), False)]


@pytest.mark.parametrize("shape_q,shape_kv,causal", BWD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_plain_matches_reference_vjp(shape_q, shape_kv,
                                                         causal, dtype):
    (q, k, v), (tq, tk, tv), _ = _inputs(shape_q, shape_kv, dtype, 11)
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(5)
    dout = np.asarray(jnp.asarray(rng.normal(size=shape_q), jdt))
    tdo = tensor_from_numpy(dout, "cpu")
    out, lse = ops.flash_attention(tq, tk, tv, causal=causal,
                                   return_lse=True)
    got = ops.flash_attention_bwd(tq, tk, tv, out, tdo, lse, causal=causal)
    want = _ref_vjp(q, k, v, dout, causal)
    # torch autograd of the plain forward, in float64
    t64 = [t.to(torch.float64).requires_grad_() for t in (tq, tk, tv)]
    o64 = ops.flash_attention_plain(*t64, causal=causal)
    auto = torch.autograd.grad(o64, t64, tdo.to(torch.float64))
    tol = 1e-4 if dtype == "float32" else 2e-2
    for g, w, a, t in zip(got, want, auto, (tq, tk, tv)):
        assert g.dtype == tdt and g.shape == t.shape
        scale = max(float(np.abs(w).max()), 1.0)
        g32 = g.to(torch.float32).numpy()
        np.testing.assert_allclose(g32, w, rtol=0, atol=tol * scale)
        np.testing.assert_allclose(g32, a.numpy(), rtol=0, atol=tol * scale)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_train_gradients_are_the_plain_autograd(causal):
    """The autograd function (forward kernel, backward kernel) on the
    model's permuted views gives the gradients torch autograd gives the
    plain forward, in the inputs' shapes."""
    rng = np.random.default_rng(3)
    B, S, K, G, H = 2, 45, 2, 3, 16
    q0 = torch.as_tensor(rng.normal(size=(B, S, K, G, H)), dtype=torch.float32)
    k0 = torch.as_tensor(rng.normal(size=(B, S, K, H)), dtype=torch.float32)
    v0 = torch.as_tensor(rng.normal(size=(B, S, K, H)), dtype=torch.float32)
    dout = torch.as_tensor(rng.normal(size=(B, K, G, S, H)),
                           dtype=torch.float32)
    views = lambda q, k, v: (q.permute(0, 2, 3, 1, 4),
                             k.permute(0, 2, 1, 3).unsqueeze(2),
                             v.permute(0, 2, 1, 3).unsqueeze(2))
    a = [t.clone().requires_grad_() for t in (q0, k0, v0)]
    ops.flash_attention_train(*views(*a), causal=causal).backward(dout)
    b = [t.clone().requires_grad_() for t in (q0, k0, v0)]
    ops.flash_attention_plain(*views(*b), causal=causal).backward(dout)
    for x, y in zip(a, b):
        assert x.grad.shape == y.grad.shape
        np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(),
                                   rtol=1e-5, atol=1e-5)


def _kv_heads(lead, kdims):
    """The backward kernels' grouping, as csrc/flash_attention_bwd.cu's
    kv_lead computes it: for each kv head u (row-major over the leading
    dims k's map indexes, size > 1) the leading coordinates of its G query
    heads, g row-major over the dims k broadcasts over."""
    ki = [kdims[4 - i] > 1 for i in range(3)]
    own = [n if x else 1 for n, x in zip(lead, ki)]
    shared = [1 if x else n for n, x in zip(lead, ki)]
    heads = []
    for u in range(math.prod(own)):
        cu = np.unravel_index(u, own)
        heads.append([tuple(int(cu[i] if ki[i] else cg[i]) for i in range(3))
                      for cg in (np.unravel_index(g, shared)
                                 for g in range(math.prod(shared)))])
    return heads


@pytest.mark.parametrize("shape_q,shape_kv", [
    ((2, 8, 4, 33, 16), (2, 8, 1, 33, 16)),     # the model's views
    ((2, 3, 4, 9, 16), (2, 1, 4, 9, 16)),       # k shared over a middle dim
    ((4, 9, 16), (1, 9, 16)), ((1, 5, 9, 16), (1, 5, 9, 16))])
def test_flash_attention_bwd_kernel_layout(shape_q, shape_kv):
    """``bwd_layout``, what the kernels read: their grouping of q heads
    by kv head (``_kv_heads``, from the maps' sizes) covers every q head
    once, and the plain backward per q head, dk and dv summed over each
    kv head's group in that order, equals the plain backward on the
    inputs."""
    from repro_torch.kernels.flash_attention import bwd_layout
    rng = np.random.default_rng(1)
    q, out, dout = (torch.as_tensor(rng.normal(size=shape_q),
                                    dtype=torch.float32) for _ in range(3))
    k, v = (torch.as_tensor(rng.normal(size=shape_kv), dtype=torch.float32)
            for _ in range(2))
    lse = torch.logsumexp(fa._masked_scores(q, k, True), dim=-1)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    lead, dims, _, _ = bwd_layout(q, k, v, out, dout, dq, dk, dv)
    heads = _kv_heads(lead, dims[5:10])
    seen = sorted(c for group in heads for c in group)
    assert seen == sorted(np.ndindex(*lead))
    # the kernels' view of every tensor: (lead0, lead1, lead2, rows, d)
    view = lambda t: t.expand(*q.shape[:-2], *t.shape[-2:]).reshape(
        *lead, *t.shape[-2:])
    qv, kv_, vv, ov, dov = (view(t) for t in (q, k, v, out, dout))
    lv = lse.reshape(*lead, -1)
    want = ops.flash_attention_bwd_plain(q, k, v, out, dout, lse)
    dq_w, dk_w, dv_w = (view(t) for t in want)
    for group in heads:
        sk = sv = 0
        for c in group:
            g = ops.flash_attention_bwd_plain(qv[c], kv_[c], vv[c], ov[c],
                                              dov[c], lv[c])
            np.testing.assert_allclose(g[0].numpy(), dq_w[c].numpy(),
                                       rtol=1e-5, atol=1e-5)
            sk, sv = sk + g[1], sv + g[2]
        np.testing.assert_allclose(sk.numpy(), dk_w[group[0]].numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(sv.numpy(), dv_w[group[0]].numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_flash_attention_bwd_hands_over_the_model_views_uncopied():
    """The training path's views through ``bwd_launch_args``: every
    pointer handed to the bf16 entry point is a tensor's own data
    pointer, the maps describe the views' own strides (k's and v's group
    dim of size 1), dq, dk and dv come back in q's, k's and v's shapes and
    strides, and the output gradient autograd hands the backward comes in
    out's memory order, so nothing is made dense on the way."""
    B, S, K, G, H = 2, 40, 3, 4, 64
    bf = torch.bfloat16
    q = torch.zeros((B, S, K, G, H), dtype=bf).permute(0, 2, 3, 1, 4)
    k, v = (torch.zeros((B, S, K, H), dtype=bf).permute(0, 2, 1, 3)
            .unsqueeze(2) for _ in range(2))
    out = torch.empty_like(q)
    # autograd's gradient of out through the model's permute and the
    # projection's (B, S, K * G * H) reshape
    recorded = {}
    inner = fa.flash_attention_bwd

    def record(q_, k_, v_, out_, dout_, lse_, causal=True):
        recorded["dout"] = dout_
        return inner(q_, k_, v_, out_, dout_, lse_, causal=causal)
    fa.flash_attention_bwd = record
    try:
        x = [torch.randn(t.shape).to(bf).requires_grad_() for t in (q, k, v)]
        y = ops.flash_attention_train(*x).permute(0, 3, 1, 2, 4)
        (y.reshape(B, S, -1).float() ** 2).sum().backward()
    finally:
        fa.flash_attention_bwd = inner
    dout = recorded["dout"]
    assert fa._strided_ok(dout) and dout.stride() == out.stride()
    lse = torch.empty(q.shape[:-1])
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    for got, x in ((dq, q), (dk, k), (dv, v)):
        assert got.shape == x.shape and got.stride() == x.stride()
    scratch = torch.empty(2 * B * K * G * 64)
    args = fa.bwd_launch_args(q, k, v, out, dout, lse, dq, dk, dv, scratch)
    assert args[:10] == [t.data_ptr() for t in (q, k, v, out, dout, lse, dq,
                                                 dk, dv, scratch)]
    dims, strides, lead, out_strides = (list(a) for a in args[10:14])
    assert args[14:] == [S, S, H] and lead == [B, K, G]
    assert dims[:5] == dims[15:20] == dims[20:25] == [H, S, G, K, B]
    assert dims[5:10] == dims[10:15] == [H, S, 1, K, B]
    q_bytes = [2 * K * G * H, 2 * H, 2 * G * H, 2 * S * K * G * H]
    assert strides[:4] == strides[12:16] == strides[16:20] == q_bytes
    assert strides[4:8] == strides[8:12] == [2 * K * H, 2 * S * K * H, 2 * H,
                                             2 * S * K * H]
    assert out_strides == [S * K * G * H, G * H, H, K * G * H] \
        + [S * K * H, H, 0, K * H] * 2


# ------------------------------------------------ the bf16 backward's model --
# csrc/flash_attention_bwd.cu's bf16 arithmetic: S and dP as f32 sums of
# exact bf16 products, P = exp2(fma(S, log2(e)/sqrt(d), -lse log2(e))) from
# the forward's lse, D = rowsum(dO * O) in f32, dS = P (dP - D) in f32, and
# the three gradient products from single bf16 P and dS (exact products,
# f32 sums).  Held to chip_smoke.py's phase-11a limit: BWD_TOL x max(1,
# max |want|) of each gradient against jax.vjp of the oracle.

BWD_TOL = 1e-2              # chip_smoke.py's BWD_TOL["bfloat16"]


def _bwd_model(q, k, v, out, dout, lse, causal):
    qf, kf, vf, of, dof = (t.to(torch.float32) for t in (q, k, v, out, dout))
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)
    scale = 1 / torch.sqrt(torch.tensor(float(q.shape[-1])))
    c = log2e * scale
    s = torch.matmul(qf, kf.transpose(-1, -2))
    l2 = (lse * log2e)[..., None]
    # fma(s, c, -l2): one rounding, as float64 holds s * c exactly
    p = torch.exp2((s.double() * c.double() - l2.double()).float())
    if causal:
        S, T = s.shape[-2:]
        p = torch.where(torch.arange(S)[:, None] >= torch.arange(T)[None, :],
                        p, 0.0)
    delta = (dof * of).sum(-1, keepdim=True)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta)
    pb, dsb = (t.to(torch.bfloat16).to(torch.float32) for t in (p, ds))
    dq = torch.matmul(dsb, kf) * scale
    dk = fa._sum_to(torch.matmul(dsb.transpose(-1, -2), qf) * scale, k.shape)
    dv = fa._sum_to(torch.matmul(pb.transpose(-1, -2), dof), v.shape)
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


BWD_MODEL_CASES = [  # q shape, kv shape, causal, input scale
    ((1, 2, 2, 200, 64), (1, 2, 1, 200, 64), True, 0.25),
    ((1, 2, 2, 200, 64), (1, 2, 1, 200, 64), True, 1.0),
    ((130, 64), (250, 64), False, 3.0),
    ((1, 2, 2, 200, 96), (1, 2, 1, 200, 96), True, 1.0),
    ((130, 96), (250, 96), False, 0.25),
    ((1, 2, 2, 150, 96), (1, 2, 1, 150, 96), True, 3.0),
    ((1, 2, 2, 256, 128), (1, 2, 1, 256, 128), True, 0.25),
    ((1, 2, 2, 256, 128), (1, 2, 1, 256, 128), True, 1.0),
    ((1, 2, 2, 256, 128), (1, 2, 1, 256, 128), True, 3.0),
]


@pytest.mark.parametrize("shape_q,shape_kv,causal,scale", BWD_MODEL_CASES)
def test_bwd_kernel_model_within_the_phase_11a_limit(shape_q, shape_kv,
                                                     causal, scale):
    """The bf16 backward kernels' arithmetic, on the forward kernel's
    modelled output and lse, against jax.vjp of the reference oracle at
    head dims 64, 96 and 128 and input scales 0.25, 1 and 3: each of dq,
    dk and dv within BWD_TOL x max(1, max |want|)."""
    rng = np.random.default_rng(shape_q[-2] * 7 + shape_q[-1])
    arrs = [np.asarray(jnp.asarray(scale * rng.normal(size=sh),
                                   jnp.bfloat16))
            for sh in (shape_q, shape_kv, shape_kv)]
    dout = np.asarray(jnp.asarray(rng.normal(size=shape_q), jnp.bfloat16))
    tq, tk, tv, tdo = (tensor_from_numpy(a, "cpu")
                       for a in (*arrs, dout))
    _, lse = ops.flash_attention_plain(tq, tk, tv, causal=causal,
                                       return_lse=True)
    out = _kernel_model(tq, tk, tv, causal)
    got = _bwd_model(tq, tk, tv, out, tdo, lse, causal)
    want = _ref_vjp(*arrs, dout, causal)
    for g, w, t in zip(got, want, (tq, tk, tv)):
        assert g.shape == t.shape
        limit = BWD_TOL * max(1.0, float(np.abs(w).max()))
        assert float(np.abs(g.float().numpy() - w).max()) <= limit
