"""Grouped-query attention with a TP-even head layout, KV caching, and
memory-bounded (chunked online-softmax) cores for long sequences.

HeadLayout
----------
q/o weights are stored in a ``(kv_eff, g_eff, head_dim)`` layout with
``kv_eff % tp == 0``: each kv_eff slot serves g_eff q slots whose keys and
values it holds; kv weights are stored raw ``(d, n_kv, hd)`` and expanded
to kv_eff slots with a static gather ``wk[:, kv_map, :]``; surplus slots
are dead (zero-init q weights, a hard output mask), so the math is exactly
the published architecture.  At tp = 1 every layout is the plain GQA one:
kv_eff = n_kv, g_eff = n_q / n_kv, no dead slot.

Mirrors ``src/repro/models/attention.py``, with the reference's tensor
layouts: q ``(B, S, K, G, H)``, k and v ``(B, T, K, H)``.  ``HeadLayout``
and ``resolve_head_layout`` are verbatim.  The cores ``attend_full`` and
``attend_chunked`` stay plain PyTorch, as the reference computes them
outside any Pallas kernel; the prefill's causal self-attention goes to the
Hopper flash kernel instead (models/transformer.py).  ``cache_update``
writes the cache in place (the reference returns an updated copy), which
keeps one cache alive instead of two.  The int8 KV cache
(``quantize_kv``/``dequantize_kv``) keeps the reference's symmetric
codes and per-token, per-head f32 scales.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .layers import apply_rope, rmsnorm, rmsnorm_decl
from .params import ParamDecl

NEG_INF = -1e9
CHUNKED_THRESHOLD = 8192   # use chunked online-softmax core above this T
KV_CHUNK = 1024


@dataclasses.dataclass(frozen=True)
class HeadLayout:
    n_q: int
    n_kv: int
    head_dim: int
    tp: int
    kv_eff: int
    g_eff: int
    kv_map: Tuple[int, ...]   # len kv_eff; original kv head (dead slots -> 0)
    q_map: Tuple[int, ...]    # len kv_eff*g_eff; original q head or -1
    alive: Tuple[int, ...]    # len kv_eff*g_eff; 1 if slot is a real q head

    @property
    def n_q_eff(self) -> int:
        return self.kv_eff * self.g_eff

    @property
    def n_dead(self) -> int:
        return self.n_q_eff - self.n_q

    def alive_mask(self) -> np.ndarray:
        return np.asarray(self.alive, np.float32).reshape(
            self.kv_eff, self.g_eff)


def resolve_head_layout(n_q: int, n_kv: int, head_dim: int,
                        tp: int) -> HeadLayout:
    assert n_q % n_kv == 0, (n_q, n_kv)
    group = n_q // n_kv
    if n_kv >= tp:
        kv_eff = -(-n_kv // tp) * tp
        g_eff = group
        kv_map, q_map = [], []
        for j in range(kv_eff):
            kv_map.append(j if j < n_kv else 0)
            for g in range(g_eff):
                q_map.append(j * group + g if j < n_kv else -1)
    else:
        g_eff = max(1, -(-n_q // tp))
        # grow g_eff until all (kv, q-chunk) pairs fit in tp slots
        while n_kv * (-(-group // g_eff)) > tp:
            g_eff += 1
        kv_map, q_map = [], []
        for k in range(n_kv):
            qs = list(range(k * group, (k + 1) * group))
            for c in range(0, group, g_eff):
                kv_map.append(k)
                chunk = qs[c: c + g_eff]
                chunk += [-1] * (g_eff - len(chunk))
                q_map.extend(chunk)
        while len(kv_map) < tp:
            kv_map.append(0)
            q_map.extend([-1] * g_eff)
        kv_eff = len(kv_map)
    alive = tuple(1 if q >= 0 else 0 for q in q_map)
    return HeadLayout(n_q, n_kv, head_dim, tp, kv_eff, g_eff,
                      tuple(kv_map), tuple(q_map), alive)


# ---------------------------------------------------------------------------
# Param decls
# ---------------------------------------------------------------------------

def attention_decls(d: int, layout: HeadLayout, qk_norm: bool,
                    cross: bool = False) -> Dict[str, Any]:
    hd = layout.head_dim
    decls = {
        "wq": ParamDecl((d, layout.kv_eff, layout.g_eff, hd),
                        ("embed", "kv_heads_eff", "q_group", "head_dim")),
        "wk": ParamDecl((d, layout.n_kv, hd),
                        ("embed", "kv_heads", "head_dim")),
        "wv": ParamDecl((d, layout.n_kv, hd),
                        ("embed", "kv_heads", "head_dim")),
        "wo": ParamDecl((layout.kv_eff, layout.g_eff, hd, d),
                        ("kv_heads_eff", "q_group", "head_dim", "embed")),
    }
    if qk_norm:
        decls["q_norm"] = rmsnorm_decl(hd)
        decls["k_norm"] = rmsnorm_decl(hd)
    if cross:
        decls["gate"] = ParamDecl((1,), (None,), init="zeros")
    return decls


def _expand_kv_weight(w: torch.Tensor, layout: HeadLayout) -> torch.Tensor:
    """(d, n_kv, hd) -> (d, kv_eff, hd): the static gather over kv_map.
    Where kv_map is the identity (every layout at tp = 1) the gather would
    copy the weight unchanged, so the weight itself is returned."""
    if layout.kv_map == tuple(range(w.shape[1])):
        return w
    idx = torch.tensor(layout.kv_map, dtype=torch.long, device=w.device)
    return torch.index_select(w, 1, idx)


def project_qkv(p, x: torch.Tensor, layout: HeadLayout, *,
                positions: Optional[torch.Tensor], rope_theta: float,
                qk_norm: bool, kv_x: Optional[torch.Tensor] = None):
    """x: (B,S,d) -> q (B,S,kv_eff,g_eff,hd), k/v (B,T,kv_eff,hd).

    kv_x: source for k/v (cross attention); defaults to x.
    positions=None skips RoPE (cross attention / encoder option)."""
    src = x if kv_x is None else kv_x
    q = torch.einsum("bsd,dkgh->bskgh", x, p["wq"].to(x.dtype))
    wk = _expand_kv_weight(p["wk"].to(x.dtype), layout)
    wv = _expand_kv_weight(p["wv"].to(x.dtype), layout)
    k = torch.einsum("btd,dkh->btkh", src, wk)
    v = torch.einsum("btd,dkh->btkh", src, wv)
    if qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    if positions is not None:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


def output_proj(p, ctx: torch.Tensor, layout: HeadLayout) -> torch.Tensor:
    """ctx (B,S,kv_eff,g_eff,hd) -> (B,S,d), dead slots hard-masked."""
    if layout.n_dead:
        mask = torch.as_tensor(layout.alive_mask(), dtype=ctx.dtype,
                               device=ctx.device)
        ctx = ctx * mask[None, None, :, :, None]
    return torch.einsum("bskgh,kghd->bsd", ctx, p["wo"].to(ctx.dtype))


# ---------------------------------------------------------------------------
# Attention cores
# ---------------------------------------------------------------------------

def _mask_bias(q_pos, k_pos, causal: bool, window: Optional[int]):
    """(S,T) additive bias from absolute positions."""
    d = q_pos[:, None] - k_pos[None, :]
    ok = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if causal:
        ok &= d >= 0
    if window is not None:
        ok &= d < window
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def attend_full(q, k, v, q_pos, k_pos, *, causal: bool,
                window: Optional[int]) -> torch.Tensor:
    """Materialized-scores core. q (B,S,K,G,H), k/v (B,T,K,H).  Scores
    in q's type, then divided by sqrt(H) and softmaxed in f32 (the
    reference divides by a numpy float64, which promotes bf16 to f32),
    probabilities cast back to q's type before P.V."""
    hd = q.shape[-1]
    scores = torch.einsum("bskgh,btkh->bkgst", q, k).to(torch.float32) \
        / math.sqrt(hd)
    bias = _mask_bias(q_pos, k_pos, causal, window)
    probs = torch.softmax(scores + bias, dim=-1)
    return torch.einsum("bkgst,btkh->bskgh", probs.to(q.dtype), v)


def attend_chunked(q, k, v, q_pos, k_pos, *, causal: bool,
                   window: Optional[int], chunk: int = KV_CHUNK
                   ) -> torch.Tensor:
    """Online-softmax over KV chunks: O(S*chunk) live memory instead of
    O(S*T).  The reference's ``lax.scan`` over chunks is a Python loop."""
    B, S, K, G, H = q.shape
    T = k.shape[1]
    n_chunks = -(-T // chunk)
    pad = n_chunks * chunk - T
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = torch.nn.functional.pad(k_pos, (0, pad), value=-10**9)
    scale = 1.0 / np.sqrt(H)
    acc = torch.zeros((B, S, K, G, H), dtype=torch.float32, device=q.device)
    m = torch.full((B, K, G, S), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, K, G, S), dtype=torch.float32, device=q.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        kc, vc, kp = k[:, sl], v[:, sl], k_pos[sl]
        s = torch.einsum("bskgh,btkh->bkgst", q, kc).to(torch.float32) \
            * scale
        s = s + _mask_bias(q_pos, kp, causal, window)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bkgst,btkh->bskgh", p.to(q.dtype), vc)
        acc = acc * alpha.permute(0, 3, 1, 2)[..., None] + \
            pv.to(torch.float32)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30).permute(0, 3, 1, 2)[..., None]
    return out.to(q.dtype)


def attend(q, k, v, q_pos, k_pos, *, causal: bool = True,
           window: Optional[int] = None) -> torch.Tensor:
    if k.shape[1] > CHUNKED_THRESHOLD:
        return attend_chunked(q, k, v, q_pos, k_pos, causal=causal,
                              window=window)
    return attend_full(q, k, v, q_pos, k_pos, causal=causal, window=window)


# ---------------------------------------------------------------------------
# KV cache (decode) -- optionally int8-quantized (one scale per token and
# head)
# ---------------------------------------------------------------------------


_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def quantize_kv(x: torch.Tensor):
    """(B,T,K,H) -> (int8 codes, f32 scale (B,T,K,1)); symmetric.
    ``torch.round`` rounds half to even, as ``jnp.round`` does.  The
    reference writes ``max / 127``; compiled, as its model runs it, XLA
    makes that a product with 1/127 rounded to f32, which differs from the
    quotient by an ulp of some scales, so the port takes the product."""
    xf = x.to(torch.float32)
    s = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) * _INV_127,
                    min=1e-8)
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return q, s


def dequantize_kv(q: torch.Tensor, s: torch.Tensor, dtype) -> torch.Tensor:
    return (q.to(torch.float32) * s).to(dtype)


def cache_decl_shapes(batch: int, max_len: int, layout: HeadLayout,
                      window: Optional[int]):
    """Shape/axes for one layer's KV cache. Window layers use a ring buffer
    of the window size; global layers hold the full context."""
    T = min(max_len, window) if window else max_len
    shape = (batch, T, layout.kv_eff, layout.head_dim)
    axes = ("batch", "kv_seq", "kv_heads_eff", "head_dim")
    return shape, axes


def cache_update(cache_k, cache_v, k_new, v_new, pos: int,
                 window: Optional[int]):
    """Insert one step's k/v at absolute position ``pos`` (ring for SWA),
    in place.  As ``lax.dynamic_update_slice`` does, a start past the end
    is clamped so the update fits.  Returns the (same) caches."""
    T = cache_k.shape[1]
    n = k_new.shape[1]
    idx = (pos % T) if window else pos
    idx = max(0, min(int(idx), T - n))
    cache_k[:, idx:idx + n] = k_new.to(cache_k.dtype)
    cache_v[:, idx:idx + n] = v_new.to(cache_v.dtype)
    return cache_k, cache_v


def cache_positions(pos: int, T: int, window: Optional[int], device=None):
    """Absolute positions of each cache slot given current write pos."""
    slots = torch.arange(T, device=device)
    if not window:
        # slot i holds absolute position i; unwritten slots get -10**9
        return torch.where(slots <= pos, slots, -10**9)
    # ring: slot i holds the largest p <= pos with p % T == i
    cur = pos % T
    p = pos - ((cur - slots) % T)
    return torch.where(p >= 0, p, -10**9)


def attend_decode(q, cache_k, cache_v, pos: int,
                  window: Optional[int]) -> torch.Tensor:
    """q (B,1,K,G,H) against the cache (B,T,K,H); pos = current abs pos."""
    T = cache_k.shape[1]
    k_pos = cache_positions(pos, T, window, q.device)
    q_pos = torch.full((1,), pos, device=q.device)   # a fill, no copy
    return attend_full(q, cache_k, cache_v, q_pos, k_pos,
                       causal=True, window=window)
