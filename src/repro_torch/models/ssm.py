"""Mamba2 SSD (state-space duality) mixer.

Train/prefill use the chunked block-matmul dual form (the inner loops are
(L x L) and (N x P) matmuls per chunk); decode uses the O(1) recurrent form
with a conv ring buffer + (H, N, P) state.

TP layout: SSD heads are padded to a multiple of the model axis
(24 -> 32 at tp=16) with dead heads zero-init and hard-masked, mirroring
attention's HeadLayout policy. B/C projections are per-group (G=1 for the
assigned archs) and replicated over 'model'.

Numerics: all decay terms are exp of non-positive cumulative sums (A < 0),
so nothing overflows; accumulation is fp32.

Mirrors ``src/repro/models/ssm.py``.  ``SSMLayout``,
``resolve_ssm_layout``, ``ssm_decls`` and ``ssm_cache_shapes`` are
verbatim, and so is ``_head_groups``.  Every config has one B/C group
(``resolve_ssm_layout`` sets G = 1), so the port broadcasts that group to
the heads where the reference gathers it with ``_head_groups``' indices.
The reference computes the scan with plain ``jnp`` (einsums, a ``cumsum``, a ``lax.scan``), outside any Pallas
kernel, so the port's is plain PyTorch: the ``lax.scan`` over chunks is a
Python loop, and the reference's ``shard_hint`` calls (identities on one
card) are left out.  Two choices keep the reference's roundings where a
library call would read the same but round otherwise, and one keeps a
single cache alive:

* ``softplus`` is ``jnp.logaddexp(x, 0)``'s formula (what
  ``jax.nn.softplus`` computes), not ``torch.nn.functional.softplus``;
* each three-operand einsum of the reference is two pairwise products in
  one fixed order, the order ``jnp.einsum``'s path takes at the reduced
  configs (``torch.einsum`` would follow opt_einsum only where that
  package is installed, and the order changes the bf16 roundings);
* ``ssm_decode_step`` writes the new state and conv rings into the cache
  it is given (the reference returns new arrays), as the attention cache
  is written in place: the decoder hands a stacked segment's cache back
  as it received it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..configs.base import SSMConfig
from .layers import silu
from .params import ParamDecl


@dataclasses.dataclass(frozen=True)
class SSMLayout:
    n_heads: int      # real heads = d_inner // head_dim
    h_eff: int        # padded to multiple of tp
    head_dim: int     # P
    d_state: int      # N
    n_groups: int     # G (1 for assigned archs)
    d_conv: int

    def alive_mask(self) -> np.ndarray:
        m = np.zeros(self.h_eff, np.float32)
        m[: self.n_heads] = 1
        return m


def resolve_ssm_layout(d_model: int, ssm: SSMConfig, tp: int) -> SSMLayout:
    d_inner = ssm.expand * d_model
    h = d_inner // ssm.head_dim
    h_eff = -(-h // tp) * tp
    # G = 1: ``_per_head`` relies on it
    return SSMLayout(h, h_eff, ssm.head_dim, ssm.d_state, 1, ssm.d_conv)


def ssm_decls(d: int, lo: SSMLayout) -> Dict[str, Any]:
    H, P, N, G, K = lo.h_eff, lo.head_dim, lo.d_state, lo.n_groups, lo.d_conv
    return {
        "wz": ParamDecl((d, H, P), ("embed", "ssm_heads", "head_dim")),
        "wx": ParamDecl((d, H, P), ("embed", "ssm_heads", "head_dim")),
        "wB": ParamDecl((d, G, N), ("embed", None, "ssm_state")),
        "wC": ParamDecl((d, G, N), ("embed", None, "ssm_state")),
        "wdt": ParamDecl((d, H), ("embed", "ssm_heads")),
        "dt_bias": ParamDecl((H,), ("ssm_heads",), init="zeros"),
        "A_log": ParamDecl((H,), ("ssm_heads",), init="ones"),
        "D": ParamDecl((H,), ("ssm_heads",), init="ones"),
        "conv_x": ParamDecl((K, H, P), ("conv", "ssm_heads", "head_dim")),
        "conv_B": ParamDecl((K, G, N), ("conv", None, "ssm_state")),
        "conv_C": ParamDecl((K, G, N), ("conv", None, "ssm_state")),
        "norm": ParamDecl((H, P), ("ssm_heads", "head_dim"), init="ones"),
        "wo": ParamDecl((H, P, d), ("ssm_heads", "head_dim", "embed")),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, i.e. ``jnp.logaddexp(x, 0)``: max(x, 0) +
    log1p(exp(-|x|)).  ``torch.nn.functional.softplus`` computes
    log1p(exp(x)) and returns x above 20, which rounds otherwise."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along axis 1. x (B,S,...), w (K, ...)."""
    K = w.shape[0]
    S = x.shape[1]
    out = x * w[K - 1]
    for i in range(K - 1):
        shift = K - 1 - i
        pad = (0, 0) * (x.dim() - 2) + (shift, 0)
        xi = torch.nn.functional.pad(x, pad)[:, :S]
        out = out + xi * w[i]
    return out


def _conv_step(state: torch.Tensor, x_new: torch.Tensor, w: torch.Tensor):
    """Decode-time conv: state (B,K,...) ring holding the last K inputs.
    Returns the shifted ring (a new tensor) and the conv's output."""
    state = torch.cat([state[:, 1:], x_new[:, None]], dim=1)
    out = torch.einsum("bk...,k...->b...", state, w.to(state.dtype))
    return state, out


def _project(p, u: torch.Tensor, lo: SSMLayout):
    """u (B,S,d) -> z,x (B,S,H,P), B,C (B,S,G,N), dt (B,S,H) (pre-conv)."""
    dt = u @ p["wdt"].to(u.dtype)
    z = torch.einsum("bsd,dhp->bshp", u, p["wz"].to(u.dtype))
    x = torch.einsum("bsd,dhp->bshp", u, p["wx"].to(u.dtype))
    Bm = torch.einsum("bsd,dgn->bsgn", u, p["wB"].to(u.dtype))
    Cm = torch.einsum("bsd,dgn->bsgn", u, p["wC"].to(u.dtype))
    return z, x, Bm, Cm, dt


def _finish(p, y: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
            lo: SSMLayout) -> torch.Tensor:
    """y,x,z (B,S,H,P) -> (B,S,d): +Dx, gated RMSNorm, dead-head mask, out."""
    y = y + p["D"].to(y.dtype)[:, None] * x
    y = y * silu(z.to(torch.float32)).to(y.dtype)
    yf = y.to(torch.float32)
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    y = (yf * torch.rsqrt(var + 1e-6)).to(y.dtype) * p["norm"].to(y.dtype)
    if lo.h_eff != lo.n_heads:
        # at tp = 1 every head is alive and the mask is all ones
        mask = torch.as_tensor(lo.alive_mask(), dtype=y.dtype,
                               device=y.device)
        y = y * mask[:, None]
    return torch.einsum("bshp,hpd->bsd", y, p["wo"].to(y.dtype))


def _head_groups(lo: SSMLayout) -> torch.Tensor:
    """Real head h -> group h*G//n_heads; dead heads -> group 0."""
    g = np.zeros(lo.h_eff, np.int32)
    for h in range(lo.n_heads):
        g[h] = h * lo.n_groups // lo.n_heads
    return torch.as_tensor(g)


def _per_head(t: torch.Tensor, lo: SSMLayout, dim: int) -> torch.Tensor:
    """The reference's ``t[..., _head_groups(lo), ...]`` along ``dim``
    (groups -> heads): with its one group, a broadcast view, no copy."""
    assert lo.n_groups == 1 and t.shape[dim] == 1, (lo, t.shape)
    shape = list(t.shape)
    shape[dim] = lo.h_eff
    return t.expand(shape)


def _silu_f32(t: torch.Tensor) -> torch.Tensor:
    return silu(t.to(torch.float32)).to(t.dtype)


def ssd_apply(p, u: torch.Tensor, lo: SSMLayout, chunk: int,
              initial_state: Optional[torch.Tensor] = None,
              return_state: bool = False):
    """Chunked SSD over a full sequence. u (B,S,d) -> (B,S,d).

    S is padded internally to a multiple of ``chunk``; padded positions get
    dt=0 (identity decay, zero input) so the returned final state is exactly
    the state after the S real tokens.  The reference's five ``shard_hint``
    calls (``repro/models/ssm.py:163, 173, 179, 182, 202``) pin heads to
    the mesh's model axis; on one card they are identities and are left
    out."""
    B, S0, d = u.shape
    L = chunk
    S = -(-S0 // L) * L
    if S != S0:
        u = torch.nn.functional.pad(u, (0, 0, 0, S - S0))
    nc = S // L
    z, x, Bm, Cm, dt = _project(p, u, lo)
    x = _causal_conv(x, p["conv_x"].to(x.dtype))
    Bm = _causal_conv(Bm, p["conv_B"].to(Bm.dtype))
    Cm = _causal_conv(Cm, p["conv_C"].to(Cm.dtype))
    x, Bm, Cm = (_silu_f32(t) for t in (x, Bm, Cm))

    dt = softplus(dt.to(torch.float32)
                  + p["dt_bias"].to(torch.float32))              # (B,S,H)
    if S != S0:
        valid = (torch.arange(S, device=u.device) < S0)[None, :, None]
        dt = dt * valid
    A = -torch.exp(p["A_log"].to(torch.float32))                 # (H,) < 0
    dA = dt * A                                                   # <= 0

    # chunked views
    c = lambda t: t.reshape((B, nc, L) + tuple(t.shape[2:]))
    xc, Bc, Cc, dtc, dAc = c(x), c(Bm), c(Cm), c(dt), c(dA)
    cum = torch.cumsum(dAc, dim=2)                                # (B,nc,L,H)

    # ---- intra-chunk (dual / quadratic-within-chunk form) ----
    CB = torch.einsum("bclgn,bcsgn->bcgls", Cc, Bc)              # (B,nc,G,L,L)
    CBh = _per_head(CB, lo, 2)                                 # (B,nc,H,L,L)
    cumh = cum.permute(0, 1, 3, 2)                                # (B,nc,H,L)
    seg = cumh[..., :, None] - cumh[..., None, :]                 # cum_i-cum_j
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=u.device))
    # mask BEFORE exp: seg is positive above the diagonal and exp overflows
    # there; exp(inf)*0 => NaN in the backward (d(exp)=exp). exp(-inf)=0
    # has a clean zero gradient.
    seg = torch.where(tri, seg, float("-inf"))
    M = torch.exp(seg) * CBh.to(torch.float32) * \
        dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_intra = torch.einsum("bchls,bcshp->bclhp", M.to(u.dtype), xc)

    # ---- chunk states ----
    w = torch.exp(cum[:, :, -1:, :] - cum) * dtc                  # (B,nc,L,H)
    Bh = _per_head(Bc, lo, 3)                                  # (B,nc,L,H,N)
    # the reference's "bclh,bclhn,bclhp->bchnp", (w, B) first
    wB = w.to(u.dtype)[..., None] * Bh
    states = torch.einsum("bclhn,bclhp->bchnp", wB, xc)          # (B,nc,H,N,P)

    # ---- inter-chunk recurrence over nc (the reference's lax.scan) ----
    decay = torch.exp(cum[:, :, -1, :])                           # (B,nc,H)
    s = initial_state if initial_state is not None else torch.zeros(
        (B, lo.h_eff, lo.d_state, lo.head_dim), dtype=torch.float32,
        device=u.device)
    s_prevs = []
    for ci in range(nc):
        s_prevs.append(s)
        s = s * decay[:, ci, :, None, None].to(s.dtype) + \
            states[:, ci].to(s.dtype)
    s_final = s
    s_prevs = torch.stack(s_prevs, dim=1)                         # (B,nc,H,N,P)

    Ch = _per_head(Cc, lo, 3)                                  # (B,nc,L,H,N)
    # the reference's "bclhn,bchnp,bclh->bclhp", (C, s) first
    Cs = torch.einsum("bclhn,bchnp->bclhp", Ch, s_prevs.to(u.dtype))
    y_inter = Cs * torch.exp(cum).to(u.dtype)[..., None]
    y = (y_intra + y_inter).reshape(B, S, lo.h_eff, lo.head_dim)
    out = _finish(p, y, x, z, lo)
    if S != S0:
        out = out[:, :S0]
    if return_state:
        return out, s_final
    return out


def ssd_reference(p, u: torch.Tensor, lo: SSMLayout):
    """Sequential (per-token recurrent) oracle for tests."""
    B, S, d = u.shape
    z, x, Bm, Cm, dt = _project(p, u, lo)
    x = _causal_conv(x, p["conv_x"].to(x.dtype))
    Bm = _causal_conv(Bm, p["conv_B"].to(Bm.dtype))
    Cm = _causal_conv(Cm, p["conv_C"].to(Cm.dtype))
    x, Bm, Cm = (_silu_f32(t) for t in (x, Bm, Cm))
    dt = softplus(dt.to(torch.float32) + p["dt_bias"])
    A = -torch.exp(p["A_log"].to(torch.float32))

    s = torch.zeros((B, lo.h_eff, lo.d_state, lo.head_dim),
                    dtype=torch.float32, device=u.device)
    ys = []
    for t in range(S):
        xt, bt, ct, dtt = x[:, t], Bm[:, t], Cm[:, t], dt[:, t]
        da = torch.exp(dtt * A)                                   # (B,H)
        bh, ch = _per_head(bt, lo, 1), _per_head(ct, lo, 1)    # (B,H,N)
        s = s * da[..., None, None] + _outer(dtt, bh, xt)
        ys.append(torch.einsum("bhn,bhnp->bhp", ch.to(torch.float32), s))
    y = torch.stack(ys, dim=1).to(u.dtype)                        # (B,S,H,P)
    return _finish(p, y, x, z, lo)


def _outer(dtt, bh, xt):
    """The reference's "bh,bhn,bhp->bhnp" in f32, (dt, B) first."""
    db = dtt[..., None] * bh.to(torch.float32)
    return db[..., None] * xt.to(torch.float32)[..., None, :]


# ---------------------------------------------------------------------------
# Decode (recurrent) path
# ---------------------------------------------------------------------------

def ssm_cache_shapes(batch: int, lo: SSMLayout):
    H, P, N, G, K = lo.h_eff, lo.head_dim, lo.d_state, lo.n_groups, lo.d_conv
    return {
        "state": ((batch, H, N, P),
                  ("batch", "ssm_heads", "ssm_state", "head_dim")),
        "conv_x": ((batch, K, H, P),
                   ("batch", "conv", "ssm_heads", "head_dim")),
        "conv_B": ((batch, K, G, N), ("batch", "conv", None, "ssm_state")),
        "conv_C": ((batch, K, G, N), ("batch", "conv", None, "ssm_state")),
    }


def ssm_decode_step(p, cache: Dict[str, torch.Tensor], u: torch.Tensor,
                    lo: SSMLayout):
    """u (B,1,d) one token -> (out (B,1,d), cache): the new state and conv
    rings are written into ``cache`` in place, and ``cache`` is returned."""
    z, x, Bm, Cm, dt = _project(p, u, lo)
    cx, xo = _conv_step(cache["conv_x"], x[:, 0], p["conv_x"].to(x.dtype))
    cb, bo = _conv_step(cache["conv_B"], Bm[:, 0], p["conv_B"].to(x.dtype))
    cc, co = _conv_step(cache["conv_C"], Cm[:, 0], p["conv_C"].to(x.dtype))
    xo, bo, co = (_silu_f32(t) for t in (xo, bo, co))

    dtt = softplus(dt.to(torch.float32)[:, 0] + p["dt_bias"])
    A = -torch.exp(p["A_log"].to(torch.float32))
    da = torch.exp(dtt * A)                                       # (B,H)
    bh, ch = _per_head(bo, lo, 1), _per_head(co, lo, 1)        # (B,H,N)
    s = cache["state"] * da[..., None, None] + _outer(dtt, bh, xo)
    y = torch.einsum("bhn,bhnp->bhp", ch.to(torch.float32), s)
    out = _finish(p, y[:, None].to(u.dtype), xo[:, None], z, lo)
    for name, new in (("state", s), ("conv_x", cx), ("conv_B", cb),
                      ("conv_C", cc)):
        cache[name].copy_(new)
    return out, cache
