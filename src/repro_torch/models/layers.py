"""Shared model layers: norms, RoPE, MLPs, embeddings.

Dtype policy: parameters are held in ``param_dtype`` (fp32 master for
training, bf16 for serving); activations run in ``compute_dtype`` (bf16);
softmax/norm statistics accumulate in fp32.

Mirrors ``src/repro/models/layers.py``.  Every ``.astype(x.dtype)`` of a
weight is kept as ``.to(x.dtype)``: a serving model holds bf16 weights, so
it is a no-op there, and casting f32 master weights to bf16 once at load
gives the same numbers as the reference's cast at every use.  The
reference's ``shard_hint`` pins activations to a mesh; the port runs at
tp = 1 on one device, where the hint is the identity, so it is left out.
The reference's ``Policy`` (a dtype pair that nothing in either package
calls) is left out until a caller needs it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .params import ParamDecl

VOCAB_ALIGN = 256  # pad vocab to a multiple of (data*model) so the embedding
                   # shards evenly on both mesh axes; padded logits are masked.


def pad_vocab(v: int, align: int = VOCAB_ALIGN) -> int:
    return -(-v // align) * align


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_decl(d: int) -> ParamDecl:
    return ParamDecl((d,), (None,), init="ones")


def rmsnorm(scale, x, eps: float = 1e-6):
    """f32 statistics, cast back to x's type, then the scale in that type
    (the reference's cast order, which parity depends on)."""
    dt = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * scale.to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, *heads, head_dim) with positions (B, S).  The two halves
    of the head dim rotate together (split, not interleaved)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    angles = positions.to(torch.float32)[..., None] * freqs  # (B,S,hd/2)
    # broadcast over any interior head axes
    shape = angles.shape[:2] + (1,) * (x.dim() - 3) + angles.shape[-1:]
    angles = angles.reshape(shape)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP blocks
# ---------------------------------------------------------------------------

def mlp_decls(d: int, d_ff: int, kind: str):
    if kind == "swiglu":
        return {
            "wi_gate": ParamDecl((d, d_ff), ("embed", "mlp")),
            "wi_up": ParamDecl((d, d_ff), ("embed", "mlp")),
            "wo": ParamDecl((d_ff, d), ("mlp", "embed")),
        }
    return {  # gelu
        "wi": ParamDecl((d, d_ff), ("embed", "mlp")),
        "wo": ParamDecl((d_ff, d), ("mlp", "embed")),
    }


def _const(c: float, dtype) -> float:
    """A constant as the reference's arithmetic sees it: rounded to the
    working type (PyTorch would otherwise apply it in f32)."""
    return float(torch.tensor(c, dtype=dtype))


def silu(x):
    """``jax.nn.silu`` as XLA computes it: x * 1 / (1 + exp(-x)), every
    op rounded to x's type (``F.silu`` rounds once and differs by an ulp)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def gelu_tanh(x):
    """``jax.nn.gelu(approximate=True)`` as written there, every op and
    constant in x's type."""
    inner = _const(math.sqrt(2 / math.pi), x.dtype) * (
        x + _const(0.044715, x.dtype) * (x * x * x))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def mlp_apply(p, x, kind: str):
    if kind == "swiglu":
        g = x @ p["wi_gate"].to(x.dtype)
        u = x @ p["wi_up"].to(x.dtype)
        return (silu(g) * u) @ p["wo"].to(x.dtype)
    return gelu_tanh(x @ p["wi"].to(x.dtype)) @ p["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding (padded vocab)
# ---------------------------------------------------------------------------

def embed_decls(vocab: int, d: int, tie: bool):
    vp = pad_vocab(vocab)
    decls = {"embedding": ParamDecl((vp, d), ("vocab", "embed"),
                                    init="embed")}
    if not tie:
        decls["unembed"] = ParamDecl((d, vp), ("embed", "vocab"))
    return decls


def embed_lookup(p, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    return p["embedding"].to(compute_dtype)[tokens.long()]


def logits_fn(p, x: torch.Tensor, vocab: int, tie: bool) -> torch.Tensor:
    """(B,S,d) -> (B,S,vocab_padded) fp32 logits with padded slots masked."""
    if tie:
        w = p["embedding"].to(x.dtype).T
    else:
        w = p["unembed"].to(x.dtype)
    logits = (x @ w).to(torch.float32)
    vp = logits.shape[-1]
    if vp != vocab:
        mask = torch.arange(vp, device=logits.device) < vocab
        logits = torch.where(mask, logits, -1e9)
    return logits


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross entropy in fp32. labels: (B,S) int32."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()
