"""Mixture-of-Experts layer: a router, top-k experts per token, and a
capacity buffer per expert.

Capacity policy: tokens beyond ``capacity_factor * N * top_k / E`` per expert
are dropped (standard Switch/GShard semantics); the residual stream carries
them unchanged.

Mirrors ``src/repro/models/moe.py`` (``moe_decls``, ``_route``,
``_expert_ffn``, ``moe_apply``, ``_moe_apply_scatter``).  The expert
products are plain batched matmuls, as the reference's einsums are plain
products outside any Pallas kernel.  Three of the reference's semantics are
kept by construction rather than by the library call that reads the same:

* top-k ties go to the lower expert index, as ``jax.lax.top_k`` does
  (``torch.topk`` may return equal probabilities in another order): the
  first k of a stable descending sort;
* the dispatch writes only the kept (token, k) pairs; the reference adds
  every dropped pair's zero into slot ``cap - 1``, which leaves that slot's
  kept token as it was, and an indexed ``+=`` in PyTorch would instead let
  a dropped pair's write replace it;
* arrival ranks are int32 (``cumsum(..., dtype=int32)``; torch's default
  is int64), the reference's 32-bit lanes.

Not ported: ``moe_apply_expert_local`` (a ``shard_map`` over the experts'
mesh axis), which waits for a mesh of cards.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from ..configs.base import MoEConfig
from .layers import silu
from .params import ParamDecl


def moe_decls(d: int, moe: MoEConfig) -> Dict[str, Any]:
    e, f = moe.num_experts, moe.d_ff_expert
    return {
        "router": ParamDecl((d, e), ("embed", "experts")),
        "wi_gate": ParamDecl((e, d, f), ("experts", "expert_in", "mlp")),
        "wi_up": ParamDecl((e, d, f), ("experts", "expert_in", "mlp")),
        "wo": ParamDecl((e, f, d), ("experts", "mlp", "expert_in")),
    }


def _route(p, x, moe: MoEConfig):
    """Router: returns (gates (N,k), experts (N,k), aux_loss).  The softmax
    is written out as ``jax.nn.softmax`` computes it."""
    logits = (x @ p["router"].to(x.dtype)).to(torch.float32)     # (N,E)
    u = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = u / u.sum(dim=-1, keepdim=True)
    experts = torch.sort(probs, dim=-1, descending=True,
                         stable=True).indices[:, :moe.top_k]
    gates = probs.gather(-1, experts)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance loss
    e = moe.num_experts
    density = torch.zeros(e, dtype=torch.float32, device=x.device).index_add_(
        0, experts.reshape(-1),
        torch.ones(experts.numel(), dtype=torch.float32, device=x.device)
    ) / max(1, experts.numel())
    mean_prob = probs.mean(dim=0)
    aux = e * torch.sum(density * mean_prob)
    return gates.to(x.dtype), experts, aux


def _expert_ffn(p, h):
    """h: (E, C, d) -> (E, C, d); per-expert SwiGLU."""
    g = torch.bmm(h, p["wi_gate"].to(h.dtype))
    u = torch.bmm(h, p["wi_up"].to(h.dtype))
    return torch.bmm(silu(g) * u, p["wo"].to(h.dtype))


def capacity(n: int, moe: MoEConfig) -> int:
    """Slots per expert for ``n`` tokens, in Python floats as the
    reference computes it."""
    return max(int(math.ceil(n * moe.top_k * moe.capacity_factor
                             / moe.num_experts)), 4)


def moe_apply(p, x: torch.Tensor, moe: MoEConfig):
    """x: (B,S,d) -> (out (B,S,d), aux_loss scalar).  The reference takes
    its expert-local path only under an active ``activation_hints`` mesh
    context, which one card never has, so either ``dispatch`` value takes
    the scatter path here, as it does there."""
    return _moe_apply_scatter(p, x, moe)


def dispatch_plan(experts: torch.Tensor, moe: MoEConfig, cap: int):
    """Each (token, k) pair's arrival rank within its expert (int32) and
    whether it fits the expert's ``cap`` slots."""
    flat_e = experts.reshape(-1)                              # (n*k,)
    onehot = torch.nn.functional.one_hot(
        flat_e, moe.num_experts).to(torch.int32)              # (n*k, E)
    pos_in_e = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    pos = pos_in_e.gather(1, flat_e[:, None])[:, 0]
    return pos, pos < cap


def _moe_apply_scatter(p, x: torch.Tensor, moe: MoEConfig):
    """x: (B,S,d) -> (out (B,S,d), aux_loss scalar)."""
    B, S, d = x.shape
    n = B * S
    flat = x.reshape(n, d)
    gates, experts, aux = _route(p, flat, moe)

    e, k = moe.num_experts, moe.top_k
    cap = capacity(n, moe)
    flat_e = experts.reshape(-1)
    pos, keep = dispatch_plan(experts, moe, cap)

    # dispatch: each kept pair into its own slot of the (E, cap, d) buffer;
    # the dropped pairs all go to one spare row past the buffer's end
    tok_idx = torch.arange(n * k, device=x.device) // k
    slot = torch.where(keep, flat_e * cap + pos, e * cap)
    buf = torch.zeros((e * cap + 1, d), dtype=flat.dtype, device=x.device)
    buf[slot] = flat[tok_idx]
    # the reference's shard_hint calls (repro/models/moe.py:102,104) pin
    # the buffer to the experts' mesh axis; on one card they are identities
    buf = _expert_ffn(p, buf[:e * cap].view(e, cap, d))

    # combine: gather expert outputs back and weight by gates
    out_tok = buf[flat_e, torch.clamp(pos, 0, cap - 1)]       # (n*k, d)
    out_tok = torch.where(keep[:, None], out_tok, 0)
    out = (out_tok * gates.reshape(-1)[:, None]).reshape(n, k, d)
    return out.sum(dim=1).reshape(B, S, d), aux * moe.router_aux_coef
