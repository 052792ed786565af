"""AdamW + cosine schedule + global-norm clipping.

Mirrors ``src/repro/train/optim.py``: the same arithmetic, in f32, on
0-d tensors where the reference has jnp scalars.  The reference builds
new trees (clipped gradients, moments, parameters); the port updates
parameters, moments and gradients in place, one leaf at a time, so a
step holds no tree-wide temporary: at qwen3-4b's width the f32 state
(parameters, gradients, m and v, 16.09 GB each) already fills most of
an 80 GB card.  The functions take trees or flat lists of leaves.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..configs.base import RunConfig
from .tree import tree_leaves, tree_map


class OptState(NamedTuple):
    m: Any
    v: Any
    step: torch.Tensor       # 0-d int32


def init_opt_state(params) -> OptState:
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    dev = tree_leaves(params)[0].device
    return OptState(tree_map(zeros, params), tree_map(zeros, params),
                    torch.zeros((), dtype=torch.int32, device=dev))


def lr_schedule(rc: RunConfig, step) -> torch.Tensor:
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(rc.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - rc.warmup_steps) /
                    max(rc.total_steps - rc.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return rc.learning_rate * warm * (0.1 + 0.9 * cos)


def global_norm(tree) -> torch.Tensor:
    sq = sum(torch.sum(torch.square(x.to(torch.float32)))
             for x in tree_leaves(tree))
    return torch.sqrt(sq)


def clip_by_global_norm(grads, max_norm: float):
    """Scales ``grads`` in place; returns (grads, the norm before)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in tree_leaves(grads):
        g.mul_(scale)
    return grads, norm


@torch.no_grad()
def adamw_update(rc: RunConfig, params, grads,
                 opt: OptState) -> Tuple[Any, OptState, Dict[str, Any]]:
    """One AdamW step, in place: ``params``, ``opt.m`` and ``opt.v`` are
    updated and returned (with the step advanced), ``grads`` is clipped
    in place.  Each leaf's update uses two temporaries of its size."""
    grads, gnorm = clip_by_global_norm(grads, rc.grad_clip)
    step = opt.step + 1
    lr = lr_schedule(rc, step)
    b1, b2 = rc.beta1, rc.beta2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(opt.m), tree_leaves(opt.v)):
        g = g.to(torch.float32)
        t = g * (1 - b1)
        m.mul_(b1).add_(t)                        # b1 m + (1 - b1) g
        torch.mul(g, 1 - b2, out=t)
        v.mul_(b2).add_(t.mul_(g))                # b2 v + (1 - b2) g g
        denom = torch.div(v, bc2).sqrt_().add_(rc.eps)
        torch.div(m, bc1, out=t)
        t.div_(denom).add_(rc.weight_decay * p)   # mhat / (..) + wd p
        p.sub_(t.mul_(lr).to(p.dtype))
    return params, OptState(opt.m, opt.v, step), \
        {"lr": lr, "grad_norm": gnorm}
