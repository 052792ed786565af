"""The training step.

Mirrors ``src/repro/train/train_step.py``'s ``init_train_state``,
``abstract_train_state``, ``train_state_axes`` and ``make_train_step``:
``step_fn(state, batch) -> (state, metrics)`` takes a state ``{"params",
"opt": OptState(m, v, step)}`` in the reference's layout (stacked
segments, f32) and a batch of ``tokens`` and ``labels`` (and the memory
of a model with cross layers).  Gradient accumulation (``rc.microbatches > 1``) is the reference's
``lax.scan`` over microbatch slices as a loop that sums f32 gradients.

What differs is memory, not arithmetic.  The state is updated in place
(the returned state holds the same tensors).  The gradient is taken
with respect to per-layer views of the stacked leaves (every entry of
``model.stacked()``: the decoder's, an enc-dec model's encoder, the
VLM's groups), each its own autograd leaf: the gradient of
``stacked[i]`` would otherwise be a zero tensor of the whole stacked
leaf for every layer.  The views share the stacked storage, so AdamW's
in-place update of a view is the update of the stacked leaf, and the
checkpoint and carry layouts stay the reference's.  The dry-run's
``abstract_train_state`` is meta tensors (no memory) and
``train_state_axes`` its logical-axis tree.

A train state crosses between the packages whole:
``train_state_from_numpy`` takes the reference's state as numpy
(``jax.tree.map(np.asarray, state)``, or a restored checkpoint) and
``train_state_to_numpy`` gives the port's back in the same structure, so
the two compare leaf for leaf.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..configs.base import RunConfig
from ..models.carry import tensor_from_numpy
from ..models.model import Model
from ..models.params import abstract_params, init_params, logical_axes
from .optim import OptState, adamw_update, init_opt_state
from .tree import tree_flatten, tree_leaves, tree_map, tree_unflatten


def init_train_state(model: Model, seed: int = 0) -> Dict[str, Any]:
    params = init_params(model.decls, seed, torch.float32, model.device)
    return {"params": params, "opt": init_opt_state(params)}


def abstract_train_state(model: Model) -> Dict[str, Any]:
    """The train state as meta tensors: f32 parameters, two moments of
    their shapes and the 0-d int32 step."""
    params = abstract_params(model.decls, torch.float32)
    like = lambda tree: tree_map(torch.empty_like, tree)
    return {"params": params,
            "opt": OptState(like(params), like(params),
                            torch.empty((), dtype=torch.int32,
                                        device="meta"))}


def train_state_axes(model: Model):
    """Logical-axis tree matching the train state structure."""
    p_axes = logical_axes(model.decls)
    return {"params": p_axes, "opt": OptState(p_axes, p_axes, ())}


def train_state_from_numpy(state: Dict[str, Any], device) -> Dict[str, Any]:
    """A train state of numpy arrays as the port's on ``device``: f32
    parameters and moments, the step a 0-d int32 tensor."""
    m, v, step = state["opt"]
    f32 = lambda tree: tree_map(
        lambda a: tensor_from_numpy(a, device, torch.float32), tree)
    return {"params": f32(state["params"]),
            "opt": OptState(f32(m), f32(v), torch.tensor(
                int(np.asarray(step)), dtype=torch.int32, device=device))}


def train_state_to_numpy(state: Dict[str, Any]) -> Dict[str, Any]:
    """The port's train state as numpy, in the same structure."""
    m, v, step = state["opt"]
    host = lambda tree: tree_map(lambda t: t.detach().cpu().numpy(), tree)
    return {"params": host(state["params"]),
            "opt": OptState(host(m), host(v), step.detach().cpu().numpy())}


def _split(tree, depth: int):
    n = tree_leaves(tree)[0].shape[0]
    layers = [tree_map(lambda t, i=i: t[i], tree) for i in range(n)]
    return layers if depth == 1 else [_split(t, depth - 1) for t in layers]


def split_layers(model: Model, tree) -> Dict[str, Any]:
    """``tree`` (parameters or a moment, the reference's layout) with each
    stacked entry (``model.stacked()``) as a list of per-layer trees of
    views (a list of such lists for two stacked levels)."""
    out = dict(tree)
    for name, depth in model.stacked().items():
        out[name] = _split(tree[name], depth)
    return out


def stack_layers(model: Model, params, leaves) -> Dict[str, Any]:
    """``leaves`` in ``split_layers(model, params)``'s order (gradients
    from ``loss_and_grads``) as a tree of the parameters' stacked layout,
    as jax returns them."""
    _, treedef = tree_flatten(split_layers(model, params))
    tree = tree_unflatten(treedef, leaves)

    def stack(layers, depth):
        if depth > 1:
            layers = [stack(t, depth - 1) for t in layers]
        return tree_map(lambda *ls: torch.stack(ls), *layers)
    for name, depth in model.stacked().items():
        tree[name] = stack(tree[name], depth)
    return tree


def loss_and_grads(model: Model, params, batch: Dict[str, torch.Tensor],
                   microbatches: int = 1
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The loss of ``batch`` and its gradients, one per leaf of
    ``split_layers(model, params)`` in that tree's order (f32, summed over
    microbatches and divided by their count)."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(),
                      split_layers(model, params))
    flat = tree_leaves(leaves)
    nm = max(microbatches, 1)
    if nm == 1:
        loss = model.loss(leaves, batch)
        # materialize_grads: a leaf the loss never reads (a hybrid block's
        # ``ln_ssm``, declared as in the reference) gets zeros, as from
        # ``jax.grad``, where ``autograd.grad`` would raise
        return loss.detach(), list(torch.autograd.grad(
            loss, flat, materialize_grads=True))
    n = next(iter(batch.values())).shape[0] // nm
    grads, losses = None, []
    for i in range(nm):
        mb = {k: x[i * n:(i + 1) * n] for k, x in batch.items()}
        loss = model.loss(leaves, mb)
        g = torch.autograd.grad(loss, flat, materialize_grads=True)
        if grads is None:
            grads = [x.to(torch.float32) for x in g]
        else:
            for acc, x in zip(grads, g):
                acc.add_(x)
        losses.append(loss.detach())
    for g in grads:
        g.div_(nm)
    return torch.stack(losses).mean(), grads


def make_train_step(model: Model, rc: RunConfig):
    nm = rc.microbatches

    def step_fn(state, batch):
        params, opt = state["params"], state["opt"]
        loss, grads = loss_and_grads(model, params, batch, nm)
        split = lambda t: tree_leaves(split_layers(model, t))
        _, new_opt, om = adamw_update(
            rc, split(params), grads,
            OptState(split(opt.m), split(opt.v), opt.step))
        metrics = {"loss": loss, **om}
        return {"params": params,
                "opt": OptState(opt.m, opt.v, new_opt.step)}, metrics

    return step_fn
