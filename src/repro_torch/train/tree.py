"""Nested containers of arrays ("trees"), flattened in jax's order.

The reference handles its train state, gradients and checkpoints with
``jax.tree``; the port keeps its own few functions, with jax's leaf
order, so a checkpoint written by one package restores in the other:
dict entries in sorted-key order, tuples (``OptState`` included) and
lists in their own order, anything else a leaf; ``None`` holds no leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves, treedef): ``tree_unflatten(treedef, leaves)`` rebuilds
    ``tree``."""
    leaves: List[Any] = []

    def walk(t):
        if t is None:
            return ("none",)
        if isinstance(t, dict):
            keys = sorted(t)
            return ("dict", keys, [walk(t[k]) for k in keys])
        if isinstance(t, (tuple, list)):
            return (type(t), [walk(x) for x in t])
        leaves.append(t)
        return ("leaf",)

    return leaves, walk(tree)


def tree_unflatten(treedef, leaves):
    it = iter(leaves)

    def build(d):
        if d[0] == "none":
            return None
        if d[0] == "leaf":
            return next(it)
        if d[0] == "dict":
            return {k: build(c) for k, c in zip(d[1], d[2])}
        kind, children = d
        items = [build(c) for c in children]
        if kind is list:
            return items
        return kind(*items) if hasattr(kind, "_fields") else kind(items)

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the tree holds")
    return out


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and, leaf for leaf, of ``rest``
    (trees of the same structure)."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
