"""Parameter trees: nested dicts of tensors (the FL half's CNN, its
updates; the LM's parameters), and the NamedTuples that hold them.

The reference walks its pytrees with ``jax.tree``, which visits a dict's
keys in sorted order; these helpers do the same, so that leaves pair up
and run in the reference's order.
"""
from __future__ import annotations

from typing import Callable, List


def tree_leaves(tree) -> List:
    """The leaves of a nested dict, keys in sorted order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves) -> object:
    """A tree shaped like ``like`` holding ``leaves`` in
    :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(like)


def tree_map(fn: Callable, tree, *rest) -> object:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same keys). NamedTuples (a ``TrainState``, an
    ``OptState``) are walked field by field and rebuilt in place."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *parts)
                            for parts in zip(tree, *rest)))
    return fn(tree, *rest)
