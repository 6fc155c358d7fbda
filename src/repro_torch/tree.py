"""Parameter trees: nested dicts and lists of tensors.

The port's counterpart of the JAX pytree utilities the training stack
uses.  Dict keys are visited in sorted order, as ``jax.tree_util``
flattens them, so leaves and key paths come out in the reference's order.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    return tree_map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)


def tree_map_with_path(fn: Callable, tree, *rest, _prefix: tuple = ()):
    """``fn(key path, leaf, *matching leaves of rest)`` over the leaves of
    ``tree``; paths as in ``tree_paths``."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      _prefix=_prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map_with_path(fn, v, *(r[i] for r in rest),
                                   _prefix=_prefix + (i,))
                for i, v in enumerate(tree)]
    return fn(_prefix, tree, *rest)


def tree_paths(tree, prefix: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """(key path, leaf) pairs: dict keys as str, list indices as int."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_paths(v, prefix + (i,))
    else:
        yield prefix, tree


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_pick(tree, i: int):
    """Element ``i`` of the tuple at every leaf: one tree out of a tree of
    tuples that ``tree_map`` built."""
    if isinstance(tree, dict):
        return {k: tree_pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_pick(v, i) for v in tree]
    return tree[i]


__all__ = ["tree_leaves", "tree_map", "tree_map_with_path", "tree_paths",
           "tree_pick"]
