"""Trees of tensors: the port's params, gradients and optimizer state are
nested dicts and lists with tensors at the leaves (``transformer.init``).

Anything else (a tensor, a tuple) is a leaf. Leaves are visited in a
fixed order, a dict's keys sorted and a list's items in turn, as
``jax.tree_util`` orders the reference's trees.
"""

from __future__ import annotations

from typing import Any, Callable


def leaves_with_paths(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs, the path the keys and indices joined by "/"."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in leaves_with_paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [pl for i, v in enumerate(tree)
                for pl in leaves_with_paths(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the trees of the same shape
    in ``rest``, rebuilt into ``tree``'s shape."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree, prefix: str = ""):
    """``fn(path, leaf)`` over the leaves, rebuilt into ``tree``'s shape;
    paths as in ``leaves_with_paths``."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, f"{prefix}{i}/")
                for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)
