"""Nested dicts and lists of tensors (the port's parameter trees)."""
from __future__ import annotations

__all__ = ["tree_leaves", "tree_map"]


def tree_leaves(tree) -> list:
    """Leaves in a fixed order: dicts by insertion order, lists in order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` applied leafwise over ``tree`` and trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)
