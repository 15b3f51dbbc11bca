"""Leaf order of parameter and optimizer trees: JAX's ``tree_flatten`` order.

The optimizer walks parameters, gradients and moments leaf by leaf, and a
checkpoint stores leaves by index, so both need one order, and it must be
the JAX package's for a checkpoint written by either package to restore
in the other: dict keys sorted, ``NamedTuple`` fields and tuple or list
items in order, ``None`` and empty containers giving no leaf, a tensor
(or any other object) one leaf.
"""
from __future__ import annotations

from typing import Any


def _children(node) -> list | None:
    """(name, child) pairs of a container in flatten order, None for a
    leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (tuple, list)):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def tree_leaves(tree: Any) -> list:
    """The leaves of ``tree`` in JAX's flatten order."""
    return [leaf for _, leaf in tree_items(tree)]


def tree_items(tree: Any, prefix: str = "") -> list:
    """(key path, leaf) pairs in flatten order; paths join keys and field
    names with ``/``."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for name, child in kids:
        out.extend(tree_items(child, f"{prefix}/{name}" if prefix else name))
    return out


def tree_unflatten(like: Any, leaves) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` in flatten order
    (the inverse of :func:`tree_leaves` over that structure)."""
    it = iter(leaves)
    out = _rebuild(like, it)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the structure holds")
    return out


_END = object()


def _rebuild(node, it):
    if node is None:
        return None
    kids = _children(node)
    if kids is None:
        leaf = next(it, _END)
        if leaf is _END:
            raise ValueError("fewer leaves than the structure holds")
        return leaf
    if isinstance(node, dict):
        return {k: _rebuild(node[k], it) for k in sorted(node)}
    values = [_rebuild(c, it) for _, c in kids]
    if hasattr(node, "_fields"):
        return type(node)(*values)
    return type(node)(values)

