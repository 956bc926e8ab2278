"""Nested dicts and lists of tensors, the port's counterpart of JAX pytrees:
map, leaves and key paths.

Nodes are dicts and lists; anything else, a tuple included, is a leaf
(the int8 compressor's ``(values, scale)`` pairs).  Every traversal visits
dict keys in sorted order, as ``jax.tree_util`` does, so leaves come in the
JAX package's order and :func:`key_paths` gives the strings
``jax.tree_util.keystr`` gives for the same tree
(``['params']['layers'][0]['attn']['wq']``).
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure) -> a tree of the results."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, list):
        return [tree_map(fn, x, *(r[i] for r in rest))
                for i, x in enumerate(tree)]
    return fn(tree, *rest)


def key_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """-> [(key path, leaf)] in traversal order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in key_paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, list):
        return [kv for i, x in enumerate(tree)
                for kv in key_paths(x, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in key_paths(tree)]


def tree_unflatten(template, leaves):
    """A tree of ``template``'s structure holding ``leaves`` (in traversal
    order)."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out
