"""Parameter trees of nested dicts and lists: map, flatten and rebuild.

Leaves are flattened in ``jax.tree_util.tree_leaves`` order, which sorts
dict keys at every level (GPT-2: ``blocks`` before ``ln_f`` before ``wpe``
before ``wte``, ``attn/proj`` before ``attn/qkv``) and keeps a list's
order (the ResNet and VGG ``blocks``).  A tuple is a leaf here.  That
order fixes the per-leaf gradient norms the monitor expects, the
order-statistics sample and the leaf count, so the port's batteries line
up with the JAX package's column for column.
"""

from __future__ import annotations

from typing import Any, Callable, List


def map_tree(fn: Callable, tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a nested dict or list."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves in sorted-key order."""
    if isinstance(tree, dict):
        out: List[Any] = []
        for k in sorted(tree):
            out.extend(tree_leaves(tree[k]))
        return out
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """A tree shaped like ``like`` holding ``leaves`` (sorted-key order)."""
    it = iter(leaves)

    def build(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [build(v) for v in node]
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the tree holds")
    return out


__all__ = ["map_tree", "tree_leaves", "tree_unflatten"]
