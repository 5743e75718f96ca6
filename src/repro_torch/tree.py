"""Nested dicts and NamedTuples of tensors as trees, with the leaves in
``jax.tree`` order: dict keys sorted, record fields in order.  The
model's parameters, the optimizer state, the caches and the checkpoint
store all walk trees through these."""
from __future__ import annotations

import torch


def is_record(x) -> bool:
    """A NamedTuple instance."""
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn, tree):
    """``fn`` over the leaves; the same structure back."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if is_record(tree):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    return fn(tree)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if is_record(tree):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_stack(trees):
    """Stack the leaves of same-shaped trees on a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_stack([t[k] for t in trees]) for k in first}
    if is_record(first):
        return type(first)(*(tree_stack([t[i] for t in trees])
                             for i in range(len(first))))
    return torch.stack(trees)
