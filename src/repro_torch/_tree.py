"""Nested-dict parameter trees: the port's counterpart of JAX pytrees.

Parameters are plain nested dicts whose leaves are tensors (layer-stacked
along axis 0 under ``"layers"``), so a tree map is all the structure the
port needs.
"""
from __future__ import annotations

from typing import Any, Callable, List


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` to every leaf of a nested dict (dicts are nodes); with
    ``rest``, trees of the same structure, ``fn`` takes the leaves at one
    place in all of them."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves of a nested dict in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]
