"""Nested-dict parameter trees: the port's counterpart of JAX pytrees.

Parameters are plain nested dicts whose leaves are tensors (layer-stacked
along axis 0 under ``"layers"``), so a tree map is all the structure the
port needs.
"""
from __future__ import annotations

from typing import Any, Callable, List


def tree_map(fn: Callable, tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a nested dict (dicts are nodes)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves of a nested dict in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]
