"""Nested-dict trees of tensors: the port's stand-in for JAX pytrees.

Parameters, caches and stage carries are plain ``dict``s whose leaves are
tensors (or numpy arrays); these two helpers are all the tree machinery the
port needs.
"""
from __future__ import annotations

from typing import Any, Callable, List


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over dicts with identical key sets."""
    if isinstance(tree, dict):
        for other in rest:
            if not isinstance(other, dict) or other.keys() != tree.keys():
                raise ValueError("tree structures differ")
        return {k: tree_map(fn, v, *(o[k] for o in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves in key-insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_items(tree: Any, prefix: str = "") -> List[tuple]:
    """``(path, leaf)`` pairs, paths joined with ``/``."""
    if isinstance(tree, dict):
        return [item for k, v in tree.items()
                for item in tree_items(v, f"{prefix}/{k}" if prefix else k)]
    return [(prefix, tree)]
