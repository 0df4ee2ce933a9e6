"""A small tree utility over the port's state trees: dicts (in insertion
order), lists and tuples, with tensors or other values at the leaves.

The train state (``{"params": ..., "opt": {"m": ..., "v": ...}, "step":
..., "lr_scale": ...}``) is such a tree; its dicts are built in the JAX
tree's flatten order (:func:`repro_torch.weights.param_order`), so walking
them in insertion order visits the leaves in that order.
"""
from __future__ import annotations

from typing import Any, Callable


def tree_leaves(tree) -> list:
    """The leaves of ``tree``, depth first, dicts in insertion order."""
    return [leaf for _, leaf in tree_items(tree)]


def tree_items(tree, prefix: str = "") -> list:
    """``(path, leaf)`` pairs in :func:`tree_leaves`' order; a path names
    the keys and indices on the way down, joined by ``/``."""
    if isinstance(tree, dict):
        return [item for k, v in tree.items()
                for item in tree_items(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in tree_items(v, f"{prefix}{i}/")]
    return [(prefix.rstrip("/"), tree)]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``tree``'s structure with ``fn(leaf, *leaves of rest)`` at each leaf;
    ``rest`` are trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(like, leaves: list) -> Any:
    """``like``'s structure with ``leaves`` (in :func:`tree_leaves`' order)
    at its leaves."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
