"""Minimal pytree helpers over nested dicts, lists and tuples of tensors.

Leaves are visited in the JAX package's order: dict entries by sorted key,
lists and tuples in sequence.  The parameter trees of ``repro_torch.fl``
therefore flatten to the same leaf sequence as the reference's
``jax.tree.leaves`` — what ``stack_ravel``'s feature layout and the
STC bit accounting depend on.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

__all__ = ["tree_leaves", "tree_map", "tree_flatten", "tree_unflatten",
           "tree_unstack", "params_from_numpy", "params_to_numpy",
           "cache_from_numpy"]


def _flatten(node: Any, leaves: list) -> Any:
    if isinstance(node, dict):
        keys = sorted(node)
        return ("dict", keys, [_flatten(node[k], leaves) for k in keys])
    if isinstance(node, (list, tuple)):
        return (type(node).__name__, None, [_flatten(x, leaves) for x in node])
    leaves.append(node)
    return ("leaf", None, None)


def tree_flatten(tree: Any) -> tuple[list, Any]:
    """``(leaves, treedef)``; ``treedef`` rebuilds the nesting.  The walk
    is a module-level function: a recursive closure is a reference cycle
    that would hold the leaves until the garbage collector's next full
    pass (at zamba2_2_7b's width, a train step's 9 GiB of gradients)."""
    leaves: list = []
    return leaves, _flatten(tree, leaves)


def _build(node: Any, it) -> Any:
    kind, keys, children = node
    if kind == "leaf":
        return next(it)
    built = [_build(c, it) for c in children]
    if kind == "dict":
        return dict(zip(keys, built))
    return built if kind == "list" else tuple(built)


def tree_unflatten(treedef: Any, leaves: list) -> Any:
    return _build(treedef, iter(leaves))


def tree_leaves(tree: Any) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    leaves, treedef = tree_flatten(tree)
    others = [tree_leaves(r) for r in rest]
    return tree_unflatten(treedef,
                          [fn(x, *(o[i] for o in others))
                           for i, x in enumerate(leaves)])


def tree_unstack(stacked: Any) -> list:
    """A tree whose leaves share a leading axis (stacked layers) as one tree
    of views per index along it: one ``unbind`` per leaf, so gradients
    taken through the views stack back in one copy."""
    leaves, treedef = tree_flatten(stacked)
    cols = [leaf.unbind(0) for leaf in leaves]
    return [tree_unflatten(treedef, [c[i] for c in cols])
            for i in range(len(cols[0]))]


def params_from_numpy(tree: Any, device: str | torch.device = "cpu") -> Any:
    """Reference params (nested dicts/lists of numpy arrays) → tensors on
    ``device``, leaf for leaf."""
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), tree)


def cache_from_numpy(tree: Any, device: str | torch.device = "cpu") -> Any:
    """A reference decode cache (numpy arrays; bf16 ones as ``ml_dtypes``'
    bfloat16) → tensors on ``device``, leaf for leaf and dtype for dtype."""
    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
                torch.bfloat16).to(device)
        return torch.from_numpy(np.array(a)).to(device)
    return tree_map(leaf, tree)


def params_to_numpy(tree: Any) -> Any:
    """Port params → nested dicts/lists of numpy arrays, leaf for leaf."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
