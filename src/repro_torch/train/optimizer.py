"""SGD with momentum, global-norm clipping and update application.

Counterpart of ``repro.train.optimizer`` (``sgd``, ``clip_by_global_norm``,
``apply_updates``) over the port's param trees.  The clip uses the
reference formula ``min(1, max_norm / max(norm, 1e-9))``, not
``torch.nn.utils.clip_grad_norm_``.  All functions are pure, so the fleet
executor can ``vmap`` them over the client axis.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.tree import tree_leaves, tree_map

Params = Any

__all__ = ["Optimizer", "sgd", "apply_updates", "global_norm",
           "clip_by_global_norm"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], Any]
    update: Callable[..., tuple[Params, Any]]


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.to(torch.float32) + u).to(p.dtype),
                    params, updates)


def sgd(momentum: float = 0.9) -> Optimizer:
    """SGD with heavy-ball momentum — the paper's local optimizer."""

    def init(params):
        return {"mu": tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params)}

    def update(grads, state, params, lr):
        mu = tree_map(lambda g, m: momentum * m + g.to(torch.float32),
                      grads, state["mu"])
        return tree_map(lambda m: -lr * m, mu), {"mu": mu}

    return Optimizer(init, update)
