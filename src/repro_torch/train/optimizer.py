"""Optimizers, global-norm clipping, update application and LR schedules.

Counterpart of ``repro.train.optimizer`` over the port's param trees:
``sgd`` (heavy-ball momentum, optionally Nesterov and weight decay — the
paper's local optimizer), ``adamw`` (decoupled weight decay, the count a
0-d int32 tensor and the bias corrections in fp32), and the schedules
``constant_lr``, ``cosine_lr`` and ``warmup_cosine_lr`` as functions of a
step tensor.  The clip uses the reference formula ``min(1, max_norm /
max(norm, 1e-9))``, not ``torch.nn.utils.clip_grad_norm_``.  Every
function is pure, so the fleet planes can ``vmap`` them over the client
axis.

An optimizer is an ``Optimizer(init, update)`` pair::

    state = init(params)
    updates, state = update(grads, state, params, lr)
    params = apply_updates(params, updates)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.tree import (tree_flatten, tree_leaves, tree_map,
                              tree_unflatten)

Params = Any

__all__ = ["Optimizer", "sgd", "adamw", "apply_updates", "global_norm",
           "clip_by_global_norm", "constant_lr", "cosine_lr",
           "warmup_cosine_lr"]


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


def _per_leaf(fn, tree, *rest) -> list:
    """``fn`` on each leaf of ``tree`` (and the matching leaves of
    ``rest``), returning a tuple per leaf: one tree in ``tree``'s structure
    for each of the tuple's positions."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_leaves(r) for r in rest]
    outs = [fn(x, *(o[i] for o in others)) for i, x in enumerate(leaves)]
    return [tree_unflatten(treedef, [o[j] for o in outs])
            for j in range(len(outs[0]))]


def _zeros_f32(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def sgd(momentum: float = 0.9, nesterov: bool = False,
        weight_decay: float = 0.0) -> Optimizer:
    """SGD with heavy-ball momentum — the paper's local optimizer."""

    def init(params):
        return {"mu": _zeros_f32(params)}

    def update(grads, state, params, lr):
        def one(g, mu, p):
            g = g.to(torch.float32)
            if weight_decay:
                g = g + weight_decay * p.to(torch.float32)
            mu_new = momentum * mu + g
            step = g + momentum * mu_new if nesterov else mu_new
            return -lr * step, mu_new

        outs = _per_leaf(one, grads, state["mu"], params)
        return outs[0], {"mu": outs[1]}

    return Optimizer(init, update)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        return {"m": _zeros_f32(params), "v": _zeros_f32(params),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=tree_leaves(params)[0].device)}

    def update(grads, state, params, lr):
        c = state["count"] + 1
        cf = c.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                         device=cf.device), cf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                         device=cf.device), cf)

        def one(g, m, v, p):
            g = g.to(torch.float32)
            m_new = b1 * m + (1 - b1) * g
            v_new = b2 * v + (1 - b2) * g * g
            mhat = m_new / bc1
            vhat = v_new / bc2
            upd = -lr * (mhat / (torch.sqrt(vhat) + eps)
                         + weight_decay * p.to(torch.float32))
            return upd, m_new, v_new

        upd, m, v = _per_leaf(one, grads, state["m"], state["v"], params)
        return upd, {"m": m, "v": v, "count": c}

    return Optimizer(init, update)


# ------------------------------------------------------------- schedules

def constant_lr(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


def cosine_lr(peak: float, total_steps: int, floor: float = 0.0):
    def fn(step):
        step = torch.as_tensor(step)
        t = torch.clamp(step / max(total_steps, 1), 0.0, 1.0)
        return floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * t))
    return fn


def warmup_cosine_lr(peak: float, warmup: int, total_steps: int,
                     floor: float = 0.0):
    cos = cosine_lr(peak, max(total_steps - warmup, 1), floor)

    def fn(step):
        step = torch.as_tensor(step)
        w = peak * step / max(warmup, 1)
        return torch.where(step < warmup, w, cos(step - warmup))
    return fn
