"""FL client: the LocalUpdate of Algorithm 2 (lines 31–37), the host plane's
local solver.

Counterpart of ``repro.fl.client``.  Generic over any ``loss_fn(params,
batch)``: one SGD step is ``torch.func.grad_and_value`` of the loss, a
global-norm clip at 10 and a heavy-ball momentum update
(:mod:`repro_torch.train.optimizer`).  Batches arrive as dicts of numpy
arrays (``data/pipeline.py``) and move to the params' device per step.

The reference reads ``float(loss)`` after every step; on the card that is a
host sync per step.  Here the loss sum stays on the device and the session
returns its mean as a 0-d tensor, read only if the caller reads it (the host
executor does not).
"""
from __future__ import annotations

from typing import Any, Callable, Iterable

import torch
from torch.func import grad_and_value

from repro_torch.train import optimizer as opt_lib
from repro_torch.tree import tree_leaves, tree_map

Params = Any

__all__ = ["make_local_update", "make_step", "run_session"]


def make_step(objective: Callable, momentum: float, clip: float | None):
    """``step(params, mu, batch, lr, *extra) -> (params, mu, loss)``: one
    clipped SGD-momentum step on ``objective(params, batch, *extra)``."""
    opt = opt_lib.sgd(momentum=momentum)
    grad_fn = grad_and_value(objective)

    def step(params, mu, batch, lr, *extra):
        grads, loss = grad_fn(params, batch, *extra)
        if clip is not None:
            grads, _ = opt_lib.clip_by_global_norm(grads, clip)
        updates, new_state = opt.update(grads, {"mu": mu}, params, lr)
        return (opt_lib.apply_updates(params, updates), new_state["mu"],
                loss.detach())

    return step


def run_session(step: Callable, params: Params, batches: Iterable[dict],
                lr: float, *extra) -> tuple[Params, torch.Tensor]:
    """One local session from zero momentum: every batch once, in order.
    Returns the params and the mean loss as a 0-d tensor on the device."""
    device = tree_leaves(params)[0].device
    mu = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    total, n = torch.zeros((), device=device), 0
    for batch in batches:
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        params, mu, loss = step(params, mu, batch, lr, *extra)
        total = total + loss
        n += 1
    return params, total / max(n, 1)


def make_local_update(loss_fn: Callable, momentum: float = 0.9,
                      clip: float | None = 10.0):
    """Returns ``local_update(params, batches, lr) -> (params, mean_loss)``.

    Momentum is reset per local session, as each hop of the paper's
    diffusion restarts SGD on the receiving PUE (the BS ships only model
    parameters, not optimizer state)."""
    step = make_step(loss_fn, momentum, clip)

    def local_update(params: Params, batches: Iterable[dict], lr: float):
        return run_session(step, params, batches, lr)

    return local_update

