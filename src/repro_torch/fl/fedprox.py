"""FedProx local solver (Li et al. — the weight-regularization family the
paper positions FedDif as complementary to, Sec. II-1).

Counterpart of ``repro.fl.fedprox``.  Local objective
``F_i(w) + (μ/2)·‖w − w_anchor‖²``, for ``strategy="fedprox"`` and, composed
with diffusion, ``"feddif_prox"``.  The step and session are those of
:mod:`repro_torch.fl.client`.
"""
from __future__ import annotations

from typing import Any, Callable, Iterable

import torch

from repro_torch.fl.client import make_step, run_session
from repro_torch.tree import tree_leaves

Params = Any

__all__ = ["make_prox_local_update", "prox_objective"]


def prox_objective(loss_fn: Callable, mu: float) -> Callable:
    """``objective(params, batch, anchor)``: the loss plus
    ``0.5·μ·Σ‖params − anchor‖²`` in fp32, leaf by leaf."""

    def objective(params, batch, anchor):
        prox = sum(torch.sum((a.to(torch.float32) - b.to(torch.float32)) ** 2)
                   for a, b in zip(tree_leaves(params), tree_leaves(anchor)))
        return loss_fn(params, batch) + 0.5 * mu * prox

    return objective


def make_prox_local_update(loss_fn: Callable, mu: float = 0.01,
                           momentum: float = 0.9,
                           clip: float | None = 10.0):
    """Returns ``local_update(params, batches, lr, anchor) -> (params,
    mean_loss)``.  ``anchor`` defaults to the incoming params: proximal to
    the received model, the FedDif-compatible variant where the anchor
    travels with the hop."""
    step = make_step(prox_objective(loss_fn, mu), momentum, clip)

    def local_update(params: Params, batches: Iterable[dict], lr: float,
                     anchor: Params | None = None):
        anchor = params if anchor is None else anchor
        return run_session(step, params, batches, lr, anchor)

    return local_update
