"""Step functions of the LM zoo: training, the full-context forward and
one-token decode.

Counterpart of ``repro.train.trainstep``.  :func:`make_train_step` returns
a pure ``(state, batch) -> (state, metrics)`` over a :class:`TrainState`
(params, optimizer state, step), built on ``torch.func.grad_and_value`` so
that ``torch.func.vmap`` batches it over a client axis
(``distributed.fedshard.make_fleet_train_step``); on the card its gradients
run through the zoo's backward kernels (``kernels/autograd.py``) and, with
``remat``, each layer body and cross-entropy chunk is recomputed in the
backward.  :func:`make_prefill_step` (the prefill target: full-context
forward, no gradient) and :func:`make_eval_step` return plain functions
``(params, batch) -> loss``; :func:`make_serve_step` returns ``(params,
tokens, cache, pos) -> (logits, cache)``, the cache updated in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.utils._pytree as _pytree
from torch.func import grad_and_value

from repro_torch.models.zoo import Model
from repro_torch.train import optimizer as opt_lib
from repro_torch.tree import tree_leaves, tree_map

Params = Any

__all__ = ["TrainState", "init_train_state", "make_train_step",
           "make_prefill_step", "make_eval_step", "make_serve_step"]


@dataclasses.dataclass
class TrainState:
    """A pytree node of ``torch.utils._pytree``, so ``torch.func.vmap``
    maps over its leaves."""
    params: Params
    opt_state: Any
    step: torch.Tensor          # 0-d int32


_pytree.register_pytree_node(
    TrainState,
    lambda s: ([s.params, s.opt_state, s.step], None),
    lambda children, _: TrainState(*children),
    serialized_type_name="repro_torch.train.trainstep.TrainState")


def init_train_state(model: Model, gen: torch.Generator,
                     opt: opt_lib.Optimizer) -> TrainState:
    """Params drawn from ``gen`` on its device, the optimizer's zero state
    and step 0."""
    params = model.init(gen)
    return TrainState(params=params, opt_state=opt.init(params),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=gen.device))


def make_train_step(model: Model, opt: opt_lib.Optimizer,
                    lr_fn: Callable | None = None,
                    clip_norm: float | None = 1.0, remat: bool = True,
                    accum_steps: int = 1):
    """``(state, batch) -> (state, {"loss", "grad_norm", "lr"})``.

    ``accum_steps = K > 1`` takes batch leaves stacked ``(K, B/K, …)`` and
    sums the microbatches' fp32 gradients in order, then scales loss and
    gradients by ``1/K``, as the reference's scan does.  The clip (when
    ``clip_norm`` is set) reports the pre-clip global norm."""
    lr_fn = lr_fn or opt_lib.constant_lr(0.01)
    grad_fn = grad_and_value(lambda p, b: model.loss(p, b, remat=remat))

    def train_step(state: TrainState, batch: dict):
        if accum_steps == 1:
            grads, loss = grad_fn(state.params, batch)
        else:
            for leaf in tree_leaves(batch):
                if leaf.shape[0] != accum_steps:
                    raise ValueError(
                        f"with accum_steps={accum_steps} pass batch leaves "
                        f"stacked (K, B/K, …), got {tuple(leaf.shape)}")
            loss = 0.0
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), state.params)
            for k in range(accum_steps):
                g, l_k = grad_fn(state.params,
                                 {n: t[k] for n, t in batch.items()})
                loss = loss + l_k
                grads = tree_map(lambda a, b: a + b.to(torch.float32),
                                 grads, g)
            inv = 1.0 / accum_steps
            loss = loss * inv
            grads = tree_map(lambda g: g * inv, grads)
        if clip_norm is not None:
            grads, gnorm = opt_lib.clip_by_global_norm(grads, clip_norm)
        else:
            gnorm = opt_lib.global_norm(grads)
        lr = lr_fn(state.step)
        updates, opt_state = opt.update(grads, state.opt_state,
                                        state.params, lr)
        del grads           # not held while the new params are formed
        params = opt_lib.apply_updates(state.params, updates)
        return (TrainState(params=params, opt_state=opt_state,
                           step=state.step + 1),
                {"loss": loss, "grad_norm": gnorm, "lr": lr})

    return train_step


def make_eval_step(model: Model):
    def eval_step(params: Params, batch: dict) -> torch.Tensor:
        return model.loss(params, batch, remat=False)
    return eval_step


def make_prefill_step(model: Model):
    """Full-context forward to the loss; labels default to zeros."""
    def prefill_step(params: Params, batch: dict) -> torch.Tensor:
        b = dict(batch)
        if "labels" not in b:
            b["labels"] = torch.zeros_like(b["tokens"])
        return model.loss(params, b, remat=False)
    return prefill_step


def make_serve_step(model: Model):
    """One-token decode: (params, tokens (B,1), cache, pos) -> (logits,
    cache)."""
    def serve_step(params: Params, tokens, cache, pos):
        return model.decode_step(params, tokens, cache, pos)
    return serve_step
