"""FedDif data plane on a client-stacked tree: local steps, diffusion hops,
STC hops and the Eq.-11 aggregation.

Counterpart of ``repro.distributed.fedshard``.  FL clients are stacked on a
leading axis of every leaf:

* a local step of the LM fleet is :func:`make_fleet_train_step`,
  ``torch.func.vmap`` of ``train.trainstep.make_train_step`` over the
  client axis — on the card each zoo kernel (and its backward) launches
  once per layer for the whole fleet (``kernels/autograd.py`` folds the
  client axis into the kernel's batch);
* a diffusion hop is :func:`diffuse_params`, a row gather over that axis;
  :func:`make_diffusion_step` runs one whole FedDif diffusion round (hop,
  local step at the receivers, winners keep the trained model, optional
  aggregation);
* :func:`fleet_aggregate` is Eq. (11), an fp32 contraction over the client
  axis broadcast back to every slot;
* an STC-compressed hop runs every leaf through ``kernels.ops.stc_topk`` —
  one ``stc_rows_fused`` launch per leaf on the card, the plain version on
  the CPU.

The reference's ``REPRO_PERF_OPTS`` are fixed at their default (``all``,
as ``models/layers.py`` fixes them): a hop moves the params only (the
optimizer state restarts from zero at the receiver:
``params_only_diffusion``) and fp32 params cross it rounded to bf16
(``wire_bf16``).  The client-sharded mesh is ROADMAP item A12.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch
from torch.func import vmap

from repro_torch.kernels import ops
from repro_torch.models.zoo import Model
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.trainstep import TrainState, make_train_step
from repro_torch.tree import tree_leaves, tree_map

Params = Any

__all__ = ["make_fleet_train_step", "make_diffusion_step", "fleet_aggregate",
           "diffuse_params", "masked_stc_compress"]


def diffuse_params(params: Params, src_of_dst: torch.Tensor) -> Params:
    """One diffusion round: slot ``c`` receives the row of slot
    ``src_of_dst[c]`` (new[c] = old[src_of_dst[c]])."""
    return tree_map(lambda x: x.index_select(0, src_of_dst), params)


def masked_stc_compress(params: Params, ref: Params, mask,
                        sparsity: float = 0.01) -> Params:
    """Slot ``c`` with ``mask[c]`` becomes ``ref + STC(params[c] − ref)``
    (the compressed D2D payload the receiver reconstructs); other slots pass
    through untouched.  ``ref`` is the unstacked round-start global.  The
    mask goes to the device once per tree, as the int32 the kernels read."""
    device = tree_leaves(params)[0].device
    mask_t = torch.as_tensor(np.asarray(mask, bool).astype(np.int32),
                             device=device)

    def leaf(x, r):
        c = x.shape[0]
        out = ops.stc_topk(x.reshape(c, -1), r.reshape(-1), mask_t, sparsity)
        return out.reshape(x.shape).to(x.dtype)

    return tree_map(leaf, params, ref)


def fleet_aggregate(params: Params, weights: torch.Tensor) -> Params:
    """Eq. (11): the weighted FedAvg over the leading client axis, broadcast
    back to every client slot (the BS broadcast of the next round).  The
    weights are normalised by ``max(Σw, 1e-9)``; the sum is an fp32
    contraction, each leaf back in its dtype."""
    w = torch.as_tensor(weights, dtype=torch.float32)
    w = w / torch.clamp(torch.sum(w), min=1e-9)

    def one(x):
        avg = torch.tensordot(w.to(x.device), x.to(torch.float32),
                              dims=([0], [0]))
        return avg[None].expand(x.shape).to(x.dtype)

    return tree_map(one, params)


def make_fleet_train_step(model: Model, opt: opt_lib.Optimizer,
                          lr: float = 0.01, remat: bool = True) -> Callable:
    """The local update vmapped over the leading client axis:
    ``(state, batch) -> (state, metrics)`` on client-stacked
    :class:`TrainState` and batches."""
    return vmap(make_train_step(model, opt, opt_lib.constant_lr(lr),
                                remat=remat))


def _state_map(fn, state: TrainState, *rest: TrainState) -> TrainState:
    return TrainState(
        params=tree_map(fn, state.params, *(r.params for r in rest)),
        opt_state=tree_map(fn, state.opt_state,
                           *(r.opt_state for r in rest)),
        step=fn(state.step, *(r.step for r in rest)))


def make_diffusion_step(model: Model, opt: opt_lib.Optimizer,
                        lr: float = 0.01, remat: bool = True) -> Callable:
    """One full FedDif diffusion round over a client-stacked fleet:
    ``(state, batch, src_of_dst, train_mask, weights=None) -> (state,
    metrics)``.

    ``state`` and ``batch`` carry the client axis C on every leaf; slot c
    receives the model of slot ``src_of_dst[c]`` ((C,) int64 on the
    state's device); ``train_mask`` (C,) bool marks the receivers that
    train (the auction's winners, constraint 18d) — the others carry the
    received model; ``weights`` (C,) are the chain data sizes of the final
    aggregation (None: a mid-round hop, no aggregation)."""
    fleet_step = make_fleet_train_step(model, opt, lr, remat)

    def move(x, src_of_dst):
        if x.dtype != torch.float32:
            return diffuse_params(x, src_of_dst)
        # The hop's wire is bf16; the master copies stay fp32.
        return diffuse_params(x.to(torch.bfloat16), src_of_dst).to(x.dtype)

    def diffusion_step(state: TrainState, batch: dict,
                       src_of_dst: torch.Tensor, train_mask: torch.Tensor,
                       weights: torch.Tensor | None = None):
        # 1. The hop moves the model only: the receiver's SGD session
        #    restarts from zero momentum.
        opt_state = tree_map(
            lambda x: torch.zeros_like(x)
            if x.dtype in (torch.float32, torch.bfloat16) else x,
            state.opt_state)
        moved = TrainState(
            params=tree_map(lambda x: move(x, src_of_dst), state.params),
            opt_state=opt_state, step=state.step)
        # 2. The local update at the receiving clients.
        trained, metrics = fleet_step(moved, batch)

        # 3. Winners keep the trained model; the others the received one.
        def select(a, b):
            m = train_mask.reshape((-1,) + (1,) * (a.dim() - 1))
            return torch.where(m, a, b)
        out = _state_map(select, trained, moved)
        # 4. The optional aggregation at the end of the round.
        if weights is not None:
            out = TrainState(params=fleet_aggregate(out.params, weights),
                             opt_state=out.opt_state, step=out.step)
        return out, metrics

    return diffusion_step
