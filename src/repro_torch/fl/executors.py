"""The fleet executor: run one :class:`RoundSchedule` on client-stacked params.

Counterpart of ``repro.fl.executors.FleetExecutor``.  All client slots live
in one params tree with a leading client axis, on one device:

* a local session (one epoch of batches per trained slot, momentum reset,
  per-slot gradient clipping at 10) is ``torch.func.vmap`` of one
  ``grad_and_value`` step over the client axis.  Clients with shorter
  epochs are padded with zero batches and masked out per step
  (``torch.where(active, new, old)``), so each slot's math is its own loop;
* a diffusion hop is :func:`~repro_torch.distributed.fedshard.diffuse_params`
  (a row gather); with ``hop_quant="int8"`` the stacked payload first makes
  one int8 pack→unpack roundtrip per client row
  (:func:`~repro_torch.fl.adapters.quant_roundtrip_tree`: the ``quant``
  kernels on the card); STC-compressed hops and the STC uplink go through
  :func:`~repro_torch.distributed.fedshard.masked_stc_compress` (the
  ``stc_rows`` kernels on the card);
* the Eq.-(11) aggregation is one ``kernels.ops.mix_aggregate_tree`` call
  (one ``mix_aggregate`` kernel launch on the card).  The MixOp of gossip
  and TT-HF, the same call with a (C, C) matrix, comes with ROADMAP A6.

Ledger charging lives elsewhere (``core.schedule.charge_schedule``).
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from repro_torch.core.schedule import PermuteOp, RoundSchedule, TrainOp
from repro_torch.distributed.fedshard import (diffuse_params,
                                              masked_stc_compress)
from repro_torch.fl.adapters import quant_roundtrip_tree
from repro_torch.kernels import ops as kernel_ops
from repro_torch.train import optimizer as opt_lib
from repro_torch.tree import tree_map

Params = Any

__all__ = ["FleetExecutor"]

#: Per-slot global-norm gradient clip of every local step.
CLIP_NORM = 10.0


class FleetExecutor:
    """Client-stacked execution: one params tree, leading client axis."""

    def __init__(self, loss_fn: Callable, client_batches: Sequence[Callable],
                 cfg, device: torch.device):
        self.client_batches = client_batches
        self.cfg = cfg
        self.device = device
        self.quant = cfg.hop_quant == "int8"
        opt = opt_lib.sgd(momentum=cfg.momentum)
        lr = float(cfg.lr)

        def one(p, mom, batch, active):
            grads, loss = grad_and_value(loss_fn)(p, batch)
            grads, _ = opt_lib.clip_by_global_norm(grads, CLIP_NORM)
            updates, new_state = opt.update(grads, {"mu": mom}, p, lr)
            p2 = opt_lib.apply_updates(p, updates)

            def sel(a, b):
                return torch.where(active, a, b)
            return (tree_map(sel, p2, p), tree_map(sel, new_state["mu"], mom),
                    loss)

        self._step = vmap(one)

    # ---------------------------------------------------------------- batches

    def _draw_session(self, mask: np.ndarray):
        """Draw one local epoch per masked slot (each client's own batch
        stream), pad to the longest epoch, stack per step.  Returns
        ``(steps, actives)``: per padded step, a client-stacked batch dict
        on the device and the (C,) bool mask of slots training that step."""
        per_slot = [list(self.client_batches[c]()) if mask[c] else []
                    for c in range(len(mask))]
        nb = max((len(b) for b in per_slot), default=0)
        if nb == 0:
            return [], []
        template = {k: np.zeros_like(v)
                    for k, v in next(b[0] for b in per_slot if b).items()}
        steps, actives = [], []
        for k in range(nb):
            rows = [b[k] if k < len(b) else template for b in per_slot]
            steps.append({key: torch.from_numpy(
                np.stack([r[key] for r in rows])).to(self.device)
                for key in template})
            actives.append(torch.from_numpy(
                np.array([k < len(b) for b in per_slot])).to(self.device))
        return steps, actives

    def _session(self, params: Params, mask: np.ndarray) -> Params:
        """One local-update session at every masked slot (vmapped epoch)."""
        if not mask.any():
            return params
        steps, actives = self._draw_session(mask)
        mom = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       params)
        for batch, active in zip(steps, actives):
            params, mom, _ = self._step(params, mom, batch, active)
        return params

    # ------------------------------------------------------------- primitives

    def _broadcast(self, global_params: Params, num_slots: int) -> Params:
        return tree_map(lambda x: x.unsqueeze(0).expand(
            (num_slots,) + tuple(x.shape)).contiguous(), global_params)

    def _permute(self, params: Params, op: PermuteOp) -> Params:
        if self.quant:
            # int8 wire: roundtrip the stacked payload per client row, then
            # move the decoded rows (packing commutes with the row gather).
            params = quant_roundtrip_tree(params)
        return diffuse_params(params, torch.as_tensor(
            np.asarray(op.src_of_dst, np.int64), device=self.device))

    def _aggregate(self, payload: Params, w: torch.Tensor) -> Params:
        # Eq. (11): the same kernel with one output row.
        return kernel_ops.mix_aggregate_tree(payload, w.reshape(1, -1),
                                             collapse=True)

    # ------------------------------------------------------------------ round

    def run_ops(self, sched: RoundSchedule, global_params: Params) -> Params:
        """Replay the op list on the client-stacked tree."""
        params = self._broadcast(global_params, sched.num_slots)
        ref = global_params
        for op in sched.ops:
            if isinstance(op, TrainOp):
                params = self._session(params, op.train_mask)
            elif isinstance(op, PermuteOp):
                if op.compress:
                    params = masked_stc_compress(params, ref,
                                                 op.compress_src_mask(),
                                                 sched.stc_sparsity)
                params = self._permute(params, op)
                params = self._session(params, op.train_mask)
            else:
                raise TypeError(f"unknown op {type(op).__name__}")
        return params

    def aggregate(self, sched: RoundSchedule, params: Params,
                  ref: Params) -> Params:
        wvec = sched.slot_weights()
        w = torch.as_tensor((wvec / wvec.sum()).astype(np.float32),
                            device=self.device)
        if sched.agg_mode == "stc_delta":
            params = masked_stc_compress(params, ref, wvec > 0,
                                         sched.stc_sparsity)
        return self._aggregate(params, w)

    def run_round(self, sched: RoundSchedule, global_params: Params) -> Params:
        params = self.run_ops(sched, global_params)
        return self.aggregate(sched, params, global_params)
