"""Executors: run one :class:`RoundSchedule` on params, on the device.

Counterpart of ``repro.fl.executors`` (``HostExecutor``, ``FleetExecutor``,
``make_executor``).  Both planes consume the same schedule object:

* :class:`HostExecutor` — the reference semantics.  One param tree per
  client slot (a list of trees on the device), local sessions through
  :mod:`repro_torch.fl.client` / :mod:`repro_torch.fl.fedprox` one client
  at a time, STC-compressed hops and the STC uplink per slot and per leaf
  through ``fl.compression.stc_compress`` (on the card one ``stc_fused``
  launch per leaf up to ``N_FUSED`` elements, the ``stc_reduce``/
  ``stc_apply`` kernels beyond), int8 hops through ``fl.adapters.
  quant_roundtrip_slots`` (every slot and the move in one
  ``quant_roundtrip`` launch per PermuteOp), and MixOps and the
  Eq.-(11) aggregation through ``core.aggregation.fedavg`` in plain tensor
  ops, as the reference computes them outside any Pallas kernel.
* :class:`FleetExecutor` — client-stacked.  All slots live in one params
  tree with a leading client axis:

  - a local session (one epoch of batches per trained slot, momentum
    reset, per-slot gradient clipping at 10, the proximal term for
    ``fedprox``/``feddif_prox`` anchored at the session's incoming params)
    is ``torch.func.vmap`` of one ``grad_and_value`` step over the client
    axis.  Clients with shorter epochs are padded with zero batches and
    masked out per step (``torch.where(active, new, old)``), so each
    slot's math is its own loop;
  - a diffusion hop is :func:`~repro_torch.distributed.fedshard.
    diffuse_params` (a row gather); with ``hop_quant="int8"`` the stacked
    payload first makes one int8 pack→unpack roundtrip per client row
    (:func:`~repro_torch.fl.adapters.quant_roundtrip_tree`: the ``quant``
    kernels on the card); STC-compressed hops and the STC uplink go through
    :func:`~repro_torch.distributed.fedshard.masked_stc_compress` (one
    ``stc_rows_fused`` launch per leaf on the card);
  - a MixOp and the Eq.-(11) aggregation are one
    ``kernels.ops.mix_aggregate_tree`` call each (one ``mix_tree`` launch
    on the card, every leaf read in place), with the (C, C) MixOp matrix
    or a (1, C) row built on the host.

Under ``FLConfig.profile_phases`` the fleet executor synchronizes the
device after each primitive and charges its wall-clock to ``train``,
``hop_collective`` or ``mix`` (:meth:`FleetExecutor.pop_phase_times`), as
the reference's does; the host plane reports only the server's ``plan``.

Persistent schedules (gossip, TT-HF) carry the slots across rounds on
either plane; ``capture_slots`` / ``slots_like`` / ``num_slots_of`` /
``adopt_slots`` round-trip them through a round checkpoint
(:mod:`repro_torch.fl.resume`).  The buffered-async plane
(:mod:`repro_torch.fl.async_plane`) replays a round through ``run_ops``
and takes each contribution with ``slot_state``: a copy of the slot's
tree, so a contribution waiting in the event queue across rounds shares no
storage with the stacked rows, kernel tables or slot trees that a later
round writes.  Ledger charging lives elsewhere
(``core.schedule.charge_schedule``).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Sequence

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from repro_torch.core import aggregation as agg
from repro_torch.core.schedule import MixOp, PermuteOp, RoundSchedule, TrainOp
from repro_torch.distributed.fedshard import (diffuse_params,
                                              masked_stc_compress)
from repro_torch.fl.adapters import quant_roundtrip_slots, quant_roundtrip_tree
from repro_torch.fl.compression import stc_compress
from repro_torch.fl.fedprox import prox_objective
from repro_torch.fl.schedulers import PROX_STRATEGIES
from repro_torch.kernels import ops as kernel_ops
from repro_torch.train import optimizer as opt_lib
from repro_torch.tree import tree_leaves, tree_map

Params = Any

__all__ = ["HostExecutor", "FleetExecutor", "make_executor", "EXECUTORS",
           "CLIP_NORM"]

#: The data planes of the port; the reference's third, "sharded", is
#: ROADMAP item A12.
EXECUTORS = ("host", "fleet")

#: Per-slot global-norm gradient clip of every local step.
CLIP_NORM = 10.0


def _to_host(tree):
    return tree_map(lambda x: x.detach().cpu(), tree)


def _host_like(tree):
    return tree_map(lambda x: torch.empty(tuple(x.shape), dtype=x.dtype),
                    tree)


def _to_device(tree, device: torch.device):
    return tree_map(lambda x: x.to(device).contiguous(), tree)


def _tree_sub(a, b):
    return tree_map(lambda x, y: x - y, a, b)


def _tree_add(a, b):
    return tree_map(lambda x, y: x + y, a, b)


class HostExecutor:
    """Per-slot list-of-trees execution — the reference semantics."""

    def __init__(self, local_update: Callable,
                 client_batches: Sequence[Callable], cfg,
                 device: torch.device):
        self.local_update = local_update
        self.client_batches = client_batches
        self.cfg = cfg
        self.device = device
        self.quant = cfg.hop_quant == "int8"

    def _train(self, slots: list, mask: np.ndarray) -> None:
        for c in np.flatnonzero(mask):
            slots[c], _ = self.local_update(
                slots[c], self.client_batches[c](), self.cfg.lr)

    # ------------------------------------------------- round-state capture
    # Persistent strategies (gossip, tthf) carry slots across rounds; the
    # resume seam (fl/resume.py) round-trips them through these hooks, so a
    # checkpoint restores onto the executor that wrote it.

    def capture_slots(self, slots: list | None):
        """Host copy of the persistent slot state (or ``None``): a list of
        slot trees, saved as ``slots/<i>/…``."""
        return None if slots is None else [_to_host(s) for s in slots]

    def slots_like(self, global_params: Params, num_slots: int):
        """Template of a :meth:`capture_slots` capture."""
        return [_host_like(global_params) for _ in range(num_slots)]

    def num_slots_of(self, saved) -> int:
        """Slot count of a capture (host: the outer list).  The executor is
        authoritative: a params tree that is itself a list looks alike."""
        return len(saved)

    def adopt_slots(self, saved):
        """A capture on this executor's device, contiguous."""
        return [_to_device(s, self.device) for s in saved]

    # ------------------------------------------------------------------ round

    def run_ops(self, sched: RoundSchedule, global_params: Params,
                slots: list | None) -> list:
        """Replay the schedule's op list; return the post-op slot list."""
        c_slots = sched.num_slots
        if not sched.persistent or slots is None:
            slots = [tree_map(torch.clone, global_params)
                     for _ in range(c_slots)]
        ref = global_params
        for op in sched.ops:
            if isinstance(op, TrainOp):
                self._train(slots, op.train_mask)
            elif isinstance(op, PermuteOp):
                if op.compress:
                    for s in np.flatnonzero(op.compress_src_mask()):
                        delta = stc_compress(_tree_sub(slots[s], ref),
                                             sched.stc_sparsity)
                        slots[s] = _tree_add(ref, delta)
                if self.quant:
                    # int8 wire: each destination decodes the pack→unpack
                    # of its payload (the hop is a bijection, so every slot
                    # moves and is roundtripped exactly once).
                    slots = quant_roundtrip_slots(slots, op.src_of_dst)
                else:
                    slots = [slots[int(op.src_of_dst[c])]
                             for c in range(c_slots)]
                self._train(slots, op.train_mask)
            elif isinstance(op, MixOp):
                for members, weights in op.groups:
                    avg = agg.fedavg([slots[i] for i in members],
                                     list(weights))
                    for i in members:
                        slots[i] = avg
            else:
                raise TypeError(f"unknown op {type(op).__name__}")
        return slots

    def slot_state(self, slots: list, slot: int) -> Params:
        """A copy of one slot's post-op tree (the async plane's
        contribution), owning its storage."""
        return tree_map(torch.clone, slots[slot])

    def aggregate(self, sched: RoundSchedule, slots: list,
                  ref: Params) -> Params:
        """Eq. (11) over the schedule's ``agg`` entries, in entry order."""
        weights = [w for _, w in sched.agg]
        if sched.agg_mode == "stc_delta":
            deltas = [stc_compress(_tree_sub(slots[s], ref),
                                   sched.stc_sparsity) for s, _ in sched.agg]
            return _tree_add(ref, agg.fedavg(deltas, weights))
        return agg.fedavg([slots[s] for s, _ in sched.agg], weights)

    def run_round(self, sched: RoundSchedule, global_params: Params,
                  slots: list | None) -> tuple[Params, list | None]:
        slots = self.run_ops(sched, global_params, slots)
        new_global = self.aggregate(sched, slots, global_params)
        return new_global, (slots if sched.persistent else None)


class FleetExecutor:
    """Client-stacked execution: one params tree, leading client axis."""

    def __init__(self, loss_fn: Callable, client_batches: Sequence[Callable],
                 cfg, device: torch.device):
        self.client_batches = client_batches
        self.cfg = cfg
        self.device = device
        self.quant = cfg.hop_quant == "int8"
        self.prox = cfg.strategy in PROX_STRATEGIES
        opt = opt_lib.sgd(momentum=cfg.momentum)
        lr = float(cfg.lr)
        objective = prox_objective(loss_fn, float(cfg.prox_mu))

        def one(p, mom, batch, active, anchor=None):
            if anchor is None:
                grads, loss = grad_and_value(loss_fn)(p, batch)
            else:
                grads, loss = grad_and_value(objective)(p, batch, anchor)
            grads, _ = opt_lib.clip_by_global_norm(grads, CLIP_NORM)
            updates, new_state = opt.update(grads, {"mu": mom}, p, lr)
            p2 = opt_lib.apply_updates(p, updates)

            def sel(a, b):
                return torch.where(active, a, b)
            return (tree_map(sel, p2, p), tree_map(sel, new_state["mu"], mom),
                    loss)

        # ``_step(params, mom, batch, active[, anchor])``: the proximal
        # strategies pass the anchor, the others leave it out.
        self._step = vmap(one)
        self.profile = bool(cfg.profile_phases)
        self._phase: dict = {}

    # ------------------------------------------------------- phase profiling

    def _timed(self, phase: str, fn, *args):
        """Run a round primitive; under ``cfg.profile_phases`` synchronize
        the executor's device after it and charge the wall-clock to
        ``phase`` (train / hop_collective / mix; the server adds plan)."""
        if not self.profile:
            return fn(*args)
        t0 = time.perf_counter()
        out = fn(*args)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._phase[phase] = (self._phase.get(phase, 0.0)
                              + time.perf_counter() - t0)
        return out

    def pop_phase_times(self) -> dict:
        """Return and reset the round's phase seconds."""
        out, self._phase = self._phase, {}
        return out

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
        # The proximal anchor is the received model, as on the host plane.
        extra = (params,) if self.prox else ()
        for batch, active in zip(steps, actives):
            params, mom, _ = self._step(params, mom, batch, active, *extra)
        return params

    # ------------------------------------------------- round-state capture

    def capture_slots(self, slots: Params | None):
        """Host copy of the client-stacked slot tree (or ``None``)."""
        return None if slots is None else _to_host(slots)

    def slots_like(self, global_params: Params, num_slots: int):
        return tree_map(lambda x: torch.empty((num_slots,) + tuple(x.shape),
                                              dtype=x.dtype), global_params)

    def num_slots_of(self, saved) -> int:
        """Slot count of a capture (fleet: the stacked leading axis)."""
        return int(tree_leaves(saved)[0].shape[0])

    def adopt_slots(self, saved):
        return _to_device(saved, self.device)

    # ------------------------------------------------------------- primitives

    def _broadcast(self, global_params: Params, num_slots: int) -> Params:
        return tree_map(lambda x: x.unsqueeze(0).expand(
            (num_slots,) + tuple(x.shape)).contiguous(), global_params)

    def _permute(self, params: Params, op: PermuteOp) -> Params:
        if self.quant:
            # int8 wire: roundtrip the stacked payload per client row and
            # move the decoded rows in one call (packing commutes with the
            # row gather).
            return quant_roundtrip_tree(params, op.src_of_dst)
        return diffuse_params(params, torch.as_tensor(
            np.asarray(op.src_of_dst, np.int64), device=self.device))

    def _mix(self, params: Params, op: MixOp, num_slots: int) -> Params:
        # Eq. (10): the (C, C) MixOp matrix through the same kernel, handed
        # over on the host (the kernel takes it in its parameters).
        w = torch.from_numpy(op.matrix(num_slots))
        return kernel_ops.mix_aggregate_tree(params, w)

    def _aggregate(self, payload: Params, w: torch.Tensor) -> Params:
        # Eq. (11): the same kernel with one output row.
        return kernel_ops.mix_aggregate_tree(payload, w.reshape(1, -1),
                                             collapse=True)

    # ------------------------------------------------------------------ round

    def run_ops(self, sched: RoundSchedule, global_params: Params,
                slots: Params | None) -> Params:
        """Replay the op list on the client-stacked tree."""
        c_slots = sched.num_slots
        if sched.persistent and slots is not None:
            params = slots
        else:
            params = self._timed("hop_collective", self._broadcast,
                                 global_params, c_slots)
        ref = global_params
        for op in sched.ops:
            if isinstance(op, TrainOp):
                params = self._timed("train", self._session, params,
                                     op.train_mask)
            elif isinstance(op, PermuteOp):
                if op.compress:
                    params = self._timed("hop_collective",
                                         masked_stc_compress, params, ref,
                                         op.compress_src_mask(),
                                         sched.stc_sparsity)
                params = self._timed("hop_collective", self._permute,
                                     params, op)
                params = self._timed("train", self._session, params,
                                     op.train_mask)
            elif isinstance(op, MixOp):
                params = self._timed("mix", self._mix, params, op, c_slots)
            else:
                raise TypeError(f"unknown op {type(op).__name__}")
        return params

    def slot_state(self, params: Params, slot: int) -> Params:
        """A copy of one slot's row of the stacked tree (the async plane's
        contribution), owning its storage."""
        return tree_map(lambda x: x[slot].clone(), params)

    def aggregate(self, sched: RoundSchedule, params: Params,
                  ref: Params) -> Params:
        wvec = sched.slot_weights()
        w = torch.from_numpy((wvec / wvec.sum()).astype(np.float32))
        if sched.agg_mode == "stc_delta":
            params = self._timed("hop_collective", masked_stc_compress,
                                 params, ref, wvec > 0, sched.stc_sparsity)
        return self._timed("mix", self._aggregate, params, w)

    def run_round(self, sched: RoundSchedule, global_params: Params,
                  slots: Params | None) -> tuple[Params, Params | None]:
        params = self.run_ops(sched, global_params, slots)
        new_global = self.aggregate(sched, params, global_params)
        return new_global, (params if sched.persistent else None)


def make_executor(name: str, loss_fn: Callable, local_update: Callable,
                  client_batches: Sequence[Callable], cfg,
                  device: torch.device):
    """Build the executor of the resolved engine mode."""
    if name == "host":
        return HostExecutor(local_update, client_batches, cfg, device)
    if name == "fleet":
        return FleetExecutor(loss_fn, client_batches, cfg, device)
    if name == "sharded":
        raise NotImplementedError(
            "the sharded data plane is ROADMAP item A12")
    raise ValueError(f"unknown executor {name!r}; expected one of "
                     f"{EXECUTORS}")
