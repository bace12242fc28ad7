"""Durable round-state checkpoints for ``run_federated``: the resume seam.

Counterpart of ``repro.fl.resume``, with its files and metadata.
:class:`RoundCheckpointer` makes one experiment cell preemption-proof:
every ``FLConfig.checkpoint_every`` communication rounds it writes the full
state at the round boundary,

* the global params and, for persistent strategies (gossip, TT-HF), the
  slots through the executor's ``capture_slots`` / ``adopt_slots`` hooks
  (each executor restores onto its own device);
* the cumulative Eq.-15 :class:`~repro_torch.channels.resources.
  ResourceLedger`;
* the accuracy, loss, diffusion-round, IID-distance, round-wall and
  phase-profile histories;
* the wireless world (:class:`~repro_torch.channels.world.HostWorld`:
  positions, waypoints, serving cells, spent energy), so a mobile or
  energy-capped run resumes where it stopped, with or without a
  ``topology_seed``, from this saved state (the reference writes none and
  replays ``advance_round`` instead, which cannot rebuild spent energy);
* the buffered-async plane's state (:mod:`repro_torch.fl.async_plane`):
  its virtual-clock curves in the metadata (``async_hist``), the pending
  contributions stacked on a leading entry axis in the npz (``abuf/…``)
  and their entry metadata (``buffer``: count, virtual clock, next
  sequence number, and per entry arrival, sequence, round, slot and
  weight), as the reference writes them, so a run killed with
  contributions still queued resumes with the same queue;
* every RNG position: the model-seed generator's bit-generator state (as
  JSON) and the caller's data cursors (``capture_extra``: the clients'
  loader epochs).  The control plane's streams are keyed
  ``[topology_seed, t]`` per round, so a loop restarted at round t draws
  them again exactly with no stored position,

through :mod:`repro_torch.train.checkpoint` (atomic npz, then the metadata
JSON as commit marker).  A run resumed from any boundary is bit-identical
to one that never stopped: params, ledger and curves.

:class:`Preempted` is the in-process kill switch of the fault-injection
tests: a ``BaseException``, so the sweep's per-cell failure isolation,
which catches ``Exception`` only, never swallows a preemption.
"""
from __future__ import annotations

import os
import warnings
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.channels.resources import ResourceLedger
from repro_torch.fl.engine import engine_fingerprint
from repro_torch.train.checkpoint import (load_metadata, restore_checkpoint,
                                          save_checkpoint, valid_steps)
from repro_torch.tree import tree_map

__all__ = ["RoundCheckpointer", "Preempted", "RoundState"]

# FLConfig fields a checkpoint must agree on to be restorable: everything
# that alters the trajectory.  The cadence (checkpoint_every) is absent on
# purpose: changing it on resume is safe.  The resolved engine is guarded
# apart (engine_fingerprint).
_CONFIG_GUARD = ("strategy", "num_clients", "num_models", "rounds",
                 "local_epochs", "lr", "momentum", "batch_size", "epsilon",
                 "gamma_min", "metric", "stc_sparsity", "prox_mu", "seed",
                 "topology_seed", "executor", "planner", "churn_rate",
                 "allow_retraining", "underlay")

# Round checkpoints kept after a save: two, so a corrupt latest one can fall
# back one boundary.
KEEP = 2


class Preempted(BaseException):
    """A simulated preemption raised at a round boundary (fault injection).
    Not an ``Exception``: the sweep's cell isolation lets it kill the
    sweep, as SIGTERM would."""


class RoundState:
    """What a resumed ``run_federated`` gets back."""

    def __init__(self, step: int, params: Any, slots: Any,
                 ledger: ResourceLedger, meta: dict,
                 buffer_tree: Any = None):
        self.step = step
        self.params = params
        self.slots = slots
        self.ledger = ledger
        self.acc_hist = [float(x) for x in meta["acc_hist"]]
        self.loss_hist = [float(x) for x in meta["loss_hist"]]
        self.dif_hist = [int(x) for x in meta["dif_hist"]]
        self.iid_hist = [float(x) for x in meta["iid_hist"]]
        self.round_wall = [float(x) for x in meta["round_wall"]]
        self.phase_s = [dict(x) for x in meta.get("phase_s", [])]
        self.rng_state = meta["rng_state"]
        self.world = meta.get("world")
        self.extra = meta.get("extra")
        # The async plane's curves and its pending contributions.
        self.async_hist = meta.get("async_hist")
        self.buffer_meta = meta.get("buffer") or {"count": 0,
                                                  "virtual_s": 0.0,
                                                  "next_seq": 0}
        self.buffer_tree = buffer_tree


class RoundCheckpointer:
    """Write and restore ``run_federated``'s round state every R rounds.

    Args:
      directory: the checkpoint directory of one cell and seed.
      every: cadence R in communication rounds (≥ 1).
      capture_extra / restore_extra: the caller's data cursors (the
        experiment harness passes the clients' loader epochs), so
        ``run_federated`` need not know where batches come from.

    Older checkpoints than the newest :data:`KEEP` are pruned after a save.
    The class attribute ``fail_after_save`` (default ``None``) is fault
    injection: once that step's checkpoint is on disk, :meth:`save` raises
    :class:`Preempted`.  One monkeypatch arms every checkpointer a sweep
    builds.
    """

    fail_after_save: int | None = None

    def __init__(self, directory: str, every: int = 1,
                 capture_extra: Callable[[], Any] | None = None,
                 restore_extra: Callable[[Any], None] | None = None):
        self.directory = directory
        self.every = max(1, int(every))
        self.capture_extra = capture_extra
        self.restore_extra = restore_extra

    def due(self, step: int, total_rounds: int) -> bool:
        """Save at round boundary ``step`` (rounds completed)?  The final
        round never saves: the finished result supersedes it."""
        return step < total_rounds and step % self.every == 0

    def save(self, step: int, executor, params: Any, slots: Any,
             ledger: ResourceLedger, cfg, *, acc_hist, loss_hist, dif_hist,
             iid_hist, round_wall, rng: np.random.Generator,
             phase_s=(), world=None, async_hist: dict | None = None,
             buffer_tree: Any = None, buffer_meta: dict | None = None
             ) -> str:
        """Write one round boundary; returns the ``.npz`` path.  ``world``
        (a :class:`~repro_torch.channels.world.HostWorld`) is saved with
        it; the async plane passes its curves (``async_hist``), its pending
        contributions stacked on a leading axis (``buffer_tree``, host
        tensors) and their entry metadata (``buffer_meta``)."""
        tree = {"params": params}
        saved_slots = executor.capture_slots(slots)
        if saved_slots is not None:
            tree["slots"] = saved_slots
        if buffer_tree is not None:
            tree["abuf"] = buffer_tree
        meta = {
            "config": {k: getattr(cfg, k) for k in _CONFIG_GUARD},
            "engine": engine_fingerprint(cfg),
            "ledger": ledger.as_dict(),
            "acc_hist": [float(x) for x in acc_hist],
            "loss_hist": [float(x) for x in loss_hist],
            "dif_hist": [int(x) for x in dif_hist],
            "iid_hist": [float(x) for x in iid_hist],
            "round_wall": [float(x) for x in round_wall],
            "phase_s": [{k: float(v) for k, v in ph.items()}
                        for ph in phase_s],
            "world": None if world is None else world.state_dict(),
            # numpy keeps PCG64's 128-bit state as Python ints, which JSON
            # carries exactly.
            "rng_state": rng.bit_generator.state,
            "num_slots": (None if saved_slots is None
                          else executor.num_slots_of(saved_slots)),
            "has_slots": saved_slots is not None,
            "extra": (self.capture_extra()
                      if self.capture_extra is not None else None),
        }
        if async_hist is not None:
            meta["async_hist"] = {k: list(v) for k, v in async_hist.items()}
        if buffer_meta is not None:
            meta["buffer"] = buffer_meta
        path = save_checkpoint(self.directory, step, tree, metadata=meta)
        self._prune()
        if self.fail_after_save is not None and step == self.fail_after_save:
            raise Preempted(f"simulated preemption after round-{step} "
                            f"checkpoint in {self.directory!r}")
        return path

    def _prune(self) -> None:
        for s in valid_steps(self.directory)[:-KEEP]:
            for suffix in (".npz", ".json"):
                p = os.path.join(self.directory, f"ckpt_{s:08d}{suffix}")
                if os.path.exists(p):
                    os.remove(p)

    def restore(self, executor, params_template: Any, cfg
                ) -> RoundState | None:
        """The latest readable round state, or ``None`` (a fresh start).

        Walks the checkpoints newest first, skipping unreadable ones with a
        ``RuntimeWarning``.  Raises ``ValueError`` if a readable checkpoint
        was written by another config.  The async plane's pending
        contributions come back stacked on the host (``buffer_tree``)."""
        for step in reversed(valid_steps(self.directory)):
            try:
                meta = load_metadata(self.directory, step)
            except Exception as e:                  # noqa: BLE001
                warnings.warn(
                    f"round checkpoint {step} metadata unreadable "
                    f"({type(e).__name__}: {e}); falling back",
                    RuntimeWarning, stacklevel=2)
                continue
            self._guard_config(meta, cfg)
            like = {"params": params_template}
            if meta["has_slots"]:
                like["slots"] = executor.slots_like(params_template,
                                                    int(meta["num_slots"]))
            nbuf = int((meta.get("buffer") or {}).get("count", 0))
            if nbuf > 0:
                like["abuf"] = tree_map(
                    lambda x: torch.empty((nbuf,) + tuple(x.shape),
                                          dtype=x.dtype), params_template)
            try:
                tree = restore_checkpoint(self.directory, step, like)
            except Exception as e:                  # noqa: BLE001
                warnings.warn(
                    f"round checkpoint {step} arrays unreadable "
                    f"({type(e).__name__}: {e}); falling back",
                    RuntimeWarning, stacklevel=2)
                continue
            slots = (executor.adopt_slots(tree["slots"])
                     if meta["has_slots"] else None)
            state = RoundState(step, tree["params"], slots,
                               ResourceLedger(**meta["ledger"]), meta,
                               buffer_tree=tree.get("abuf"))
            if self.restore_extra is not None and state.extra is not None:
                self.restore_extra(state.extra)
            return state
        return None

    @staticmethod
    def _guard_config(meta: dict, cfg) -> None:
        saved = meta.get("config", {})
        diffs = {k: (saved.get(k), getattr(cfg, k)) for k in _CONFIG_GUARD
                 if k in saved and saved[k] != getattr(cfg, k)}
        if "engine" in meta and meta["engine"] != engine_fingerprint(cfg):
            diffs["engine"] = (meta["engine"], engine_fingerprint(cfg))
        if diffs:
            raise ValueError(
                "refusing to resume: checkpoint was written by a different "
                f"config — mismatched fields (saved, current): {diffs}")

    @staticmethod
    def restore_world(world, state: RoundState) -> None:
        """Bring ``world`` (a fresh :class:`~repro_torch.channels.world.
        HostWorld`) to the checkpoint's round from its saved state.  Only a
        static world's checkpoint can lack one, and a static world has no
        state that a round reads."""
        if state.world is not None:
            world.load_state_dict(state.world)

    @staticmethod
    def apply_rng_state(rng: np.random.Generator, state: dict) -> None:
        """Reposition the model-seed generator to its checkpointed state."""
        rng.bit_generator.state = state
