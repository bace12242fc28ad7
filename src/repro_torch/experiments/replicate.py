"""Multi-seed replication: one sweep cell at ``S`` replicate seeds.

Counterpart of ``repro.experiments.replicate``.  :func:`run_replicates_loop`
is the general path: one :func:`~repro_torch.fl.experiment.run_experiment`
per seed, sharing the plan cache so FedDif's control plane is replayed, not
planned again, for the seeds after the first (the plans depend on
``topology_seed``, not on the model seed).  The seed-vmapped engine,
:func:`run_replicates_vmapped`, is ROADMAP item A10c and raises.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from repro_torch.core.diffusion import PlanCache
from repro_torch.fl.engine import RunResult
from repro_torch.fl.experiment import ExperimentSpec, run_experiment

__all__ = ["SEED_VMAP_STRATEGIES", "run_replicates_vmapped",
           "run_replicates_loop"]

#: Strategies whose per-round control flow is the same for every seed, so
#: the seed axis could live on the data plane (the reference's vmapped
#: engine; ROADMAP A10c in the port).
SEED_VMAP_STRATEGIES = ("fedavg", "feddif")


def run_replicates_loop(spec: ExperimentSpec, seeds: Sequence[int],
                        plan_cache: PlanCache | None = None,
                        checkpoint_root: str | None = None,
                        device: str | torch.device | None = None,
                        init_for: Callable | None = None
                        ) -> list[RunResult]:
    """One ``run_experiment`` per seed on ``device`` (the CUDA device by
    default), the plan cache shared across seeds.  ``init_for`` maps each
    seed's ``ExperimentSpec`` to the ``init_fn`` its run takes (the tests
    carry the reference's initial params in through it).  Round
    checkpoints (``checkpoint_root``) are ROADMAP item A10b and raise."""
    if checkpoint_root is not None:
        raise NotImplementedError(
            "durable replicates (checkpoint_root) are ROADMAP item A10b "
            "(durability)")
    results = []
    for s in seeds:
        spec_s = dataclasses.replace(
            spec, fl=dataclasses.replace(spec.fl, seed=int(s)))
        results.append(run_experiment(
            spec_s, plan_cache=plan_cache, device=device,
            init_fn=None if init_for is None else init_for(spec_s)))
    return results


def run_replicates_vmapped(spec: ExperimentSpec, seeds: Sequence[int],
                           plan_cache: PlanCache | None = None
                           ) -> list[RunResult]:
    """The seed-vmapped engine: ROADMAP item A10c."""
    raise NotImplementedError(
        "seed-vmapped replication is ROADMAP item A10c; use "
        "run_replicates_loop")
