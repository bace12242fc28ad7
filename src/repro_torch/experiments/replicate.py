"""Multi-seed replication: one sweep cell at ``S`` replicate seeds.

Counterpart of ``repro.experiments.replicate``.  Two engines:

* :func:`run_replicates_vmapped` — the seed-stacked engine.  Replicate
  seeds differ only on the data plane (the initial params, hence every
  local update), so the cohort trains as one tree with a leading seed
  axis: every local SGD step is ``torch.func.vmap`` of one clipped
  momentum step over that axis, every seed on the same batch.  The control
  plane (positions, channel draws, the FedDif plan, the ledger) does not
  depend on the seed (``FLConfig.topology_seed``), runs once per round and
  is shared by every replicate; with a :class:`~repro_torch.core.diffusion.
  PlanCache` it is replayed across cells that share a key.  FedAvg and
  FedDif only (:data:`SEED_VMAP_STRATEGIES`), full fp32 payloads only.
* :func:`run_replicates_loop` — the general path: one
  :func:`~repro_torch.fl.experiment.run_experiment` per seed (any
  strategy, either plane), sharing the plan cache, so FedDif's control
  plane is replayed, not planned again, for the seeds after the first.

Both return one :class:`~repro_torch.fl.engine.RunResult` per seed, with
equal ledgers across seeds.  The seed-stacked engine's data plane launches
none of the port's kernels: it is the reference's own host-side data
plane, which runs none of its Pallas kernels either.  Its control plane
does: with ``planner="jax"`` the shared :class:`~repro_torch.core.
diffusion.DiffusionPlanner` launches ``bid_fused`` on the card for every
round the plan cache misses.
"""
from __future__ import annotations

import copy
import dataclasses
import os
from typing import Callable, Sequence

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from repro_torch.channels.fading import ChannelModel
from repro_torch.channels.resources import GAMMA_FLOOR, ResourceLedger
from repro_torch.channels.topology import CellTopology
from repro_torch.core import aggregation as agg
from repro_torch.core.auction import AuctionConfig
from repro_torch.core.diffusion import (DiffusionPlanner, PlanCache,
                                        feddif_cache_key)
from repro_torch.core.dol import DiffusionState, iid_distance
from repro_torch.device import resolve_device
from repro_torch.fl.adapters import make_adapter_view
from repro_torch.fl.engine import RunResult
from repro_torch.fl.executors import CLIP_NORM
from repro_torch.fl.experiment import (ExperimentSpec, load_experiment_data,
                                       run_experiment)
from repro_torch.fl.models import build_task_model
from repro_torch.fl.schedulers import _xla_mean
from repro_torch.fl.server import check_supported, static_round_draws
from repro_torch.train import optimizer as opt_lib
from repro_torch.tree import tree_map

__all__ = ["SEED_VMAP_STRATEGIES", "run_replicates_vmapped",
           "run_replicates_loop", "hops_full_model"]

#: Strategies whose per-round control flow is the same for every seed, so
#: the seed axis can live on the data plane.  The others (fedswap's visit
#: loop, gossip's pairings, …) run on the loop engine.
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
    carry the reference's initial params in through it).

    ``checkpoint_root`` (durable sweeps) gives each seed its own round
    checkpoint directory, ``<root>/seed<s>``: a preempted cell resumes
    mid-cohort, finished seeds from their last checkpoint, the interrupted
    one from its last boundary."""
    results = []
    for s in seeds:
        spec_s = dataclasses.replace(
            spec, fl=dataclasses.replace(spec.fl, seed=int(s)))
        ckpt_dir = (os.path.join(checkpoint_root, f"seed{int(s)}")
                    if checkpoint_root is not None else None)
        results.append(run_experiment(
            spec_s, plan_cache=plan_cache, device=device,
            init_fn=None if init_for is None else init_for(spec_s),
            checkpoint_dir=ckpt_dir))
    return results


def hops_full_model(spec: ExperimentSpec) -> bool:
    """Is a cell's hop payload the full fp32 model (no int8 codes, the
    identity adapter view)?"""
    model = build_task_model(spec.task, spec.dim, spec.num_classes)
    return (spec.fl.hop_quant == "none"
            and make_adapter_view(model, spec.fl,
                                  spec.adapter_hops).base is None)


def _make_stacked_local_update(loss_fn: Callable, cfg,
                               device: torch.device):
    """Seed-stacked counterpart of :func:`~repro_torch.fl.client.
    make_local_update`: one clipped SGD-momentum step ``vmap``-ed over the
    leading seed axis of (params, momentum), the batch shared (the data
    partition is fixed by ``data_seed``, not the replicate seed).  The clip
    is per seed, inside the vmap, as in the loop engine."""
    opt = opt_lib.sgd(momentum=cfg.momentum)
    lr = float(cfg.lr)

    def one(params, mu, batch):
        grads, loss = grad_and_value(loss_fn)(params, batch)
        grads, _ = opt_lib.clip_by_global_norm(grads, CLIP_NORM)
        updates, new_state = opt.update(grads, {"mu": mu}, params, lr)
        return opt_lib.apply_updates(params, updates), new_state["mu"], loss

    step = vmap(one, in_dims=(0, 0, None))

    def local_update(params, batches):
        """One session from zero momentum: every batch once, in order."""
        mu = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                      params)
        for batch in batches:
            b = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
            params, mu, _ = step(params, mu, b)
        return params

    return local_update


def run_replicates_vmapped(spec: ExperimentSpec, seeds: Sequence[int],
                           plan_cache: PlanCache | None = None,
                           device: str | torch.device | None = None,
                           init_for: Callable | None = None
                           ) -> list[RunResult]:
    """Run one cell at ``len(seeds)`` replicate seeds on ``device`` (the
    CUDA device by default), the seed axis vmapped.  Seed s starts from
    ``init_for(spec_s)`` (or the task model's init) applied to a
    ``torch.Generator`` seeded with s, as its loop run would.

    Raises ``ValueError`` on the reference's guards (strategy,
    ``topology_seed``, churn, scenario, learning-value bids) and on one of
    the port's own: the hop payload must be the full fp32 model
    (:func:`hops_full_model`).  The engine trains and charges the full
    params, so an int8 hop or an adapter view would be charged and trained
    as the fp32 model; the reference's engine does just that on
    ``fig_lm`` (ROADMAP C)."""
    cfg = spec.fl
    if cfg.strategy not in SEED_VMAP_STRATEGIES:
        raise ValueError(f"strategy {cfg.strategy!r} is not seed-vmappable; "
                         f"use run_replicates_loop")
    if cfg.topology_seed is None:
        raise ValueError("seed-vmapped replication needs fl.topology_seed "
                         "(the control plane must not depend on the model "
                         "seed)")
    if cfg.churn_rate > 0.0:
        raise ValueError("seed-vmapped replication does not model churn "
                         "(fl.churn_rate > 0); use run_replicates_loop")
    if cfg.scenario != "static":
        raise ValueError(
            f"seed-vmapped replication supports scenario='static' only "
            f"(got {cfg.scenario!r}); use run_replicates_loop")
    if cfg.uncertainty_weight > 0.0:
        raise ValueError(
            "seed-vmapped replication cannot fuse learning values "
            "(fl.uncertainty_weight > 0): the values depend on each seed's "
            "params, so plans are not shareable; use run_replicates_loop")
    if not hops_full_model(spec):
        raise ValueError(
            f"seed-vmapped replication hops the full fp32 model; this cell "
            f"hops an adapter view or int8 codes (task={spec.task!r}, "
            f"adapter_hops={spec.adapter_hops}, "
            f"hop_quant={cfg.hop_quant!r}); use run_replicates_loop")
    check_supported(cfg)
    dev = resolve_device(device)
    seeds = [int(s) for s in seeds]

    # ---- data and model, once ------------------------------------------
    train, test, part, loaders = load_experiment_data(spec)
    model = build_task_model(spec.task, spec.dim, spec.num_classes)
    dsi, data_sizes = part.dsi, part.data_sizes
    n, m = cfg.num_clients, cfg.num_models
    inits = []
    for s in seeds:
        spec_s = dataclasses.replace(
            spec, fl=dataclasses.replace(cfg, seed=s))
        init_fn = model.init if init_for is None else init_for(spec_s)
        inits.append(init_fn(torch.Generator().manual_seed(s)))
    global_params = tree_map(lambda *xs: torch.stack(xs).to(dev), *inits)
    local_update = _make_stacked_local_update(model.loss, cfg, dev)
    test_x = torch.as_tensor(test.x, device=dev)
    test_y = torch.as_tensor(test.y, device=dev)

    def eval_one(p):
        return (model.accuracy(p, test_x, test_y),
                model.loss(p, {"x": test_x, "y": test_y}))

    eval_stacked = vmap(eval_one)

    # ---- the shared control plane --------------------------------------
    topology = CellTopology(num_pues=n)
    channel = ChannelModel()
    auction = AuctionConfig(gamma_min=cfg.gamma_min, metric=cfg.metric,
                            allow_retraining=cfg.allow_retraining)
    planner = DiffusionPlanner(topology, channel, auction,
                               epsilon=cfg.epsilon,
                               max_rounds=cfg.max_diffusion_rounds,
                               mode=cfg.planner, device=dev,
                               underlay=cfg.underlay)
    ledger = ResourceLedger()
    model_bits = agg.model_bits(inits[0], cfg.bits_per_param)
    auction.model_bits = model_bits

    acc_hist, loss_hist, dif_hist, iid_hist = [], [], [], []
    for t in range(cfg.rounds):
        ctrl_rng = np.random.default_rng([cfg.topology_seed, t])
        pos, up_gamma = static_round_draws(topology, channel, ctrl_rng, n)
        ledger.charge_downlink(model_bits, float(np.median(up_gamma)), n)
        if cfg.strategy == "fedavg":
            locals_ = []
            for i in range(n):
                locals_.append(local_update(global_params,
                                            list(loaders[i].epoch())))
                ledger.charge_uplink(model_bits, float(up_gamma[i]))
            global_params = agg.fedavg(locals_, list(data_sizes))
            dif_hist.append(0)
            iid_hist.append(_xla_mean(iid_distance(np.asarray(dsi),
                                                   cfg.metric)))
        else:                                               # feddif
            models = [global_params for _ in range(m)]
            state = DiffusionState.init(m, n, dsi.shape[1])
            for mi in range(m):
                holder = int(state.holder[mi])
                models[mi] = local_update(models[mi],
                                          list(loaders[holder].epoch()))
                state.record_training(mi, holder, dsi[holder],
                                      float(data_sizes[holder]))
            cache_key = None
            if plan_cache is not None:
                cache_key = feddif_cache_key(cfg, t, dsi, data_sizes,
                                             model_bits, auction)
            plan = planner.plan_communication_round(
                state, dsi, data_sizes, ctrl_rng, positions=pos,
                cache=plan_cache, cache_key=cache_key)
            for k in range(plan.num_rounds):
                for hop in plan.hops_in_round(k):
                    ledger.charge_d2d(model_bits, max(hop.gamma, GAMMA_FLOOR))
                    models[hop.model] = local_update(
                        models[hop.model], list(loaders[hop.dst].epoch()))
            for mi in range(m):
                ledger.charge_uplink(model_bits,
                                     float(up_gamma[int(state.holder[mi])]))
            global_params = agg.fedavg(
                models, [float(state.chain_size[mi]) for mi in range(m)])
            dif_hist.append(plan.num_rounds)
            iid_hist.append(float(np.mean(plan.final_iid_distance)))

        if (t + 1) % cfg.eval_every == 0 or t == cfg.rounds - 1:
            with torch.no_grad():
                a, l = eval_stacked(global_params)
            acc_hist.append(a.double().cpu().numpy())
            loss_hist.append(l.double().cpu().numpy())

    # ---- one RunResult per seed ----------------------------------------
    results = []
    for si, s in enumerate(seeds):
        results.append(RunResult.from_histories(
            accuracy=[float(a[si]) for a in acc_hist],
            loss=[float(l[si]) for l in loss_hist],
            ledger=copy.deepcopy(ledger),
            diffusion_rounds=list(dif_hist),
            iid_distance=list(iid_hist),
            config=dataclasses.replace(cfg, seed=s),
            final_params=tree_map(lambda x: x[si], global_params)))
    return results
