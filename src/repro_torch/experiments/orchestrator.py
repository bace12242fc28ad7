"""Sweep orchestrator: registry entry -> grid -> replicated runs -> artifact.

Counterpart of ``repro.experiments.orchestrator``.  ``run_sweep`` is the
one-command reproduction of a paper figure::

    from repro_torch.experiments import run_sweep
    artifact = run_sweep("fig3_alpha", smoke=True, seeds=(0, 1, 2))

For every cell of the sweep's grid it stamps a shared ``topology_seed``
(so the wireless control plane does not depend on the replicate seed), runs
the cell at every seed, shares one :class:`~repro_torch.core.diffusion
.PlanCache` across the whole sweep (so FedDif's auction loop runs once per
distinct topology seed, round, partition, ε and γ_min, and is replayed for
every other replicate), and folds the per-seed curves, the Eq.-15 ledger
and the wall-clock into one JSON record per cell.

Before it runs a cell, ``run_sweep`` checks every cell of the grid with
:func:`~repro_torch.fl.server.check_supported`: a sweep that needs churn,
the async plane or a world scenario (``fig7_scaling``, ``fig_async``,
``fig_scenarios``: ROADMAP A11) raises ``NotImplementedError`` and runs
nothing.  Seeds run one after another (the seed-vmapped engine is A10c);
durable sweeps (round checkpoints, resume) are A10b.

Everything runs on ``device``, the CUDA device unless the caller passes
``"cpu"``: the cells and, with ``planner="jax"``, the pre-planner.  The
plan-cache key does not name the device, so a cache planned on one device
must not be replayed by runs on another.
"""
from __future__ import annotations

import time
import warnings
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.channels.fading import ChannelModel
from repro_torch.channels.topology import CellTopology
from repro_torch.core.auction import AuctionConfig
from repro_torch.core.diffusion import (DiffusionPlanner, PlanCache,
                                        feddif_cache_key)
from repro_torch.core.dol import DiffusionState
from repro_torch.core.planner import (decode_plan, plan_round_inputs,
                                      plan_rounds_batched)
from repro_torch.device import resolve_device
from repro_torch.experiments import artifacts
from repro_torch.experiments.registry import (SweepCell, expand_sweep,
                                              get_sweep)
from repro_torch.experiments.replicate import run_replicates_loop
from repro_torch.fl.engine import SHARDED_CROSSOVER_N, resolve_engine
from repro_torch.fl.experiment import load_experiment_data, spec_model_bits
from repro_torch.fl.server import check_supported, static_round_draws

__all__ = ["run_cell", "run_sweep", "prepopulate_plan_cache",
           "SHARDED_CROSSOVER_N", "REPLICATION_ENGINES"]

_FEDDIF_STRATEGIES = ("feddif", "feddif_stc", "feddif_prox")

#: How replicate seeds run: ``"auto"`` resolves to ``"loop"`` (one run per
#: seed) until the seed-vmapped engine, ``"seed_vmap"``, lands (A10c).
REPLICATION_ENGINES = ("auto", "seed_vmap", "loop")


def prepopulate_plan_cache(cells: Sequence[SweepCell], cache: PlanCache,
                           device: str | torch.device | None = None
                           ) -> dict:
    """Plan every FedDif cell × communication round up front with the
    device planner on ``device``.

    For each eligible cell (FedDif family, ``planner="jax"``, topology seed
    set, no underlay, the static world, no learning value) this replays the
    control-plane stream of ``run_federated`` for round t (seed
    ``default_rng([topology_seed, t])``, positions and the uplink draw,
    then the planner's channel rounds), builds one
    :class:`~repro_torch.core.planner.PlanInputs` per round, groups them by
    signature (N, M, C, max_rounds, metric, retraining) and plans each
    group through :func:`~repro_torch.core.planner.plan_rounds_batched`.
    The decoded plans and post-plan states land in ``cache`` under the
    :func:`~repro_torch.core.diffusion.feddif_cache_key` the scheduler
    builds, so every later run of those cells, at any seed, replays them.

    Returns ``{"planned", "skipped", "batches"}`` as the reference does,
    and ``planner_stats``: the summed ``loop_iterations`` (bid rounds),
    ``auction_iterations`` and ``auction_host_reads`` of the plans made.
    """
    groups: dict[tuple, list] = {}
    skipped = 0
    for cell in cells:
        cfg = cell.spec.fl
        if (cell.strategy not in _FEDDIF_STRATEGIES
                or cfg.planner != "jax" or cfg.topology_seed is None
                or cfg.underlay or cfg.scenario != "static"
                or cfg.uncertainty_weight > 0.0):
            # Value-fused plans depend on each seed's params; the other
            # worlds replay their own streams inside run_federated.
            skipped += 1
            continue
        _, _, part, _ = load_experiment_data(cell.spec, with_loaders=False)
        dsi, data_sizes = part.dsi, part.data_sizes
        n, m, c = cfg.num_clients, cfg.num_models, dsi.shape[1]
        model_bits = spec_model_bits(cell.spec)
        topology = CellTopology(num_pues=n)
        channel = ChannelModel()
        auction = AuctionConfig(gamma_min=cfg.gamma_min, metric=cfg.metric,
                                allow_retraining=cfg.allow_retraining,
                                model_bits=model_bits)
        planner = DiffusionPlanner(topology, channel, auction,
                                   epsilon=cfg.epsilon,
                                   max_rounds=cfg.max_diffusion_rounds,
                                   mode="jax", device=device)
        max_rounds = cfg.max_diffusion_rounds or n * (n - 1)
        for t in range(cfg.rounds):
            key = feddif_cache_key(cfg, t, dsi, data_sizes, model_bits,
                                   auction)
            if key in cache:
                skipped += 1
                continue
            ctrl_rng = np.random.default_rng([cfg.topology_seed, t])
            pos, _ = static_round_draws(topology, channel, ctrl_rng, n)
            state = DiffusionState.init(m, n, c)
            for mi in range(m):
                holder = int(state.holder[mi])
                state.record_training(mi, holder, dsi[holder],
                                      float(data_sizes[holder]))
            inp, gamma64 = plan_round_inputs(planner, state, dsi, data_sizes,
                                             ctrl_rng, positions=pos)
            sig = (n, m, c, max_rounds, cfg.metric, cfg.allow_retraining)
            groups.setdefault(sig, []).append(
                (key, inp, state, gamma64, model_bits))

    planned = 0
    stats: dict = {}
    for sig, items in groups.items():
        outs = plan_rounds_batched([inp for _, inp, _, _, _ in items],
                                   metric=sig[4], allow_retraining=sig[5],
                                   stats=stats)
        for (key, _, state, gamma64, model_bits), out in zip(items, outs):
            if not out.converged:
                warnings.warn("sweep pre-planner: an auction hit its "
                              "iteration cap; the cached plan may be "
                              "truncated", RuntimeWarning, stacklevel=2)
            plan = decode_plan(out, gamma64, model_bits)
            state.update_from(out.state, rounds_advanced=out.num_rounds)
            cache.store(key, plan, state)
            planned += 1
    return {"planned": planned, "skipped": skipped, "batches": len(groups),
            "planner_stats": stats}


def _pick_executor(cell: SweepCell, engine: str) -> SweepCell:
    """The reference's crossover downgrade: with ``engine="auto"`` a
    sharded cell below :data:`SHARDED_CROSSOVER_N` clients runs on the
    fleet plane (larger ones stay sharded: ROADMAP A12)."""
    cfg = cell.spec.fl
    if engine == "auto" and cfg.engine is None and cfg.executor == "sharded":
        mode = resolve_engine(cfg).auto(cfg.num_clients).mode
        if mode != cfg.executor:
            print(f"orchestrator,{cell.label},executor={mode},"
                  f"reason=N={cfg.num_clients}<crossover="
                  f"{SHARDED_CROSSOVER_N}", flush=True)
            return cell.with_fl(executor=mode)
    return cell


def _pick_engine(cell: SweepCell, engine: str) -> str:
    """The replication engine of a cell: ``"loop"`` until A10c."""
    if engine == "seed_vmap":
        raise NotImplementedError(
            "the seed_vmap replication engine is ROADMAP item A10c; use "
            "engine='loop' or 'auto'")
    if engine not in REPLICATION_ENGINES:
        raise ValueError(f"unknown replication engine {engine!r}; expected "
                         f"one of {REPLICATION_ENGINES}")
    return "loop"


def run_cell(cell: SweepCell, seeds: Sequence[int],
             plan_cache: PlanCache | None = None,
             engine: str = "auto",
             checkpoint_root: str | None = None,
             device: str | torch.device | None = None,
             init_for: Callable | None = None) -> dict:
    """Run one sweep cell at every replicate seed on ``device``; returns
    the JSON record.  ``init_for`` maps each seed's ``ExperimentSpec`` to
    the ``init_fn`` of its run (a test seam; ``None`` keeps the task
    model's own init).  ``checkpoint_root`` is ROADMAP item A10b."""
    if not len(seeds):
        raise ValueError("run_cell needs at least one replicate seed")
    if checkpoint_root is not None:
        raise NotImplementedError(
            "durable cells (checkpoint_root) are ROADMAP item A10b "
            "(durability)")
    cell = _pick_executor(cell, engine)
    chosen = _pick_engine(cell, engine)
    cache_before = plan_cache.stats() if plan_cache is not None else None
    t0 = time.time()
    results = run_replicates_loop(cell.spec, seeds, plan_cache,
                                  device=device, init_for=init_for)
    wall = time.time() - t0

    # Per-cell plan-cache delta: how much of this cell's control plane was
    # replayed and how much planned.
    cache_stats = None
    if plan_cache is not None:
        after = plan_cache.stats()
        cache_stats = {"hits": after["hits"] - cache_before["hits"],
                       "misses": after["misses"] - cache_before["misses"],
                       "entries": after["entries"]}

    ledger = results[0].ledger            # seed-independent by construction
    curves = [r.accuracy for r in results]
    return {
        "label": cell.label,
        "axis": cell.axis,
        "value": cell.value,
        "strategy": cell.strategy,
        "engine": chosen,
        "executor": resolve_engine(cell.spec.fl).mode,
        "plan_cache": cache_stats,
        "seeds": [int(s) for s in seeds],
        "accuracy": curves,
        "loss": [r.loss for r in results],
        "summary": artifacts.summarize_curves(curves),
        "diffusion_rounds": list(results[0].diffusion_rounds),
        "iid_distance": [float(x) for x in results[0].iid_distance],
        "comm": {
            "subframes": int(ledger.subframes),
            "transmitted_models": int(ledger.transmitted_models),
            "transmitted_bits": float(ledger.transmitted_bits),
            "pusch_bandwidth_hz_s": float(ledger.bandwidth_hz_s),  # Eq. 15
            "uplink_models": int(ledger.uplink_models),
            "downlink_models": int(ledger.downlink_models),
            "energy_j": float(ledger.energy_j),
        },
        "wall_clock_s": wall,
    }


def run_sweep(name: str, smoke: bool = True, seeds: Sequence[int] = (0,),
              out_dir: str | None = "auto", engine: str = "auto",
              executor: str = "host", planner: str = "host",
              engine_preset: str | None = None,
              plan_cache: PlanCache | None = None,
              checkpoint_every: int = 0, resume: bool = False,
              state_dir: str | None = None,
              log=None, device: str | torch.device | None = None,
              init_for: Callable | None = None, **spec_overrides) -> dict:
    """Expand a registered sweep, run every cell, write the BENCH artifact.

    Args:
      name: registry key (``fig3_alpha`` … ``table2_strategies``).
      smoke: smoke-sized grid vs full grid.
      seeds: replicate seeds, run one after another; curves are reported
        per seed.
      out_dir: where ``BENCH_feddif_<name>.json`` is written; ``"auto"``
        resolves through :func:`~repro_torch.experiments.artifacts
        .default_out_dir` (``benchmarks/results/torch/``); ``None`` skips
        writing.
      engine: replication engine, one of :data:`REPLICATION_ENGINES`
        (``"seed_vmap"`` is A10c and raises).
      executor: ``FLConfig.executor`` stamped on every cell — ``"host"``
        or ``"fleet"`` (``"sharded"`` downgrades to ``"fleet"`` below
        :data:`SHARDED_CROSSOVER_N` clients and is A12 above).
      planner: ``FLConfig.planner`` stamped on every cell — ``"host"``
        numpy planner or ``"jax"``, the device planner.  With ``"jax"`` the
        sweep's diffusion plans are made up front
        (:func:`prepopulate_plan_cache`) and the cells replay them.
      engine_preset: an engine preset name stamped as ``FLConfig.engine``
        on every cell (the async presets are A11 and raise).
      plan_cache: share one across sweeps if desired; default is a fresh
        cache per sweep, shared across all cells and seeds.  Its default
        256 entries hold the full fig3/fig4 grids (5 FedDif cells × 20
        rounds per seed); a larger grid evicts its oldest plans, which its
        cells then plan again.
      checkpoint_every, resume, state_dir: durable sweeps, ROADMAP item
        A10b: any of them raises.
      log: a callable taking one progress line per pre-plan and per cell.
      device: where the cells and the pre-planner run (the CUDA device by
        default).
      init_for: forwarded to :func:`run_cell`.
      spec_overrides: forwarded to ``SweepDef.expand`` (e.g. a small
        ``num_samples`` in tests).

    Returns the artifact dict (also written to disk unless out_dir=None).
    """
    if checkpoint_every > 0 or resume or state_dir is not None:
        raise NotImplementedError(
            "durable sweeps (checkpoint_every, resume, state_dir) are "
            "ROADMAP item A10b (durability)")
    defn = get_sweep(name)
    cells = expand_sweep(name, smoke=smoke, executor=executor,
                         planner=planner, **spec_overrides)
    if engine_preset is not None:
        cells = [c.with_fl(engine=engine_preset) for c in cells]
    cells = [_pick_executor(c, engine) for c in cells]
    for cell in cells:
        # Refuse before running: a grid the port cannot finish runs nothing.
        _pick_engine(cell, engine)
        check_supported(cell.spec.fl)
    device = resolve_device(device)
    cache = plan_cache if plan_cache is not None else PlanCache()

    t0 = time.time()
    if planner == "jax":
        pre = prepopulate_plan_cache(cells, cache, device=device)
        if log is not None:
            log(f"{name},preplan,planned={pre['planned']},"
                f"batches={pre['batches']},sec={time.time() - t0:.1f}")

    records = []
    for cell in cells:
        rec = run_cell(cell, seeds, plan_cache=cache, engine=engine,
                       device=device, init_for=init_for)
        if log is not None:
            s = rec["summary"]
            log(f"{name},{rec['label']},engine={rec['engine']},"
                f"peak_acc={s['peak_mean']:.4f},"
                f"subframes={rec['comm']['subframes']},"
                f"bandwidth_hz_s={rec['comm']['pusch_bandwidth_hz_s']:.3e},"
                f"sec={rec['wall_clock_s']:.1f}")
        records.append(rec)

    artifact = artifacts.build_artifact(
        sweep_name=name, figure=defn.figure, axis=defn.axis, smoke=smoke,
        seeds=list(seeds), cells=records, executor=executor,
        planner=planner, plan_cache_stats=cache.stats(),
        wall_clock_s=time.time() - t0)
    if out_dir is not None:
        if out_dir == "auto":
            out_dir = artifacts.default_out_dir()
        artifact["path"] = artifacts.write_artifact(artifact, out_dir)
    return artifact
