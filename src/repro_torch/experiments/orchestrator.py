"""Sweep orchestrator: registry entry -> grid -> replicated runs -> artifact.

Counterpart of ``repro.experiments.orchestrator``.  ``run_sweep`` is the
one-command reproduction of a paper figure::

    from repro_torch.experiments import run_sweep
    artifact = run_sweep("fig3_alpha", smoke=True, seeds=(0, 1, 2))

For every cell of the sweep's grid it stamps a shared ``topology_seed``
(so the wireless control plane does not depend on the replicate seed), runs
the cell at every seed (seed-stacked on the data plane where the cell
allows it, one run per seed otherwise), shares one
:class:`~repro_torch.core.diffusion.PlanCache` across the whole sweep (so
FedDif's auction loop runs once per distinct topology seed, round,
partition, ε and γ_min, and is replayed for every other replicate), and
folds the per-seed curves, the Eq.-15 ledger
and the wall-clock into one JSON record per cell.

Before it runs a cell, ``run_sweep`` checks every cell of the grid with
:func:`~repro_torch.fl.server.check_supported`, so a grid the port cannot
finish runs nothing.  The buffered-async cells (``fig_async``, the
``async`` / ``async_barrier`` presets) run on the loop engine, as in the
reference, and their records carry the async plane's per-seed curves
(``async``: virtual clock, arrivals and staleness per tick, parked hops
per round).  Cells of the other worlds, with churn or with the underlay
plan cell by cell inside their runs (:func:`prepopulate_plan_cache` skips
them).  A durable sweep (``checkpoint_every``, ``resume``,
``state_dir``) keeps a manifest, round checkpoints, cell records and the
plan cache under a state directory (:mod:`~repro_torch.experiments.
durability`), and a killed sweep resumes bit for bit.

Everything runs on ``device``, the CUDA device unless the caller passes
``"cpu"``: the cells and, with ``planner="jax"``, the pre-planner.  The
plan-cache key does not name the device, so a cache planned on one device
must not be replayed by runs on another.
"""
from __future__ import annotations

import os
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
from repro_torch.experiments import artifacts, durability
from repro_torch.experiments.registry import (SweepCell, expand_sweep,
                                              get_sweep)
from repro_torch.experiments.replicate import (SEED_VMAP_STRATEGIES,
                                               hops_full_model,
                                               run_replicates_loop,
                                               run_replicates_vmapped)
from repro_torch.fl.engine import SHARDED_CROSSOVER_N, resolve_engine
from repro_torch.fl.experiment import load_experiment_data, spec_model_bits
from repro_torch.fl.server import check_supported, static_round_draws

__all__ = ["run_cell", "run_sweep", "prepopulate_plan_cache",
           "SHARDED_CROSSOVER_N", "REPLICATION_ENGINES"]

_FEDDIF_STRATEGIES = ("feddif", "feddif_stc", "feddif_prox")

#: How replicate seeds run: seed-stacked (``"seed_vmap"``), one run per
#: seed (``"loop"``), or ``"auto"``, which picks per cell (_pick_engine).
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


def _pick_engine(cell: SweepCell, engine: str, num_seeds: int) -> str:
    """The replication engine of a cell at ``num_seeds`` replicate seeds,
    routed as the reference routes it, with two departures, both under
    ``"auto"`` (ROADMAP C):

    * a cell whose hop payload is not the full fp32 model (int8 hops, an
      adapter view: ``fig_lm``) runs on ``"loop"``, since the seed-stacked
      engine would charge and train it as the fp32 model;
    * a cell of one seed runs on ``"loop"``: with no seed axis to batch,
      the stacked engine's per-op vmap cost makes it the slower one
      (0.66–0.78× the loop's speed at fig3's full width on one H100 in
      two runs, PERF.md)."""
    if engine not in REPLICATION_ENGINES:
        raise ValueError(f"unknown replication engine {engine!r}; expected "
                         f"one of {REPLICATION_ENGINES}")
    cfg = cell.spec.fl
    if resolve_engine(cfg).mode in ("fleet", "sharded", "async"):
        # These planes batch the client axis or order ticks themselves; the
        # seed-stacked engine is its own host-side data plane.
        return "loop"
    if (cfg.churn_rate > 0.0 or cfg.scenario != "static"
            or cfg.uncertainty_weight > 0.0):
        # Churn masks and evolving worlds live in run_federated, and
        # learning values make plans seed-dependent.
        return "loop"
    if engine == "auto":
        return ("seed_vmap" if cell.strategy in SEED_VMAP_STRATEGIES
                and hops_full_model(cell.spec) and num_seeds > 1
                else "loop")
    return engine


def run_cell(cell: SweepCell, seeds: Sequence[int],
             plan_cache: PlanCache | None = None,
             engine: str = "auto",
             checkpoint_root: str | None = None,
             device: str | torch.device | None = None,
             init_for: Callable | None = None) -> dict:
    """Run one sweep cell at every replicate seed on ``device``; returns
    the JSON record.

    ``engine``: ``"auto"`` (the seed-stacked engine where
    :func:`_pick_engine` allows it, else the loop), ``"seed_vmap"`` or
    ``"loop"``.  ``checkpoint_root`` (durable sweeps) forces the loop
    engine, whose runs go through ``run_federated`` and its round
    checkpoints, and gives each seed a checkpoint directory under it.
    ``init_for`` maps each seed's ``ExperimentSpec`` to the ``init_fn`` of
    its run (a test seam; ``None`` keeps the task model's own init)."""
    if not len(seeds):
        raise ValueError("run_cell needs at least one replicate seed")
    cell = _pick_executor(cell, engine)
    chosen = _pick_engine(cell, engine, len(seeds))
    if checkpoint_root is not None:
        chosen = "loop"
    cache_before = plan_cache.stats() if plan_cache is not None else None
    t0 = time.time()
    if chosen == "seed_vmap":
        results = run_replicates_vmapped(cell.spec, seeds, plan_cache,
                                         device=device, init_for=init_for)
    else:
        results = run_replicates_loop(cell.spec, seeds, plan_cache,
                                      checkpoint_root=checkpoint_root,
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
    record = {
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
    if resolve_engine(cell.spec.fl).mode == "async":
        # The event queue's own curves, per seed: what the sweep measures.
        record["async"] = {k: [list(getattr(r.history, k)) for r in results]
                           for k in ("virtual_s", "arrivals", "staleness",
                                     "parked_hops")}
    return record


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
      seeds: replicate seeds; curves are reported per seed.
      out_dir: where ``BENCH_feddif_<name>.json`` is written; ``"auto"``
        resolves through :func:`~repro_torch.experiments.artifacts
        .default_out_dir` (``benchmarks/results/torch/``); ``None`` skips
        writing.
      engine: replication engine, one of :data:`REPLICATION_ENGINES`
        (see :func:`run_cell`).
      executor: ``FLConfig.executor`` stamped on every cell — ``"host"``
        or ``"fleet"`` (``"sharded"`` downgrades to ``"fleet"`` below
        :data:`SHARDED_CROSSOVER_N` clients and is A12 above).
      planner: ``FLConfig.planner`` stamped on every cell — ``"host"``
        numpy planner or ``"jax"``, the device planner.  With ``"jax"`` the
        sweep's diffusion plans are made up front
        (:func:`prepopulate_plan_cache`) and the cells replay them.
      engine_preset: an engine preset name stamped as ``FLConfig.engine``
        on every cell (``async`` and ``async_barrier`` run the
        buffered-async plane).
      plan_cache: share one across sweeps if desired; default is a fresh
        cache per sweep, shared across all cells and seeds.  Its default
        256 entries hold the full fig3/fig4 grids (5 FedDif cells × 20
        rounds per seed); a larger grid evicts its oldest plans, which its
        cells then plan again.
      checkpoint_every: round-checkpoint cadence R.  Any of
        ``checkpoint_every > 0``, ``resume`` or ``state_dir`` makes the
        sweep durable: a manifest, per-cell round checkpoints, finished
        cells' records and the plan cache live under ``state_dir``
        (default ``benchmarks/results/torch/sweeps/<name>``); a crashing
        cell is marked failed while the rest of the grid runs, and a
        killed sweep restarts with ``resume=True`` to the same artifact
        (after :func:`~repro_torch.experiments.artifacts.strip_volatile`).
      resume: continue a durable run from its manifest: done cells load
        their records, failed cells are retried, interrupted cells restart
        from their latest round checkpoint, and the stored plan cache is
        replayed instead of pre-planned again.
      state_dir: the durable-state directory.
      log: a callable taking one progress line per pre-plan and per cell.
      device: where the cells and the pre-planner run (the CUDA device by
        default).
      init_for: forwarded to :func:`run_cell`.
      spec_overrides: forwarded to ``SweepDef.expand`` (e.g. a small
        ``num_samples`` in tests).

    Returns the artifact dict (also written to disk unless out_dir=None).
    """
    defn = get_sweep(name)
    cells = expand_sweep(name, smoke=smoke, executor=executor,
                         planner=planner, **spec_overrides)
    if engine_preset is not None:
        cells = [c.with_fl(engine=engine_preset) for c in cells]
    cells = [_pick_executor(c, engine) for c in cells]
    for cell in cells:
        # Refuse before running: a grid the port cannot finish runs nothing.
        _pick_engine(cell, engine, len(seeds))
        check_supported(cell.spec.fl)
    device = resolve_device(device)
    cache = plan_cache if plan_cache is not None else PlanCache()
    durable = checkpoint_every > 0 or resume or state_dir is not None

    manifest = None
    if durable:
        state_dir = state_dir or durability.default_state_dir(name)
        os.makedirs(state_dir, exist_ok=True)
        config = {"sweep": name, "smoke": smoke,
                  "seeds": [int(s) for s in seeds], "executor": executor,
                  "planner": planner, "engine": engine,
                  "engine_preset": engine_preset,
                  # Plans and round checkpoints are replayed only on the
                  # device type that made them.
                  "device": device.type,
                  "checkpoint_every": int(checkpoint_every),
                  "spec_overrides": spec_overrides}
        manifest = durability.SweepManifest.open(
            state_dir, name, config, [c.label for c in cells], resume)
        if checkpoint_every <= 0:
            # A resume without a cadence adopts the stored one.
            checkpoint_every = int(
                manifest.data["config"].get("checkpoint_every") or 0) or 1
        if resume and durability.load_plan_cache_file(state_dir, cache):
            if log is not None:
                log(f"{name},plan_cache,restored="
                    f"{cache.stats()['entries']}")

    t0 = time.time()
    if planner == "jax":
        pre = prepopulate_plan_cache(cells, cache, device=device)
        if log is not None:
            log(f"{name},preplan,planned={pre['planned']},"
                f"batches={pre['batches']},sec={time.time() - t0:.1f}")
        if manifest is not None:
            durability.save_plan_cache_file(state_dir, cache)

    records = []
    for cell in cells:
        if manifest is None:
            rec = run_cell(cell, seeds, plan_cache=cache, engine=engine,
                           device=device, init_for=init_for)
        elif manifest.status(cell.label) == "done":
            records.append(manifest.load_record(cell.label))
            if log is not None:
                log(f"{name},{cell.label},resumed=done")
            continue
        else:
            manifest.mark(cell.label, "running")
            cell = cell.with_fl(checkpoint_every=int(checkpoint_every))
            try:
                rec = run_cell(
                    cell, seeds, plan_cache=cache, engine=engine,
                    checkpoint_root=manifest.cell_checkpoint_root(
                        cell.label),
                    device=device, init_for=init_for)
            except Exception as e:          # noqa: BLE001 — cell isolation
                # One broken cell must not sink the grid.  Preempted and
                # KeyboardInterrupt (BaseException) still end the sweep.
                manifest.mark(cell.label, "failed",
                              error=f"{type(e).__name__}: {e}")
                if log is not None:
                    log(f"{name},{cell.label},FAILED={type(e).__name__}")
                continue
            manifest.store_record(cell.label, rec)
            manifest.mark(cell.label, "done")
            durability.save_plan_cache_file(state_dir, cache)
            rec = manifest.load_record(cell.label)  # canonical JSON types
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
        wall_clock_s=time.time() - t0,
        failed_cells=manifest.failed_cells() if manifest is not None
        else None)
    if manifest is not None:
        artifact["manifest"] = manifest.path
    if out_dir is not None:
        if out_dir == "auto":
            out_dir = artifacts.default_out_dir()
        artifact["path"] = artifacts.write_artifact(artifact, out_dir)
    return artifact
