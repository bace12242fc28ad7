"""Paper-figure sweep CLI of the port — a figure or table in one command.

    PYTHONPATH=src python -m repro_torch.launch.sweep --sweep fig3_alpha \\
        --executor fleet --planner jax
    PYTHONPATH=src python -m repro_torch.launch.sweep --sweep fig3_alpha --device cpu
    PYTHONPATH=src python -m repro_torch.launch.sweep --list

Durable mode (kill-safe, bit-identical resume)::

    python -m repro_torch.launch.sweep --sweep fig3_alpha --checkpoint-every 1
    # ... SIGTERM / crash / power loss ...
    python -m repro_torch.launch.sweep --sweep fig3_alpha --resume

Counterpart of ``repro.launch.sweep``, with its flags and exit codes (0 on
success, 2 for an unknown sweep or ``--seeds`` < 1), plus ``--device``:
the CUDA device by default, ``cpu`` on request, never a fallback.  It
expands the named registry entry (:mod:`repro_torch.experiments.registry`),
runs every cell at every replicate seed with the diffusion plans cached
across seeds, and writes ``BENCH_feddif_<sweep>.json`` to the port's
artifact directory (``benchmarks/results/torch/``, or
``$REPRO_BENCH_DIR/torch/``) unless ``--out-dir`` says otherwise.
The durable state (manifest, round checkpoints, cell records, plan cache)
lives under ``--state-dir``, by default the artifact directory's
``sweeps/<sweep>``; with ``--sweep all`` each sweep takes a subdirectory
of ``--state-dir`` named after it.  ``--engine seed_vmap`` trains a
FedAvg or FedDif cell's replicate seeds as one seed-stacked pass; the
default ``auto`` does so for such cells at two seeds or more.
``--engine async`` / ``async_barrier`` stamp a buffered-async preset on
every cell, and ``--sweep fig_async`` runs both.  ``--executor sharded``
at N ≥ 64 (A12) raises ``NotImplementedError`` naming its ROADMAP item
before any cell runs.
"""
from __future__ import annotations

import argparse
import os
import sys

from repro_torch.experiments import REGISTRY, run_sweep, sweep_names
from repro_torch.experiments.artifacts import default_out_dir
from repro_torch.experiments.orchestrator import REPLICATION_ENGINES
from repro_torch.fl.engine import ENGINE_PRESETS, UNPORTED_PRESETS

__all__ = ["main"]

# --engine takes the replication engines (how replicate seeds run) and the
# engine preset names (which plane every cell uses); "auto" belongs to both
# and keeps its replication meaning.
_ENGINE_CHOICES = list(REPLICATION_ENGINES) + sorted(
    (set(ENGINE_PRESETS) | set(UNPORTED_PRESETS)) - {"auto"})


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.sweep",
        description="Run a registered paper-figure sweep on the port and "
                    "write BENCH_feddif_<sweep>.json")
    ap.add_argument("--sweep", default=None,
                    help="registry name (see --list) or 'all'")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke-sized grid (default unless --full)")
    ap.add_argument("--full", action="store_true",
                    help="paper-approaching grid sizes")
    ap.add_argument("--seeds", type=int, default=1,
                    help="number of replicate seeds (0..N-1)")
    ap.add_argument("--engine", choices=_ENGINE_CHOICES, default="auto",
                    help="replication engine (auto/seed_vmap/loop) or an "
                         "engine preset stamped on every cell (async, "
                         "async_barrier: the buffered-async plane)")
    ap.add_argument("--executor", choices=["host", "fleet", "sharded"],
                    default="host",
                    help="data plane per cell: host reference loop or "
                         "client-stacked fleet (sharded: fleet below 64 "
                         "clients, ROADMAP A12 above)")
    ap.add_argument("--planner", choices=["host", "jax"], default="host",
                    help="control plane per cell: host numpy planner or "
                         "the device planner, which pre-plans the whole "
                         "sweep before the cells run")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the cells and the pre-planner "
                         "(default: cuda; 'cpu' runs the plain versions)")
    ap.add_argument("--out-dir", default=None,
                    help="artifact directory (default: "
                         "benchmarks/results/torch/, or "
                         "$REPRO_BENCH_DIR/torch/)")
    ap.add_argument("--checkpoint-every", type=int, default=0, metavar="R",
                    help="durable mode: checkpoint the full round state "
                         "every R communication rounds; a killed sweep "
                         "restarts bit-identically with --resume")
    ap.add_argument("--resume", action="store_true",
                    help="continue a durable run from its manifest (done "
                         "cells load their records, interrupted cells "
                         "restart from their latest round checkpoint, "
                         "failed cells are retried)")
    ap.add_argument("--state-dir", default=None,
                    help="durable-state directory (default: <artifact "
                         "dir>/sweeps/<sweep>; with --sweep all, a "
                         "per-sweep subdirectory of this path)")
    ap.add_argument("--num-samples", type=int, default=None,
                    help="override ExperimentSpec.num_samples per cell "
                         "(small values make smoke runs fast)")
    ap.add_argument("--list", action="store_true",
                    help="list registered sweeps and exit")
    args = ap.parse_args(argv)

    if args.list or not args.sweep:
        print(f"{'name':20s} {'paper':16s} axis        description")
        for name in sweep_names():
            d = REGISTRY[name]
            print(f"{name:20s} {d.figure:16s} {d.axis:11s} {d.description}")
        return 0

    smoke = not args.full
    if args.seeds < 1:
        print("error: --seeds must be >= 1", file=sys.stderr)
        return 2
    if args.sweep != "all" and args.sweep not in REGISTRY:
        print(f"error: unknown sweep {args.sweep!r}; registered: "
              f"{', '.join(sweep_names())} (or 'all')", file=sys.stderr)
        return 2
    names = sweep_names() if args.sweep == "all" else [args.sweep]
    seeds = tuple(range(args.seeds))
    out_dir = args.out_dir if args.out_dir is not None else default_out_dir()
    overrides = {}
    if args.num_samples is not None:
        overrides["num_samples"] = args.num_samples
    durable = (args.checkpoint_every > 0 or args.resume
               or args.state_dir is not None)
    for name in names:
        print(f"# === sweep {name} ({'smoke' if smoke else 'full'}, "
              f"seeds={list(seeds)}) ===", flush=True)
        state_dir = args.state_dir
        if state_dir is not None and args.sweep == "all":
            state_dir = os.path.join(state_dir, name)
        # Preset names select the plane of every cell; replicate seeds then
        # run on the "auto" replication engine.
        preset = (args.engine if args.engine not in REPLICATION_ENGINES
                  else None)
        repl_engine = args.engine if preset is None else "auto"
        artifact = run_sweep(name, smoke=smoke, seeds=seeds,
                             out_dir=out_dir, engine=repl_engine,
                             engine_preset=preset,
                             executor=args.executor, planner=args.planner,
                             checkpoint_every=args.checkpoint_every,
                             resume=args.resume,
                             state_dir=state_dir if durable else None,
                             log=lambda s: print(s, flush=True),
                             device=args.device, **overrides)
        pc = artifact["plan_cache"]
        failed = artifact["failed_cells"]
        print(f"# wrote {artifact['path']} "
              f"(cells={len(artifact['cells'])}, "
              f"failed={len(failed)}, "
              f"plan_cache hits={pc.get('hits', 0)} "
              f"misses={pc.get('misses', 0)}, "
              f"{artifact['wall_clock_s']:.1f}s)", flush=True)
        if "manifest" in artifact:
            print(f"# manifest {artifact['manifest']}", flush=True)
        for fc in failed:
            print(f"# FAILED cell {fc['label']}: {fc['error']}",
                  file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
