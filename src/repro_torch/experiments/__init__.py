"""Paper-figure sweeps on the port: the registry, the orchestrator, the
replication loop and the BENCH artifacts (counterpart of
``repro.experiments``; durable sweeps are ROADMAP A10b, the seed-vmapped
engine A10c).

CLI: ``PYTHONPATH=src python -m repro_torch.launch.sweep --sweep fig3_alpha``.
"""
from repro_torch.experiments.artifacts import (bench_file, bench_path,
                                               build_artifact,
                                               default_out_dir,
                                               strip_volatile, write_artifact,
                                               write_bench_json)
from repro_torch.experiments.orchestrator import (prepopulate_plan_cache,
                                                  run_cell, run_sweep)
from repro_torch.experiments.registry import (REGISTRY, SweepCell, SweepDef,
                                              expand_sweep, get_sweep,
                                              register, sweep_names)
from repro_torch.experiments.replicate import (SEED_VMAP_STRATEGIES,
                                               run_replicates_loop,
                                               run_replicates_vmapped)

__all__ = [
    "REGISTRY", "SweepCell", "SweepDef", "expand_sweep", "get_sweep",
    "register", "sweep_names",
    "run_cell", "run_sweep", "prepopulate_plan_cache",
    "SEED_VMAP_STRATEGIES", "run_replicates_loop", "run_replicates_vmapped",
    "bench_file", "bench_path", "build_artifact", "default_out_dir",
    "strip_volatile", "write_artifact", "write_bench_json",
]
