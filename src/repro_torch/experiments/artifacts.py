"""Sweep artifacts: ``BENCH_feddif_<sweep>.json`` and the other BENCH files.

Counterpart of ``repro.experiments.artifacts``, with the same schema
version, keys and file names, so tooling reads both packages' artifacts
alike.  One artifact per sweep run holds per-cell accuracy and loss curves
(per seed), the communication ledger (sub-frames, transmitted models and
bits, the Eq.-15 cumulative PUSCH bandwidth in Hz·s), wall-clock and
plan-cache statistics.

The port writes under its own directory, :func:`default_out_dir`:
``benchmarks/results/torch/``, or ``$REPRO_BENCH_DIR/torch/`` when that
variable is set.  The reference writes the same file names one level up,
so a run of the port never overwrites a run of the reference.
"""
from __future__ import annotations

import os
import time
from typing import Any

import numpy as np

from repro_torch.train.checkpoint import atomic_write_json

__all__ = ["SCHEMA_VERSION", "DEFAULT_OUT_DIR", "default_out_dir",
           "bench_file", "bench_path", "build_artifact", "write_artifact",
           "write_bench_json", "summarize_curves", "strip_volatile",
           "atomic_write_json"]

SCHEMA_VERSION = 1

# Resolved relative to the process CWD (the repo root for every entry point).
DEFAULT_OUT_DIR = os.path.join("benchmarks", "results", "torch")


def default_out_dir() -> str:
    """The port's BENCH artifact directory: ``$REPRO_BENCH_DIR/torch`` when
    the variable is set, else ``benchmarks/results/torch/``."""
    base = os.environ.get("REPRO_BENCH_DIR")
    return DEFAULT_OUT_DIR if base is None else os.path.join(base, "torch")


def bench_file(name: str, out_dir: str | None = None) -> str:
    """Path of ``BENCH_<name>.json`` under the (default) artifact dir."""
    return os.path.join(default_out_dir() if out_dir is None else out_dir,
                        f"BENCH_{name}.json")


def bench_path(sweep: str, out_dir: str | None = None) -> str:
    """Path of a sweep artifact, ``BENCH_feddif_<sweep>.json``."""
    return bench_file(f"feddif_{sweep}", out_dir)


def write_bench_json(name: str, record: dict,
                     out_dir: str | None = None) -> str:
    """Write a non-sweep bench record to ``BENCH_<name>.json`` atomically;
    returns the path."""
    path = bench_file(name, out_dir)
    atomic_write_json(path, record, indent=2, default=_json_default)
    return path


def summarize_curves(curves: list[list[float]]) -> dict:
    """Per-seed curves -> mean/std of the peak and of the final value."""
    peaks = [max(c) for c in curves if c]
    finals = [c[-1] for c in curves if c]
    return {
        "peak_mean": float(np.mean(peaks)) if peaks else None,
        "peak_std": float(np.std(peaks)) if peaks else None,
        "final_mean": float(np.mean(finals)) if finals else None,
        "final_std": float(np.std(finals)) if finals else None,
        "per_seed_peak": [float(p) for p in peaks],
    }


def build_artifact(sweep_name: str, figure: str, axis: str, smoke: bool,
                   seeds: list[int], cells: list[dict],
                   executor: str = "host", planner: str = "host",
                   plan_cache_stats: dict | None = None,
                   wall_clock_s: float | None = None,
                   failed_cells: list[dict] | None = None) -> dict:
    """Assemble one ``BENCH_feddif_<sweep>.json`` payload.

    ``plan_cache_stats`` is the sweep's
    :meth:`~repro_torch.core.diffusion.PlanCache.stats`; each cell record
    carries its own hit / miss delta under ``cells[i]["plan_cache"]``.
    ``failed_cells`` is always present (``[]`` when none failed), so
    tooling can gate on it without probing for the key."""
    return {
        "schema_version": SCHEMA_VERSION,
        "sweep": sweep_name,
        "figure": figure,
        "axis": axis,
        "mode": "smoke" if smoke else "full",
        "executor": executor,
        "planner": planner,
        "seeds": [int(s) for s in seeds],
        "created_unix": time.time(),
        "wall_clock_s": wall_clock_s,
        "plan_cache": plan_cache_stats or {},
        "failed_cells": list(failed_cells or []),
        "cells": cells,
    }


def write_artifact(artifact: dict, out_dir: str | None = None) -> str:
    """Write ``BENCH_feddif_<sweep>.json`` atomically; returns the path."""
    path = bench_path(artifact["sweep"], out_dir)
    atomic_write_json(path, artifact, indent=2, sort_keys=False,
                      default=_json_default)
    return path


# Keys that differ between two runs of the same sweep (timing, cache-warmth
# counters, filesystem locations): strip_volatile drops them so two
# artifacts can be compared bit for bit.
_VOLATILE_TOP = ("created_unix", "wall_clock_s", "plan_cache", "path",
                 "manifest")
_VOLATILE_CELL = ("wall_clock_s", "plan_cache")


def strip_volatile(artifact: dict) -> dict:
    """Copy of a sweep artifact with run-dependent fields removed."""
    out = {k: v for k, v in artifact.items() if k not in _VOLATILE_TOP}
    out["cells"] = [{k: v for k, v in cell.items()
                     if k not in _VOLATILE_CELL}
                    for cell in artifact.get("cells", [])]
    return out


def _json_default(obj: Any):
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    raise TypeError(f"not JSON serializable: {type(obj)}")
