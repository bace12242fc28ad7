"""Sweep-level durability: the manifest, the cell records and the plan-cache
file.

Counterpart of ``repro.experiments.durability``, with its layout and file
formats.  A **durable sweep** (``run_sweep(..., checkpoint_every=R)``, or
``resume`` or ``state_dir``) keeps all its restartable state under one
state directory::

    <state_dir>/
      manifest.json            # the work queue (atomic temp + rename)
      plan_cache.json          # PlanCache.state_dict() snapshot
      records/<cell>.json      # finished cells' JSON records
      cells/<cell>/seed<s>/    # RoundCheckpointer round checkpoints

``manifest.json`` is the work queue: each cell goes ``pending → running →
done | failed``, every transition an atomic rewrite, so a SIGKILL at any
instant leaves a readable manifest.  A cell found ``running`` on resume
reruns from its round checkpoints, which is bit-identical to never having
stopped; ``failed`` cells are retried.  :class:`~repro_torch.fl.resume.
Preempted` and ``KeyboardInterrupt`` are ``BaseException``\\ s and escape
the orchestrator's per-cell isolation: a preemption kills the sweep.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import time

from repro_torch.core.diffusion import PlanCache
from repro_torch.train.checkpoint import atomic_write_json

__all__ = ["SweepManifest", "cell_slug", "default_state_dir",
           "save_plan_cache_file", "load_plan_cache_file"]

MANIFEST_VERSION = 1

# Config keys that may differ between the launch and a resume without
# invalidating stored progress: the cadence and the replication engine
# (durable sweeps run the loop engine anyway).
_RESUME_SAFE_KEYS = ("checkpoint_every", "engine")


def cell_slug(label: str) -> str:
    """Filesystem-safe name of a cell label (``alpha=0.1/feddif`` →
    ``alpha-0.1__feddif``)."""
    return re.sub(r"[^A-Za-z0-9._-]+", "__",
                  label.replace("/", "__").replace("=", "-"))


def default_state_dir(name: str) -> str:
    """Durable-state home of sweep ``name``, under the port's artifact
    directory (``benchmarks/results/torch/sweeps/<name>``)."""
    from repro_torch.experiments import artifacts
    return os.path.join(artifacts.default_out_dir(), "sweeps", name)


class SweepManifest:
    """The durable work queue of one sweep run."""

    def __init__(self, state_dir: str, data: dict):
        self.state_dir = state_dir
        self.data = data

    @classmethod
    def open(cls, state_dir: str, sweep: str, config: dict,
             labels: list[str], resume: bool) -> "SweepManifest":
        """Create a fresh manifest, or adopt the stored one on resume.  A
        fresh open refuses a state directory that already holds a
        manifest: overwriting durable progress is what this module
        prevents."""
        path = cls._path(state_dir)
        if os.path.exists(path):
            if not resume:
                raise FileExistsError(
                    f"{path} already exists — pass resume=True (CLI: "
                    f"--resume) to continue it, or use a fresh state_dir")
            m = cls.load(state_dir)
            m._check_config(config)
            # A label the stored manifest never saw starts pending.
            for lab in labels:
                m.data["cells"].setdefault(
                    lab, {"status": "pending", "error": None})
            m.data["order"] = list(labels)
            m.flush()
            return m
        if resume and not os.path.isdir(state_dir):
            raise FileNotFoundError(
                f"resume requested but no manifest at {path}")
        now = time.time()
        m = cls(state_dir, {
            "version": MANIFEST_VERSION,
            "sweep": sweep,
            "config": _jsonable(config),
            "created_unix": now,
            "updated_unix": now,
            "order": list(labels),
            "cells": {lab: {"status": "pending", "error": None}
                      for lab in labels},
        })
        m.flush()
        return m

    @classmethod
    def load(cls, state_dir: str) -> "SweepManifest":
        with open(cls._path(state_dir)) as f:
            return cls(state_dir, json.load(f))

    @staticmethod
    def _path(state_dir: str) -> str:
        return os.path.join(state_dir, "manifest.json")

    @property
    def path(self) -> str:
        return self._path(self.state_dir)

    def flush(self) -> None:
        self.data["updated_unix"] = time.time()
        atomic_write_json(self.path, self.data, indent=2)

    def _check_config(self, config: dict) -> None:
        saved = self.data.get("config", {})
        current = _jsonable(config)
        diffs = {k: (saved.get(k), current.get(k))
                 for k in set(saved) | set(current)
                 if k not in _RESUME_SAFE_KEYS
                 and saved.get(k) != current.get(k)}
        if diffs:
            raise ValueError(
                "refusing to resume: sweep was launched with a different "
                f"configuration — mismatched keys (saved, current): {diffs}")

    # ------------------------------------------------------------ work queue

    def status(self, label: str) -> str:
        return self.data["cells"][label]["status"]

    def mark(self, label: str, status: str, error: str | None = None) -> None:
        self.data["cells"][label].update(status=status, error=error)
        self.flush()

    def failed_cells(self) -> list[dict]:
        return [{"label": lab, "error": c.get("error")}
                for lab, c in self.data["cells"].items()
                if c["status"] == "failed"]

    # ---------------------------------------------------------- cell records

    def record_path(self, label: str) -> str:
        return os.path.join(self.state_dir, "records",
                            f"{cell_slug(label)}.json")

    def store_record(self, label: str, record: dict) -> None:
        from repro_torch.experiments.artifacts import _json_default
        atomic_write_json(self.record_path(label), record, indent=2,
                          default=_json_default)

    def load_record(self, label: str) -> dict:
        with open(self.record_path(label)) as f:
            return json.load(f)

    def cell_checkpoint_root(self, label: str) -> str:
        return os.path.join(self.state_dir, "cells", cell_slug(label))


# ------------------------------------------------------------- plan cache

def plan_cache_path(state_dir: str) -> str:
    return os.path.join(state_dir, "plan_cache.json")


def save_plan_cache_file(state_dir: str, cache: PlanCache) -> str:
    """Snapshot the sweep's plan cache (atomic): a resumed run replays the
    plans made instead of planning them again."""
    return atomic_write_json(plan_cache_path(state_dir), cache.state_dict())


def load_plan_cache_file(state_dir: str, cache: PlanCache) -> bool:
    """Merge a saved plan-cache snapshot into ``cache``; False if absent."""
    path = plan_cache_path(state_dir)
    if not os.path.exists(path):
        return False
    with open(path) as f:
        cache.load_state_dict(json.load(f))
    return True


def _jsonable(obj):
    """Round-trip through JSON so stored and loaded configs compare equal
    (tuples become lists, numpy scalars Python scalars)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        obj = dataclasses.asdict(obj)
    return json.loads(json.dumps(obj, default=str))
