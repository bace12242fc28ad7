"""Checkpointing: a tree of tensors <-> ``.npz`` with path-joined keys, plus
a metadata JSON.

Counterpart of ``repro.train.checkpoint``, with its files: one
``ckpt_%08d.npz`` whose keys are the reference's ``/``-joined tree paths
(dict keys, then sequence indices; dicts by sorted key, as
:mod:`repro_torch.tree` and ``jax.tree`` flatten them) and one
``ckpt_%08d.json``.  Either package restores the other's checkpoints.

Durability contract (the sweep resume path rests on it):

* every file, the array payload and the metadata JSON, is written to a temp
  file in the same directory and ``os.replace``-d into place, so a kill at
  any instant leaves the old bytes or the new bytes, never a torn file;
* the metadata JSON is written after the ``.npz`` and is the commit
  marker: :func:`valid_steps` reports only steps whose pair is complete;
* :func:`restore_latest` walks the steps newest first and falls back, with
  a ``RuntimeWarning``, past a checkpoint that is truncated, corrupt or of
  another structure: a bad latest step costs one cadence of progress,
  never a silent wrong restore.

:func:`restore_checkpoint` restores onto a template tree of tensors,
checking each leaf's shape, and returns tensors on each template leaf's
device and dtype.
"""
from __future__ import annotations

import json
import os
import tempfile
import warnings
from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_flatten, tree_unflatten

__all__ = ["save_checkpoint", "restore_checkpoint", "restore_latest",
           "latest_step", "valid_steps", "load_metadata",
           "atomic_write_json"]

_SEP = "/"


def _paths(tree: Any) -> tuple[list[str], list, Any]:
    """``(keys, leaves, treedef)``: each leaf's ``/``-joined path in
    :func:`~repro_torch.tree.tree_flatten`'s leaf order."""
    leaves, treedef = tree_flatten(tree)
    keys: list[str] = []

    def walk(node, prefix):
        kind, names, children = node
        if kind == "leaf":
            keys.append(_SEP.join(prefix))
            return
        labels = names if kind == "dict" else range(len(children))
        for label, child in zip(labels, children):
            walk(child, prefix + [str(label)])

    walk(treedef, [])
    return keys, leaves, treedef


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def atomic_write_json(path: str, obj: Any, **dump_kwargs) -> str:
    """Serialize ``obj`` to JSON at ``path`` via a temp file and a rename:
    a reader, or a writer killed mid-write, sees the previous document or
    the complete new one, never a torn one.  Shared by checkpoints, sweep
    manifests and the BENCH artifacts."""
    directory = os.path.dirname(path) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".json.tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f, **dump_kwargs)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def _npz_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step:08d}.npz")


def _meta_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step:08d}.json")


def save_checkpoint(directory: str, step: int, tree: Any,
                    metadata: dict | None = None) -> str:
    """Write ``tree`` (tensors or arrays) as step ``step``; returns the
    ``.npz`` path."""
    os.makedirs(directory, exist_ok=True)
    keys, leaves, _ = _paths(tree)
    flat = {k: _to_numpy(x) for k, x in zip(keys, leaves)}
    path = _npz_path(directory, step)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".npz.tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    meta = dict(metadata or {})
    meta["step"] = step
    # Written last: the metadata JSON is the commit marker valid_steps keys
    # on, so a kill between the two writes leaves an ignorable orphan .npz.
    atomic_write_json(_meta_path(directory, step), meta)
    return path


def restore_checkpoint(directory: str, step: int, like: Any) -> Any:
    """Step ``step``'s arrays in the structure of ``like``, a tree of
    tensors: each leaf checked for its shape and returned on that template
    leaf's device and dtype."""
    keys, leaves, treedef = _paths(like)
    out = []
    with np.load(_npz_path(directory, step)) as data:
        for key, leaf in zip(keys, leaves):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: shape {tuple(arr.shape)} != "
                                 f"{tuple(leaf.shape)}")
            out.append(torch.as_tensor(arr).to(
                device=leaf.device, dtype=leaf.dtype))
    return tree_unflatten(treedef, out)


def load_metadata(directory: str, step: int) -> dict:
    """The metadata JSON written beside step ``step``'s arrays."""
    with open(_meta_path(directory, step)) as f:
        return json.load(f)


def _npz_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return [int(f[5:13]) for f in os.listdir(directory)
            if f.startswith("ckpt_") and f.endswith(".npz")]


def latest_step(directory: str) -> int | None:
    steps = _npz_steps(directory)
    return max(steps) if steps else None


def valid_steps(directory: str) -> list[int]:
    """Steps with a complete (npz, metadata) pair, ascending.  A checkpoint
    whose metadata JSON is missing was cut before its commit marker landed;
    it is invisible here and to :func:`restore_latest`."""
    return sorted(s for s in _npz_steps(directory)
                  if os.path.exists(_meta_path(directory, s)))


def restore_latest(directory: str, like: Any
                   ) -> tuple[int, Any, dict] | None:
    """Restore the newest readable checkpoint: ``(step, tree, metadata)``.

    Walks :func:`valid_steps` newest first.  A step that fails to load (a
    truncated or corrupt ``.npz``, unparseable metadata, a missing leaf, a
    shape mismatch) is skipped with a ``RuntimeWarning`` naming the file
    and the error, and the step before it is tried.  Returns ``None`` when
    no checkpoint, or no readable one, exists."""
    for step in reversed(valid_steps(directory)):
        try:
            meta = load_metadata(directory, step)
            tree = restore_checkpoint(directory, step, like)
            return step, tree, meta
        except Exception as e:                      # noqa: BLE001 — any
            # unreadable checkpoint falls through to the one before, loudly.
            warnings.warn(
                f"checkpoint step {step} in {directory!r} is unreadable "
                f"({type(e).__name__}: {e}); falling back to the previous "
                f"step", RuntimeWarning, stacklevel=2)
    return None
