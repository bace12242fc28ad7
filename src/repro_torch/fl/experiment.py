"""Experiment harness: dataset → partition → :func:`run_federated`.

Counterpart of ``repro.fl.experiment``: one call runs one cell of the
paper's figures and tables.  :func:`load_experiment_data` consumes the
``data_seed`` stream in the reference's order, so both packages see the
same datasets, partitions and batch order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from repro_torch.data.partitioner import dirichlet_partition
from repro_torch.data.pipeline import make_client_loaders
from repro_torch.data.synthetic import gaussian_image_dataset
from repro_torch.device import resolve_device
from repro_torch.fl.models import TASK_MODELS, build_task_model
from repro_torch.fl.server import FLConfig, RunResult, run_federated

__all__ = ["ExperimentSpec", "run_experiment", "load_experiment_data"]


@dataclasses.dataclass
class ExperimentSpec:
    task: str = "fcn"                  # one of repro_torch.fl.models.TASK_MODELS
    alpha: float = 1.0                 # Dirichlet concentration
    num_samples: int = 12_000
    num_classes: int = 10
    dim: int = 64                      # feature dim
    test_frac: float = 0.2
    fl: FLConfig = dataclasses.field(default_factory=FLConfig)
    data_seed: int = 0

    def __post_init__(self):
        if self.task == "lm":
            raise NotImplementedError("task 'lm' is ROADMAP item A9")
        if self.task not in TASK_MODELS:
            raise ValueError(f"unknown task {self.task!r}; expected one of "
                             f"{TASK_MODELS}")
        if self.task == "cnn":
            side = int(self.dim ** 0.5)
            if side * side != self.dim:
                raise ValueError(f"task='cnn' needs a square feature dim "
                                 f"(got dim={self.dim})")
        if self.task == "lstm" and self.dim % 8 != 0:
            raise ValueError(f"task='lstm' needs dim divisible by 8 "
                             f"(got dim={self.dim})")


def load_experiment_data(spec: ExperimentSpec):
    """Dataset → split → Dirichlet partition → loaders for one cell.
    Returns ``(train, test, part, loaders)``."""
    rng = np.random.default_rng(spec.data_seed)
    ds = gaussian_image_dataset(spec.num_samples, spec.num_classes,
                                spec.dim, seed=spec.data_seed)
    test, train = ds.split(spec.test_frac, rng)
    part = dirichlet_partition(train.y, spec.fl.num_clients, spec.alpha, rng)
    loaders = make_client_loaders(train, part, spec.fl.batch_size,
                                  seed=spec.data_seed)
    return train, test, part, loaders


def run_experiment(spec: ExperimentSpec,
                   device: str | torch.device | None = None,
                   init_fn: Callable | None = None) -> RunResult:
    """Run one cell on ``device`` (the CUDA device by default).

    ``init_fn`` replaces the task model's own init (it receives the
    ``torch.Generator`` seeded with ``spec.fl.seed``): the tests pass the
    reference's initial params through it."""
    dev = resolve_device(device)
    train, test, part, loaders = load_experiment_data(spec)
    model = build_task_model(spec.task, spec.dim, spec.num_classes)
    test_batch = {"x": torch.as_tensor(test.x, device=dev),
                  "y": torch.as_tensor(test.y, device=dev)}

    def client_epoch(i):
        return lambda: list(loaders[i].epoch())

    def eval_fn(params):
        with torch.no_grad():
            acc = model.accuracy(params, test_batch["x"], test_batch["y"])
            loss = model.loss(params, test_batch)
        return float(acc), float(loss)

    value_fn = None
    if spec.fl.uncertainty_weight > 0.0:
        # Learning-value probe: a fixed 32-sample draw from each client's
        # shard (np.resize wraps small shards); the value is the global
        # model's mean predictive entropy on it over log C, in [0, 1].
        probe = torch.as_tensor(np.stack([train.x[np.resize(idx, 32)]
                                          for idx in part.indices]),
                                device=dev)                  # (N, 32, dim)

        def value_fn(params):
            with torch.no_grad():
                lg = model.logits(params, probe.reshape(-1, probe.shape[-1]))
                logp = torch.log_softmax(lg, dim=-1)
                ent = -(logp.exp() * logp).sum(dim=-1)
                ent = ent.reshape(probe.shape[0], -1).mean(dim=1)
                return (ent / math.log(lg.shape[-1])).cpu().numpy()

    return run_federated(init_fn or model.init, model.loss,
                         [client_epoch(i) for i in range(spec.fl.num_clients)],
                         part.dsi, part.data_sizes, eval_fn, spec.fl,
                         device=dev, value_fn=value_fn)
