"""Experiment harness: dataset → partition → :func:`run_federated`.

Counterpart of ``repro.fl.experiment``: one call runs one cell of the
paper's figures and tables.  :func:`load_experiment_data` consumes the
``data_seed`` stream in the reference's order, so both packages see the
same datasets, partitions and batch order.  The executor trains and hops
the task's :class:`~repro_torch.fl.adapters.AdapterView`: the LoRA adapter
of the ``lm`` task, the full params of every other task.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from repro_torch.data.partitioner import dirichlet_partition
from repro_torch.data.pipeline import make_client_loaders
from repro_torch.core.aggregation import model_bits
from repro_torch.core.diffusion import PlanCache
from repro_torch.data.synthetic import (ImageDataset, class_labels_for_lm,
                                        gaussian_image_dataset, lm_corpus)
from repro_torch.device import resolve_device
from repro_torch.fl.adapters import make_adapter_view, packed_bits
from repro_torch.fl.models import LM_VOCAB, TASK_MODELS, build_task_model
from repro_torch.fl.server import FLConfig, RunResult, run_federated

__all__ = ["ExperimentSpec", "run_experiment", "load_experiment_data",
           "spec_model_bits", "spec_adapter_bits"]


@dataclasses.dataclass
class ExperimentSpec:
    task: str = "fcn"                  # one of repro_torch.fl.models.TASK_MODELS
    alpha: float = 1.0                 # Dirichlet concentration
    num_samples: int = 12_000
    num_classes: int = 10
    dim: int = 64                      # feature dim; seq_len for task="lm"
    test_frac: float = 0.2
    fl: FLConfig = dataclasses.field(default_factory=FLConfig)
    data_seed: int = 0
    adapter_hops: bool = True          # hop the trainable-adapter view when
                                       # the task has one (TaskModel.split);
                                       # full-params tasks are untouched

    def __post_init__(self):
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


def load_experiment_data(spec: ExperimentSpec, with_loaders: bool = True):
    """Dataset → split → Dirichlet partition → loaders for one cell.
    Returns ``(train, test, part, loaders)``.  ``with_loaders=False``
    skips the loaders (``None``; they draw from their own seed, so the
    partition is the same): the sweep pre-planner needs only ``part``."""
    rng = np.random.default_rng(spec.data_seed)
    if spec.task == "lm":
        # Token rows: spec.dim is the sequence length, one sample is one
        # document; labels are the dominant-token buckets that drive the
        # Dirichlet partition (non-IID unigram shards per client).
        tokens = lm_corpus(spec.num_samples * spec.dim, vocab=LM_VOCAB,
                           seed=spec.data_seed)
        y = class_labels_for_lm(tokens, spec.num_classes, spec.dim)
        x = tokens[:len(y) * spec.dim].reshape(len(y), spec.dim)
        ds = ImageDataset(x.astype(np.int32), y, spec.num_classes)
    else:
        ds = gaussian_image_dataset(spec.num_samples, spec.num_classes,
                                    spec.dim, seed=spec.data_seed)
    test, train = ds.split(spec.test_frac, rng)
    part = dirichlet_partition(train.y, spec.fl.num_clients, spec.alpha, rng)
    loaders = (make_client_loaders(train, part, spec.fl.batch_size,
                                   seed=spec.data_seed)
               if with_loaders else None)
    return train, test, part, loaders


def _model_and_params(spec: ExperimentSpec):
    """The task model and a CPU init of its params, read for their shapes
    only."""
    model = build_task_model(spec.task, spec.dim, spec.num_classes)
    return model, model.init(torch.Generator())


def spec_model_bits(spec: ExperimentSpec) -> float:
    """S (Eq. 15) of a cell's whole task model."""
    return model_bits(_model_and_params(spec)[1], spec.fl.bits_per_param)


def spec_adapter_bits(spec: ExperimentSpec) -> float:
    """S (Eq. 15) of one D2D hop for a cell: the trainable-adapter view
    when the task has one and ``spec.adapter_hops`` is set, int8-packed
    (8 bits per element + one fp32 scale per row-block) when
    ``spec.fl.hop_quant == "int8"``.  Full-params fp32 cells return exactly
    :func:`spec_model_bits`."""
    model, params = _model_and_params(spec)
    if spec.adapter_hops and model.split is not None:
        _, params = model.split(params)
    if spec.fl.hop_quant == "int8":
        return packed_bits(params)
    return model_bits(params, spec.fl.bits_per_param)


def run_experiment(spec: ExperimentSpec, plan_cache: PlanCache | None = None,
                   device: str | torch.device | None = None,
                   init_fn: Callable | None = None) -> RunResult:
    """Run one cell on ``device`` (the CUDA device by default).

    ``plan_cache`` is forwarded to :func:`run_federated`: with
    ``spec.fl.topology_seed`` set, replicate seeds of one cell replay its
    FedDif plans instead of planning again.  ``spec.fl`` picks the data
    plane (``executor``/``engine``: the host plane by default, as in the
    reference); schedules and ledgers are the same either way.
    ``init_fn`` replaces the task model's own init of the full params (it
    receives the ``torch.Generator`` seeded with ``spec.fl.seed``): the
    tests pass the reference's initial params through it."""
    dev = resolve_device(device)
    train, test, part, loaders = load_experiment_data(spec)
    model = build_task_model(spec.task, spec.dim, spec.num_classes)
    view = make_adapter_view(model, spec.fl, spec.adapter_hops,
                             init_fn=init_fn, device=dev)
    test_batch = {"x": torch.as_tensor(test.x, device=dev),
                  "y": torch.as_tensor(test.y, device=dev)}

    def client_epoch(i):
        return lambda: list(loaders[i].epoch())

    def eval_fn(params):
        with torch.no_grad():
            full = view.merge_fn(params)
            acc = model.accuracy(full, test_batch["x"], test_batch["y"])
            loss = model.loss(full, test_batch)
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
                lg = model.logits(view.merge_fn(params),
                                  probe.reshape(-1, probe.shape[-1]))
                logp = torch.log_softmax(lg, dim=-1)
                ent = -(logp.exp() * logp).sum(dim=-1)
                ent = ent.reshape(probe.shape[0], -1).mean(dim=1)
                return (ent / math.log(lg.shape[-1])).cpu().numpy()

    return run_federated(view.init_fn, view.loss_fn,
                         [client_epoch(i) for i in range(spec.fl.num_clients)],
                         part.dsi, part.data_sizes, eval_fn, spec.fl,
                         device=dev, value_fn=value_fn,
                         base_bits=view.base_bits, plan_cache=plan_cache)
