"""The paper's evaluation models (Sec. VI-A): FCN, CNN, LSTM, SVM, logistic.

Counterpart of ``repro.fl.models``.  Each model is a pure function of a
params tree with the reference's nesting, leaf names and layouts — dense
``w`` as (in, out), CNN kernels as HWIO — so the fleet executor can
``torch.func.vmap`` it over a client-stacked tree and the tests can feed it
the reference's own weights (:func:`params_from_numpy`).

``init(gen)`` draws from an explicit ``torch.Generator`` on the CPU: the
reference's distributions, not its bits.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.tree import tree_map

Params = Any

__all__ = ["TaskModel", "build_task_model", "TASK_MODELS",
           "params_from_numpy", "params_to_numpy"]

TASK_MODELS = ("logistic", "svm", "fcn", "lstm", "cnn")


@dataclasses.dataclass(frozen=True)
class TaskModel:
    name: str
    init: Callable[[torch.Generator], Params]
    logits: Callable[[Params, torch.Tensor], torch.Tensor]
    loss: Callable[[Params, dict], torch.Tensor]

    def predict(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return torch.argmax(self.logits(params, x), dim=-1)

    def accuracy(self, params: Params, x: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
        return (self.predict(params, x) == y).to(torch.float32).mean()


def params_from_numpy(tree: Params, device: str | torch.device = "cpu"
                      ) -> Params:
    """Reference params (nested dicts/lists of numpy arrays) → tensors."""
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), tree)


def params_to_numpy(tree: Params) -> Params:
    """Port params → nested dicts/lists of numpy arrays, leaf for leaf."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _xent(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y[:, None])[:, 0]
    return torch.mean(logz - gold)


def _hinge(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Multiclass (Crammer–Singer) hinge — the SVM task."""
    c = logits.shape[-1]
    gold = torch.gather(logits, -1, y[:, None])
    other = (torch.arange(c, device=logits.device) != y[:, None])
    margins = (logits - gold + 1.0) * other.to(logits.dtype)
    return torch.mean(torch.amax(margins, dim=-1))


def _dense_stack(gen: torch.Generator, dims) -> list:
    return [{"w": torch.randn((a, b), generator=gen) / math.sqrt(a),
             "b": torch.zeros((b,))}
            for a, b in zip(dims[:-1], dims[1:])]


def _mlp_apply(layers, x):
    for i, p in enumerate(layers):
        x = x @ p["w"] + p["b"]
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def build_task_model(name: str, dim: int = 64, num_classes: int = 10,
                     hidden: int = 128) -> TaskModel:
    if name in ("logistic", "svm"):
        def init(gen):
            return _dense_stack(gen, [dim, num_classes])

        def loss(p, b):
            if name == "logistic":
                return _xent(_mlp_apply(p, b["x"]), b["y"])
            return (_hinge(_mlp_apply(p, b["x"]), b["y"])
                    + 1e-4 * sum(torch.sum(q["w"] ** 2) for q in p))
        return TaskModel(name, init, _mlp_apply, loss)

    if name == "fcn":
        def init(gen):
            return _dense_stack(gen, [dim, hidden, hidden, num_classes])
        return TaskModel(name, init, _mlp_apply,
                         lambda p, b: _xent(_mlp_apply(p, b["x"]), b["y"]))

    if name == "cnn":
        side = int(dim ** 0.5)
        if side * side != dim:
            raise ValueError("cnn task needs a square feature dim")

        def init(gen):
            return {
                "c1": torch.randn((3, 3, 1, 16), generator=gen) * 0.2,
                "c2": torch.randn((3, 3, 16, 32), generator=gen) * 0.1,
                "head": _dense_stack(gen, [32 * (side // 4) ** 2, hidden,
                                           num_classes]),
            }

        def logits(p, x):
            b = x.shape[0]
            # NHWC with one channel has the memory layout of NCHW.
            h = x.reshape(b, 1, side, side)
            for k in ("c1", "c2"):
                # HWIO → OIHW; JAX's SAME padding of a 3x3 stride-1 conv
                # is one row/column on every side.
                h = F.conv2d(h, p[k].permute(3, 2, 0, 1), padding=1)
                h = F.max_pool2d(torch.relu(h), 2, 2)
            # Flatten in NHWC order, as the reference's head expects.
            return _mlp_apply(p["head"], h.permute(0, 2, 3, 1).reshape(b, -1))

        return TaskModel(name, init, logits,
                         lambda p, b: _xent(logits(p, b["x"]), b["y"]))

    if name == "lstm":
        steps = 8
        feat = dim // steps

        def init(gen):
            h = hidden
            return {
                "wx": torch.randn((feat, 4 * h), generator=gen)
                / math.sqrt(feat),
                "wh": torch.randn((h, 4 * h), generator=gen) / math.sqrt(h),
                "b": torch.zeros((4 * h,)),
                "head": _dense_stack(gen, [h, num_classes]),
            }

        def logits(p, x):
            b = x.shape[0]
            seq = x.reshape(b, steps, feat)
            h = x.new_zeros((b, hidden))
            c = x.new_zeros((b, hidden))
            for t in range(steps):
                z = seq[:, t] @ p["wx"] + h @ p["wh"] + p["b"]
                i, f, g, o = torch.split(z, hidden, dim=-1)
                c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
                h = torch.sigmoid(o) * torch.tanh(c)
            return _mlp_apply(p["head"], h)

        return TaskModel(name, init, logits,
                         lambda p, b: _xent(logits(p, b["x"]), b["y"]))

    if name == "lm":
        raise NotImplementedError("task 'lm' (the LoRA transformer and its "
                                  "adapter hop plane) is ROADMAP item A9")
    raise ValueError(f"unknown task model {name!r}")
