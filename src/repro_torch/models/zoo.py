"""Uniform model API over the LM zoo's families.

Counterpart of ``repro.models.zoo``.  ``build_model(cfg)`` returns a
:class:`Model` whose members are plain functions: ``init(generator)`` draws
params on the generator's device, ``loss(params, batch)`` is the
full-context (train / prefill) forward.  This slice ports the dense
(``attn`` layers), ssm (``mamba1``) and hybrid (``mamba2`` + ``shared``)
families; ``init_cache`` / ``decode_step`` (serving) raise naming ROADMAP
item A13b, and the MoE, sliding-window, local/global, vision and audio
families raise at :func:`build_model` naming A13d.

Params keep the reference's tree layout, so :func:`params_from_numpy` carries
the reference's params (as numpy arrays) across leaf for leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf
from repro_torch.tree import params_from_numpy

Params = Any

__all__ = ["Model", "build_model", "params_from_numpy"]


def _decode_not_ported(*args, **kwargs):
    raise NotImplementedError(
        "decode through the zoo (KV and SSM caches, decode_step, serving) "
        "is queued as ROADMAP item A13b")


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[[torch.Generator], Params]
    loss: Callable[..., torch.Tensor]           # (params, batch) -> scalar
    init_cache: Callable[..., Params] = _decode_not_ported
    decode_step: Callable[..., Any] = _decode_not_ported


def build_model(cfg: ModelConfig) -> Model:
    tf.check_supported(cfg)
    return Model(
        cfg=cfg,
        init=lambda gen: tf.init_lm(gen, cfg),
        loss=lambda params, batch, **kw: tf.lm_loss(params, cfg, batch, **kw))
