"""Uniform model API over the LM zoo's families.

Counterpart of ``repro.models.zoo``.  ``build_model(cfg)`` returns a
:class:`Model` whose members are plain functions: ``init(generator)`` draws
params on the generator's device, ``loss(params, batch)`` is the
full-context (train / prefill) forward, ``init_cache(params, batch,
max_seq)`` allocates the decode cache on the params' device and
``decode_step(params, tokens, cache, pos)`` decodes one token, updating the
cache in place.  Every family of the reference's zoo is ported: the dense
(``attn`` layers; gemma3's local/global bodies of ``swa`` and ``attn``
layers), MoE (``attn`` or ``swa`` layers with the MoE MLP: mixtral,
qwen3-moe, moonshot), ssm (``mamba1``), hybrid (``mamba2`` + ``shared``)
and vision (pixtral: ``patch_embeddings`` (B, P, D) in the batch ahead of
the text; decode takes text alone) families through
:mod:`repro_torch.models.transformer`, and the audio family (whisper: the
encoder–decoder of :mod:`repro_torch.models.encdec`, ``frames`` (B, T, D)
in the batch) whose ``init_cache`` takes the reference's ``(params,
frames, batch, max_seq)``: it runs the encoder once over the frames.

Params and caches keep the reference's tree layouts, so
:func:`params_from_numpy` and :func:`cache_from_numpy` carry the
reference's trees (as numpy arrays) across leaf for leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec as ed
from repro_torch.models import transformer as tf
from repro_torch.tree import cache_from_numpy, params_from_numpy, tree_leaves

Params = Any

__all__ = ["Model", "build_model", "params_from_numpy", "cache_from_numpy"]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[[torch.Generator], Params]
    loss: Callable[..., torch.Tensor]           # (params, batch) -> scalar
    init_cache: Callable[..., Params]   # (params, [frames,] batch, max_seq)
    decode_step: Callable[..., Any]             # -> (logits, cache)


def _device_of(params: Params) -> torch.device:
    return tree_leaves(params)[0].device


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family == "audio":
        return Model(
            cfg=cfg,
            init=lambda gen: ed.init_encdec(gen, cfg),
            loss=lambda params, batch, **kw: ed.encdec_loss(params, cfg,
                                                            batch, **kw),
            init_cache=lambda params, frames, batch, max_seq: (
                ed.init_encdec_cache(params, cfg, frames, batch, max_seq)),
            decode_step=lambda params, tokens, cache, pos: (
                ed.encdec_decode_step(params, cfg, tokens, cache, pos)))
    return Model(
        cfg=cfg,
        init=lambda gen: tf.init_lm(gen, cfg),
        loss=lambda params, batch, **kw: tf.lm_loss(params, cfg, batch, **kw),
        init_cache=lambda params, batch, max_seq: tf.init_cache(
            cfg, batch, max_seq, device=_device_of(params)),
        decode_step=lambda params, tokens, cache, pos: tf.decode_step(
            params, cfg, tokens, cache, pos))
