"""Step functions of the LM zoo: the full-context forward and one-token
decode.

Counterpart of ``repro.train.trainstep``.  :func:`make_prefill_step` (the
prefill target: full-context forward, no gradient) and
:func:`make_eval_step` return plain functions ``(params, batch) -> loss``;
:func:`make_serve_step` returns ``(params, tokens, cache, pos) -> (logits,
cache)``, the cache updated in place.
On the card run them under ``torch.inference_mode()``: the zoo's kernels
are forward-only.  Training through the zoo — :func:`make_train_step`,
which needs backward kernels for attention and the two scans — is queued as
ROADMAP item A13c.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.zoo import Model

Params = Any

__all__ = ["make_prefill_step", "make_eval_step", "make_serve_step",
           "make_train_step"]


def make_eval_step(model: Model):
    def eval_step(params: Params, batch: dict) -> torch.Tensor:
        return model.loss(params, batch, remat=False)
    return eval_step


def make_prefill_step(model: Model):
    """Full-context forward to the loss; labels default to zeros."""
    def prefill_step(params: Params, batch: dict) -> torch.Tensor:
        b = dict(batch)
        if "labels" not in b:
            b["labels"] = torch.zeros_like(b["tokens"])
        return model.loss(params, b, remat=False)
    return prefill_step


def make_serve_step(model: Model):
    """One-token decode: (params, tokens (B,1), cache, pos) -> (logits,
    cache)."""
    def serve_step(params: Params, tokens, cache, pos):
        return model.decode_step(params, tokens, cache, pos)
    return serve_step


def make_train_step(model: Model, *args, **kwargs):
    raise NotImplementedError(
        "training through the zoo (backward kernels for flash_attention, "
        "ssm_scan and ssd_scan; make_train_step) is queued as ROADMAP item "
        "A13c")
