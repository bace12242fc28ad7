"""Token samplers of the serving engine: greedy, temperature, top-k and
nucleus (top-p), as pure functions of ``(key, logits)``.

Counterpart of ``repro.serving.sampler``.  The key is the reference's
threefry key, a (2,) ``int64`` tensor of 32-bit words on the logits'
device, and every draw is ``jax.random.categorical``'s Gumbel-max in
float32 (:func:`repro_torch.core.threefry.categorical_t`), so a sampled
token equals the reference's for the same key and logits.  The eager
reference's float forms are kept where they decide a token: the
temperature divides by a float32 tensor (on the card a division by a
Python scalar multiplies by its reciprocal), and top-p's softmax takes
XLA-CPU's ``exp`` and its windowed sum, and its cumulative sum XLA's
chunked form (:func:`repro_torch.core.dol.xla_sum_t`,
:func:`repro_torch.core.dol.xla_cumsum_t`).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.dol import xla_cumsum_t, xla_sum_t
from repro_torch.core.threefry import categorical_t, xla_exp_t

__all__ = ["SamplerConfig", "sample"]


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 1.0      # 0 => greedy
    top_k: int = 0                # 0 => disabled
    top_p: float = 1.0            # 1 => disabled


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis, as the eager reference
    computes it: ``exp(x − max) / Σ exp(x − max)``."""
    e = xla_exp_t(x - x.max(dim=-1, keepdim=True).values)
    return e / xla_sum_t(e)[..., None]


def sample(key: torch.Tensor, logits: torch.Tensor,
           cfg: SamplerConfig) -> torch.Tensor:
    """logits: (B, V) -> token ids (B,) int32, on the logits' device."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.to(torch.float32) / logits.new_tensor(
        cfg.temperature, dtype=torch.float32)
    neg_inf = logits.new_tensor(-torch.inf)
    if cfg.top_k > 0:
        # The reference's index −top_k is clamped to the row, so a top_k
        # past V keeps every logit.
        k = min(cfg.top_k, logits.shape[-1])
        kth = torch.topk(logits, k, dim=-1).values[:, -1:]
        logits = torch.where(logits >= kth, logits, neg_inf)
    if cfg.top_p < 1.0:
        sorted_l = torch.sort(logits, dim=-1, descending=True).values
        cum = xla_cumsum_t(_softmax(sorted_l))
        # the smallest prefix with cumulative mass >= top_p
        cut = torch.sum(cum < cfg.top_p, dim=-1, keepdim=True)
        v = sorted_l.shape[-1]
        cutoff = torch.gather(sorted_l, -1, torch.clamp(cut, max=v - 1))
        # Past the last entry the reference's gather fills NaN, which
        # masks every logit.
        cutoff = torch.where(cut >= v, torch.nan, cutoff)
        logits = torch.where(logits >= cutoff, logits, neg_inf)
    return categorical_t(key, logits).to(torch.int32)
