"""Global aggregation (Eq. 11), weight divergence (Prop. 1) and model size.

Counterpart of ``repro.core.aggregation``.  :func:`fedavg` is the host
plane's Eq.-11 average over a list of param trees (and the MixOp group
average); the fleet plane aggregates the client-stacked tree through
``kernels.ops.mix_aggregate_tree`` instead.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map

__all__ = ["fedavg", "weight_distance", "divergence_bound", "model_bits"]


def fedavg(params_list: Sequence, weights: Sequence[float]):
    """Eq. (11): data-size-weighted average of param trees.

    In the reference's order: the weights are normalized in float64 and cast
    to fp32, then every leaf is accumulated in fp32 in list order
    (``acc = x₀·w₀``, then ``acc = acc + xᵢ·wᵢ``, each product and sum
    rounded), and cast back to the leaf's dtype."""
    w = np.asarray(weights, np.float64)
    total = w.sum()
    if total <= 0:
        raise ValueError("aggregation weights must sum to a positive value")
    w = [float(v) for v in (w / total).astype(np.float32)]

    def combine(*leaves):
        acc = leaves[0].to(torch.float32) * w[0]
        for wi, leaf in zip(w[1:], leaves[1:]):
            acc = acc + leaf.to(torch.float32) * wi
        return acc.to(leaves[0].dtype)

    return tree_map(combine, *params_list)


def weight_distance(a, b) -> float:
    """Global L2 distance between two param trees: ‖w_a − w_b‖."""
    sq = sum(float(torch.sum((x.to(torch.float32) - y.to(torch.float32))
                             ** 2))
             for x, y in zip(tree_leaves(a), tree_leaves(b)))
    return float(np.sqrt(sq))


def divergence_bound(init_gap: float, lipschitz: np.ndarray, eta: float,
                     mu: float, prob_distance: np.ndarray, k: int) -> float:
    """Prop. 1 / Eq. (20): upper bound on ‖w^(m)_{t,K} − w^(c)_{t,K}‖.

    ``a = 1 + η·mean(λ_i)``; bound = a^K·‖w0 gap‖ + (a^K−1)/(a−1)·η·μ·mean(Σ_c
    |P(X_i=c) − P(X_g=c)|)."""
    lam = float(np.mean(lipschitz))
    a = 1.0 + eta * lam
    pd = float(np.mean(prob_distance))
    geom = k if abs(a - 1.0) < 1e-12 else (a ** k - 1.0) / (a - 1.0)
    return (a ** k) * init_gap + geom * eta * mu * pd


def model_bits(params, bits_per_param: int = 32) -> float:
    """S — serialized model size in bits (Eq. 15 numerator)."""
    n = sum(math.prod(x.shape) for x in tree_leaves(params))
    return float(n * bits_per_param)
