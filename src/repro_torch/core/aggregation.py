"""Model size for the Eq.-15 accounting.

Counterpart of ``repro.core.aggregation.model_bits``; the Eq.-11 average
itself runs on the device through ``kernels.ops.mix_aggregate_tree``.
"""
from __future__ import annotations

import math

from repro_torch.tree import tree_leaves

__all__ = ["model_bits"]


def model_bits(params, bits_per_param: int = 32) -> float:
    """S — serialized model size in bits (Eq. 15 numerator)."""
    n = sum(math.prod(x.shape) for x in tree_leaves(params))
    return float(n * bits_per_param)
