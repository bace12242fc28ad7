"""STC wire accounting — Sattler et al., the paper's compression baseline.

Counterpart of ``repro.fl.compression.compressed_bits``: per tensor,
``k·(log2(n/k) + 2)`` index bits + one sign bit per kept entry + 32 bits
for μ.  The ternarization itself runs on the device
(``distributed.fedshard.masked_stc_compress``).
"""
from __future__ import annotations

import math
from typing import Any

from repro_torch.tree import tree_leaves

__all__ = ["compressed_bits"]


def compressed_bits(tree: Any, sparsity: float = 0.01) -> float:
    total = 0.0
    for leaf in tree_leaves(tree):
        n = math.prod(leaf.shape)
        k = max(1, int(n * sparsity))
        total += k * (math.log2(max(n / k, 2.0)) + 2.0) + k + 32.0
    return total
