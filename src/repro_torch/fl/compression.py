"""Sparse Ternary Compression (STC) — Sattler et al., the paper's
model-compression baseline (Table II).

Counterpart of ``repro.fl.compression``.  STC sends, per tensor, the
indices of the top-``p`` fraction of entries by magnitude, their signs and
one magnitude ``μ`` (the mean of the kept magnitudes): the tensor is
approximated by ``μ·(sign ∘ top-k mask)``.

:func:`stc_compress_leaf` is the host plane's STC (the compressed hops of
``feddif_stc``, the uplink of ``stc``), one call per slot and per leaf,
through ``kernels.ops.stc_compress``: the plain version on a CPU tensor, on
a CUDA tensor one ``stc_fused`` launch (τ selected on the card) up to
``kernels.stc_compress.N_FUSED`` elements and the ``stc_reduce``/
``stc_apply`` kernels beyond.  The fleet plane
compresses whole client stacks with ``distributed.fedshard.
masked_stc_compress`` instead.

:func:`compressed_bits` follows the paper's accounting, per tensor:
``k·(log2(n/k) + 2)`` index bits + one sign bit per kept entry + 32 bits
for μ.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.kernels import ops
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["stc_compress_leaf", "stc_compress", "compressed_bits"]


def stc_compress_leaf(x: torch.Tensor, sparsity: float = 0.01) -> torch.Tensor:
    """Ternarize one tensor, keeping the top-``sparsity`` fraction."""
    return ops.stc_compress(x, sparsity)


def stc_compress(tree: Any, sparsity: float = 0.01) -> Any:
    return tree_map(lambda x: stc_compress_leaf(x, sparsity), tree)


def compressed_bits(tree: Any, sparsity: float = 0.01) -> float:
    total = 0.0
    for leaf in tree_leaves(tree):
        n = math.prod(leaf.shape)
        k = max(1, int(n * sparsity))
        total += k * (math.log2(max(n / k, 2.0)) + 2.0) + k + 32.0
    return total
