"""FedDif data plane on a client-stacked tree: diffusion hops and STC hops.

Counterpart of ``repro.distributed.fedshard`` (``diffuse_params``,
``masked_stc_compress``).  FL clients are stacked on a leading axis of every
leaf; a diffusion hop is a row gather over that axis, and an STC-compressed
hop runs every leaf through ``kernels.ops.stc_topk`` — one
``stc_rows_fused`` launch per leaf on the card, the plain version on the
CPU.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.tree import tree_leaves, tree_map

Params = Any

__all__ = ["diffuse_params", "masked_stc_compress"]


def diffuse_params(params: Params, src_of_dst: torch.Tensor) -> Params:
    """One diffusion round: slot ``c`` receives the row of slot
    ``src_of_dst[c]`` (new[c] = old[src_of_dst[c]])."""
    return tree_map(lambda x: x.index_select(0, src_of_dst), params)


def masked_stc_compress(params: Params, ref: Params, mask,
                        sparsity: float = 0.01) -> Params:
    """Slot ``c`` with ``mask[c]`` becomes ``ref + STC(params[c] − ref)``
    (the compressed D2D payload the receiver reconstructs); other slots pass
    through untouched.  ``ref`` is the unstacked round-start global.  The
    mask goes to the device once per tree, as the int32 the kernels read."""
    device = tree_leaves(params)[0].device
    mask_t = torch.as_tensor(np.asarray(mask, bool).astype(np.int32),
                             device=device)

    def leaf(x, r):
        c = x.shape[0]
        out = ops.stc_topk(x.reshape(c, -1), r.reshape(-1), mask_t, sparsity)
        return out.reshape(x.shape).to(x.dtype)

    return tree_map(leaf, params, ref)
