"""Public kernel ops: dispatch by the tensor's device and nothing else.

A CPU tensor goes to the plain PyTorch version (``kernels/ref.py``); a CUDA
tensor goes to the hand-written kernel (``kernels/diffusion.py``,
``kernels/quant.py``), or the call raises.  There is no override and no fallback.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import diffusion, quant, ref
from repro_torch.kernels.diffusion import stack_ravel, stack_unravel

__all__ = ["mix_aggregate", "mix_aggregate_tree", "stc_topk",
           "dol_bid_scores", "bid_value_fuse", "quant_pack",
           "quant_unpack"]


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel route for device {t.device}")
    return t.device.type


def mix_aggregate(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Eq. (10)/(11) fused mix/aggregate: x (C, F) client-stacked flat
    params, w (G, C) weights → (G, F) fp32 in one pass."""
    if _route(x) == "cuda":
        return diffusion.mix_aggregate_cuda(
            x.to(torch.float32).contiguous(),
            w.to(device=x.device, dtype=torch.float32).contiguous())
    return ref.mix_aggregate_ref(x, w)


def mix_aggregate_tree(params, w: torch.Tensor, *, collapse: bool = False,
                       keep_float32: bool = False):
    """Tree-level Eq. (10)/(11): mix/aggregate a client-stacked tree.

    ``w`` is (G, C): a MixOp matrix or a (1, C) Eq.-11 aggregation row.
    The fleet is flattened once with :func:`stack_ravel` and reduced in one
    :func:`mix_aggregate` call (one kernel launch on the card), as the
    reference's Pallas placement does.  ``collapse=True`` (aggregation)
    drops the leading slot axis; ``keep_float32=True`` returns fp32 leaves,
    otherwise leaf dtypes are preserved."""
    if collapse and w.shape[0] != 1:
        raise ValueError(f"collapse=True needs a (1, C) row, got "
                         f"{tuple(w.shape)}")
    flat, spec = stack_ravel(params)
    out = mix_aggregate(flat, w)
    return stack_unravel(out, spec, collapse=collapse,
                         keep_float32=keep_float32)


def stc_topk(x: torch.Tensor, ref_row: torch.Tensor, mask: torch.Tensor,
             sparsity: float = 0.01) -> torch.Tensor:
    """Masked per-row (per-client) STC against a shared reference row —
    the D2D hop compression of ``fedshard.masked_stc_compress`` on one
    flattened leaf.  x (C, n); ref_row (n,); mask (C,) bool."""
    if _route(x) == "cuda":
        return diffusion.stc_rows_cuda(x.to(torch.float32), ref_row, mask,
                                       sparsity).to(x.dtype)
    return ref.stc_rows_ref(x, ref_row, mask, sparsity)


def dol_bid_scores(dol: torch.Tensor, chain_size: torch.Tensor,
                   dsi: torch.Tensor, data_size: torch.Tensor, *,
                   metric: str = "w1_norm") -> torch.Tensor:
    """The planner's (M, N) candidate IID-distance matrix (Eq. 32 bids).

    A CPU tensor takes the broadcast composite, bit for bit the host
    planner's (as the reference's CPU ``"auto"`` does); a CUDA tensor takes
    the centered-contraction kernel.  Only the paper's ``w1_norm`` metric
    (Eq. B.1) is ported (the others are ROADMAP item A15)."""
    if metric != "w1_norm":
        raise NotImplementedError(
            f"IID metric {metric!r}: the Appendix-C metrics (kld, jsd, "
            f"w1_true) are queued as ROADMAP item A15")
    if _route(dol) == "cuda":
        f32 = torch.float32
        return diffusion.dol_bid_scores_cuda(
            dol.to(f32).contiguous(), chain_size.to(f32).contiguous(),
            dsi.to(f32).contiguous(), data_size.to(f32).contiguous())
    return ref.dol_bid_scores_ref(dol, chain_size, dsi, data_size, metric)


def bid_value_fuse(bids: torch.Tensor, value: torch.Tensor,
                   weight: float) -> torch.Tensor:
    """Fuse the per-client learning value into the planner's bid matrix:
    ``bids · (1 + weight · value[None, :])``, ``weight`` a host float."""
    if _route(bids) == "cuda":
        return diffusion.bid_value_fuse_cuda(
            bids.to(torch.float32).contiguous(),
            value.to(device=bids.device, dtype=torch.float32).contiguous(),
            weight)
    return ref.bid_value_fuse_ref(bids, value, weight)


def quant_pack(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 absmax pack — the adapter hop wire format.  x (R, B)
    fp32 → (q (R, B) int8, scale (R,) fp32); rows are the QUANT_BLOCK
    row-blocks of a flattened adapter (``fl/adapters.pack_rows``)."""
    if _route(x) == "cuda":
        return quant.quant_pack_cuda(x.to(torch.float32).contiguous())
    return ref.quant_pack_ref(x)


def quant_unpack(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quant_pack`: (q (R, B) int8, scale (R,)) → (R, B)
    fp32 at the hop destination."""
    if _route(q) == "cuda":
        return quant.quant_unpack_cuda(
            q.contiguous(),
            scale.to(device=q.device, dtype=torch.float32).contiguous())
    return ref.quant_unpack_ref(q, scale)
