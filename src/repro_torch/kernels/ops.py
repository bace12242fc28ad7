"""Public kernel ops: dispatch by the tensor's device and nothing else.

A CPU tensor goes to the plain PyTorch version (``kernels/ref.py``); a CUDA
tensor goes to the hand-written kernel (``kernels/diffusion.py``,
``kernels/stc_compress.py``, ``kernels/quant.py``, ``kernels/flash_attention.py``, ``kernels/ssm_scan.py``,
``kernels/ssd_scan.py``), or the call raises.  There is no override and no
fallback.  On a CUDA tensor ``flash_attention``, ``ssm_scan`` and
``ssd_scan`` go through the ``torch.autograd.Function``s of
``kernels/autograd.py``, whose backward is a hand-written kernel too (and
whose ``vmap`` rule folds a client axis into the kernel's batch); on the
CPU they are the plain forwards under ordinary autograd.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import diffusion, quant, ref
from repro_torch.kernels.autograd import FlashAttention, SsdScan, SsmScan
from repro_torch.kernels.flash_attention import BF16_HEAD_DIMS
from repro_torch.kernels.stc_compress import stc_compress_cuda
from repro_torch.tree import tree_leaves

__all__ = ["mix_aggregate", "mix_aggregate_tree", "stc_compress", "stc_topk",
           "bid_fused", "dol_bid_scores", "bid_value_fuse", "quant_pack",
           "quant_unpack", "quant_roundtrip", "flash_attention", "ssm_scan", "ssd_scan"]


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

    ``w`` is (G, C): a MixOp matrix or a (1, C) Eq.-11 aggregation row, on
    the host or on the leaves' device.  ``collapse=True`` (aggregation)
    drops the leading slot axis; ``keep_float32=True`` returns fp32 leaves,
    otherwise leaf dtypes are preserved.  CPU leaves take
    ``ref.mix_aggregate_tree_ref`` (ravel, ``mix_aggregate_ref``, unravel:
    the reference's Pallas placement); CUDA leaves take the ``mix_tree``
    kernel, one launch that reads every leaf in place and writes each
    output leaf as its own tensor, bit for bit the ravel →
    ``mix_aggregate`` → unravel chain it replaced."""
    if collapse and w.shape[0] != 1:
        raise ValueError(f"collapse=True needs a (1, C) row, got "
                         f"{tuple(w.shape)}")
    if _route(tree_leaves(params)[0]) == "cuda":
        return diffusion.mix_aggregate_tree_cuda(
            params, w, collapse=collapse, keep_float32=keep_float32)
    return ref.mix_aggregate_tree_ref(params, w, collapse=collapse,
                                      keep_float32=keep_float32)


def stc_compress(x: torch.Tensor, sparsity: float = 0.01) -> torch.Tensor:
    """Whole-tensor sparse ternary compression — the host plane's STC
    (``fl/compression.py``).  A CPU tensor takes ``ref.stc_compress_ref``,
    the semantics of record; a CUDA tensor takes the ``stc_fused`` kernel
    (one launch, τ selected on the card) up to ``N_FUSED`` elements, and
    beyond that τ by ``torch.topk`` and the ``stc_reduce``/``stc_apply``
    kernels.  All keep exactly the k entries ``lax.top_k`` keeps, at the
    mean of their magnitudes."""
    if _route(x) == "cuda":
        return stc_compress_cuda(x, sparsity)
    return ref.stc_compress_ref(x, sparsity)


def stc_topk(x: torch.Tensor, ref_row: torch.Tensor, mask: torch.Tensor,
             sparsity: float = 0.01) -> torch.Tensor:
    """Masked per-row (per-client) STC against a shared reference row —
    the D2D hop compression of ``fedshard.masked_stc_compress`` on one
    flattened leaf.  x (C, n); ref_row (n,); mask (C,) bool or int.  A CPU
    tensor takes ``ref.stc_rows_ref``, the semantics of record; a CUDA
    tensor takes the ``stc_rows_fused`` kernel (one launch, each row's τ
    selected on the card) for rows of up to ``N_FUSED`` elements, and
    beyond that τ by ``torch.topk`` and the ``stc_rows_reduce``/
    ``stc_rows_apply`` kernels.  The kernels read the mask as int32 on x's
    device; a mask already so is passed as it is."""
    if _route(x) == "cuda":
        return diffusion.stc_rows_cuda(
            x.to(torch.float32), ref_row,
            mask.to(device=x.device, dtype=torch.int32), sparsity
        ).to(x.dtype)
    return ref.stc_rows_ref(x, ref_row, mask, sparsity)


def bid_fused(iid: torch.Tensor, dol: torch.Tensor, chain_size: torch.Tensor,
              dsi: torch.Tensor, data_size: torch.Tensor,
              value: torch.Tensor | None = None, weight: float = 0.0, *,
              metric: str = "w1_norm") -> torch.Tensor:
    """One bid round of the device planner: the (M, N) Eq.-32 bids
    ``(iid[:, None] − cand)·(1 + weight·value[None, :])``, the factor only
    where ``value`` is given, ``cand`` the candidate IID distances.

    A CPU tensor takes exactly the chain the CPU planner has always run:
    :func:`dol_bid_scores`' composite, the subtraction, then
    ``ref.bid_value_fuse_ref``.  A CUDA tensor takes the ``bid_fused``
    kernel, one launch, bit for bit the chain of the standalone kernels it
    replaced.  The kernel computes the paper's ``w1_norm`` (Eq. B.1); the
    Appendix-C metrics (``kld``, ``jsd``, ``w1_true``) have no closed
    contraction form, so on either device their candidate distances take
    the composite, as the reference routes them (its ``dol_bid_scores``
    sends every metric but ``w1_norm`` to the composite, never to a Pallas
    body), and the value factor then takes :func:`bid_value_fuse`, its
    kernel on a CUDA tensor, as the reference's planner sends it to its
    ``bid_value_fuse`` body."""
    if metric == "w1_norm" and _route(dol) == "cuda":
        f32 = torch.float32
        dev = dol.device
        return diffusion.bid_fused_cuda(
            iid.to(f32).contiguous(), dol.to(f32).contiguous(),
            chain_size.to(f32).contiguous(), dsi.to(f32).contiguous(),
            data_size.to(f32).contiguous(),
            None if value is None else value.to(device=dev,
                                                dtype=f32).contiguous(),
            weight)
    bids = iid[:, None] - ref.dol_bid_scores_ref(dol, chain_size, dsi,
                                                 data_size, metric)
    return bids if value is None else bid_value_fuse(bids, value, weight)


def dol_bid_scores(dol: torch.Tensor, chain_size: torch.Tensor,
                   dsi: torch.Tensor, data_size: torch.Tensor, *,
                   metric: str = "w1_norm") -> torch.Tensor:
    """The planner's (M, N) candidate IID-distance matrix alone (the
    planner itself calls :func:`bid_fused`).

    A CPU tensor takes the broadcast composite, bit for bit the host
    planner's (as the reference's CPU ``"auto"`` does); a CUDA tensor takes
    the centered-contraction kernel for the paper's ``w1_norm`` metric
    (Eq. B.1); the Appendix-C metrics take the composite on either device,
    as in the reference."""
    if metric == "w1_norm" and _route(dol) == "cuda":
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


def quant_roundtrip(rows_of_leaves, src_of_dst=None) -> list:
    """The int8 hop of one PermuteOp: row c of the result is the
    pack → unpack of row ``src_of_dst[c]`` (identity when None), per
    QUANT_BLOCK block of the row's leaves concatenated in order.
    ``rows_of_leaves``: C rows of L tensors (the host plane's slot trees) or
    L client-stacked leaves (C, *shape) (the fleet plane's tree); returns L
    leaves (C, *shape).  A CPU tensor takes ``ref.quant_roundtrip_ref``
    (fp32 inside, each leaf back to its dtype); a CUDA tensor takes the
    ``quant_roundtrip`` kernel, one launch, on contiguous fp32 leaves."""
    first = rows_of_leaves[0]
    if not isinstance(first, torch.Tensor):
        first = first[0]
    if _route(first) == "cuda":
        return quant.quant_roundtrip_cuda(rows_of_leaves, src_of_dst)
    return ref.quant_roundtrip_ref(rows_of_leaves, src_of_dst)[0]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """Causal, sliding-window or non-causal attention, q (B, Sq, H, D)
    right-aligned to k/v (B, Sk, H, D) with heads pre-repeated for GQA
    (the zoo's self-attention, and whisper's encoder and cross-attention,
    non-causal with Sq ≠ Sk); bf16 or fp32 in, q's dtype out, fp32
    softmax.  Differentiable on either device.  On the
    card bf16 at D in ``BF16_HEAD_DIMS`` (64, 80, 128, 160, 256) takes the
    tensor-core kernels in both directions; bf16 at another D (the smoke
    configs' 32) runs the fp32 kernels on operands widened to fp32, the
    output rounded to bf16; fp32 runs the fp32 kernels up to D = 256."""
    if _route(q) == "cuda":
        dtype = q.dtype
        if dtype == torch.bfloat16 and q.shape[-1] not in BF16_HEAD_DIMS:
            # The tensor-core kernel takes the zoo's head dims; at another
            # width (the smoke configs' 32) the fp32 kernel runs on the
            # widened operands, and its output is rounded back.
            dtype = torch.float32
        out, _ = FlashAttention.apply(*(t.to(dtype).contiguous()
                                        for t in (q, k, v)),
                                      causal, window, scale)
        return out.to(q.dtype)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)


def ssm_scan(da: torch.Tensor, dbx: torch.Tensor) -> torch.Tensor:
    """Mamba-1 recurrence ``h_t = da_t ⊙ h_{t−1} + dbx_t`` from 0: da/dbx
    (B, S, D, N) → every state (B, S, D, N) fp32.  Differentiable on either
    device."""
    if _route(da) == "cuda":
        return SsmScan.apply(da.to(torch.float32).contiguous(),
                             dbx.to(torch.float32).contiguous())
    return ref.ssm_scan_ref(da, dbx)


def ssd_scan(xh: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
             cmat: torch.Tensor, *, chunk: int = 128) -> torch.Tensor:
    """Mamba-2 SSD chunk scan from a zero state: xh (B, S, H, P), a
    (B, S, H), b/c (B, S, N) → y (B, S, H, P) fp32.  Differentiable on
    either device."""
    if _route(xh) == "cuda":
        f32 = torch.float32
        return SsdScan.apply(*(t.to(f32).contiguous()
                               for t in (xh, a, bmat, cmat)), chunk)[0]
    return ref.ssd_scan_ref(xh, a, bmat, cmat, chunk)
