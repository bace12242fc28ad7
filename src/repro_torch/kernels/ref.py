"""Plain PyTorch versions of the port's kernels: the FL data plane's and
the LM zoo's (attention, the Mamba-1 scan, the Mamba-2 SSD scan).

These are the semantics of record on the port's side, as
``repro.kernels.ref`` is on the reference's: the CPU path runs them, the
tests hold them to the JAX package, and ``chip_smoke.py`` holds each CUDA
kernel to them on the card.  They run on any device, but nothing on the
main path calls them with a CUDA tensor: there the wrappers in
``repro_torch.kernels`` launch the hand-written kernels.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.dol import iid_distance_candidates_t, xla_sum_t
from repro_torch.kernels.quant import QUANT_BLOCK, roundtrip_rows, rows_src
from repro_torch.tree import tree_flatten, tree_unflatten

__all__ = ["mix_aggregate_ref", "stack_ravel", "stack_unravel",
           "mix_aggregate_tree_ref", "stc_compress_ref", "stc_threshold",
           "stc_reduce_ref", "stc_apply_ref", "stc_radix_threshold_ref",
           "stc_fused_ref", "stc_rows_ref",
           "stc_rows_threshold", "stc_rows_reduce_ref", "stc_rows_apply_ref",
           "stc_rows_fused_ref",
           "dol_bid_scores_ref", "dol_bid_scores_fused_ref",
           "bid_value_fuse_ref", "bid_fused_ref", "quant_pack_ref",
           "quant_unpack_ref",
           "quant_roundtrip_ref", "flash_attention_ref",
           "flash_attention_bwd_ref", "ssm_scan_ref", "ssm_scan_bwd_ref",
           "ssd_scan_ref",
           "ssd_chunk_states_ref", "ssd_state_pass_ref",
           "ssd_chunk_output_ref", "ssd_scan_stages_ref",
           "ssd_bwd_local_ref", "ssd_bwd_pass_ref", "ssd_bwd_intra_ref",
           "ssd_bwd_state_ref", "ssd_bwd_chunks_ref", "ssd_scan_bwd_ref"]


def mix_aggregate_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Eq. (10)/(11) weighted reduction on a flattened client-stacked block:
    ``out[g, f] = Σ_c w[g, c]·x[c, f]``.  x (C, F); w (G, C) → (G, F) fp32."""
    return torch.einsum("gc,cf->gf", w.to(torch.float32),
                        x.to(torch.float32))


def stack_ravel(params) -> tuple[torch.Tensor, tuple]:
    """Flatten a client-stacked tree to one (C, F) fp32 block.

    Every leaf (C, *shape) is raveled to (C, n) and concatenated on the
    feature axis in the reference's leaf order.  Returns ``(flat, spec)``;
    :func:`stack_unravel` inverts it."""
    leaves, treedef = tree_flatten(params)
    c = leaves[0].shape[0]
    flat = torch.cat([x.reshape(c, -1).to(torch.float32) for x in leaves],
                     dim=1)
    meta = tuple((tuple(x.shape[1:]), x.dtype) for x in leaves)
    return flat, (treedef, meta)


def stack_unravel(flat: torch.Tensor, spec: tuple, *, collapse: bool = False,
                  keep_float32: bool = False):
    """Inverse of :func:`stack_ravel`.

    ``flat`` may carry any leading slot count G.  ``collapse=True`` drops
    the leading axis (requires G = 1) — explicit, because a one-slot MixOp
    also has G = 1 and must stay stacked.  ``keep_float32`` skips the
    restore to each leaf's stored dtype."""
    treedef, meta = spec
    g = flat.shape[0]
    if collapse and g != 1:
        raise ValueError(f"collapse=True needs one output row, got {g}")
    leaves, off = [], 0
    for shape, dtype in meta:
        n = math.prod(shape)
        blk = flat[:, off:off + n]
        off += n
        blk = blk.reshape(shape) if collapse else blk.reshape((g,) + shape)
        leaves.append(blk if keep_float32 else blk.to(dtype))
    return tree_unflatten(treedef, leaves)


def mix_aggregate_tree_ref(params, w: torch.Tensor, *, collapse: bool = False,
                           keep_float32: bool = False):
    """Tree-level Eq. (10)/(11), the plain version of record: the
    client-stacked tree raveled to one (C, F) block (:func:`stack_ravel`),
    reduced by :func:`mix_aggregate_ref` and cut back into leaves
    (:func:`stack_unravel`), as the reference's Pallas placement does.
    ``w`` (G, C); ``collapse`` and ``keep_float32`` as in
    :func:`stack_unravel`."""
    flat, spec = stack_ravel(params)
    return stack_unravel(mix_aggregate_ref(flat, w), spec, collapse=collapse,
                         keep_float32=keep_float32)


def _top_k(a: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of ``a`` along its last axis and their indices
    under ``lax.top_k``'s rule: of equal values the lower index first (a
    stable descending sort; ``torch.topk`` breaks ties otherwise)."""
    idx = torch.sort(a, dim=-1, descending=True, stable=True).indices
    idx = idx[..., :k]
    return torch.gather(a, -1, idx), idx


def _xla_mean(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mean`` over the last axis, bit for bit: XLA-CPU's float32 sum
    times fp32(1/N)."""
    return xla_sum_t(x) * torch.full((), 1.0 / x.shape[-1],
                                     dtype=torch.float32, device=x.device)


def stc_compress_ref(x: torch.Tensor, sparsity: float) -> torch.Tensor:
    """Sparse ternary compression (Sattler et al.): keep exactly the top-k
    entries by magnitude (``lax.top_k``'s tie rule) and replace them with
    ``sign(x)·mean(|top-k|)`` — ``repro.kernels.ref.stc_compress_ref`` bit
    for bit."""
    flat = x.reshape(-1).to(torch.float32)
    k = max(1, int(flat.numel() * sparsity))
    topv, topi = _top_k(flat.abs(), k)
    out = torch.zeros_like(flat)
    out[topi] = torch.sign(flat[topi]) * _xla_mean(topv)
    return out.reshape(x.shape).to(x.dtype)


def stc_threshold(flat: torch.Tensor, sparsity: float) -> torch.Tensor:
    """τ, the k-th largest ``|x|`` of a flat tensor, as a (1,) fp32 tensor on
    its device (``k = max(1, int(n·sparsity))``) — computed outside the STC
    kernels, as the reference leaves it to an XLA sort."""
    a = flat.reshape(-1).to(torch.float32).abs()
    k = max(1, int(a.numel() * sparsity))
    return torch.topk(a, k).values[k - 1:k].contiguous()


def stc_reduce_ref(flat: torch.Tensor, thr: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the STC reduce kernel: the survivor sum
    ``Σ|x|·1[|x| ≥ τ]`` as (1,) fp32 and the survivor count as (1,) int32,
    for a flat tensor and a one-element threshold."""
    a = flat.reshape(-1).to(torch.float32).abs()
    keep = a >= thr.reshape(())
    return (torch.where(keep, a, 0.0).sum().reshape(1),
            keep.sum().to(torch.int32).reshape(1))


def _divisor(k: int, device: torch.device) -> torch.Tensor:
    """k as a float32 tensor on ``device``: a true division by it rounds
    once, as the kernels' ``__fdiv_rn`` (PyTorch's CUDA division by a
    Python scalar multiplies by its reciprocal instead).  Filled on the
    device, not copied there, so a CUDA graph can capture it."""
    return torch.full((), float(k), dtype=torch.float32, device=device)


def stc_mu_ref(ssum: torch.Tensor, cnt: torch.Tensor, thr: torch.Tensor,
               k: int) -> torch.Tensor:
    """The μ the STC apply kernel forms from the reduce's outputs: the mean
    of the top-k magnitudes, ``(sum − (count − k)·τ) / k`` as (1,) fp32 —
    the ``count − k`` survivors past the k-th all equal τ.  With τ = 0 (a
    tensor with fewer than k nonzeros) it is ``Σ|x| / k``, the exact-k μ
    of :func:`stc_compress_ref`, where ``sum / count`` would be
    ``Σ|x| / n``.  Each fp32 op rounds once, as in the kernel."""
    extra = (cnt.to(torch.int64) - k).to(torch.float32)
    return ((ssum.to(torch.float32) - extra * thr.to(torch.float32))
            / _divisor(k, ssum.device))


def _keep_top_k(a: torch.Tensor, thr: torch.Tensor, k: int) -> torch.Tensor:
    """The kernels' survivors along the last axis of ``a``: every entry
    above τ plus the first ``k − count_{>τ}`` entries equal to τ in index
    order — exactly k, the entries ``lax.top_k`` keeps."""
    above = a > thr
    tied = a == thr
    need = k - above.sum(dim=-1, keepdim=True)
    rank = torch.cumsum(tied.to(torch.int64), dim=-1) - 1
    return above | (tied & (rank < need))


def stc_apply_ref(flat: torch.Tensor, thr: torch.Tensor, mu: torch.Tensor,
                  k: int) -> torch.Tensor:
    """Plain version of the STC apply kernel: ``μ·sign(x)`` on the k
    survivors of :func:`_keep_top_k`, 0 elsewhere, over a flat tensor, fp32
    out; ``thr`` and ``mu`` hold one element each (the kernel forms μ as
    :func:`stc_mu_ref` does from the reduce's outputs)."""
    x = flat.reshape(-1).to(torch.float32)
    keep = _keep_top_k(x.abs(), thr.reshape(()), k)
    return torch.where(keep, torch.sign(x) * mu.reshape(()), 0.0)


#: The fused STC kernel's radix digits: 4 passes of 8 bits over the 32-bit
#: keys, from the top.
STC_RADIX_SHIFTS = (24, 16, 8, 0)


def stc_radix_threshold_ref(a: torch.Tensor, k: int) -> torch.Tensor:
    """τ, the k-th largest ``|a|`` along the last axis, as the fused STC
    kernels select it: a radix select on the int32 view of ``|a|`` (for
    non-negative fp32 values integer order is value order; −0 keys as +0),
    one 8-bit digit a pass from the top.  Each pass counts the digit among
    the keys that match the prefix so far and takes the digit where the
    count from the top reaches the rank still sought.  (The kernel's lone
    block stops early once the keys that match the prefix fit one warp and
    ranks them there: the same τ.)  A (…, n) tensor gives one τ per row,
    (…,) fp32; a 1-D tensor is one row and gives (1,).  Tensor ops only
    (no host read), so a CUDA graph can capture it."""
    a = a.to(torch.float32)
    rows = a.reshape(-1, a.shape[-1]) if a.dim() > 1 else a.reshape(1, -1)
    keys = rows.abs().view(torch.int32).to(torch.int64)
    r = keys.shape[0]
    dev = keys.device
    prefix = torch.zeros((r,), dtype=torch.int64, device=dev)
    rem = torch.full((r, 1), k, dtype=torch.int64, device=dev)
    for shift in STC_RADIX_SHIFTS:
        digit = (keys >> shift) & 255
        if shift != 24:               # keys off the prefix count in bin 256
            digit = torch.where((keys >> (shift + 8)) == prefix[:, None],
                                digit, 256)
        hist = torch.zeros((r, 257), dtype=torch.int64,
                           device=dev).scatter_add_(
            1, digit, torch.ones_like(digit))[:, :256].flip(1)
        from_top = torch.cumsum(hist, 1)
        i = torch.searchsorted(from_top, rem)       # (r, 1): the digit's slot
        rem = rem - (from_top.gather(1, i) - hist.gather(1, i))
        prefix = prefix * 256 + (255 - i[:, 0])
    tau = prefix.to(torch.int32).view(torch.float32)
    return tau.reshape(a.shape[:-1]) if a.dim() > 1 else tau


def stc_fused_ref(flat: torch.Tensor, k: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """Plain version of the fused STC kernel, step by step: τ by
    :func:`stc_radix_threshold_ref`, the survivor sum and count by
    :func:`stc_reduce_ref`, μ by :func:`stc_mu_ref` and the exact-k apply
    by :func:`stc_apply_ref`.  Returns ``(out, thr, ssum, cnt)``."""
    x = flat.reshape(-1).to(torch.float32)
    thr = stc_radix_threshold_ref(x, k)
    ssum, cnt = stc_reduce_ref(x, thr)
    out = stc_apply_ref(x, thr, stc_mu_ref(ssum, cnt, thr, k), k)
    return out, thr, ssum, cnt


def stc_rows_ref(x: torch.Tensor, ref_row: torch.Tensor, mask: torch.Tensor,
                 sparsity: float) -> torch.Tensor:
    """Masked per-row STC against a shared reference row: row ``c`` becomes
    ``ref + STC(x_c − ref)`` where ``mask[c]``, else passes through.

    Exactly ``k = max(1, int(n·sparsity))`` survivors per row, chosen by
    ``lax.top_k``'s rule — ``repro.kernels.ref.stc_rows_ref`` bit for bit."""
    ref32 = ref_row.to(torch.float32)
    delta = x.to(torch.float32) - ref32[None, :]
    k = max(1, int(x.shape[1] * sparsity))
    topv, topi = _top_k(delta.abs(), k)
    mu = _xla_mean(topv)[:, None]
    tern = torch.zeros_like(delta).scatter(
        1, topi, torch.sign(torch.gather(delta, 1, topi)) * mu)
    comp = (ref32[None, :] + tern).to(x.dtype)
    return torch.where(mask.reshape(-1, 1).to(torch.bool), comp, x)


def stc_rows_threshold(x: torch.Tensor, ref_row: torch.Tensor,
                       sparsity: float) -> torch.Tensor:
    """τ_c, the k-th largest ``|x_c − ref|`` of every row (C,) by
    ``torch.topk`` — computed outside the reduce and apply kernels, as the
    reference leaves it to an XLA sort (rows of more than ``N_FUSED``
    elements; the fused kernel selects τ_c itself)."""
    delta = x.to(torch.float32) - ref_row.to(torch.float32)[None, :]
    k = max(1, int(x.shape[1] * sparsity))
    return torch.topk(delta.abs(), k, dim=1).values[:, k - 1].contiguous()


def stc_rows_reduce_ref(x: torch.Tensor, ref_row: torch.Tensor,
                        thr: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the reduce kernel: per row, the survivor sum
    ``Σ|Δ|·1[|Δ| ≥ τ_c]`` and the survivor count, both (C,) fp32."""
    a = (x.to(torch.float32) - ref_row.to(torch.float32)[None, :]).abs()
    keep = a >= thr.reshape(-1, 1)
    return (torch.where(keep, a, 0.0).sum(dim=1),
            keep.sum(dim=1).to(torch.float32))


def stc_rows_apply_ref(x: torch.Tensor, ref_row: torch.Tensor,
                       thr: torch.Tensor, ssum: torch.Tensor,
                       cnt: torch.Tensor, mask: torch.Tensor,
                       k: int) -> torch.Tensor:
    """Plain version of the apply kernel: ternarize each masked row's k
    survivors (:func:`_keep_top_k`) at the exact-k ``μ_c = (ssum_c −
    (cnt_c − k)·τ_c) / k`` (each fp32 op rounded once, as in the kernel)
    and blend; unmasked rows pass through."""
    r = ref_row.to(torch.float32)[None, :]
    d = x.to(torch.float32) - r
    t = thr.reshape(-1, 1)
    mu = ((ssum.reshape(-1, 1) - (cnt.reshape(-1, 1) - float(k)) * t)
          / _divisor(k, ssum.device))
    tern = torch.where(_keep_top_k(d.abs(), t, k), torch.sign(d) * mu, 0.0)
    return torch.where(mask.reshape(-1, 1) != 0, (r + tern).to(x.dtype), x)


def stc_rows_fused_ref(x: torch.Tensor, ref_row: torch.Tensor,
                       mask: torch.Tensor, k: int
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """Plain version of the fused per-row STC kernel, step by step: τ_c by
    :func:`stc_radix_threshold_ref` on each row of ``x − ref``, the survivor
    sum and count by :func:`stc_rows_reduce_ref`, the exact-k μ_c and the
    blend by :func:`stc_rows_apply_ref`.  Returns ``(out, thr, ssum,
    cnt)``: out (C, n) fp32; thr, ssum (C,) fp32 and cnt (C,) int32, 0 on
    the rows whose mask is 0."""
    x32 = x.to(torch.float32)
    r = ref_row.to(torch.float32)
    thr = stc_radix_threshold_ref(x32 - r[None, :], k)
    ssum, cnt = stc_rows_reduce_ref(x32, r, thr)
    out = stc_rows_apply_ref(x32, r, thr, ssum, cnt, mask, k)
    on = mask.reshape(-1) != 0
    return (out, torch.where(on, thr, 0.0), torch.where(on, ssum, 0.0),
            torch.where(on, cnt, 0.0).to(torch.int32))


def dol_bid_scores_ref(dol: torch.Tensor, chain_size: torch.Tensor,
                       dsi: torch.Tensor, data_size: torch.Tensor,
                       metric: str = "w1_norm") -> torch.Tensor:
    """The planner's (M, N) candidate IID distances by the (M, N, C)
    broadcast composite — ``repro_torch.core.dol.iid_distance_candidates_t``,
    the semantics of record for the Eq.-32 bids.  The CPU path runs it."""
    return iid_distance_candidates_t(dol, chain_size, dsi, data_size, metric)


def _center_stats(dol, chain_size, dsi, data_size):
    """Centered operands and the row statistics of the fused expansion."""
    u = 1.0 / dol.shape[1]
    psi_c = dol.to(torch.float32) - u                         # (M, C)
    d_c = dsi.to(torch.float32) - u                           # (N, C)
    a = chain_size.to(torch.float32).reshape(-1, 1)           # (M, 1)
    b = data_size.to(torch.float32).reshape(1, -1)            # (1, N)
    p_psi = (psi_c * psi_c).sum(dim=1, keepdim=True)          # (M, 1)
    s_psi = psi_c.sum(dim=1, keepdim=True)                    # (M, 1)
    p_d = (d_c * d_c).sum(dim=1).reshape(1, -1)               # (1, N)
    s_d = d_c.sum(dim=1).reshape(1, -1)                       # (1, N)
    return psi_c, d_c, a, b, p_psi, s_psi, p_d, s_d


def _bid_scores_from_stats(cross, a, b, p_psi, s_psi, p_d, s_d, u):
    """dist(cand, U) from the centered statistics (w1_norm):
    with ``s = a + b``, ``sp = max(s, 1)`` and ``δ = s/sp − 1``,
    ``dist² = (a²P_ψ + 2ab·cross + b²P_d)/sp² + 2uδ(aS_ψ + bS_d)/sp
    + C·u²δ²`` — the δ terms live only where ``s < 1``."""
    s = a + b                                                 # (M, N)
    sp = torch.clamp(s, min=1.0)
    delta = s / sp - 1.0
    core = (a * a * p_psi + 2.0 * a * b * cross + b * b * p_d) / (sp * sp)
    lin = 2.0 * u * delta * (a * s_psi + b * s_d) / sp
    quad = (1.0 / u) * (u * delta) ** 2
    return torch.sqrt(torch.clamp(core + lin + quad, min=0.0))


def dol_bid_scores_fused_ref(dol: torch.Tensor, chain_size: torch.Tensor,
                             dsi: torch.Tensor, data_size: torch.Tensor
                             ) -> torch.Tensor:
    """The CUDA kernel's own algebra in plain PyTorch: centering on U turns
    Eq. 2 + B.1 into one ``ψ_c @ d_cᵀ`` contraction plus rank-1 statistics,
    with no (M, N, C) tensor and no cancellation as dist → 0.  Twin of the
    reference's ``dol_bid_scores_xla_fused``; ``chip_smoke.py`` holds the
    kernel to it."""
    psi_c, d_c, a, b, p_psi, s_psi, p_d, s_d = _center_stats(
        dol, chain_size, dsi, data_size)
    return _bid_scores_from_stats(psi_c @ d_c.T, a, b, p_psi, s_psi, p_d,
                                  s_d, 1.0 / dol.shape[1])


def bid_value_fuse_ref(bids: torch.Tensor, value: torch.Tensor,
                       weight: float) -> torch.Tensor:
    """Learning-value bid fusion ``bids · (1 + w · value[None, :])`` in
    float32: multiply, add, multiply, each rounded (the kernel does the
    same, so it equals this bit for bit)."""
    return bids.to(torch.float32) * (
        1.0 + float(weight) * value.to(torch.float32)[None, :])


def bid_fused_ref(iid: torch.Tensor, dol: torch.Tensor,
                  chain_size: torch.Tensor, dsi: torch.Tensor,
                  data_size: torch.Tensor, value: torch.Tensor | None = None,
                  weight: float = 0.0) -> torch.Tensor:
    """The ``bid_fused`` kernel's own algebra in plain PyTorch: the centered
    contraction (:func:`dol_bid_scores_fused_ref`), the subtraction from
    ``iid`` and, where a value is given, :func:`bid_value_fuse_ref`.
    ``chip_smoke.py`` holds the kernel to it; the CPU path runs the
    composite instead (``ops.bid_fused``)."""
    bids = iid.to(torch.float32)[:, None] - dol_bid_scores_fused_ref(
        dol, chain_size, dsi, data_size)
    return bids if value is None else bid_value_fuse_ref(bids, value, weight)


#: float32(1/127) (bits 0x3c010204) as a Python float: the scale is a
#: multiply by it, never a division by 127, as in the reference (which keeps
#: its wire bit for bit).  A float32 tensor times this scalar rounds the
#: exact product once to float32, on the CPU and on the card.
_INV127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()


def quant_pack_ref(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 absmax pack — the adapter hop wire format.  x (R, B)
    fp32 → (q (R, B) int8, scale (R,) fp32) with ``scale = max(absmax,
    1e-12)·f32(1/127)`` and ``q = clip(round_half_even(x/scale), ±127)``;
    all-zero rows hit the floor and quantize to exact zeros."""
    x = x.to(torch.float32)
    scale = torch.clamp(x.abs().amax(dim=1), min=1e-12) * _INV127
    q = torch.clamp(torch.round(x / scale[:, None]), -127.0, 127.0)
    return q.to(torch.int8), scale


def quant_unpack_ref(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(q (R, B) int8, scale (R,)) → (R, B) fp32 dequantized payload."""
    return q.to(torch.float32) * scale.to(torch.float32)[:, None]


def quant_roundtrip_ref(rows_of_leaves, src_of_dst=None
                        ) -> tuple[list, torch.Tensor, torch.Tensor]:
    """The int8 hop of one PermuteOp, plainly: the C rows (each its leaves
    concatenated in order, in fp32, zero-padded to a QUANT_BLOCK multiple)
    through :func:`quant_pack_ref` → :func:`quant_unpack_ref`, then the row
    gather ``new[c] = old[src_of_dst[c]]`` (identity when None).

    ``rows_of_leaves``: C rows of L tensors, or L client-stacked leaves
    (C, *shape) (``kernels.quant.roundtrip_rows``).  Returns ``(leaves,
    codes, scales)``: L leaves (C, *shape) in the input leaves' dtypes, the
    codes (C, Fp) int8 and scales (C, Fp/QUANT_BLOCK) fp32 of each output
    row — ``repro.fl.adapters.quant_roundtrip_rows`` followed by the move,
    bit for bit."""
    c, _, rows, stacked = roundtrip_rows(rows_of_leaves)
    src = rows_src(src_of_dst, c)
    if rows is None:
        meta = [(tuple(x.shape[1:]), x.dtype) for x in stacked]
        flat = torch.cat([x.reshape(c, -1).to(torch.float32)
                          for x in stacked], dim=1)
    else:
        meta = [(tuple(x.shape), x.dtype) for x in rows[0]]
        flat = torch.stack([torch.cat([x.reshape(-1).to(torch.float32)
                                       for x in row]) for row in rows])
    f = flat.shape[1]
    fp = -(-f // QUANT_BLOCK) * QUANT_BLOCK
    nb = fp // QUANT_BLOCK
    q, scale = quant_pack_ref(F.pad(flat, (0, fp - f)).reshape(
        c * nb, QUANT_BLOCK))
    out, q, scale = (t.reshape(c, -1) for t in (
        quant_unpack_ref(q, scale), q, scale))
    if src != list(range(c)):
        # The move as a stack of row views: no host index goes to the
        # device, so the call also runs inside a CUDA graph.
        out, q, scale = (torch.stack([t[s] for s in src])
                         for t in (out, q, scale))
    leaves, off = [], 0
    for shape, dtype in meta:
        n = math.prod(shape)
        leaves.append(out[:, off:off + n].reshape((c,) + shape).to(dtype))
        off += n
    return leaves, q, scale


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        scale: float | None = None, return_lse: bool = False):
    """Naive softmax attention.  q: (B, Sq, H, D); k/v: (B, Sk, H, D).

    fp32 scores over the whole (Sq, Sk) rectangle, q right-aligned to the
    end of the keys; a fully masked row returns 0; output in q's dtype —
    ``repro.kernels.ref.flash_attention_ref``.  With ``return_lse`` also
    each row's natural-log log-sum-exp of its scaled visible scores, (B, H,
    Sq) fp32, +inf for a fully masked row (the output is unchanged)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / d ** 0.5 if scale is None else scale
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    mask = _attention_mask(sq, sk, causal, window, q.device)
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)                # fully masked rows
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32)).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(s, dim=-1)
    return out, lse.masked_fill(lse == float("-inf"), float("inf"))


def _attention_mask(sq: int, sk: int, causal: bool, window: int | None,
                    device) -> torch.Tensor:
    """(Sq, Sk) bool: the keys each query sees, q right-aligned to the end
    of the keys."""
    q_pos = torch.arange(sq, device=device)[:, None] + (sk - sq)
    k_pos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return mask


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            do: torch.Tensor, *,
                            lse: torch.Tensor | None = None,
                            causal: bool = True, window: int | None = None,
                            scale: float | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The backward of :func:`flash_attention_ref`, as formulas: ``o`` is
    the forward's output and ``do`` the gradient reaching it.

    fp32 scores over the whole rectangle recompute ``P``: by a softmax, or
    given the forward's ``lse`` (B, H, Sq), as ``exp(s·scale − lse)`` (0 on
    masked entries and on a row with lse = +inf), as the kernel does;
    ``Δ = rowsum(dO ∘ O)`` in fp32; ``dV = Pᵀ·dO``, ``dP = dO·Vᵀ``, ``dS =
    P ∘ (dP − Δ)``, ``dQ = scale·dS·K``, ``dK = scale·dSᵀ·Q``.  A row that
    sees no key has ``P = 0``, so it adds nothing to any gradient.  Each
    result comes back in its input's dtype."""
    d = q.shape[-1]
    scale = 1.0 / d ** 0.5 if scale is None else scale
    f32 = torch.float32
    qf, kf, vf, of, dof = (t.to(f32) for t in (q, k, v, o, do))
    mask = _attention_mask(q.shape[1], k.shape[1], causal, window, q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    s = s.masked_fill(~mask, float("-inf"))
    if lse is None:
        p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
    else:
        p = torch.exp(s - lse.to(f32)[..., None])   # -inf - lse: 0
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = (dof * of).sum(-1).transpose(1, 2)[..., None]    # (B,H,Sq,1)
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def ssm_scan_ref(da: torch.Tensor, dbx: torch.Tensor) -> torch.Tensor:
    """Diagonal linear recurrence ``h_t = da_t·h_{t−1} + dbx_t`` from 0.

    da/dbx: (B, S, D, N) fp32.  Returns all states (B, S, D, N): a multiply
    then an add per step, each rounded (the CUDA kernel does the same)."""
    da = da.to(torch.float32)
    dbx = dbx.to(torch.float32)
    hs = torch.empty_like(da)
    h = torch.zeros_like(da[:, 0])
    for t in range(da.shape[1]):
        h = da[:, t] * h + dbx[:, t]
        hs[:, t] = h
    return hs


def ssm_scan_bwd_ref(da: torch.Tensor, hs: torch.Tensor,
                     dhs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward of :func:`ssm_scan_ref`: ``da`` and the forward's
    states ``hs``, ``dhs`` the gradient reaching them, all (B, S, D, N)
    fp32 → ``(dda, ddbx)``.

    In reverse time from ``g = 0``: ``g = dhs_t + da_{t+1}·g`` (a multiply,
    then an add, each rounded; ``da_S = 0``), ``ddbx_t = g`` and ``dda_t =
    g·h_{t−1}`` with ``h_{−1} = 0`` — the CUDA kernel's arithmetic, so the
    two agree bit for bit."""
    da, hs, dhs = (t.to(torch.float32) for t in (da, hs, dhs))
    dda = torch.empty_like(da)
    ddbx = torch.empty_like(da)
    zero = torch.zeros_like(da[:, 0])
    g = zero
    for t in reversed(range(da.shape[1])):
        a_next = da[:, t + 1] if t + 1 < da.shape[1] else zero
        g = dhs[:, t] + a_next * g
        ddbx[:, t] = g
        dda[:, t] = g * (hs[:, t - 1] if t > 0 else zero)
    return dda, ddbx


def ssd_scan_ref(xh: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                 cmat: torch.Tensor, chunk: int = 128, *,
                 return_state: bool = False):
    """Chunked SSD (Mamba-2) scan from a zero state — the model layer's
    form, ``repro.models.ssm._ssd_chunk_scan`` with ``h0 = 0``.

    xh (B, S, H, P) value stream, a (B, S, H) per-step log decay, bmat /
    cmat (B, S, N) input / output projections, all fp32 → y (B, S, H, P).
    S is padded to a multiple of ``chunk``; the triangle is masked before
    ``exp``, as the reference does.  ``return_state=True`` also returns
    what the backward takes: the state entering each chunk (B, nc, H, P,
    N) and the chunks' cumulative decays (B, nc, H, chunk)."""
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    f32 = torch.float32
    xh, a, bmat, cmat = (t.to(f32) for t in (xh, a, bmat, cmat))
    pad = (-s) % chunk
    if pad:
        xh = torch.nn.functional.pad(xh, (0, 0, 0, 0, 0, pad))
        a = torch.nn.functional.pad(a, (0, 0, 0, pad))
        bmat = torch.nn.functional.pad(bmat, (0, 0, 0, pad))
        cmat = torch.nn.functional.pad(cmat, (0, 0, 0, pad))
    nc = xh.shape[1] // chunk
    x_c = xh.reshape(b, nc, chunk, h, p)
    a_c = a.reshape(b, nc, chunk, h)
    b_c = bmat.reshape(b, nc, chunk, n)
    c_c = cmat.reshape(b, nc, chunk, n)
    ltri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=xh.device))[None, :, :, None]
    hprev = torch.zeros((b, h, p, n), dtype=f32, device=xh.device)
    ys, entering, acums = [], [], []
    for i in range(nc):
        x_i, a_i, b_i, c_i = x_c[:, i], a_c[:, i], b_c[:, i], c_c[:, i]
        acum = torch.cumsum(a_i, dim=1)                      # (B,L,H)
        entering.append(hprev)
        acums.append(acum.transpose(1, 2))
        rel = acum[:, :, None, :] - acum[:, None, :, :]      # (B,Lq,Lk,H)
        dec = torch.exp(torch.where(ltri, rel, -1e30))
        cb = torch.einsum("bqn,bkn->bqk", c_i, b_i)          # (B,Lq,Lk)
        w = cb[..., None] * dec                              # (B,Lq,Lk,H)
        y_intra = torch.einsum("bqkh,bkhp->bqhp", w, x_i)
        y_state = torch.einsum("bqn,bhpn,bqh->bqhp", c_i, hprev,
                               torch.exp(acum))
        tot = torch.exp(acum[:, -1])                         # (B,H)
        decay_k = torch.exp(acum[:, -1:, :] - acum)          # (B,L,H)
        hprev = tot[:, :, None, None] * hprev + torch.einsum(
            "bkn,bkhp,bkh->bhpn", b_i, x_i, decay_k)
        ys.append(y_intra + y_state)
    y = torch.cat(ys, dim=1)[:, :s]
    if return_state:
        return y, torch.stack(entering, dim=1), torch.stack(acums, dim=1)
    return y


# The SSD scan in its state-passing form, stage by stage, as the CUDA
# kernels (csrc/ssd_scan.cu) compute it: chunk states from zero, the carry
# over chunks in order, then each chunk's output from its entering state.
# ``mm`` takes every matrix product (batched ``torch.matmul`` semantics),
# so that a test can put an emulation of the kernels' arithmetic in it.

def _ssd_chunks(t: torch.Tensor, chunk: int) -> torch.Tensor:
    """(B, S, ...) fp32 → (B, nc, chunk, ...), zeros past S."""
    t = t.to(torch.float32)
    pad = (-t.shape[1]) % chunk
    if pad:
        t = torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
    return t.reshape(t.shape[0], -1, chunk, *t.shape[2:])


def ssd_chunk_states_ref(xh: torch.Tensor, a: torch.Tensor,
                         bmat: torch.Tensor, chunk: int = 128, *,
                         mm=torch.matmul) -> tuple[torch.Tensor, torch.Tensor]:
    """Per chunk and head: ``acum = cumsum(a)`` over the chunk and the
    chunk's own state from zero, ``s = Xᵀ·(exp(acum_L − acum_k) ∘ B)``.

    xh (B, S, H, P), a (B, S, H), bmat (B, S, N) → acum (B, nc, H, chunk),
    states (B, nc, H, P, N); rows past S are zeros."""
    x_c = _ssd_chunks(xh, chunk)                          # (B,nc,L,H,P)
    b_c = _ssd_chunks(bmat, chunk)                        # (B,nc,L,N)
    acum = torch.cumsum(_ssd_chunks(a, chunk), dim=2).transpose(2, 3)
    decay_k = torch.exp(acum[..., -1:] - acum)            # (B,nc,H,L)
    states = mm(x_c.permute(0, 1, 3, 4, 2),
                decay_k[..., None] * b_c[:, :, None])
    return acum, states


def ssd_state_pass_ref(states: torch.Tensor,
                       acum: torch.Tensor) -> torch.Tensor:
    """``h_c = exp(acum_L^c)·h_{c−1} + s_c`` over the chunks in order, from
    zero: states (B, nc, H, P, N), acum (B, nc, H, L) → the state entering
    each chunk (B, nc, H, P, N), zeros for the first."""
    tot = torch.exp(acum[..., -1])[..., None, None]       # (B,nc,H,1,1)
    h = torch.zeros_like(states[:, 0])
    entering = torch.empty_like(states)
    for c in range(states.shape[1]):
        entering[:, c] = h
        h = tot[:, c] * h + states[:, c]
    return entering


def ssd_chunk_output_ref(xh: torch.Tensor, acum: torch.Tensor,
                         bmat: torch.Tensor, cmat: torch.Tensor,
                         entering: torch.Tensor, chunk: int = 128, *,
                         mm=torch.matmul) -> torch.Tensor:
    """Each chunk's output, ``y = exp(acum_q)·(C·hᵀ) + (C·Bᵀ ∘ dec)·X``
    with ``dec[q, k] = exp(acum_q − acum_k)`` on ``k ≤ q`` (masked before
    ``exp``) and h the state entering the chunk → y (B, S, H, P)."""
    b, s, h, p = xh.shape
    x_c = _ssd_chunks(xh, chunk).transpose(2, 3)          # (B,nc,H,L,P)
    b_c = _ssd_chunks(bmat, chunk)                        # (B,nc,L,N)
    c_c = _ssd_chunks(cmat, chunk)
    cb = mm(c_c, b_c.transpose(-1, -2))[:, :, None]       # (B,nc,1,L,L)
    ltri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=xh.device))
    rel = acum[..., :, None] - acum[..., None, :]         # (B,nc,H,L,L)
    dec = torch.exp(torch.where(ltri, rel, -1e30))
    y = mm(cb * dec, x_c) + torch.exp(acum)[..., None] * mm(
        c_c[:, :, None], entering.transpose(-1, -2))
    return y.transpose(2, 3).reshape(b, -1, h, p)[:, :s]


def ssd_scan_stages_ref(xh: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                        cmat: torch.Tensor, chunk: int = 128, *,
                        mm=torch.matmul) -> torch.Tensor:
    """:func:`ssd_scan_ref`'s function through the three stages."""
    acum, states = ssd_chunk_states_ref(xh, a, bmat, chunk, mm=mm)
    entering = ssd_state_pass_ref(states, acum)
    return ssd_chunk_output_ref(xh, acum, bmat, cmat, entering, chunk, mm=mm)


# The backward of the SSD scan, stage by stage as the CUDA kernels
# (csrc/ssd_scan_bwd.cu) compute it, from the forward's entering states and
# cumulative decays: each chunk's own term of G (the gradient reaching the
# state a chunk leaves), the reverse carry over the chunks, then per chunk
# the intra-chunk terms (dX, the C·Bᵀ gradient E's products, dacum from
# dW ∘ W) and the state terms (through the entering and leaving states),
# and da, the reverse cumulative sum of dacum in the chunk.  ``mm`` as
# above.  Layouts: chunked (B, nc, H, L, ·), rows past S zeros.

def ssd_bwd_local_ref(dy: torch.Tensor, acum: torch.Tensor,
                      cmat: torch.Tensor, chunk: int = 128, *,
                      mm=torch.matmul) -> torch.Tensor:
    """Each chunk's own term of G: ``dYᵀ·diag(exp(acum))·C`` → (B, nc, H,
    P, N)."""
    dy_c = _ssd_chunks(dy, chunk).permute(0, 1, 3, 4, 2)  # (B,nc,H,P,L)
    c_c = _ssd_chunks(cmat, chunk)[:, :, None]            # (B,nc,1,L,N)
    return mm(dy_c * torch.exp(acum)[..., None, :], c_c)


def ssd_bwd_pass_ref(local: torch.Tensor, acum: torch.Tensor) -> torch.Tensor:
    """``G_{c−1} = local_c + exp(acum_L^c)·G_c`` over the chunks in reverse
    order from zero: local (B, nc, H, P, N) → G of each chunk, zeros for
    the last."""
    tot = torch.exp(acum[..., -1])[..., None, None]       # (B,nc,H,1,1)
    g = torch.zeros_like(local[:, 0])
    out = torch.empty_like(local)
    for c in reversed(range(local.shape[1])):
        out[:, c] = g
        g = local[:, c] + tot[:, c] * g
    return out


def _ssd_decay(acum: torch.Tensor) -> torch.Tensor:
    """D[q, k] = exp(acum_q − acum_k) on k ≤ q, the exponent masked to
    −1e30 off the triangle before ``exp``."""
    chunk = acum.shape[-1]
    ltri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=acum.device))
    rel = acum[..., :, None] - acum[..., None, :]
    return torch.exp(torch.where(ltri, rel, -1e30))


def ssd_bwd_intra_ref(xh: torch.Tensor, acum: torch.Tensor,
                      bmat: torch.Tensor, cmat: torch.Tensor,
                      dy: torch.Tensor, grads: torch.Tensor, chunk: int = 128,
                      *, mm=torch.matmul):
    """The intra-chunk terms: ``dX = Wᵀ·dY + diag(dk)·B·Gᵀ`` (B, nc, H, L,
    P), ``E = Σ_h (dY·Xᵀ) ∘ D``'s products ``Eᵀ·C`` (dB) and ``E·B`` (dC)
    (B, nc, L, N), and ``rowsum − colsum`` of ``dW ∘ W`` (B, nc, H, L);
    W = (C·Bᵀ) ∘ D, dk = exp(acum_L − acum), G the chunks' gradients."""
    x_c = _ssd_chunks(xh, chunk).transpose(2, 3)          # (B,nc,H,L,P)
    dy_c = _ssd_chunks(dy, chunk).transpose(2, 3)
    b_c = _ssd_chunks(bmat, chunk)                        # (B,nc,L,N)
    c_c = _ssd_chunks(cmat, chunk)
    dec = _ssd_decay(acum)                                # (B,nc,H,L,L)
    w = mm(c_c, b_c.transpose(-1, -2))[:, :, None] * dec
    dk = torch.exp(acum[..., -1:] - acum)                 # (B,nc,H,L)
    dx = (dk[..., None] * mm(b_c[:, :, None], grads.transpose(-1, -2))
          + mm(w.transpose(-1, -2), dy_c))
    dw = mm(dy_c, x_c.transpose(-1, -2))                  # (B,nc,H,L,L)
    dww = dw * w
    dacum = dww.sum(-1) - dww.sum(-2)
    e = (dw * dec).sum(2)                                 # (B,nc,L,L)
    return dx, mm(e.transpose(-1, -2), c_c), mm(e, b_c), dacum


def ssd_bwd_state_ref(xh: torch.Tensor, acum: torch.Tensor,
                      bmat: torch.Tensor, cmat: torch.Tensor,
                      dy: torch.Tensor, states: torch.Tensor,
                      grads: torch.Tensor, chunk: int = 128, *,
                      mm=torch.matmul):
    """The terms through the states: ``diag(exp(acum))·dY·h`` (dC) and
    ``diag(dk)·X·G`` (dB), each summed over the heads (B, nc, L, N), and
    their part of dacum (B, nc, H, L): the row dots with C and −B, and
    ``⟨G, h_out⟩`` at the chunk's last row (h_out the state entering the
    next chunk)."""
    x_c = _ssd_chunks(xh, chunk).transpose(2, 3)          # (B,nc,H,L,P)
    dy_c = _ssd_chunks(dy, chunk).transpose(2, 3)
    b_c = _ssd_chunks(bmat, chunk)[:, :, None]            # (B,nc,1,L,N)
    c_c = _ssd_chunks(cmat, chunk)[:, :, None]
    dk = torch.exp(acum[..., -1:] - acum)
    dcs = torch.exp(acum)[..., None] * mm(dy_c, states)   # (B,nc,H,L,N)
    dbs = dk[..., None] * mm(x_c, grads)
    dacum = (dcs * c_c).sum(-1) - (dbs * b_c).sum(-1)
    h_out = torch.cat([states[:, 1:], torch.zeros_like(states[:, :1])], 1)
    dacum[..., -1] += (grads * h_out).sum((-1, -2))
    return dbs.sum(2), dcs.sum(2), dacum


def ssd_bwd_chunks_ref(xh: torch.Tensor, acum: torch.Tensor,
                       bmat: torch.Tensor, cmat: torch.Tensor,
                       dy: torch.Tensor, states: torch.Tensor,
                       grads: torch.Tensor, chunk: int = 128, *,
                       mm=torch.matmul):
    """``(dxh, da, db, dc)`` from the chunks' gradients ``grads`` (what
    :func:`ssd_bwd_pass_ref` returns): the intra-chunk and state terms,
    and da the reverse cumulative sum of dacum in each chunk."""
    b, s, h, p = xh.shape
    dx, db, dc, dacum = ssd_bwd_intra_ref(xh, acum, bmat, cmat, dy, grads,
                                          chunk, mm=mm)
    db_s, dc_s, dacum_s = ssd_bwd_state_ref(xh, acum, bmat, cmat, dy, states,
                                            grads, chunk, mm=mm)
    da = torch.flip(torch.cumsum(torch.flip(dacum + dacum_s, (-1,)), -1),
                    (-1,))                                # (B,nc,H,L)
    return (dx.transpose(2, 3).reshape(b, -1, h, p)[:, :s],
            da.transpose(2, 3).reshape(b, -1, h)[:, :s],
            (db + db_s).reshape(b, -1, bmat.shape[-1])[:, :s],
            (dc + dc_s).reshape(b, -1, cmat.shape[-1])[:, :s])


def ssd_scan_bwd_ref(xh: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                     cmat: torch.Tensor, dy: torch.Tensor, chunk: int = 128,
                     *, states: torch.Tensor | None = None,
                     acum: torch.Tensor | None = None, mm=torch.matmul):
    """The backward of :func:`ssd_scan_ref` (fp32): the gradients ``(dxh,
    da, db, dc)`` that ``dy`` (B, S, H, P) sends to xh, a, bmat and cmat,
    through the stages above.  ``states`` and ``acum`` are the forward's
    (``ssd_scan_ref(..., return_state=True)``), recomputed when not
    given."""
    xh, a, bmat, cmat, dy = (t.to(torch.float32)
                             for t in (xh, a, bmat, cmat, dy))
    if states is None or acum is None:
        acum, own = ssd_chunk_states_ref(xh, a, bmat, chunk, mm=mm)
        states = ssd_state_pass_ref(own, acum)
    grads = ssd_bwd_pass_ref(
        ssd_bwd_local_ref(dy, acum, cmat, chunk, mm=mm), acum)
    return ssd_bwd_chunks_ref(xh, acum, bmat, cmat, dy, states, grads, chunk,
                              mm=mm)
