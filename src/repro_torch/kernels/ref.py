"""Plain PyTorch versions of the FL data-plane kernels.

These are the semantics of record on the port's side, as
``repro.kernels.ref`` is on the reference's: the CPU path runs them, the
tests hold them to the JAX package, and ``chip_smoke.py`` holds each CUDA
kernel to them on the card.  They run on any device, but nothing on the
main path calls them with a CUDA tensor: there the wrappers in
``repro_torch.kernels.diffusion`` launch the hand-written kernels.
"""
from __future__ import annotations

import torch

__all__ = ["mix_aggregate_ref", "stc_compress_ref", "stc_rows_ref",
           "stc_rows_threshold", "stc_rows_reduce_ref", "stc_rows_apply_ref"]


def mix_aggregate_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Eq. (10)/(11) weighted reduction on a flattened client-stacked block:
    ``out[g, f] = Σ_c w[g, c]·x[c, f]``.  x (C, F); w (G, C) → (G, F) fp32."""
    return torch.einsum("gc,cf->gf", w.to(torch.float32),
                        x.to(torch.float32))


def stc_compress_ref(x: torch.Tensor, sparsity: float) -> torch.Tensor:
    """Sparse ternary compression (Sattler et al.): keep exactly the top-k
    entries by magnitude and replace them with ``sign(x)·mean(|top-k|)``."""
    flat = x.reshape(-1).to(torch.float32)
    k = max(1, int(flat.numel() * sparsity))
    topv, topi = torch.topk(flat.abs(), k)
    out = torch.zeros_like(flat)
    out[topi] = torch.sign(flat[topi]) * topv.mean()
    return out.reshape(x.shape).to(x.dtype)


def stc_rows_ref(x: torch.Tensor, ref_row: torch.Tensor, mask: torch.Tensor,
                 sparsity: float) -> torch.Tensor:
    """Masked per-row STC against a shared reference row: row ``c`` becomes
    ``ref + STC(x_c − ref)`` where ``mask[c]``, else passes through.

    Exactly ``k = max(1, int(n·sparsity))`` survivors per row, chosen by
    ``topk`` — the semantics of ``repro.kernels.ref.stc_rows_ref``."""
    ref32 = ref_row.to(torch.float32)
    delta = x.to(torch.float32) - ref32[None, :]
    k = max(1, int(x.shape[1] * sparsity))
    topv, topi = torch.topk(delta.abs(), k, dim=1)
    mu = topv.mean(dim=1, keepdim=True)
    tern = torch.zeros_like(delta).scatter(
        1, topi, torch.sign(torch.gather(delta, 1, topi)) * mu)
    comp = (ref32[None, :] + tern).to(x.dtype)
    return torch.where(mask.reshape(-1, 1).to(torch.bool), comp, x)


def stc_rows_threshold(x: torch.Tensor, ref_row: torch.Tensor,
                       sparsity: float) -> torch.Tensor:
    """τ_c, the k-th largest ``|x_c − ref|`` of every row (C,) — computed
    outside the kernels, as the reference leaves it to an XLA sort."""
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
                       cnt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Plain version of the apply kernel: ternarize at τ_c with
    ``μ_c = ssum_c / max(cnt_c, 1)`` and blend; unmasked rows pass through."""
    r = ref_row.to(torch.float32)[None, :]
    d = x.to(torch.float32) - r
    mu = (ssum / torch.clamp(cnt, min=1.0)).reshape(-1, 1)
    tern = torch.where(d.abs() >= thr.reshape(-1, 1), torch.sign(d) * mu, 0.0)
    return torch.where(mask.reshape(-1, 1) != 0, (r + tern).to(x.dtype), x)
