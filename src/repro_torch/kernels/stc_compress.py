"""Whole-tensor sparse ternary compression on Hopper — the host plane's STC.

Counterpart of ``repro.kernels.stc_compress``.  STC (Sattler et al., the
paper's Table-II compression baseline) maps a tensor to
``μ·sign(x)·1[|x| ≥ τ]``, τ the k-th largest magnitude and μ the mean
magnitude of the survivors.  :func:`stc_compress_cuda` takes one of two
routes on the card:

* n ≤ :data:`N_FUSED` (every leaf of the FL tasks): :func:`stc_fused_cuda`,
  one launch of a thread-block cluster that selects τ by radix select on
  chip, reduces over distributed shared memory and applies — x read once,
  no global scratch.  It replaces ``_reduce_kernel`` and ``_apply_kernel``
  together with the XLA sort the reference leaves τ to;
* larger n: τ by ``torch.topk(|x|, k).values[k − 1]``
  (:func:`~repro_torch.kernels.ref.stc_threshold`), then
  :func:`stc_reduce_cuda` — ``(Σ|x|·1[|x| ≥ τ], Σ1[|x| ≥ τ])``, an fp32 sum
  and an int32 count, and the prefix of each block's ties (``|x| = τ``);
  replaces ``repro/kernels/stc_compress.py::_reduce_kernel``
  (``stc_reduce_pallas``) — and :func:`stc_apply_cuda` — ``μ·sign(x)`` on
  exactly k survivors, 0 elsewhere, with the exact-k
  ``μ = (sum − (count − k)·τ) / k`` formed on the device from the reduce's
  outputs (:func:`~repro_torch.kernels.ref.stc_mu_ref`); replaces
  ``_apply_kernel`` (``stc_apply_pallas``).  No host read sits between them.

All three kernels are hand-written CUDA C++ for ``sm_90a``
(``csrc/stc_compress.cu``), built by ``nvcc`` and bound with ``ctypes``
(:mod:`repro_torch.kernels.build`); the source says what bounds them and how
their sums stay deterministic.  The fused kernel also runs per row for the
fleet plane's masked STC (:func:`~repro_torch.kernels.diffusion.
stc_rows_fused_cuda`, from the same library).

The survivors are the ones ``lax.top_k`` keeps, as in the plain version of
record, ``kernels/ref.py::stc_compress_ref``: every ``|x| > τ`` plus the
first ``k − count_{>τ}`` entries with ``|x| = τ`` in index order.  (The
Pallas kernels keep every ``|x| ≥ τ``.)

Each wrapper takes CUDA tensors only, checks them, allocates its outputs
with ``torch.empty``, launches on PyTorch's current stream, raises on a
launch error and adds one to its entry of
:data:`~repro_torch.kernels.launch.LAUNCHES`.  The reduce's scratch (the
per-block partials and the last-block ticket, which the kernel leaves at
0) is allocated once per device and reused, so calls on one device must
share a stream, as the port's do.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launch import LAUNCHES, check_tensor, raise_on
from repro_torch.kernels.ref import stc_threshold

__all__ = ["N_FUSED", "stc_fused_cuda", "stc_reduce_cuda", "stc_apply_cuda",
           "stc_compress_cuda"]

#: Largest tensor :func:`stc_fused_cuda` takes: a cluster of 8 blocks of
#: 16384 elements (``repro_stc_fused_max_n`` in ``csrc/stc_compress.cu``).
N_FUSED = 8 * 16384

#: Reduce scratch per device: (partial sums, partial counts, ticket).
_SCRATCH: dict[torch.device, tuple[torch.Tensor, ...]] = {}


def _reduce_scratch(lib, dev: torch.device) -> tuple[torch.Tensor, ...]:
    if dev not in _SCRATCH:
        blocks = lib.repro_stc_reduce_max_blocks()
        _SCRATCH[dev] = (
            torch.empty((blocks,), device=dev, dtype=torch.float32),
            torch.empty((blocks,), device=dev, dtype=torch.int32),
            torch.zeros((1,), device=dev, dtype=torch.int32))
    return _SCRATCH[dev]


def _check_flat(flat: torch.Tensor, thr: torch.Tensor) -> int:
    check_tensor(flat, "flat", 1)
    check_tensor(thr, "thr", 1)
    n = flat.shape[0]
    if n == 0 or thr.shape[0] != 1 or thr.device != flat.device:
        raise ValueError(f"flat {tuple(flat.shape)} must be non-empty and thr "
                         f"{tuple(thr.shape)} one element on its device")
    return n


def stc_reduce_cuda(flat: torch.Tensor, thr: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Survivor sum ``Σ|x|·1[|x| ≥ τ]`` (1,) fp32 and count (1,) int32 of a
    flat fp32 tensor at the threshold ``thr`` (1,), and the ties'
    per-block prefix for :func:`stc_apply_cuda` (int32, its total last)."""
    n = _check_flat(flat, thr)
    lib = build.load("stc_compress")
    dev = flat.device
    part_sum, part_cnt, ticket = _reduce_scratch(lib, dev)
    ssum = torch.empty((1,), device=dev, dtype=torch.float32)
    cnt = torch.empty((1,), device=dev, dtype=torch.int32)
    ties = torch.empty((part_sum.shape[0] + 1,), device=dev,
                       dtype=torch.int32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_stc_reduce_f32(
            flat.data_ptr(), thr.data_ptr(), part_sum.data_ptr(),
            part_cnt.data_ptr(), ties.data_ptr(), ticket.data_ptr(),
            ssum.data_ptr(), cnt.data_ptr(), n, stream)
    raise_on(err, "stc_reduce")
    LAUNCHES["stc_reduce"] += 1
    return ssum, cnt, ties


def stc_apply_cuda(flat: torch.Tensor, thr: torch.Tensor, ssum: torch.Tensor,
                   cnt: torch.Tensor, ties: torch.Tensor,
                   k: int) -> torch.Tensor:
    """``μ·sign(x)`` on the k survivors (every ``|x| > τ``, then the ties
    in index order), 0 elsewhere, with ``μ = (ssum − (cnt − k)·τ) / k``
    formed on the device: flat (n,) fp32, thr and ssum (1,) fp32, cnt (1,)
    int32, ties the reduce's tie prefix, k the entries STC keeps
    (1 ≤ k ≤ n) → (n,) fp32."""
    n = _check_flat(flat, thr)
    check_tensor(ssum, "ssum", 1)
    check_tensor(cnt, "cnt", 1, torch.int32)
    check_tensor(ties, "ties", 1, torch.int32)
    if not 1 <= k <= n:
        raise ValueError(f"k={k} must lie in [1, {n}]")
    out = torch.empty_like(flat)
    lib = build.load("stc_compress")
    if ties.shape[0] != lib.repro_stc_reduce_max_blocks() + 1:
        raise ValueError(f"ties {tuple(ties.shape)} is not stc_reduce_cuda's")
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_stc_apply_f32(
            flat.data_ptr(), thr.data_ptr(), ssum.data_ptr(), cnt.data_ptr(),
            ties.data_ptr(), k, out.data_ptr(), n, stream)
    raise_on(err, "stc_apply")
    LAUNCHES["stc_apply"] += 1
    return out


def stc_fused_cuda(flat: torch.Tensor, k: int
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """STC of a flat fp32 tensor of n ≤ :data:`N_FUSED` elements in one
    launch: ``(out, thr, ssum, cnt)`` — out (n,) fp32, ``μ·sign(x)`` on the
    k survivors (every ``|x| > τ``, then the ties in index order); thr (1,)
    fp32, τ, the k-th largest ``|x|``, selected on the card; ssum (1,) fp32
    and cnt (1,) int32, the sum and count of ``|x| ≥ τ``, from which the
    kernel forms ``μ = (ssum − (cnt − k)·τ) / k`` (1 ≤ k ≤ n)."""
    check_tensor(flat, "flat", 1)
    n = flat.shape[0]
    if not 1 <= n <= N_FUSED:
        raise ValueError(f"flat {tuple(flat.shape)} must hold 1 to "
                         f"{N_FUSED} elements")
    if not 1 <= k <= n:
        raise ValueError(f"k={k} must lie in [1, {n}]")
    lib = build.load("stc_compress")
    dev = flat.device
    out = torch.empty_like(flat)
    thr = torch.empty((1,), device=dev, dtype=torch.float32)
    ssum = torch.empty((1,), device=dev, dtype=torch.float32)
    cnt = torch.empty((1,), device=dev, dtype=torch.int32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_stc_fused_f32(
            flat.data_ptr(), out.data_ptr(), thr.data_ptr(), ssum.data_ptr(),
            cnt.data_ptr(), n, k, stream)
    raise_on(err, "stc_fused")
    LAUNCHES["stc_fused"] += 1
    return out, thr, ssum, cnt


def stc_compress_cuda(x: torch.Tensor, sparsity: float) -> torch.Tensor:
    """STC of one tensor on the card: one :func:`stc_fused_cuda` launch for
    n ≤ :data:`N_FUSED`, else τ by ``torch.topk`` and the reduce and apply
    kernels, with no host read between them.  Any shape and float dtype
    in, the same out."""
    flat = x.reshape(-1).to(torch.float32).contiguous()
    k = max(1, int(flat.numel() * sparsity))
    if flat.numel() <= N_FUSED:
        out = stc_fused_cuda(flat, k)[0]
    else:
        thr = stc_threshold(flat, sparsity)
        ssum, cnt, ties = stc_reduce_cuda(flat, thr)
        out = stc_apply_cuda(flat, thr, ssum, cnt, ties, k)
    return out.reshape(x.shape).to(x.dtype)
