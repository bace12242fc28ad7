"""The Mamba-2 SSD chunk scan on Hopper.

Counterpart of ``repro.kernels.ssd_scan``.  :func:`ssd_scan_cuda` computes
what ``_ssd_kernel`` (``ssd_scan_pallas``) computes from a zero state: for
xh (B, S, H, P), per-step log decays a (B, S, H) and projections b, c
(B, S, N), all fp32, the output y (B, S, H, P) of
``h_t = exp(a_t)·h_{t−1} + xh_t ⊗ b_t``, ``y_t = h_t · c_t``, in the
chunked form (intra-chunk ``(C·Bᵀ ∘ decay-tril)·X`` plus the carried
state) with chunk length ``chunk``; S need not be a multiple of it.  The
kernel is hand-written CUDA C++ for ``sm_90a`` (``csrc/ssd_scan.cu``): one
launch forms each chunk's C·Bᵀ once per batch row into a scratch tensor the
wrapper allocates, a second gives one block to (b, h, 16 rows of P) and
walks the chunks in order; the plain version is
:func:`repro_torch.kernels.ref.ssd_scan_ref`.  The wrapper takes CUDA
tensors only, checks them, allocates the output, launches on PyTorch's
current stream, raises on a launch error and adds one to each launch's
count: ``LAUNCHES["ssd_scan_cb"]`` (the C·Bᵀ kernel) and
``LAUNCHES["ssd_scan"]`` (the scan kernel).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launch import LAUNCHES, check_tensor, int32, raise_on

__all__ = ["ssd_scan_cuda", "SMEM_LIMIT"]

#: Shared memory one block may use on an H100 (bytes).
SMEM_LIMIT = 232_448


def ssd_scan_cuda(xh: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                  cmat: torch.Tensor, *, chunk: int = 128) -> torch.Tensor:
    """xh (B, S, H, P), a (B, S, H), b/c (B, S, N) fp32 → y (B, S, H, P)."""
    check_tensor(xh, "xh", 4)
    check_tensor(a, "a", 3)
    check_tensor(bmat, "bmat", 3)
    check_tensor(cmat, "cmat", 3)
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    if (a.shape != (b, s, h) or bmat.shape != (b, s, n)
            or cmat.shape != bmat.shape
            or {t.device for t in (a, bmat, cmat)} != {xh.device}):
        raise ValueError(f"ssd_scan shapes do not match: xh {tuple(xh.shape)}"
                         f", a {tuple(a.shape)}, b {tuple(bmat.shape)}, "
                         f"c {tuple(cmat.shape)}")
    if b > 65535 or h > 65535 or s == 0 or chunk < 1:
        raise ValueError(f"ssd_scan kernel takes B, H <= 65535, S > 0 and "
                         f"chunk >= 1, got {tuple(xh.shape)}, chunk {chunk}")
    lib = build.load("ssd_scan")
    smem = lib.repro_ssd_scan_smem_bytes(int32(chunk, "chunk"), int32(n, "N"))
    if smem > SMEM_LIMIT:
        raise ValueError(f"ssd_scan at chunk {chunk}, N {n} needs {smem} "
                         f"bytes of shared memory (> {SMEM_LIMIT})")
    if b * -(-s // chunk) > 65535:
        raise ValueError(f"ssd_scan kernel takes B·⌈S/chunk⌉ <= 65535, got "
                         f"{tuple(xh.shape)}, chunk {chunk}")
    y = torch.empty_like(xh)
    cb = torch.empty((b, -(-s // chunk), chunk, chunk), device=xh.device,
                     dtype=torch.float32)
    with torch.cuda.device(xh.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_ssd_scan_f32(
            xh.data_ptr(), a.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
            cb.data_ptr(), y.data_ptr(), int32(b, "B"), int32(s, "S"),
            int32(h, "H"), int32(p, "P"), n, chunk, stream)
    raise_on(err, "ssd_scan")
    LAUNCHES["ssd_scan_cb"] += 1
    LAUNCHES["ssd_scan"] += 1
    return y
