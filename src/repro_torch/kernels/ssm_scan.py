"""The Mamba-1 selective scan on Hopper.

Counterpart of ``repro.kernels.ssm_scan``.  :func:`ssm_scan_cuda` computes
what ``_scan_kernel`` (``ssm_scan_pallas``) computes: the diagonal linear
recurrence ``h_t = da_t ⊙ h_{t−1} + dbx_t`` from ``h = 0`` over (B, S, D, N)
fp32 inputs, returning every state.  The kernel is hand-written CUDA C++ for
``sm_90a`` (``csrc/ssm_scan.cu``), one thread per (b, d, n) channel, and
rounds as the plain version :func:`repro_torch.kernels.ref.ssm_scan_ref`
does (a multiply, then an add), so the two agree bit for bit.  The wrapper
takes CUDA tensors only, checks them, allocates the output, launches on
PyTorch's current stream, raises on a launch error and adds one to
``LAUNCHES["ssm_scan"]``.

:func:`ssm_scan_bwd_cuda` is its backward (no TPU counterpart: the
reference differentiates its inline XLA scan): from ``da``, the forward's
states ``hs`` and their gradient ``dhs``, the gradients ``(dda, ddbx)``,
one thread per channel in reverse time, bit for bit
``ref.ssm_scan_bwd_ref``; each call adds one to
``LAUNCHES["ssm_scan_bwd"]``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launch import LAUNCHES, check_tensor, int32, raise_on

__all__ = ["ssm_scan_cuda", "ssm_scan_bwd_cuda"]


def ssm_scan_cuda(da: torch.Tensor, dbx: torch.Tensor) -> torch.Tensor:
    """da, dbx (B, S, D, N) fp32 → all states (B, S, D, N) fp32."""
    check_tensor(da, "da", 4)
    check_tensor(dbx, "dbx", 4)
    if dbx.shape != da.shape or dbx.device != da.device:
        raise ValueError(f"dbx {tuple(dbx.shape)} does not match da "
                         f"{tuple(da.shape)}")
    b, s, d, n = da.shape
    if b > 65535 or s == 0:
        raise ValueError(f"ssm_scan kernel takes B <= 65535 and S > 0, got "
                         f"{tuple(da.shape)}")
    hs = torch.empty_like(da)
    lib = build.load("ssm_scan")
    with torch.cuda.device(da.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_ssm_scan_f32(da.data_ptr(), dbx.data_ptr(),
                                     hs.data_ptr(), int32(b, "B"),
                                     int32(s, "S"), int32(d * n, "D·N"),
                                     stream)
    raise_on(err, "ssm_scan")
    LAUNCHES["ssm_scan"] += 1
    return hs


def ssm_scan_bwd_cuda(da: torch.Tensor, hs: torch.Tensor,
                      dhs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """da, hs, dhs (B, S, D, N) fp32 → (dda, ddbx) (B, S, D, N) fp32."""
    for name, t in (("da", da), ("hs", hs), ("dhs", dhs)):
        check_tensor(t, name, 4)
        if t.shape != da.shape or t.device != da.device:
            raise ValueError(f"{name} {tuple(t.shape)} does not match da "
                             f"{tuple(da.shape)}")
    b, s, d, n = da.shape
    if b > 65535 or s == 0:
        raise ValueError(f"ssm_scan backward takes B <= 65535 and S > 0, "
                         f"got {tuple(da.shape)}")
    dda = torch.empty_like(da)
    ddbx = torch.empty_like(da)
    lib = build.load("ssm_scan")
    with torch.cuda.device(da.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_ssm_scan_bwd_f32(
            da.data_ptr(), hs.data_ptr(), dhs.data_ptr(), dda.data_ptr(),
            ddbx.data_ptr(), int32(b, "B"), int32(s, "S"),
            int32(d * n, "D·N"), stream)
    raise_on(err, "ssm_scan_bwd")
    LAUNCHES["ssm_scan_bwd"] += 1
    return dda, ddbx
