"""What every CUDA kernel wrapper of the port shares: argument checks, the
launch-error check and the launch counters.

:data:`LAUNCHES` holds one count per kernel; a wrapper adds one to its
entry each time it launches its kernel, and nowhere else, so a run can show
which kernels its main path went through (``chip_smoke.py`` zeroes the
counts with :func:`reset_launch_counts` before a run and reads them after).
"""
from __future__ import annotations

import torch

__all__ = ["LAUNCHES", "reset_launch_counts", "check_tensor", "int32",
           "raise_on"]

#: Launches of each kernel since the last :func:`reset_launch_counts`.
LAUNCHES = {"mix_aggregate": 0, "mix_tree": 0, "stc_rows_reduce": 0, "stc_rows_apply": 0,
            "stc_rows_fused": 0, "stc_reduce": 0, "stc_apply": 0,
            "stc_fused": 0, "dol_bid_scores": 0, "bid_value_fuse": 0,
            "bid_fused": 0,
            "quant_pack": 0, "quant_unpack": 0, "quant_roundtrip": 0,
            "flash_attention": 0, "flash_attention_bwd": 0,
            "ssm_scan": 0, "ssm_scan_bwd": 0, "ssd_scan_state": 0,
            "ssd_scan_pass": 0, "ssd_scan": 0, "ssd_scan_bwd_local": 0,
            "ssd_scan_bwd_pass": 0, "ssd_scan_bwd_main": 0,
            "ssd_scan_bwd": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def check_tensor(t: torch.Tensor, name: str, ndim: int,
                 dtype: torch.dtype = torch.float32) -> None:
    """Raise unless ``t`` is a contiguous ``ndim``-d CUDA tensor of
    ``dtype``."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {ndim}-d {dtype} "
                         f"tensor, got {t.dtype} {tuple(t.shape)} "
                         f"contiguous={t.is_contiguous()}")


def int32(v: int, name: str) -> int:
    """``v`` if it fits the kernels' int32 sizes, else raise."""
    if not 0 <= v < 2 ** 31:
        raise ValueError(f"{name}={v} does not fit the kernel's int32")
    return v


def raise_on(err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError()``)."""
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")
