"""Device selection for the port's entry points.

Entry points default to the CUDA device.  The CPU is used only when the
caller asks for it (``device="cpu"``, as the tests do); a missing GPU is an
error, never a silent fallback.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "set_full_fp32"]


def set_full_fp32() -> None:
    """Keep float32 products and convolutions in full float32 on the card.

    The JAX reference computes in full fp32; cuDNN's fp32 convolution and
    cuBLAS's fp32 GEMM may otherwise drop to TF32 (about three decimal
    digits), which breaks parity for the ``cnn`` task."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the CUDA device; raise if it is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        set_full_fp32()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
