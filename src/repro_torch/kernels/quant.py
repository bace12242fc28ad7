"""Int8 absmax quantization on Hopper — the adapter hop wire.

Counterpart of ``repro.kernels.quant``.  The FedDif hop payload (the
trainable-adapter view of a client model, :mod:`repro_torch.fl.adapters`)
is cut into ``QUANT_BLOCK``-element row-blocks, and each row moves as int8
codes plus one fp32 absmax scale:

* :func:`quant_pack_cuda` — per row, ``scale = max(absmax, 1e-12)·f32(1/127)``
  and ``q = clip(round_half_even(x/scale), ±127)``; x (R, B) fp32 → (q (R, B)
  int8, scale (R,) fp32).  Replaces ``repro/kernels/quant.py::_pack_kernel``
  (``quant_pack_pallas``);
* :func:`quant_unpack_cuda` — ``q·scale`` → (R, B) fp32.  Replaces
  ``_unpack_kernel`` (``quant_unpack_pallas``).

Both are hand-written CUDA C++ for ``sm_90a`` (``csrc/quant.cu``), built by
``nvcc`` and bound with ``ctypes`` (:mod:`repro_torch.kernels.build`), and
equal the plain versions (``kernels/ref.py``) bit for bit.  Each wrapper
takes CUDA tensors only, checks them, allocates its outputs, launches on
PyTorch's current stream, raises on a launch error and adds one to its entry
of :data:`~repro_torch.kernels.launch.LAUNCHES`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launch import LAUNCHES, check_tensor, int32, raise_on

__all__ = ["QUANT_BLOCK", "quant_pack_cuda", "quant_unpack_cuda"]

#: Elements per quantization row-block (2 KB of fp32), as the reference's.
QUANT_BLOCK = 512


def quant_pack_cuda(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (R, B) fp32 → (q (R, B) int8, scale (R,) fp32), absmax per row."""
    check_tensor(x, "x", 2)
    r, b = x.shape
    q = torch.empty((r, b), device=x.device, dtype=torch.int8)
    scale = torch.empty((r,), device=x.device, dtype=torch.float32)
    lib = build.load("quant")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_quant_pack_f32(x.data_ptr(), q.data_ptr(),
                                       scale.data_ptr(), int32(r, "R"),
                                       int32(b, "B"), stream)
    raise_on(err, "quant_pack")
    LAUNCHES["quant_pack"] += 1
    return q, scale


def quant_unpack_cuda(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(q (R, B) int8, scale (R,) fp32) → (R, B) fp32, ``q·scale``."""
    check_tensor(q, "q", 2, torch.int8)
    check_tensor(scale, "scale", 1)
    r, b = q.shape
    if scale.shape[0] != r or scale.device != q.device:
        raise ValueError(f"scale {tuple(scale.shape)} does not match q "
                         f"{tuple(q.shape)}")
    out = torch.empty((r, b), device=q.device, dtype=torch.float32)
    lib = build.load("quant")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_quant_unpack_f32(q.data_ptr(), scale.data_ptr(),
                                         out.data_ptr(), int32(r, "R"),
                                         int32(b, "B"), stream)
    raise_on(err, "quant_unpack")
    LAUNCHES["quant_unpack"] += 1
    return out
