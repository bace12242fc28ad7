"""Causal / sliding-window attention on Hopper — the LM zoo's prefill.

Counterpart of ``repro.kernels.flash_attention``.
:func:`flash_attention_cuda` computes what ``_attn_kernel``
(``flash_attention_pallas``) computes: online-softmax attention of q
(B, Sq, H, D) against k/v (B, Sk, H, D) in bf16 or fp32, with q
right-aligned to the end of the keys, causal and sliding-window masks,
fp32 softmax, and 0 for a row that sees no key; the output has q's dtype.
Heads are pre-repeated for GQA by the caller.  The kernel is hand-written
CUDA C++ for ``sm_90a`` (``csrc/flash_attention.cu``), built by ``nvcc`` and
bound with ``ctypes``: bf16 runs on Hopper's warpgroup tensor cores
(``wgmma``), fed by TMA loads through an ``mbarrier``-guarded ring, with a
producer warpgroup and two consumer warpgroups; it takes D in {64, 80, 128}
(the zoo's calls), q, k, v and o 16-byte aligned (TMA) and scale > 0.  fp32
runs as FMAs on the CUDA cores and takes D % 4 == 0 up to 128.  The plain
version is :func:`repro_torch.kernels.ref.flash_attention_ref`.  The
wrapper takes CUDA tensors only, checks them, allocates the output,
launches on PyTorch's current stream, raises on a launch error and adds one
to ``LAUNCHES["flash_attention"]``.

:func:`flash_attention_bwd_cuda` is its backward (``csrc/
flash_attention_bwd.cu``, no TPU counterpart: the reference differentiates
its inline XLA attention): from q, k, v, the forward's output o and the
gradient do, the three gradients in the inputs' dtype, by three launches
(row statistics, dK/dV over key tiles, dQ over query tiles) with no float
atomics, so two calls give the same bits.  It takes what the forward
takes; its plain version is ``ref.flash_attention_bwd_ref``.  Each call
adds one to ``LAUNCHES["flash_attention_bwd"]``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launch import LAUNCHES, check_tensor, int32, raise_on

__all__ = ["flash_attention_cuda", "flash_attention_bwd_cuda", "HEAD_DIM_MAX",
           "BF16_HEAD_DIMS"]

#: Largest head dim the fp32 kernel takes (it also needs D % 4 == 0).
HEAD_DIM_MAX = 128
#: Head dims the bf16 (tensor-core) kernel takes.
BF16_HEAD_DIMS = (64, 80, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int | None, scale: float | None,
           like_q: tuple = ()) -> float:
    """Raise unless the kernels take these operands (``like_q``: further
    (name, tensor) pairs shaped as q); return the scale."""
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention takes bf16 or fp32, got {q.dtype}")
    check_tensor(q, "q", 4, q.dtype)
    check_tensor(k, "k", 4, q.dtype)
    check_tensor(v, "v", 4, q.dtype)
    for name, t in like_q:
        check_tensor(t, name, 4, q.dtype)
        if t.shape != q.shape or t.device != q.device:
            raise ValueError(f"{name} {tuple(t.shape)} does not match q "
                             f"{tuple(q.shape)}")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if (k.shape != (b, sk, h, d) or v.shape != k.shape
            or k.device != q.device or v.device != q.device):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if d % 4 or d > HEAD_DIM_MAX or b * h > 65535 or sq == 0 or sk == 0:
        raise ValueError(f"flash_attention kernel takes D % 4 == 0, "
                         f"D <= {HEAD_DIM_MAX}, B·H <= 65535 and non-empty "
                         f"sequences, got {tuple(q.shape)} / {tuple(k.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    return 1.0 / d ** 0.5 if scale is None else float(scale)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int | None = None,
                         scale: float | None = None) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Sk, H, D) → (B, Sq, H, D) in q's dtype."""
    scale = _check(q, k, v, window, scale)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    out = torch.empty_like(q)
    if q.dtype == torch.bfloat16:
        offsets = [t.data_ptr() % 16 for t in (q, k, v, out)]
        if d not in BF16_HEAD_DIMS or any(offsets) or not scale > 0.0:
            raise ValueError(
                f"the bf16 flash_attention kernel takes D in "
                f"{BF16_HEAD_DIMS}, 16-byte aligned q/k/v/o and scale > 0, "
                f"got D={d}, q/k/v/o at {offsets} bytes past 16, "
                f"scale={scale}")
    lib = build.load("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], int32(b, "B"), int32(h, "H"), int32(sq, "Sq"),
            int32(sk, "Sk"), int32(d, "D"), scale, int(bool(causal)),
            0 if window is None else int32(window, "window"), stream)
    raise_on(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, *, causal: bool = True,
                             window: int | None = None,
                             scale: float | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The gradients (dq, dk, dv) of :func:`flash_attention_cuda` at
    (q, k, v), given its output ``o`` and the gradient ``do`` reaching it
    (both shaped and typed as q)."""
    scale = _check(q, k, v, window, scale, (("o", o), ("do", do)))
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if q.dtype == torch.bfloat16 and d not in BF16_HEAD_DIMS:
        raise ValueError(f"the bf16 flash_attention backward takes D in "
                         f"{BF16_HEAD_DIMS}, got D={d}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    stats = torch.empty((2, b, h, sq), dtype=torch.float32, device=q.device)
    lib = build.load("flash_attention_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            stats[0].data_ptr(), stats[1].data_ptr(), _DTYPES[q.dtype],
            int32(b, "B"), int32(h, "H"), int32(sq, "Sq"), int32(sk, "Sk"),
            int32(d, "D"), scale, int(bool(causal)),
            0 if window is None else int32(window, "window"), stream)
    raise_on(err, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv
