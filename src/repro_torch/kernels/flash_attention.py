"""Causal, sliding-window and non-causal attention on Hopper — the LM zoo's
prefill and training.

Counterpart of ``repro.kernels.flash_attention``.
:func:`flash_attention_cuda` computes what ``_attn_kernel``
(``flash_attention_pallas``) computes: online-softmax attention of q
(B, Sq, H, D) against k/v (B, Sk, H, D) in bf16 or fp32, with q
right-aligned to the end of the keys, causal and sliding-window masks or
none, fp32 softmax, and 0 for a row that sees no key; the output has q's
dtype.  The zoo calls it causal (every decoder's self-attention, windowed
in ``swa`` layers) and non-causal with Sq ≠ Sk (whisper's encoder over its
1,500 frames and its cross-attention from the text to them).
Heads are pre-repeated for GQA by the caller.  The kernel is hand-written
CUDA C++ for ``sm_90a`` (``csrc/flash_attention.cu``), built by ``nvcc`` and
bound with ``ctypes``: bf16 runs on Hopper's warpgroup tensor cores
(``wgmma``), fed by TMA loads through an ``mbarrier``-guarded ring, with a
producer warpgroup and two consumer warpgroups; it takes D in {64, 80, 128,
160, 256} (the zoo's calls; past 128 on K/V tiles of 64 keys), q, k, v and
o 16-byte aligned (TMA) and scale > 0.  fp32 runs as FMAs on the CUDA cores
and takes D % 4 == 0 up to 256.  The plain
version is :func:`repro_torch.kernels.ref.flash_attention_ref`.  The
wrapper takes CUDA tensors only, checks them, allocates the output,
launches on PyTorch's current stream, raises on a launch error and adds one
to ``LAUNCHES["flash_attention"]``; :func:`fwd_kernel_launches` reads the
library's own count of each device kernel and instance, so a run shows
which route it took.

With ``return_lse=True`` the forward also returns each row's natural-log
log-sum-exp of its scaled visible scores, (B, H, Sq) fp32, +inf for a row
that sees no key; ``o`` is the same either way.

:func:`flash_attention_bwd_cuda` is its backward (``csrc/
flash_attention_bwd.cu``, no TPU counterpart: the reference differentiates
its inline XLA attention): from q, k, v, the forward's output o and lse
and the gradient do, the three gradients in the inputs' dtype, by three
launches (Δ = rowsum(dO ∘ O), dK/dV over key blocks, dQ over query
blocks) with no float atomics, so two calls give the same bits.  bf16
runs on the tensor cores (``wgmma`` fed by TMA, the forward's skeleton)
and takes D in ``BF16_HEAD_DIMS``, do and the gradients 16-byte aligned
too; past D = 128 the dK/dV kernel walks its query tiles twice (a dK
pass, then a dV pass: both accumulators do not fit a consumer's
registers together), and at D = 256 the streamed tiles hold 32 rows.
fp32 runs on the CUDA cores up to D = 256.  Its plain version is
``ref.flash_attention_bwd_ref``.  Each call adds one to
``LAUNCHES["flash_attention_bwd"]``; :func:`bwd_kernel_launches` reads the
library's own count of each device kernel and instance.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launch import LAUNCHES, check_tensor, int32, raise_on

__all__ = ["flash_attention_cuda", "flash_attention_bwd_cuda",
           "FWD_HEAD_DIM_MAX", "BWD_HEAD_DIM_MAX", "BF16_HEAD_DIMS",
           "FWD_DEVICE_KERNELS", "BWD_DEVICE_KERNELS", "fwd_kernel_launches",
           "bwd_kernel_launches"]

#: Largest head dim the fp32 forward takes (it also needs D % 4 == 0).
FWD_HEAD_DIM_MAX = 256
#: Largest head dim the backward takes (bf16: BF16_HEAD_DIMS).
BWD_HEAD_DIM_MAX = 256
#: Head dims the bf16 (tensor-core) forward takes.
BF16_HEAD_DIMS = (64, 80, 128, 160, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: The forward's device kernels and instances, in the order of the
#: library's counts: the fp32 kernel (every D), then the wgmma kernel at
#: each head dim of BF16_HEAD_DIMS.
FWD_DEVICE_KERNELS = ("flash_attention_kernel",
                      *(f"flash_attention_wgmma_kernel<{d}>"
                        for d in BF16_HEAD_DIMS))
#: The backward's device kernels and instances, in the order of the
#: library's counts: Δ, then dK/dV and dQ on the tensor cores at each head
#: dim of BF16_HEAD_DIMS (bf16), then on the CUDA cores (fp32, every D).
BWD_DEVICE_KERNELS = ("fa_bwd_delta_kernel",
                      *(f"fa_bwd_dkdv_wgmma_kernel<{d}>"
                        for d in BF16_HEAD_DIMS),
                      *(f"fa_bwd_dq_wgmma_kernel<{d}>"
                        for d in BF16_HEAD_DIMS),
                      "fa_bwd_dkdv_kernel", "fa_bwd_dq_kernel")


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
    if d % 4 or d > FWD_HEAD_DIM_MAX or b * h > 65535 or sq == 0 or sk == 0:
        raise ValueError(f"flash_attention kernel takes D % 4 == 0, "
                         f"D <= {FWD_HEAD_DIM_MAX}, B·H <= 65535 and "
                         f"non-empty sequences, got {tuple(q.shape)} / "
                         f"{tuple(k.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    return 1.0 / d ** 0.5 if scale is None else float(scale)


def _check_bf16(d: int, scale: float, tensors: dict) -> None:
    """Raise unless the bf16 (TMA) kernels take these operands."""
    offsets = {name: t.data_ptr() % 16 for name, t in tensors.items()}
    if d not in BF16_HEAD_DIMS or any(offsets.values()) or not scale > 0.0:
        raise ValueError(
            f"the bf16 flash_attention kernels take D in {BF16_HEAD_DIMS}, "
            f"16-byte aligned {'/'.join(offsets)} and scale > 0, got D={d}, "
            f"bytes past 16 {offsets}, scale={scale}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int | None = None,
                         scale: float | None = None, return_lse: bool = False):
    """q (B, Sq, H, D), k/v (B, Sk, H, D) → o (B, Sq, H, D) in q's dtype,
    or ``(o, lse)`` with ``return_lse``: lse (B, H, Sq) fp32."""
    scale = _check(q, k, v, window, scale)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if q.dtype == torch.bfloat16:
        _check_bf16(d, scale, {"q": q, "k": k, "v": v, "o": out})
    lib = build.load("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            _DTYPES[q.dtype], int32(b, "B"), int32(h, "H"), int32(sq, "Sq"),
            int32(sk, "Sk"), int32(d, "D"), scale, int(bool(causal)),
            0 if window is None else int32(window, "window"), stream)
    raise_on(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out if lse is None else (out, lse)


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor,
                             lse: torch.Tensor | None = None, *,
                             causal: bool = True, window: int | None = None,
                             scale: float | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The gradients (dq, dk, dv) of :func:`flash_attention_cuda` at
    (q, k, v), given its output ``o`` and ``lse`` (``return_lse=True``)
    and the gradient ``do`` reaching ``o`` (shaped and typed as q)."""
    scale = _check(q, k, v, window, scale, (("o", o), ("do", do)))
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if lse is None:
        raise ValueError("flash_attention_bwd takes the forward's lse "
                         "(flash_attention_cuda(..., return_lse=True))")
    check_tensor(lse, "lse", 3)
    if lse.shape != (b, h, sq) or lse.device != q.device:
        raise ValueError(f"lse {tuple(lse.shape)} is not (B, H, Sq) = "
                         f"{(b, h, sq)} on {q.device}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.dtype == torch.bfloat16:
        _check_bf16(d, scale, {"q": q, "k": k, "v": v, "o": o, "do": do,
                               "dq": dq, "dk": dk, "dv": dv})
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = build.load("flash_attention_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), _DTYPES[q.dtype],
            int32(b, "B"), int32(h, "H"), int32(sq, "Sq"), int32(sk, "Sk"),
            int32(d, "D"), scale, int(bool(causal)),
            0 if window is None else int32(window, "window"), stream)
    raise_on(err, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


def fwd_kernel_launches() -> dict[str, int]:
    """Launches of each of the forward's device kernels and instances since
    its library was loaded (counted in ``csrc/flash_attention.cu`` where a
    launch succeeds): which route a call went through."""
    lib = build.load("flash_attention")
    counts = (ctypes.c_longlong * len(FWD_DEVICE_KERNELS))()
    lib.repro_flash_attention_kernel_launches(counts)
    return dict(zip(FWD_DEVICE_KERNELS, counts))


def bwd_kernel_launches() -> dict[str, int]:
    """Launches of each of the backward's device kernels and instances
    since its library was loaded (counted in ``csrc/flash_attention_bwd.cu``
    where a launch succeeds): which route a call went through."""
    lib = build.load("flash_attention_bwd")
    counts = (ctypes.c_longlong * len(BWD_DEVICE_KERNELS))()
    lib.repro_flash_attention_bwd_kernel_launches(counts)
    return dict(zip(BWD_DEVICE_KERNELS, counts))
