"""The Mamba-2 SSD chunk scan on Hopper.

Counterpart of ``repro.kernels.ssd_scan``.  :func:`ssd_scan_cuda` computes
what ``_ssd_kernel`` (``ssd_scan_pallas``) computes from a zero state: for
xh (B, S, H, P), per-step log decays a (B, S, H) and projections b, c
(B, S, N), all fp32, the output y (B, S, H, P) of
``h_t = exp(a_t)·h_{t−1} + xh_t ⊗ b_t``, ``y_t = h_t · c_t``, in the
chunked form (intra-chunk ``(C·Bᵀ ∘ decay-tril)·X`` plus the carried
state) with chunk length ``chunk`` ≤ 128; S need not be a multiple of it.

The kernels are hand-written CUDA C++ for ``sm_90a`` (``csrc/ssd_scan.cu``),
SSD's state-passing form with the chunks in parallel and every product on
the tensor cores in 3×TF32 (fp32 operands split into two TF32 halves).
What bounds them on an H100 is bytes: at zamba2's shape (1, 4096, 80, 64,
64, 128) xh in and y out are 171 MB with a, b and c, 0.051 ms at
3.35 TB/s, against 0.049 ms for the products at the TF32 peak.  One
wrapper call makes three launches: ``ssd_state_kernel`` (each chunk's
cumulative decay and its state from zero, per head, plus C·Bᵀ once per
chunk for all heads), ``ssd_pass_kernel`` (the carry over the chunks in
order) and ``ssd_scan_kernel`` (each chunk's output from its entering
state and its decayed C·Bᵀ).  The plain versions are
:func:`repro_torch.kernels.ref.ssd_scan_ref` and, stage by stage,
``ref.ssd_chunk_states_ref``, ``ref.ssd_state_pass_ref`` and
``ref.ssd_chunk_output_ref``.

The wrapper takes CUDA tensors only, checks them, allocates the output and
the scratch (the chunk states, B·⌈S/chunk⌉·H·P·N floats at the tile
padding; C·Bᵀ per chunk; the cumulative decays), launches on PyTorch's
current stream, raises on a launch error and adds one to each launch's
count: ``LAUNCHES["ssd_scan_state"]``, ``LAUNCHES["ssd_scan_pass"]`` and
``LAUNCHES["ssd_scan"]``.  With ``return_state=True`` it also returns the
states entering each chunk and the cumulative decays, which the backward
takes.

:func:`ssd_scan_bwd_cuda` is its backward (no TPU counterpart: the
reference differentiates its inline XLA chunked scan): from the inputs,
``dy`` and the forward's states and decays, the gradients ``(dxh, da, db,
dc)``, in four launches of ``csrc/ssd_scan_bwd.cu``: each chunk's own term
of the state gradient and its C·Bᵀ; the reverse carry over the chunks; per
chunk and run of heads the intra-chunk and state terms; da's reverse scan
and dB and dC summed over the runs of heads in order.  At chunk 128,
P = N = 64 (zamba2's shape) with two heads or more a block the first and
third launches run on TF32 ``wgmma`` (``tf32_wgmma.cuh``; the third in
four kinds of block fed by a producer warpgroup); otherwise on
``mma.sync``.
Every product is 3×TF32, no atomics.  Its plain version is
``ref.ssd_scan_bwd_ref`` (stage by stage ``ref.ssd_bwd_local_ref``,
``ssd_bwd_pass_ref``, ``ssd_bwd_intra_ref``, ``ssd_bwd_state_ref``).  It
takes (chunk / 16)·(N / 16) ≤ 32 (N ≤ 64 at chunk 128) and shapes whose
tiles fit the 227 KB of shared memory a block has (P ≤ 80 at chunk 128,
N 64), zamba2's among them; each call adds one to
``LAUNCHES["ssd_scan_bwd_local"]``, ``["ssd_scan_bwd_pass"]``,
``["ssd_scan_bwd_main"]`` and ``["ssd_scan_bwd"]`` (the last, the
finishing launch, stands for the call).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launch import LAUNCHES, check_tensor, int32, raise_on

__all__ = ["ssd_scan_cuda", "ssd_scan_bwd_cuda", "SMEM_LIMIT"]

#: Shared memory one block may use on an H100 (bytes).
SMEM_LIMIT = 232_448
#: The backward's launches, in order: ``ssd_scan_bwd`` (the last, da's
#: scan and the sums of dB and dC) stands for the call.
BWD_LAUNCHES = ("ssd_scan_bwd_local", "ssd_scan_bwd_pass",
                "ssd_scan_bwd_main", "ssd_scan_bwd")
#: Parts of dacum and partials of dB / dC the middle launch leaves per
#: chunk (``csrc/ssd_scan_bwd.cu``: kDacumSlots, kPartSlots).
BWD_DACUM_SLOTS, BWD_PART_SLOTS = 3, 4


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def ssd_scan_cuda(xh: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                  cmat: torch.Tensor, *, chunk: int = 128,
                  return_state: bool = False):
    """xh (B, S, H, P), a (B, S, H), b/c (B, S, N) fp32 → y (B, S, H, P);
    with ``return_state`` ``(y, states, acum)``: the state entering each
    chunk (B, nc, H, P', N') and the cumulative decays (B, nc, H, chunk'),
    P', N' and chunk' rounded up to 16."""
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
    nc = -(-s // chunk) if chunk >= 1 else 0
    if b > 65535 or s == 0 or p == 0 or n == 0 or not 1 <= chunk <= 128 \
            or nc > 65535:
        raise ValueError(f"ssd_scan kernel takes B <= 65535, S, P, N > 0, "
                         f"1 <= chunk <= 128 and ⌈S/chunk⌉ <= 65535, got "
                         f"{tuple(xh.shape)}, N {n}, chunk {chunk}")
    lib = build.load("ssd_scan")
    smem = lib.repro_ssd_scan_smem_bytes(chunk, int32(p, "P"), int32(n, "N"))
    if smem == 0 or smem > SMEM_LIMIT:
        raise ValueError(f"ssd_scan kernel does not take chunk {chunk}, P {p}"
                         f", N {n} (shared memory {smem} bytes, limit "
                         f"{SMEM_LIMIT}; at most 32 tiles of 16 x 32 per "
                         f"chunk and head)")
    lp, pp, np_ = (_round_up(v, 16) for v in (chunk, p, n))
    f32 = dict(device=xh.device, dtype=torch.float32)
    y = torch.empty_like(xh)
    states = torch.empty((b, nc, h, pp, np_), **f32)
    cb = torch.empty((b, nc, lp, lp), **f32)
    acum = torch.empty((b, nc, h, lp), **f32)
    with torch.cuda.device(xh.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_ssd_scan_f32(
            xh.data_ptr(), a.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
            states.data_ptr(), cb.data_ptr(), acum.data_ptr(), y.data_ptr(),
            int32(b, "B"), int32(s, "S"), int32(h, "H"), p, n,
            chunk, stream)
    raise_on(err, "ssd_scan")
    LAUNCHES["ssd_scan_state"] += 1
    LAUNCHES["ssd_scan_pass"] += 1
    LAUNCHES["ssd_scan"] += 1
    return (y, states, acum) if return_state else y


def ssd_scan_bwd_cuda(xh: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                      cmat: torch.Tensor, dy: torch.Tensor, *,
                      states: torch.Tensor, acum: torch.Tensor,
                      chunk: int = 128):
    """xh, dy (B, S, H, P), a (B, S, H), b/c (B, S, N) fp32 and the
    forward's ``states`` and ``acum`` (``ssd_scan_cuda(...,
    return_state=True)``) → (dxh, da, db, dc), each shaped as its input.
    Scratch: the chunks' state gradients (as ``states``), C·Bᵀ per chunk,
    dacum's ``BWD_DACUM_SLOTS`` parts per chunk and head, and
    ``BWD_PART_SLOTS`` partials of dB and dC per chunk and run of heads."""
    check_tensor(xh, "xh", 4)
    check_tensor(a, "a", 3)
    check_tensor(bmat, "bmat", 3)
    check_tensor(cmat, "cmat", 3)
    check_tensor(dy, "dy", 4)
    check_tensor(states, "states", 5)
    check_tensor(acum, "acum", 4)
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    nc = -(-s // chunk) if chunk >= 1 else 0
    lp, pp, np_ = (_round_up(v, 16) for v in (chunk, p, n))
    if (a.shape != (b, s, h) or bmat.shape != (b, s, n)
            or cmat.shape != bmat.shape or dy.shape != xh.shape
            or states.shape != (b, nc, h, pp, np_)
            or acum.shape != (b, nc, h, lp)
            or {t.device for t in (a, bmat, cmat, dy, states, acum)}
            != {xh.device}):
        raise ValueError(f"ssd_scan backward shapes do not match: xh "
                         f"{tuple(xh.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(bmat.shape)}, c {tuple(cmat.shape)}, dy "
                         f"{tuple(dy.shape)}, states {tuple(states.shape)}, "
                         f"acum {tuple(acum.shape)}, chunk {chunk}")
    if b > 65535 or s == 0 or not 1 <= chunk <= 128 or nc > 65535:
        raise ValueError(f"ssd_scan backward takes B <= 65535, S > 0, "
                         f"1 <= chunk <= 128 and ⌈S/chunk⌉ <= 65535, got "
                         f"{tuple(xh.shape)}, chunk {chunk}")
    lib = build.load("ssd_scan_bwd")
    smem = lib.repro_ssd_scan_bwd_smem_bytes(chunk, int32(p, "P"),
                                             int32(n, "N"))
    if smem == 0 or smem > SMEM_LIMIT:
        raise ValueError(f"ssd_scan backward does not take chunk {chunk}, P "
                         f"{p}, N {n} (shared memory {smem} bytes, limit "
                         f"{SMEM_LIMIT}; (chunk / 16)·(N / 16) <= 32)")
    groups = lib.repro_ssd_scan_bwd_groups(int32(h, "H"), nc, int32(b, "B"))
    f32 = dict(device=xh.device, dtype=torch.float32)
    dxh = torch.empty_like(xh)
    da = torch.empty_like(a)
    db = torch.empty_like(bmat)
    dc = torch.empty_like(cmat)
    gs = torch.empty_like(states)
    cb = torch.empty((b, nc, lp, lp), **f32)
    dag = torch.empty((b, nc, h, BWD_DACUM_SLOTS, lp), **f32)
    part = torch.empty((b, nc, groups, BWD_PART_SLOTS, lp, np_), **f32)
    with torch.cuda.device(xh.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_ssd_scan_bwd_f32(
            xh.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), dy.data_ptr(),
            states.data_ptr(), acum.data_ptr(), gs.data_ptr(), cb.data_ptr(),
            dag.data_ptr(), part.data_ptr(), dxh.data_ptr(), da.data_ptr(),
            db.data_ptr(), dc.data_ptr(), b, s, h, p, n, chunk, stream)
    raise_on(err, "ssd_scan_bwd")
    for name in BWD_LAUNCHES:
        LAUNCHES[name] += 1
    return dxh, da, db, dc
