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
  ``_unpack_kernel`` (``quant_unpack_pallas``);
* :func:`quant_roundtrip_cuda` — the int8 hop of one PermuteOp in one
  launch: pack → unpack of every row of a tree (or of every slot tree),
  then the row move, reading the leaves where they lie.  What the hop
  plane runs (``fl/adapters.py``); the two above stay for a caller that
  sends the codes themselves.

All are hand-written CUDA C++ for ``sm_90a`` (``csrc/quant.cu``), built by
``nvcc`` and bound with ``ctypes`` (:mod:`repro_torch.kernels.build`), and
equal the plain versions (``kernels/ref.py``) bit for bit.  Each wrapper
takes CUDA tensors only, checks them, allocates its outputs, launches on
PyTorch's current stream, raises on a launch error and adds one to its entry
of :data:`~repro_torch.kernels.launch.LAUNCHES`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.launch import LAUNCHES, check_tensor, int32, raise_on

__all__ = ["QUANT_BLOCK", "quant_pack_cuda", "quant_unpack_cuda",
           "quant_roundtrip_cuda", "roundtrip_rows", "rows_src"]

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


def roundtrip_rows(rows_of_leaves) -> tuple[int, int, list[list[int]] | None,
                                            list]:
    """The row layout of a roundtrip's input: ``(C, L, rows, stacked)``.

    ``rows_of_leaves`` is either C rows of L tensors each (the host plane's
    slot trees), or L client-stacked leaves (C, *shape) whose row c is row
    c (the fleet plane's tree).  Returns the row count, the leaf count, the
    rows as lists (None for stacked leaves) and the stacked leaves (empty
    for rows).  Every row must hold leaves of the same shapes."""
    seq = list(rows_of_leaves)
    if not seq:
        raise ValueError("quant_roundtrip needs at least one row")
    if isinstance(seq[0], torch.Tensor):
        c = seq[0].shape[0] if seq[0].dim() else 0
        for x in seq:
            if x.dim() == 0 or x.shape[0] != c:
                raise ValueError(f"stacked leaves must share their leading "
                                 f"row axis, got {tuple(x.shape)} beside "
                                 f"{c} rows")
        if c == 0:
            raise ValueError("quant_roundtrip needs at least one row")
        return c, len(seq), None, seq
    rows = [list(r) for r in seq]
    shapes = [tuple(x.shape) for x in rows[0]]
    if not shapes:
        raise ValueError("quant_roundtrip needs at least one leaf")
    for r in rows[1:]:
        if [tuple(x.shape) for x in r] != shapes:
            raise ValueError("every row must hold leaves of the same shapes")
    return len(rows), len(shapes), rows, []


def rows_src(src_of_dst, c: int) -> list[int]:
    """``src_of_dst`` as C host ints in [0, C) (identity when None).  A
    device tensor is refused: reading it would synchronise."""
    if src_of_dst is None:
        return list(range(c))
    if isinstance(src_of_dst, torch.Tensor):
        if src_of_dst.device.type != "cpu":
            raise ValueError("src_of_dst must be on the host, got "
                             f"{src_of_dst.device}")
        src_of_dst = src_of_dst.numpy()
    src = np.asarray(src_of_dst)
    if src.shape != (c,) or not np.issubdtype(src.dtype, np.integer):
        raise ValueError(f"src_of_dst must be {c} integers, got shape "
                         f"{src.shape} {src.dtype}")
    if c and (src.min() < 0 or src.max() >= c):
        raise ValueError(f"src_of_dst entries must lie in [0, {c})")
    return [int(v) for v in src]


def quant_roundtrip_cuda(rows_of_leaves, src_of_dst=None, *,
                         codes: torch.Tensor | None = None,
                         scales: torch.Tensor | None = None) -> list:
    """The int8 hop of one PermuteOp: output row c is
    ``unpack(pack(row src_of_dst[c]))`` per 512-element block of the row's
    leaves concatenated in order (the last block zero-padded), as
    ``adapters.quant_roundtrip_rows`` and the row gather compute it.

    ``rows_of_leaves``: C rows of L fp32 CUDA tensors, or L client-stacked
    leaves (C, *shape) (see :func:`roundtrip_rows`); inputs are only read.
    ``src_of_dst``: C host ints, identity when None.  Returns L fresh
    leaves (C, *shape), row c of each the output row c.  ``codes``
    (C, ⌈F/512⌉·512) int8 and ``scales`` (C, ⌈F/512⌉) fp32, when given, get
    the wire of each output row.  One launch per group of
    ``max_entries // L`` rows (one for every tree the port hops)."""
    c, nleaves, rows, stacked = roundtrip_rows(rows_of_leaves)
    src = rows_src(src_of_dst, c)
    leaves = stacked if rows is None else [x for row in rows for x in row]
    device = leaves[0].device
    for x in leaves:
        if x.dtype != torch.float32:
            raise ValueError(f"quant_roundtrip takes torch.float32 leaves "
                             f"only, got {x.dtype}")
        if not x.is_cuda:
            raise ValueError(f"quant_roundtrip leaves must be CUDA tensors, "
                             f"got {x.device}")
        if not x.is_contiguous() or x.device != device:
            raise ValueError(f"quant_roundtrip leaves must be contiguous and "
                             f"on one device, got {tuple(x.shape)} on "
                             f"{x.device}")
    # Pointers of the (row, leaf) table, the input rows already in
    # src_of_dst's order: a stacked leaf's row r starts r·n elements in.
    if rows is None:
        numels = [x.numel() // c for x in stacked]
        shapes = [tuple(x.shape[1:]) for x in stacked]
        step = 4 * np.array(numels, np.int64)
        in_ptr = (np.array([x.data_ptr() for x in stacked], np.int64)
                  + np.array(src, np.int64)[:, None] * step)
    else:
        numels = [x.numel() for x in rows[0]]
        shapes = [tuple(x.shape) for x in rows[0]]
        step = 4 * np.array(numels, np.int64)
        in_ptr = np.array([[x.data_ptr() for x in row] for row in rows],
                          np.int64)[src]
    f = int32(sum(numels), "F")
    off = np.zeros(nleaves + 1, np.int32)
    np.cumsum(numels, out=off[1:])
    if f == 0:
        raise ValueError("quant_roundtrip needs at least one element a row")
    nb = -(-f // QUANT_BLOCK)
    for t, shape, name in ((codes, (c, nb * QUANT_BLOCK), "codes"),
                           (scales, (c, nb), "scales")):
        if t is None:
            continue
        check_tensor(t, name, 2, torch.int8 if name == "codes"
                     else torch.float32)
        if tuple(t.shape) != shape or t.device != device:
            raise ValueError(f"{name} must be {shape} on {device}, got "
                             f"{tuple(t.shape)} on {t.device}")
        if t.data_ptr() % 4:
            raise ValueError(f"{name} must be 4-byte aligned")
    out = [torch.empty((c,) + shape, device=device, dtype=torch.float32)
           for shape in shapes]
    out_ptr = (np.array([x.data_ptr() for x in out], np.int64)
               + np.arange(c, dtype=np.int64)[:, None] * step)
    lib = build.load("quant")
    if nleaves > lib.repro_quant_roundtrip_max_leaves():
        raise ValueError(f"quant_roundtrip takes at most "
                         f"{lib.repro_quant_roundtrip_max_leaves()} leaves, "
                         f"got {nleaves}")
    group = lib.repro_quant_roundtrip_max_entries() // nleaves
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        for r0 in range(0, c, group):
            r1 = min(c, r0 + group)
            ins = np.ascontiguousarray(in_ptr[r0:r1])
            outs = np.ascontiguousarray(out_ptr[r0:r1])
            err = lib.repro_quant_roundtrip_f32(
                ins.ctypes.data, outs.ctypes.data, off.ctypes.data, r1 - r0,
                nleaves,
                None if codes is None
                else codes.data_ptr() + r0 * nb * QUANT_BLOCK,
                None if scales is None else scales.data_ptr() + 4 * r0 * nb,
                stream)
            raise_on(err, "quant_roundtrip")
            LAUNCHES["quant_roundtrip"] += 1
    return out
