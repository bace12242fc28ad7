"""The FL diffusion data plane's kernels on Hopper (Eq. 10/11, STC hops and
the device planner's bids).

Counterpart of ``repro.kernels.diffusion``.  Every kernel is hand-written
CUDA C++ for ``sm_90a`` (``csrc/``), built by ``nvcc`` and bound with
``ctypes`` (:mod:`repro_torch.kernels.build`):

* :func:`mix_aggregate_tree_cuda` — Eq. 10/11 over a client-stacked tree
  in one launch, ``out_l[g, …] = Σ_c w[g, c]·x_l[c, …]`` for every leaf l,
  each leaf read and written where it lies through a table passed as a
  kernel parameter (``mix_tree_kernel``), bit for bit the chain
  :func:`stack_ravel` → :func:`mix_aggregate_cuda` → :func:`stack_unravel`
  that it replaces on the fleet plane.  Replaces ``_mix_kernel`` with the
  reference's ``stack_ravel`` and ``stack_unravel`` around it.
* :func:`mix_aggregate_cuda` — ``out[g, f] = Σ_c w[g, c]·x[c, f]`` over a
  flat (C, F) block.  Replaces ``repro/kernels/diffusion.py::_mix_kernel``
  (``mix_aggregate_pallas``); the flat op, and the yardstick the tree
  kernel is held to.  Memory-bound: at G = 1 (Eq.-11 aggregation) it is a
  GEMV that reads C·F·4 bytes once; see the source for the design.
* :func:`stc_rows_cuda` — masked per-row STC against a shared reference row,
  by one of two routes.  Rows of n ≤ :data:`N_FUSED` (every FL leaf):
  :func:`stc_rows_fused_cuda`, one launch that selects each row's τ_c (the
  k-th largest ``|x_c − ref|``) on chip by radix select, one thread-block
  cluster per row (``stc_fused_kernel<true>`` in ``csrc/stc_compress.cu``,
  the host plane's STC kernel run per row); it replaces
  ``_stc_reduce_kernel`` and ``_stc_apply_kernel`` together with the XLA
  sort the reference leaves τ_c to.  Longer rows: τ_c by ``torch.topk``,
  then :func:`stc_rows_reduce_cuda` (replaces ``_stc_reduce_kernel``) and
  :func:`stc_rows_apply_cuda` (replaces ``_stc_apply_kernel``),
  memory-bound passes over (C, n) fp32.  Like the plain version both
  routes keep exactly k entries per row, the ones ``lax.top_k`` keeps
  (every ``|Δ| > τ_c``, then the ties in index order), at the exact-k μ.
* :func:`bid_fused_cuda` — the device planner's Eq.-32 bids of one bid
  round in one launch, ``(iid[:, None] − cand)·(1 + w·value[None, :])``
  with ``cand`` the (M, N) candidate IID distances (Eq. 2 + B.1, w1_norm)
  by the centered contraction, the value factor only where a learning
  value is given; a thread per client and model, every load at its start,
  no shared memory.  Replaces ``_bid_kernel`` (``dol_bid_scores_pallas``)
  and ``_bid_value_kernel`` (``bid_value_fuse_pallas``) with the
  subtraction between them, and equals that chain on the card bit for bit.
* :func:`dol_bid_scores_cuda` — the candidate distances alone, one thread
  per output (replaces ``_bid_kernel``), and :func:`bid_value_fuse_cuda` —
  ``bids·(1 + w·value[None, :])``, one thread per element (replaces
  ``_bid_value_kernel``): the standalone ops, off the planner's path since
  :func:`bid_fused_cuda` took it.

Every wrapper takes CUDA tensors only, checks them, allocates its outputs
with ``torch.empty``, launches on PyTorch's current stream, raises if
``cudaGetLastError()`` is not 0, and adds one to its entry of
:data:`~repro_torch.kernels.launch.LAUNCHES` per launch (re-exported here).
Dispatch by device lives in :mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.launch import (LAUNCHES, check_tensor, int32,
                                        raise_on, reset_launch_counts)
from repro_torch.kernels.ref import (stack_ravel, stack_unravel,
                                     stc_rows_threshold)
from repro_torch.kernels.stc_compress import N_FUSED
from repro_torch.tree import tree_flatten, tree_unflatten

__all__ = ["stack_ravel", "stack_unravel", "mix_aggregate_cuda",
           "mix_aggregate_tree_cuda", "mix_tree_table", "mix_tree_weights",
           "mix_tree_tile_cols", "MixTreeLaunch", "MIX_TREE_L_MAX",
           "MIX_TREE_W_MAX",
           "stc_rows_cuda", "stc_rows_fused_cuda", "stc_rows_reduce_cuda",
           "stc_rows_apply_cuda", "MAX_ROWS",
           "bid_fused_cuda", "dol_bid_scores_cuda", "bid_value_fuse_cuda",
           "LAUNCHES",
           "reset_launch_counts"]


#: Most rows :func:`stc_rows_fused_cuda` takes: one cluster per row on the
#: grid's y axis (65,535 at most).
MAX_ROWS = 65535


# ----------------------------------------------------------------- wrappers

def mix_aggregate_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``w @ x`` by the hand-written kernel: x (C, F), w (G, C) → (G, F)."""
    check_tensor(x, "x", 2)
    check_tensor(w, "w", 2)
    c, f = x.shape
    g = w.shape[0]
    if w.shape[1] != c or w.device != x.device:
        raise ValueError(f"w {tuple(w.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if g > 65535 * 8:
        raise ValueError(f"G={g} exceeds the kernel's grid")
    out = torch.empty((g, f), device=x.device, dtype=torch.float32)
    lib = build.load("mix_aggregate")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_mix_aggregate_f32(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), int32(c, "C"),
            int32(f, "F"), int32(g, "G"), stream)
    raise_on(err, "mix_aggregate")
    LAUNCHES["mix_aggregate"] += 1
    return out


#: Most leaves one ``mix_tree`` launch takes (the kernel's table); a
#: larger tree goes out in several launches.  The lm model, the largest FL
#: tree, has 37.
MIX_TREE_L_MAX = 64
#: Most floats of a host ``w`` (G·C) the kernel reads from its parameters;
#: a larger or device ``w`` goes to the card as a tensor.
MIX_TREE_W_MAX = 512
#: Client chains: a thread owns all eight where each holds one term.
MIX_TREE_CHAINS = 8


def mix_tree_tile_cols(c: int) -> int:
    """Columns of a leaf one block covers: 64 threads × 4 where C ≤ 8 (a
    thread owns every chain), 32 lanes × 4 where not (a warp per chain)."""
    return 256 if c <= MIX_TREE_CHAINS else 128


class MixTreeLaunch(NamedTuple):
    """One ``mix_tree`` launch's table: the tree's leaf indices it covers,
    their input and output pointers, element counts per row, first tiles
    (with the launch's total last) and alignment classes (1: 16-byte
    loads)."""
    leaves: tuple
    x: np.ndarray
    out: np.ndarray
    n: np.ndarray
    tile0: np.ndarray
    vec: np.ndarray


def mix_tree_table(numels, x_ptrs, out_ptrs, c: int) -> list[MixTreeLaunch]:
    """The launches of a tree of leaves of ``numels`` elements per client
    row, at input / output addresses ``x_ptrs`` / ``out_ptrs``, over C
    clients: leaves with elements, in order, in groups of at most
    :data:`MIX_TREE_L_MAX`; each leaf ``⌈n / tile_cols⌉`` tiles; 16-byte
    loads where n % 4 == 0 and both bases are 16-byte aligned."""
    cols = mix_tree_tile_cols(c)
    live = [i for i, n in enumerate(numels) if n > 0]
    out = []
    for s in range(0, len(live), MIX_TREE_L_MAX):
        idx = live[s:s + MIX_TREE_L_MAX]
        n = np.array([int32(numels[i], "n") for i in idx], np.int64)
        xp = np.array([x_ptrs[i] for i in idx], np.int64)
        op = np.array([out_ptrs[i] for i in idx], np.int64)
        tile0 = np.zeros(len(idx) + 1, np.int64)
        np.cumsum(-(-n // cols), out=tile0[1:])
        int32(int(tile0[-1]), "tiles")
        vec = (n % 4 == 0) & (xp % 16 == 0) & (op % 16 == 0)
        out.append(MixTreeLaunch(tuple(idx), xp, op, n.astype(np.int32),
                                 tile0.astype(np.int32),
                                 vec.astype(np.int32)))
    return out


def mix_tree_weights(w: torch.Tensor, device: torch.device
                     ) -> tuple[np.ndarray | None, torch.Tensor | None]:
    """``w`` (G, C) as the kernel reads it: ``(host, None)`` — G·C fp32
    values row-major for the kernel's parameters — for a host ``w`` of at
    most :data:`MIX_TREE_W_MAX` values, else ``(None, device)`` — fp32 on
    ``device``, contiguous (a host ``w`` copied there)."""
    if w.device.type == "cpu" and w.numel() <= MIX_TREE_W_MAX:
        host = w.detach().to(torch.float32).numpy()
        return np.ascontiguousarray(host).reshape(-1), None
    return None, w.to(device=device, dtype=torch.float32).contiguous()


def mix_aggregate_tree_cuda(params, w: torch.Tensor, *, collapse: bool = False,
                            keep_float32: bool = False):
    """Eq. 10/11 over a client-stacked tree of CUDA leaves (C, *shape) by
    the ``mix_tree`` kernel: leaf l of the result is
    ``Σ_c w[g, c]·x_l[c, …]``, (G, *shape), or (*shape) with ``collapse``
    (G = 1), each its own contiguous tensor, restored to the leaf's dtype
    unless ``keep_float32``.  ``w`` (G, C) on the host (the kernel's
    parameters take up to :data:`MIX_TREE_W_MAX` values) or on the leaves'
    device.  A non-fp32 or non-contiguous leaf is copied to a contiguous
    fp32 one first.  One launch per :data:`MIX_TREE_L_MAX` leaves; bit for
    bit :func:`stack_ravel` → :func:`mix_aggregate_cuda` →
    :func:`stack_unravel`.  Shapes are checked before devices."""
    leaves, treedef = tree_flatten(params)
    if not leaves:
        raise ValueError("mix_tree needs at least one leaf")
    c = leaves[0].shape[0] if leaves[0].dim() else 0
    for x in leaves:
        if x.dim() == 0 or x.shape[0] != c:
            raise ValueError(f"mix_tree leaves must share their leading "
                             f"client axis, got {tuple(x.shape)} beside "
                             f"{c} clients")
    if c == 0:
        raise ValueError("mix_tree needs at least one client")
    if w.dim() != 2 or w.shape[1] != c or w.shape[0] == 0:
        raise ValueError(f"w {tuple(w.shape)} does not match {c} clients")
    g = w.shape[0]
    if collapse and g != 1:
        raise ValueError(f"collapse=True needs a (1, C) row, got "
                         f"{tuple(w.shape)}")
    if (g + 7) // 8 > 65535:
        raise ValueError(f"G={g} exceeds the kernel's grid")
    dev = leaves[0].device
    for x in leaves:
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"mix_tree leaves must be CUDA tensors on one "
                             f"device, got {x.device} beside {dev}")
    if w.device.type != "cpu" and w.device != dev:
        raise ValueError(f"w lies on {w.device}, the leaves on {dev}")
    f32 = torch.float32
    xs = [x if x.dtype == f32 and x.is_contiguous()
          else x.to(f32).contiguous() for x in leaves]
    outs = [torch.empty(tuple(x.shape[1:]) if collapse
                        else (g,) + tuple(x.shape[1:]), device=dev, dtype=f32)
            for x in leaves]
    w_host, w_dev = mix_tree_weights(w, dev)
    table = mix_tree_table([x.numel() // c for x in xs],
                           [x.data_ptr() for x in xs],
                           [o.data_ptr() for o in outs], c)
    lib = build.load("mix_aggregate")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for t in table:
            err = lib.repro_mix_tree_f32(
                t.x.ctypes.data, t.out.ctypes.data, t.n.ctypes.data,
                t.tile0.ctypes.data, t.vec.ctypes.data, len(t.leaves), c, g,
                None if w_host is None else w_host.ctypes.data,
                None if w_dev is None else w_dev.data_ptr(), stream)
            raise_on(err, "mix_tree")
            LAUNCHES["mix_tree"] += 1
    if not keep_float32:
        outs = [o.to(x.dtype) for o, x in zip(outs, leaves)]
    return tree_unflatten(treedef, outs)


def stc_rows_reduce_cuda(x: torch.Tensor, ref_row: torch.Tensor,
                         thr: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per row: survivor sum ``Σ|Δ|·1[|Δ| ≥ τ_c]`` and count, (C,) fp32,
    and the ties' prefix over the row's chunks for
    :func:`stc_rows_apply_cuda` (C, chunks + 1) int32."""
    check_tensor(x, "x", 2)
    check_tensor(ref_row, "ref_row", 1)
    check_tensor(thr, "thr", 1)
    c, n = x.shape
    if ref_row.shape[0] != n or thr.shape[0] != c:
        raise ValueError("ref_row / thr do not match x")
    lib = build.load("stc_rows")
    ssum = torch.empty((c,), device=x.device, dtype=torch.float32)
    cnt = torch.empty((c,), device=x.device, dtype=torch.float32)
    ties = torch.empty((c, lib.repro_stc_rows_max_chunks() + 1),
                       device=x.device, dtype=torch.int32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_stc_rows_reduce_f32(
            x.data_ptr(), ref_row.data_ptr(), thr.data_ptr(), ssum.data_ptr(),
            cnt.data_ptr(), ties.data_ptr(), int32(c, "C"), int32(n, "n"),
            stream)
    raise_on(err, "stc_rows_reduce")
    LAUNCHES["stc_rows_reduce"] += 1
    return ssum, cnt, ties


def stc_rows_apply_cuda(x: torch.Tensor, ref_row: torch.Tensor,
                        thr: torch.Tensor, ssum: torch.Tensor,
                        cnt: torch.Tensor, ties: torch.Tensor,
                        mask: torch.Tensor, k: int) -> torch.Tensor:
    """Ternarize each masked row's k survivors at the exact-k
    ``μ_c = (ssum_c − (cnt_c − k)·τ_c) / k`` and blend; unmasked rows come
    out bit for bit untouched.  ``ties`` is the reduce's tie prefix."""
    check_tensor(x, "x", 2)
    check_tensor(ref_row, "ref_row", 1)
    for t, name in ((thr, "thr"), (ssum, "ssum"), (cnt, "cnt")):
        check_tensor(t, name, 1)
    check_tensor(ties, "ties", 2, torch.int32)
    check_tensor(mask, "mask", 1, torch.int32)
    c, n = x.shape
    if c > 65535:
        raise ValueError(f"C={c} exceeds the apply kernel's grid")
    if not 1 <= k <= n:
        raise ValueError(f"k={k} must lie in [1, {n}]")
    lib = build.load("stc_rows")
    if ties.shape != (c, lib.repro_stc_rows_max_chunks() + 1):
        raise ValueError(f"ties {tuple(ties.shape)} is not "
                         f"stc_rows_reduce_cuda's")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_stc_rows_apply_f32(
            x.data_ptr(), ref_row.data_ptr(), thr.data_ptr(), ssum.data_ptr(),
            cnt.data_ptr(), ties.data_ptr(), mask.data_ptr(), out.data_ptr(),
            k, int32(c, "C"), int32(n, "n"), stream)
    raise_on(err, "stc_rows_apply")
    LAUNCHES["stc_rows_apply"] += 1
    return out


def stc_rows_fused_cuda(x: torch.Tensor, ref_row: torch.Tensor,
                        mask: torch.Tensor, k: int
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """Masked per-row STC of rows of n ≤ :data:`N_FUSED` in one launch,
    τ_c selected on the card: ``(out, thr, ssum, cnt)``.  x (C, n) fp32,
    ref_row (n,) fp32, mask (C,) int32, k the entries kept per masked row
    (1 ≤ k ≤ n).  out (C, n): ``ref + μ_c·sign(x_c − ref)`` on row c's k
    survivors (every ``|Δ| > τ_c``, then the ties in index order) and
    ``ref`` elsewhere where ``mask[c]``, x_c bit for bit where not; thr,
    ssum (C,) fp32 and cnt (C,) int32: τ_c and the sum and count of
    ``|Δ| ≥ τ_c`` (``μ_c = (ssum_c − (cnt_c − k)·τ_c) / k``), 0 on
    unmasked rows.  Sizes are checked before devices."""
    if x.dim() != 2:
        raise ValueError(f"x must be 2-d, got {tuple(x.shape)}")
    c, n = x.shape
    if not 1 <= n <= N_FUSED:
        raise ValueError(f"rows of n={n} do not fit the fused kernel "
                         f"(1 to {N_FUSED})")
    if not 1 <= c <= MAX_ROWS:
        raise ValueError(f"C={c} exceeds the fused kernel's grid "
                         f"({MAX_ROWS} rows)")
    if not 1 <= k <= n:
        raise ValueError(f"k={k} must lie in [1, {n}]")
    check_tensor(x, "x", 2)
    check_tensor(ref_row, "ref_row", 1)
    check_tensor(mask, "mask", 1, torch.int32)
    if (ref_row.shape[0] != n or mask.shape[0] != c
            or ref_row.device != x.device or mask.device != x.device):
        raise ValueError(f"ref_row {tuple(ref_row.shape)} / mask "
                         f"{tuple(mask.shape)} do not match x {(c, n)}")
    lib = build.load("stc_compress")
    dev = x.device
    out = torch.empty_like(x)
    thr = torch.empty((c,), device=dev, dtype=torch.float32)
    ssum = torch.empty((c,), device=dev, dtype=torch.float32)
    cnt = torch.empty((c,), device=dev, dtype=torch.int32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_stc_rows_fused_f32(
            x.data_ptr(), ref_row.data_ptr(), mask.data_ptr(), out.data_ptr(),
            thr.data_ptr(), ssum.data_ptr(), cnt.data_ptr(), c, n, k, stream)
    raise_on(err, "stc_rows_fused")
    LAUNCHES["stc_rows_fused"] += 1
    return out, thr, ssum, cnt


def stc_rows_cuda(x: torch.Tensor, ref_row: torch.Tensor, mask: torch.Tensor,
                  sparsity: float) -> torch.Tensor:
    """Masked per-row STC on the card: one :func:`stc_rows_fused_cuda`
    launch for rows of n ≤ :data:`N_FUSED`, else τ by ``torch.topk`` and
    the reduce and apply kernels.  x (C, n) fp32; ref_row (n,); mask (C,)
    int32 on x's device (``fedshard.masked_stc_compress`` converts it once
    per tree)."""
    x = x.contiguous()
    ref_row = ref_row.to(torch.float32).contiguous()
    k = max(1, int(x.shape[1] * sparsity))
    if x.shape[1] <= N_FUSED:
        return stc_rows_fused_cuda(x, ref_row, mask, k)[0]
    thr = stc_rows_threshold(x, ref_row, sparsity)
    ssum, cnt, ties = stc_rows_reduce_cuda(x, ref_row, thr)
    return stc_rows_apply_cuda(x, ref_row, thr, ssum, cnt, ties, mask, k)


def dol_bid_scores_cuda(dol: torch.Tensor, chain_size: torch.Tensor,
                        dsi: torch.Tensor, data_size: torch.Tensor
                        ) -> torch.Tensor:
    """(M, N) candidate IID distances (w1_norm) by the hand-written kernel:
    dol (M, C), chain_size (M,), dsi (N, C), data_size (N,) → (M, N)."""
    check_tensor(dol, "dol", 2)
    check_tensor(chain_size, "chain_size", 1)
    check_tensor(dsi, "dsi", 2)
    check_tensor(data_size, "data_size", 1)
    m, c = dol.shape
    n = dsi.shape[0]
    if (dsi.shape[1] != c or chain_size.shape[0] != m
            or data_size.shape[0] != n):
        raise ValueError(f"dol {tuple(dol.shape)}, chain_size "
                         f"{tuple(chain_size.shape)}, dsi "
                         f"{tuple(dsi.shape)} and data_size "
                         f"{tuple(data_size.shape)} do not match")
    if (m + 7) // 8 > 65535:
        raise ValueError(f"M={m} exceeds the kernel's grid")
    out = torch.empty((m, n), device=dol.device, dtype=torch.float32)
    lib = build.load("dol_bid_scores")
    with torch.cuda.device(dol.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_dol_bid_scores_f32(
            dol.data_ptr(), chain_size.data_ptr(), dsi.data_ptr(),
            data_size.data_ptr(), out.data_ptr(), int32(m, "M"),
            int32(n, "N"), int32(c, "C"), stream)
    raise_on(err, "dol_bid_scores")
    LAUNCHES["dol_bid_scores"] += 1
    return out


def bid_value_fuse_cuda(bids: torch.Tensor, value: torch.Tensor,
                        weight: float) -> torch.Tensor:
    """``bids · (1 + weight · value[None, :])`` by the hand-written kernel:
    bids (M, N), value (N,), a host float weight → (M, N) fp32."""
    check_tensor(bids, "bids", 2)
    check_tensor(value, "value", 1)
    m, n = bids.shape
    if value.shape[0] != n or value.device != bids.device:
        raise ValueError(f"value {tuple(value.shape)} does not match bids "
                         f"{tuple(bids.shape)}")
    out = torch.empty_like(bids)
    lib = build.load("bid_value_fuse")
    with torch.cuda.device(bids.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_bid_value_fuse_f32(
            bids.data_ptr(), value.data_ptr(), float(weight), out.data_ptr(),
            int32(m, "M"), int32(n, "N"), stream)
    raise_on(err, "bid_value_fuse")
    LAUNCHES["bid_value_fuse"] += 1
    return out


def bid_fused_cuda(iid: torch.Tensor, dol: torch.Tensor,
                   chain_size: torch.Tensor, dsi: torch.Tensor,
                   data_size: torch.Tensor, value: torch.Tensor | None = None,
                   weight: float = 0.0) -> torch.Tensor:
    """One bid round's (M, N) Eq.-32 bids by the hand-written kernel:
    ``(iid[:, None] − cand)·(1 + weight·value[None, :])``, with ``cand``
    as :func:`dol_bid_scores_cuda` computes it.  iid (M,), dol (M, C),
    chain_size (M,), dsi (N, C), data_size (N,), value (N,) or None (no
    factor; ``weight`` unused), a host float weight → (M, N) fp32.
    Shapes are checked before devices."""
    vecs = [iid, chain_size, data_size] + ([] if value is None else [value])
    if dol.dim() != 2 or dsi.dim() != 2 or any(t.dim() != 1 for t in vecs):
        raise ValueError("dol and dsi must be 2-d, iid, chain_size, "
                         "data_size and value 1-d")
    m, c = dol.shape
    n = dsi.shape[0]
    if (dsi.shape[1] != c or chain_size.shape[0] != m or iid.shape[0] != m
            or data_size.shape[0] != n
            or (value is not None and value.shape[0] != n)):
        raise ValueError(
            f"iid {tuple(iid.shape)}, dol {tuple(dol.shape)}, chain_size "
            f"{tuple(chain_size.shape)}, dsi {tuple(dsi.shape)}, data_size "
            f"{tuple(data_size.shape)} and value "
            f"{None if value is None else tuple(value.shape)} do not match")
    for t, name in ((iid, "iid"), (dol, "dol"), (chain_size, "chain_size"),
                    (dsi, "dsi"), (data_size, "data_size"), (value, "value")):
        if t is not None:
            check_tensor(t, name, t.dim())
            if t.device != dol.device:
                raise ValueError(f"{name} lies on {t.device}, dol on "
                                 f"{dol.device}")
    out = torch.empty((m, n), device=dol.device, dtype=torch.float32)
    lib = build.load("dol_bid_scores")
    with torch.cuda.device(dol.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_bid_fused_f32(
            iid.data_ptr(), dol.data_ptr(), chain_size.data_ptr(),
            dsi.data_ptr(), data_size.data_ptr(),
            None if value is None else value.data_ptr(), float(weight),
            out.data_ptr(), int32(m, "M"), int32(n, "N"), int32(c, "C"),
            stream)
    raise_on(err, "bid_fused")
    LAUNCHES["bid_fused"] += 1
    return out
