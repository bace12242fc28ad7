"""Degree-of-Learning (DoL) and IID-distance primitives of FedDif (Sec. III-B).

Counterpart of the host half of ``repro.core.dol``: the Eq.-(2) DoL update,
the Eq.-(B.1) IID distance ``‖ψ − U‖₂`` and the mutable
:class:`DiffusionState` the host planner runs on.

The tensor twins (``*_t`` and :class:`PlannerState`) carry the same math
for the device planner.

The reference computes this math in jnp float32, and the planner's auction
decisions hang on it: one ulp can flip a near-tie bid and change a hop.  So
it is reproduced here bit for bit in numpy float32:

* the Eq.-(2) update is elementwise float32 (multiply, multiply, add,
  divide), exactly as the reference's eager jnp ops;
* the norm matches XLA's CPU reduction of ``jnp.linalg.norm``, whose sum
  order depends on the class count C (:func:`_sum_squares`).  A fused
  multiply-add is emulated in float64, where the product of two float32
  values is exact, and rounded once to float32;
* the Appendix-C metrics (``kld``, ``jsd``, ``w1_true``, Scenario 2) and
  the entropy of Eq. (27) take XLA-CPU's own float32 log
  (:func:`xla_log`), which is not correctly rounded, and its cumulative
  sum (:func:`xla_cumsum`).

Lemma 1's optimal DSI (Eq. 29), Corollary 1's feasibility bound (Eq. A.16)
and Lemma 2's closed-form IID distance (Eq. 30) are here too, in the
reference's eager float32 arithmetic.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["DiffusionState", "PlannerState", "uniform_dol", "dsi_from_counts",
           "update_dol", "iid_distance", "iid_distance_candidates",
           "optimal_dsi", "min_feasible_data_size",
           "closed_form_iid_distance", "entropy", "update_dol_t",
           "iid_distance_t", "iid_distance_candidates_t", "xla_sum",
           "xla_sum_t", "xla_log", "xla_log_t", "xla_cumsum", "xla_cumsum_t",
           "METRICS"]

_F32 = np.float32


def update_dol(dol: np.ndarray, chain_size, dsi: np.ndarray, data_size
               ) -> tuple[np.ndarray, np.ndarray]:
    """Eq. (2): ``ψ_k = (D_{k-1}·ψ_{k-1} + D_i·d_i) / (D_{k-1} + D_i)``.

    Returns ``(new_dol, new_chain_size)``; broadcasts over leading axes."""
    chain_size = np.asarray(chain_size, _F32)
    data_size = np.asarray(data_size, _F32)
    dol = np.asarray(dol, _F32)
    dsi = np.asarray(dsi, _F32)
    new_size = chain_size + data_size
    num = chain_size[..., None] * dol + data_size[..., None] * dsi
    new_dol = num / np.maximum(new_size[..., None], _F32(1.0))
    return new_dol, new_size


# XLA-CPU's reduction of ``jnp.linalg.norm(x, axis=-1)`` over C classes:
#
# * C > 32: the squares are rounded in a fusion of their own, then summed in
#   windows of 32 (a reduce-window whose padding is split evenly, the odd
#   element high), window sums in order, repeated until at most 32 remain;
#   those are added in order;
# * 5 ≤ C ≤ 8: LLVM vectorizes the loop over the innermost kept axis of
#   length > 1, and in the vector body the squares are rounded before the
#   sequential add; the scalar remainder contracts each step to
#   ``fma(x, x, acc)``.  :func:`_vector_body` gives the body's length, as
#   measured on x86-64 with AVX-512; at C = 5 with an inner kept axis of
#   length 2 behind an outer one the loop runs over the classes instead
#   (:func:`_class_vector_body`);
# * otherwise a sequential fused multiply-add over the class axis.
_WINDOW = 32
# Below this inner-axis length the vectorizer adds a 4-wide epilogue to its
# 8-wide body (5 ≤ C ≤ 8).
_EPILOGUE4_BELOW = {5: 40, 6: 40, 7: 96, 8: 88}


def _vector_body(k: int, c: int) -> int:
    """Leading positions of an inner kept axis of length ``k`` that XLA-CPU's
    vector loop covers when 5 ≤ C ≤ 8 (the rest run scalar)."""
    if k < 16:
        return k if k in (2, 4, 8) else 0
    if k % 8 >= 4 and k < _EPILOGUE4_BELOW[c]:
        return k // 4 * 4
    return k // 8 * 8


def _class_vector_body(kept: list[int], c: int) -> bool:
    """True where XLA-CPU vectorizes over the class axis instead: C = 5 with
    an inner kept axis of length 2 behind an outer one.  A 4-wide body
    rounds the squares of classes 0-3 and adds them in order; the scalar
    remainder adds class 4 as an fma."""
    return c == 5 and len(kept) >= 2 and kept[-1] == 2


def _window_pad(c: int) -> tuple[int, int]:
    total = -(-c // _WINDOW) * _WINDOW - c
    return total // 2, total - total // 2


def _seq_add(x: np.ndarray) -> np.ndarray:
    acc = np.zeros(x.shape[:-1], _F32)
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def xla_sum(x: np.ndarray) -> np.ndarray:
    """float32 ``Σ`` over the last axis in XLA-CPU's order for a plain sum:
    in order up to 32 terms; a longer axis in windows of 32 (zero padding
    split evenly, the odd element high), window sums in order, repeated
    until at most 32 remain, which are added in order.  ``jnp.sum`` and
    ``jnp.mean`` (this sum times fp32(1/N)) reduce so, and so does the norm
    of :func:`_sum_squares` for C > 32 (ROADMAP C1, C2)."""
    x = np.asarray(x, _F32)
    while x.shape[-1] > _WINDOW:
        lo, hi = _window_pad(x.shape[-1])
        x = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(lo, hi)])
        x = _seq_add(x.reshape(x.shape[:-1] + (-1, _WINDOW)))
    return _seq_add(x)


def _sum_squares(d: np.ndarray) -> np.ndarray:
    """``Σ_j d_j²`` over the last axis in XLA-CPU's float32 order."""
    c = d.shape[-1]
    if c > _WINDOW:
        return xla_sum(d * d)
    kept = [k for k in d.shape[:-1] if k != 1]
    if _class_vector_body(kept, c):
        # Classes 0-3 rounded and added in order, class 4 as an fma.
        acc = _seq_add(d[..., :4] * d[..., :4]).astype(np.float64)
        x = d[..., 4].astype(np.float64)
        return (x * x + acc).astype(_F32)
    acc = np.zeros(d.shape[:-1], _F32)
    for j in range(c):
        x = d[..., j].astype(np.float64)
        acc = (x * x + acc.astype(np.float64)).astype(_F32)
    if 5 <= c <= 8 and kept:
        body = _vector_body(kept[-1], c)
        head = d.reshape(kept + [c])[..., :body, :]
        acc = acc.reshape(kept)
        acc[..., :body] = _seq_add(head * head)
        acc = acc.reshape(d.shape[:-1])
    return acc


def _w1_norm(p: np.ndarray, num_classes: int) -> np.ndarray:
    """Eq. (B.1): ``‖ψ − U‖₂``, summed in XLA's order (see module doc)."""
    return np.sqrt(_sum_squares(p - _F32(1.0 / num_classes)))


# XLA-CPU's float32 log (the Cephes polynomial XLA emits for ``log``, with
# LLVM's multiply-add contraction).  It is not correctly rounded: it differs
# from the correctly rounded log in ~14 % of float32 inputs, from
# ``torch.log`` in ~14 % and from ``np.log`` in ~23 %, and one ulp flips a
# near-tie bid.  The emulation runs the same float32 steps:
#
# * range reduction: x = m·2^e with m in [0.5, 1) from the bits; where
#   m < √½, e −= 1 and x = (m − 1) + m, else x = m − 1;
# * the degree-8 polynomial in three parts, each step ``fma(y, x, p_k)``,
#   joined by ``fma(y, x³, y1)`` and ``fma(y, x³, y2)``, with x² = x·x and
#   x³ = x²·x rounded;
# * assembly: ``fma(y, x³, q1·e)``, then ``fma(−½, x², x)`` plus it, then
#   ``fma(q2, e, ·)``;
# * subnormal inputs are flushed to zero (−inf), 0 → −inf, x < 0 or NaN →
#   the NaN with every bit set.
#
# Held to ``jnp.log`` bit for bit on every float32 of the binades the
# tests sweep (``tests/test_torch_appendix.py``).  The fused multiply-adds
# are emulated in float64, where the product of two float32 values is
# exact, and rounded once.
_LOG_P = tuple(np.float32(v) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG_Q1 = np.float32(-2.12194440e-4)
_LOG_Q2 = np.float32(0.693359375)
_SQRTHF = np.float32(0.707106781186547524)
_MIN_NORMAL = np.float32(1.17549435e-38)
_MANT_MASK = np.int32(-2139095041)          # ~0x7f800000
_HALF_BITS = np.int32(0x3F000000)
_NAN = np.int32(-1).view(_F32)             # all bits set, XLA's NaN here


def _fma(a, b, c) -> np.ndarray:
    """``fma(a, b, c)`` in float32 (one rounding of the exact product)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_F32)


def xla_log(x) -> np.ndarray:
    """float32 natural log as XLA-CPU computes it (see the comment above)."""
    x = np.asarray(x, _F32)
    bits = np.maximum(x, _MIN_NORMAL).view(np.int32)
    e = _F32(1.0) + ((bits >> 23) - 127).astype(_F32)
    m = ((bits & _MANT_MASK) | _HALF_BITS).view(_F32)
    low = m < _SQRTHF
    e = e - np.where(low, _F32(1.0), _F32(0.0))
    r = (m - _F32(1.0)) + np.where(low, m, _F32(0.0))
    r2 = r * r
    r3 = r2 * r
    y = _fma(_fma(r, _LOG_P[0], _LOG_P[1]), r, _LOG_P[2])
    y1 = _fma(_fma(r, _LOG_P[3], _LOG_P[4]), r, _LOG_P[5])
    y2 = _fma(_fma(r, _LOG_P[6], _LOG_P[7]), r, _LOG_P[8])
    y = _fma(_fma(y, r3, y1), r3, y2)
    y = _fma(y, r3, _LOG_Q1 * e)
    out = _fma(_LOG_Q2, e, _fma(_F32(-0.5), r2, r) + y)
    out = np.where(x < _MIN_NORMAL, _F32(-np.inf), out)
    out = np.where(x == np.inf, _F32(np.inf), out)
    return np.where((x < 0) | np.isnan(x), _NAN, out).astype(_F32)


# XLA-CPU rewrites a cumulative sum over more than 16 entries: zero-padded
# to chunks of 16, a sequential prefix sum inside each chunk, the chunk
# totals' exclusive prefix sum added after.  Up to 16 entries it is the
# sequential prefix sum (``np.cumsum``'s order).
_CUMSUM_BASE = 16


def _seq_cumsum(x: np.ndarray) -> np.ndarray:
    out = np.empty_like(x)
    acc = np.zeros(x.shape[:-1], _F32)
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
        out[..., j] = acc
    return out


def xla_cumsum(x) -> np.ndarray:
    """float32 ``jnp.cumsum(x, axis=-1)`` in XLA-CPU's order."""
    x = np.asarray(x, _F32)
    n = x.shape[-1]
    if n <= _CUMSUM_BASE:
        return _seq_cumsum(x)
    k = -(-n // _CUMSUM_BASE)
    pad = [(0, 0)] * (x.ndim - 1) + [(0, k * _CUMSUM_BASE - n)]
    inner = _seq_cumsum(np.pad(x, pad).reshape(x.shape[:-1]
                                               + (k, _CUMSUM_BASE)))
    tot = xla_cumsum(inner[..., -1])
    excl = np.concatenate([np.zeros(tot.shape[:-1] + (1,), _F32),
                           tot[..., :-1]], axis=-1)
    return (inner + excl[..., None]).reshape(x.shape[:-1] + (-1,))[..., :n]


_EPS = _F32(1e-12)


def _w1_true(p: np.ndarray, num_classes: int) -> np.ndarray:
    """True Wasserstein-1 on the ordered class line (CDF L1 distance)."""
    return xla_sum(np.abs(xla_cumsum(p - _F32(1.0 / num_classes))))


def _kld(p: np.ndarray, num_classes: int) -> np.ndarray:
    """KL(ψ ‖ U) — Appendix C, Scenario 2."""
    pc = np.clip(p, _EPS, _F32(1.0))
    lu = xla_log(_F32(1.0 / num_classes))
    return xla_sum(pc * (xla_log(pc) - lu))


def _jsd(p: np.ndarray, num_classes: int) -> np.ndarray:
    """Jensen–Shannon divergence to uniform — Appendix C, Scenario 2."""
    u = _F32(1.0 / num_classes)
    mc = np.clip(_F32(0.5) * (p + u), _EPS, _F32(1.0))
    pc = np.clip(p, _EPS, _F32(1.0))
    lmc = xla_log(mc)
    t1 = xla_sum(pc * (xla_log(pc) - lmc))
    t2 = xla_sum(u * (xla_log(u) - lmc))
    return _F32(0.5) * (t1 + t2)


_DISTANCES = {"w1_norm": _w1_norm, "w1_true": _w1_true, "kld": _kld,
              "jsd": _jsd}

#: The IID metrics: the paper's Eq. (B.1) and Appendix C's Scenario 2.
METRICS = tuple(_DISTANCES)


def _check_metric(metric: str) -> None:
    if metric not in _DISTANCES:
        raise ValueError(f"unknown IID metric {metric!r}; expected one of "
                         f"{METRICS}")


def iid_distance(dol: np.ndarray, metric: str = "w1_norm") -> np.ndarray:
    """IID distance ``δ(ψ) = dist(ψ, U)`` with a trailing class axis, in
    the reference's eager float32 bits."""
    _check_metric(metric)
    dol = np.asarray(dol, _F32)
    return _DISTANCES[metric](dol, dol.shape[-1])


def iid_distance_candidates(dol: np.ndarray, chain_size: np.ndarray,
                            dsi: np.ndarray, data_size: np.ndarray,
                            metric: str = "w1_norm") -> np.ndarray:
    """(M, N) IID distance model m would have after client i trains it."""
    cand, _ = update_dol(np.asarray(dol, _F32)[:, None, :],
                         np.asarray(chain_size, _F32)[:, None],
                         np.asarray(dsi, _F32)[None, :, :],
                         np.asarray(data_size, _F32)[None, :])
    return iid_distance(cand, metric)


# ------------------------------------------------- Lemmas 1–2, Eq. (27)


def uniform_dol(num_classes: int, dtype=np.float32) -> np.ndarray:
    """``U = (1/C)·1`` — the DoL of a model trained on perfectly IID data."""
    return np.full((num_classes,), 1.0 / num_classes, dtype=dtype)


def dsi_from_counts(counts) -> np.ndarray:
    """DSI from per-class sample counts: ``d[c] = n_c / Σ n`` over a
    trailing class axis; all-zero counts map to the uniform point."""
    counts = np.asarray(counts, _F32)
    total = xla_sum(counts)[..., None]
    c = counts.shape[-1]
    return np.where(total > 0, counts / np.maximum(total, _F32(1.0)),
                    _F32(1.0 / c)).astype(_F32)


def optimal_dsi(dol, chain_size, data_size) -> np.ndarray:
    """Lemma 1 / Eq. (29): the DSI a model wants from its next trainer,
    ``d*[c] = (D_{P_k}/C − D_{P_{k-1}}·ψ_{k-1}[c]) / D_i`` with
    ``D_{P_k} = D_{P_{k-1}} + D_i``.  May leave the simplex when ``D_i``
    is below the Corollary-1 bound."""
    dol = np.asarray(dol, _F32)
    chain = np.asarray(chain_size, _F32)[..., None]
    di = np.asarray(data_size, _F32)[..., None]
    c = _F32(dol.shape[-1])
    return (((chain + di) / c - chain * dol)
            / np.maximum(di, _F32(1e-9))).astype(_F32)


def min_feasible_data_size(dol, chain_size) -> np.ndarray:
    """Corollary 1 / Eq. (A.16): the smallest ``D_i`` that keeps the
    optimal DSI on the simplex, ``max_c {C·D_{k-1}·ψ[c] − D_{k-1}}``."""
    dol = np.asarray(dol, _F32)
    chain = np.asarray(chain_size, _F32)[..., None]
    c = _F32(dol.shape[-1])
    return np.maximum(np.max(c * chain * dol - chain, axis=-1),
                      _F32(0.0)).astype(_F32)


def closed_form_iid_distance(variation, chain_size) -> np.ndarray:
    """Lemma 2 / Eq. (30): ``W1(ψ_k, U) = ‖φ_k − φ̄_k‖ / D_{P_k}``, with
    ``jnp.mean``'s order for φ̄ (the XLA sum times fp32(1/C), ROADMAP C2)
    and ``jnp.linalg.norm``'s (:func:`_sum_squares`)."""
    phi = np.asarray(variation, _F32)
    mean = xla_sum(phi) * _F32(1.0 / phi.shape[-1])
    norm = np.sqrt(_sum_squares(phi - mean[..., None]))
    return (norm / np.maximum(np.asarray(chain_size, _F32),
                              _F32(1e-9))).astype(_F32)


def entropy(dol) -> np.ndarray:
    """Shannon entropy of a DoL (Eq. 27), the quantity Lemma 1 maximizes."""
    p = np.clip(np.asarray(dol, _F32), _EPS, _F32(1.0))
    return -xla_sum(p * xla_log(p))


# ------------------------------------------------------------ tensor twins
#
# The device planner (:mod:`repro_torch.core.planner`) runs the same math on
# float32 tensors, on the card or on the CPU.  On the CPU these give the
# numpy versions' bits; the fused multiply-adds are emulated in float64,
# where the product of two float32 values is exact, then rounded once.


def _fma_t(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
           ) -> torch.Tensor:
    """``fma(a, b, c)`` in float32 (one rounding of the exact product)."""
    return (a.double() * b.double() + c.double()).float()


def update_dol_t(dol: torch.Tensor, chain_size: torch.Tensor,
                 dsi: torch.Tensor, data_size: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Tensor Eq. (2), elementwise float32 as :func:`update_dol`."""
    new_size = chain_size + data_size
    num = chain_size[..., None] * dol + data_size[..., None] * dsi
    return num / torch.clamp(new_size[..., None], min=1.0), new_size


def _seq_add_t(x: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def xla_sum_t(x: torch.Tensor) -> torch.Tensor:
    """Tensor twin of :func:`xla_sum`: float32 ``Σ`` over the last axis in
    XLA-CPU's order, on the tensor's device."""
    x = x.to(torch.float32)
    while x.shape[-1] > _WINDOW:
        x = torch.nn.functional.pad(x, _window_pad(x.shape[-1]))
        x = _seq_add_t(x.reshape(x.shape[:-1] + (-1, _WINDOW)))
    return _seq_add_t(x)


def _sum_squares_t(d: torch.Tensor) -> torch.Tensor:
    """Tensor twin of :func:`_sum_squares` (XLA-CPU's order)."""
    c = d.shape[-1]
    if c > _WINDOW:
        return xla_sum_t(d * d)
    kept = [k for k in d.shape[:-1] if k != 1]
    if _class_vector_body(kept, c):
        head = d[..., :4]
        return _fma_t(d[..., 4], d[..., 4], _seq_add_t(head * head))
    acc = torch.zeros(d.shape[:-1], dtype=torch.float32, device=d.device)
    for j in range(c):
        acc = _fma_t(d[..., j], d[..., j], acc)
    if 5 <= c <= 8 and kept:
        body = _vector_body(kept[-1], c)
        head = d.reshape(kept + [c])[..., :body, :]
        acc = torch.cat([_seq_add_t(head * head),
                         acc.reshape(kept)[..., body:]], dim=-1)
        acc = acc.reshape(d.shape[:-1])
    return acc


def _w1_norm_t(p: torch.Tensor) -> torch.Tensor:
    """Tensor Eq. (B.1) in the order of :func:`_w1_norm`."""
    u = torch.tensor(1.0 / p.shape[-1], dtype=torch.float32, device=p.device)
    acc = _sum_squares_t(p - u)
    # float32 sqrt correctly rounded: through float64, whose double
    # rounding is exact for sqrt (torch's vectorized float32 sqrt on the
    # CPU is within 0.5001 ulp, and one ulp flips near-tie bids).
    return torch.sqrt(acc.double()).float()


def xla_log_t(x: torch.Tensor) -> torch.Tensor:
    """Tensor twin of :func:`xla_log` on the tensor's device: XLA-CPU's
    float32 log, step for step (the fused multiply-adds through
    :func:`_fma_t`)."""
    x = x.to(torch.float32)
    bits = torch.clamp(x, min=float(_MIN_NORMAL)).view(torch.int32)
    e = 1.0 + ((bits >> 23) - 127).to(torch.float32)
    m = ((bits & int(_MANT_MASK)) | int(_HALF_BITS)).view(torch.float32)
    low = m < float(_SQRTHF)
    zero = torch.zeros_like(m)
    e = e - torch.where(low, 1.0, zero)
    r = (m - 1.0) + torch.where(low, m, zero)
    r2 = r * r
    r3 = r2 * r

    def c(v):
        return torch.full_like(r, float(v))
    y = _fma_t(_fma_t(r, c(_LOG_P[0]), c(_LOG_P[1])), r, c(_LOG_P[2]))
    y1 = _fma_t(_fma_t(r, c(_LOG_P[3]), c(_LOG_P[4])), r, c(_LOG_P[5]))
    y2 = _fma_t(_fma_t(r, c(_LOG_P[6]), c(_LOG_P[7])), r, c(_LOG_P[8]))
    y = _fma_t(_fma_t(y, r3, y1), r3, y2)
    y = _fma_t(y, r3, c(_LOG_Q1) * e)
    out = _fma_t(c(_LOG_Q2), e, _fma_t(c(-0.5), r2, r) + y)
    out = torch.where(x < float(_MIN_NORMAL), -torch.inf, out)
    out = torch.where(x == torch.inf, torch.inf, out)
    nan = torch.tensor(-1, dtype=torch.int32,
                       device=x.device).view(torch.float32)
    return torch.where((x < 0) | torch.isnan(x), nan, out)


def _seq_cumsum_t(x: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    cols = []
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
        cols.append(acc)
    return torch.stack(cols, dim=-1)


def xla_cumsum_t(x: torch.Tensor) -> torch.Tensor:
    """Tensor twin of :func:`xla_cumsum` (XLA-CPU's chunked order)."""
    x = x.to(torch.float32)
    n = x.shape[-1]
    if n <= _CUMSUM_BASE:
        return _seq_cumsum_t(x)
    k = -(-n // _CUMSUM_BASE)
    xp = torch.nn.functional.pad(x, (0, k * _CUMSUM_BASE - n))
    inner = _seq_cumsum_t(xp.reshape(x.shape[:-1] + (k, _CUMSUM_BASE)))
    tot = xla_cumsum_t(inner[..., -1])
    excl = torch.nn.functional.pad(tot[..., :-1], (1, 0))
    return (inner + excl[..., None]).reshape(x.shape[:-1] + (-1,))[..., :n]


# Inside the reference's jitted programs XLA-CPU's LLVM back end compiles
# each class sum of the divergences in one of these forms, by C, by metric
# and by program (the standalone jitted ``iid_distance``, "iid", or the
# planner's bid expression ``iid − dol_bid_scores``: its candidates, "bid",
# and the model's own distance inside it, "bid_iid"):
#
# * "chain": ``acc = fma(a_j, b_j, acc)`` in class order;
# * "vec8": eight lanes, lane l accumulating classes l, l + 8, … of the
#   first C − C mod 8 as fused multiply-adds, the lanes then added in a
#   halving tree (lanes 0–3 plus 4–7, then 0–1 plus 2–3, then 0 plus 1),
#   the classes past the last full vector added after it as fused
#   multiply-adds;
# * "vec8m": "vec8" with the classes past the last full vector folded into
#   lanes 0, 1, … (a masked last vector) before the tree;
# * "vec8e2": "vec8", then the next two classes in a two-lane epilogue
#   started from the tree's sum in lane 0, its lanes then added;
# * "vec4e4": four lanes over the first C − C mod 8 classes (lane l
#   accumulating l, l + 4, …) and their halving tree, then the next four
#   classes in a four-lane epilogue started from that sum in lane 0, and
#   its halving tree;
# * "windowed": the products rounded and summed in XLA's windowed order, as
#   eagerly (every C > 32).
#
# Up to 32 classes the sum is a chain except where :data:`_LANE_SUMS` names
# C for (program, metric, term) — term 0 is kld's sum and jsd's
# ``Σ p·(log p − log m)``, term 1 jsd's ``Σ u·(log u − log m)``.  Measured
# on x86-64 against ``jax.jit(iid_distance)`` and the jitted bid expression
# at C = 3 … 33 and 100 (``tests/test_torch_appendix.py``).  The bid
# expression's forms were read apart by black-box probes (ROADMAP C7): its
# model distance ("bid_iid") with every candidate uniform, the candidates'
# with every DoL uniform and chain = D_i = 64 (so Eq. 2 is exact), each
# lane read from inputs with two or four non-uniform classes.  Where
# :data:`_BID_IID_MEASURED` does not name C the model distance inside the
# bid expression takes the standalone's forms.
_LANE_SUMS = {("iid", "kld", 0): {32: "vec8"},
              ("iid", "jsd", 0): {18: "vec8e2", 20: "vec4e4", 24: "vec8",
                                  25: "vec8", 32: "vec8"},
              ("iid", "jsd", 1): {25: "vec8", 32: "vec8"},
              ("bid", "kld", 0): {20: "vec4e4", 24: "vec8", 32: "vec8"},
              ("bid", "jsd", 0): {14: "vec8m", 15: "vec8m", 16: "vec8",
                                  17: "vec8", 18: "vec8e2", 20: "vec4e4",
                                  24: "vec8", 32: "vec8"},
              ("bid", "jsd", 1): {18: "vec8e2", 20: "vec4e4", 24: "vec8",
                                  32: "vec8"},
              ("bid_iid", "jsd", 0): {32: "vec8"}}
_BID_IID_MEASURED = {"jsd": (18, 20, 24, 32)}
# Each lane form: (main lanes, the last vector masked, epilogue lanes).
_LANE_FORMS = {"vec8": (8, False, 0), "vec8m": (8, True, 0),
               "vec8e2": (8, False, 2), "vec4e4": (4, False, 4)}
_VEC8 = 8
# Above this class count w1_true's bid numerator contracts the other
# product.
_W1_TRUE_SWAP_ABOVE = 16

# In the bid expression some classes' Eq.-(2) numerators are not contracted
# (``D_{k-1}·ψ + D_i·d_i``, both products rounded): every class at C ≤ 8
# where XLA vectorizes the loop over the clients (N = 4 or 8), and jsd's
# classes in :data:`_JSD_UNCONTRACTED`, C → (those classes, the N at which
# they contract after all).
_VECTOR_CLIENTS = (4, 8)
_SMALL_C = 8
_JSD_UNCONTRACTED = {10: ((8, 9), _VECTOR_CLIENTS),
                     11: ((8, 9, 10), _VECTOR_CLIENTS),
                     12: ((7, 8, 9, 10, 11), _VECTOR_CLIENTS),
                     13: ((7, 8, 9, 10, 11, 12), _VECTOR_CLIENTS),
                     17: ((16,), ()), 18: (tuple(range(18)), ()),
                     20: (tuple(range(20)), ()), 24: (tuple(range(24)), ()),
                     32: (tuple(range(32)), ())}


def _uncontracted_classes(metric: str, c: int, n: int) -> tuple:
    if n in _VECTOR_CLIENTS and c <= _SMALL_C:
        return tuple(range(c))
    if metric != "jsd" or c not in _JSD_UNCONTRACTED:
        return ()
    classes, contracted_n = _JSD_UNCONTRACTED[c]
    return () if n in contracted_n else classes


def _halving_tree(lanes: torch.Tensor) -> torch.Tensor:
    while lanes.shape[-1] > 1:
        half = lanes.shape[-1] // 2
        lanes = lanes[..., :half] + lanes[..., half:]
    return lanes[..., 0]


def _jit_dot_t(a: torch.Tensor, b: torch.Tensor, form: str = "chain"
               ) -> torch.Tensor:
    """``Σ_j a_j·b_j`` over the last axis in one of XLA's compiled forms
    (see above)."""
    a, b = torch.broadcast_tensors(a, b)
    c = a.shape[-1]
    if form == "windowed":
        return xla_sum_t(a * b)
    acc = torch.zeros(a.shape[:-1], dtype=torch.float32, device=a.device)
    done = 0
    if form in _LANE_FORMS:
        width, masked, epilogue = _LANE_FORMS[form]
        done = c if masked else c // _VEC8 * _VEC8
        lanes = torch.zeros(a.shape[:-1] + (width,), dtype=torch.float32,
                            device=a.device)
        for j in range(0, done, width):
            w = min(width, done - j)
            lanes = torch.cat([_fma_t(a[..., j:j + w], b[..., j:j + w],
                                      lanes[..., :w]), lanes[..., w:]], -1)
        acc = _halving_tree(lanes)
        w = min(epilogue, c - done)
        if w:
            tail = torch.zeros(a.shape[:-1] + (epilogue,),
                               dtype=torch.float32, device=a.device)
            tail[..., 0] = acc
            tail = torch.cat([_fma_t(a[..., done:done + w],
                                     b[..., done:done + w], tail[..., :w]),
                              tail[..., w:]], -1)
            acc = _halving_tree(tail)
            done += w
    for j in range(done, c):
        acc = _fma_t(a[..., j], b[..., j], acc)
    return acc


def _sum_form(site: str, metric: str, term: int, c: int) -> str:
    if site == "bid_iid" and c not in _BID_IID_MEASURED.get(metric, ()):
        site = "iid"
    if c > _WINDOW:
        return "windowed"
    return _LANE_SUMS.get((site, metric, term), {}).get(c, "chain")


def _w1_true_t(p: torch.Tensor) -> torch.Tensor:
    u = torch.tensor(1.0 / p.shape[-1], dtype=torch.float32, device=p.device)
    return xla_sum_t(torch.abs(xla_cumsum_t(p - u)))


def _kld_t(p: torch.Tensor, site: str = "iid") -> torch.Tensor:
    c = p.shape[-1]
    pc = torch.clamp(p, float(_EPS), 1.0)
    lu = xla_log_t(torch.tensor(1.0 / c, dtype=torch.float32,
                                device=p.device))
    return _jit_dot_t(pc, xla_log_t(pc) - lu, _sum_form(site, "kld", 0, c))


def _jsd_t(p: torch.Tensor, site: str = "iid") -> torch.Tensor:
    c = p.shape[-1]
    u = torch.tensor(1.0 / c, dtype=torch.float32, device=p.device)
    mc = torch.clamp(0.5 * (p + u), float(_EPS), 1.0)
    pc = torch.clamp(p, float(_EPS), 1.0)
    lmc = xla_log_t(mc)
    t1 = _jit_dot_t(pc, xla_log_t(pc) - lmc, _sum_form(site, "jsd", 0, c))
    t2 = _jit_dot_t(u.expand_as(lmc), xla_log_t(u) - lmc,
                    _sum_form(site, "jsd", 1, c))
    return 0.5 * (t1 + t2)


def iid_distance_t(dol: torch.Tensor, metric: str = "w1_norm",
                   site: str = "iid") -> torch.Tensor:
    """Tensor twin of :func:`iid_distance` in the bits of the reference's
    jitted programs: the same as the eager ones for ``w1_norm`` and
    ``w1_true``; for ``kld`` and ``jsd`` with the class sums as XLA
    compiles them in the standalone ``iid_distance`` (``site="iid"``), or
    in the planner's bid expression for its candidates (``"bid"``) and for
    the model's own distance beside them (``"bid_iid"``;
    :func:`_jit_dot_t`)."""
    _check_metric(metric)
    dol = dol.to(torch.float32)
    if metric == "w1_norm":
        return _w1_norm_t(dol)
    if metric == "w1_true":
        return _w1_true_t(dol)
    return {"kld": _kld_t, "jsd": _jsd_t}[metric](dol, site)


def iid_distance_candidates_t(dol: torch.Tensor, chain_size: torch.Tensor,
                              dsi: torch.Tensor, data_size: torch.Tensor,
                              metric: str = "w1_norm") -> torch.Tensor:
    """Tensor twin of :func:`iid_distance_candidates`: the (M, N, C)
    broadcast composite, (M, N) out, in the bits of the reference's jitted
    bid expression.  For ``w1_norm`` Eq. (2) keeps the eager form.  For the
    Appendix-C metrics XLA contracts one product of Eq. (2)'s numerator
    into the sum: ``fma(D_i, d_i, D_{k-1}·ψ)``, except for ``w1_true`` at
    C > 16, where it is ``fma(D_{k-1}, ψ, D_i·d_i)``, and for the classes
    of :func:`_uncontracted_classes`, summed uncontracted."""
    if metric == "w1_norm":
        cand, _ = update_dol_t(dol[:, None, :], chain_size[:, None],
                               dsi[None, :, :], data_size[None, :])
        return iid_distance_t(cand, metric)
    m, n, c = dol.shape[0], dsi.shape[0], dol.shape[1]
    shape = (m, n, c)
    chain = chain_size[:, None, None].expand(shape)
    size = data_size[None, :, None].expand(shape)
    psi = dol[:, None, :].expand(shape)
    d = dsi[None, :, :].expand(shape)
    if metric == "w1_true" and c > _W1_TRUE_SWAP_ABOVE:
        num = _fma_t(chain, psi, size * d)
    else:
        num = _fma_t(size, d, chain * psi)
    classes = _uncontracted_classes(metric, c, n)
    if classes:
        plain = chain * psi + size * d
        keep = torch.zeros(c, dtype=torch.bool, device=num.device)
        keep[list(classes)] = True
        num = torch.where(keep, plain, num)
    new_size = chain_size[:, None] + data_size[None, :]
    cand = num / torch.clamp(new_size[..., None], min=1.0)
    return iid_distance_t(cand, metric, site="bid")


class PlannerState(NamedTuple):
    """Functional twin of :class:`DiffusionState` on tensors, for the
    device planner's round loop: every field is a fixed-shape tensor on one
    device, and every update returns a new state."""
    dol: torch.Tensor            # (M, C) float32
    chain_size: torch.Tensor     # (M,) float32
    visited: torch.Tensor        # (M, N) bool
    holder: torch.Tensor         # (M,) int64

    @classmethod
    def init(cls, num_models: int, num_clients: int, num_classes: int,
             device: torch.device | str = "cpu") -> "PlannerState":
        return cls(
            dol=torch.zeros((num_models, num_classes), dtype=torch.float32,
                            device=device),
            chain_size=torch.zeros((num_models,), dtype=torch.float32,
                                   device=device),
            visited=torch.zeros((num_models, num_clients), dtype=torch.bool,
                                device=device),
            holder=torch.arange(num_models, device=device)
            % max(num_clients, 1))

    def record_training(self, model: int, client: int, dsi: torch.Tensor,
                        data_size: float) -> "PlannerState":
        """Eq. (2) fold of one (model, client) pair."""
        size = torch.tensor(data_size, dtype=torch.float32,
                            device=self.dol.device)
        new_dol, new_size = update_dol_t(self.dol[model],
                                         self.chain_size[model], dsi, size)
        dol, chain = self.dol.clone(), self.chain_size.clone()
        visited, holder = self.visited.clone(), self.holder.clone()
        dol[model] = new_dol
        chain[model] = new_size
        visited[model, client] = True
        holder[model] = client
        return PlannerState(dol, chain, visited, holder)

    def record_round(self, dst: torch.Tensor, mask: torch.Tensor,
                     dsi: torch.Tensor, data_sizes: torch.Tensor
                     ) -> "PlannerState":
        """Fold one diffusion round of hops in one masked update: model m
        trains on ``dst[m]`` where ``mask[m]`` (``dst`` must be a valid
        index everywhere; constraint 18d keeps destinations unique)."""
        # Eq. (2) as XLA compiles it inside the reference's jitted loop,
        # where one product and the sum contract to a fused multiply-add:
        # ψ' = fma(D_i, d_i, D_{k-1}·ψ) / max(D_{k-1} + D_i, 1).  The eager
        # form (update_dol_t) differs from it by an ulp in some entries,
        # and later bids inherit the ulp.
        size = data_sizes[dst]
        new_size = self.chain_size + size
        num = _fma_t(size[:, None].expand_as(self.dol), dsi[dst],
                     self.chain_size[:, None] * self.dol)
        new_dol = num / torch.clamp(new_size[:, None], min=1.0)
        rows = torch.arange(self.dol.shape[0], device=self.dol.device)
        visited = self.visited.clone()
        visited[rows, dst] = self.visited[rows, dst] | mask
        return PlannerState(
            dol=torch.where(mask[:, None], new_dol, self.dol),
            chain_size=torch.where(mask, new_size, self.chain_size),
            visited=visited,
            holder=torch.where(mask, dst, self.holder))


@dataclasses.dataclass
class DiffusionState:
    """Host-side bookkeeping for one communication round of FedDif.

    Tracks, per model m: the DoL, the chain data size, and the set of clients
    already visited (constraint 18c — no retraining)."""
    dol: np.ndarray            # (M, C)
    chain_size: np.ndarray     # (M,)
    visited: np.ndarray        # (M, N) bool
    holder: np.ndarray         # (M,) int — client currently holding model m
    round_index: int = 0

    @classmethod
    def init(cls, num_models: int, num_clients: int, num_classes: int
             ) -> "DiffusionState":
        return cls(
            dol=np.zeros((num_models, num_classes), _F32),
            chain_size=np.zeros((num_models,), _F32),
            visited=np.zeros((num_models, num_clients), bool),
            holder=(np.arange(num_models) % num_clients).astype(np.int64),
        )

    def record_training(self, model: int, client: int, dsi: np.ndarray,
                        data_size: float) -> None:
        new_dol, new_size = update_dol(self.dol[model], self.chain_size[model],
                                       dsi, data_size)
        self.dol[model] = new_dol
        self.chain_size[model] = new_size
        self.visited[model, client] = True
        self.holder[model] = client

    def iid_distances(self, metric: str = "w1_norm") -> np.ndarray:
        return iid_distance(self.dol, metric)

    def snapshot(self) -> "DiffusionState":
        """Deep copy — the plan cache stores post-plan state as one."""
        return DiffusionState(dol=self.dol.copy(),
                              chain_size=self.chain_size.copy(),
                              visited=self.visited.copy(),
                              holder=self.holder.copy(),
                              round_index=self.round_index)

    def restore(self, other: "DiffusionState") -> None:
        """Overwrite this state in place from a snapshot (cache replay)."""
        self.dol = other.dol.copy()
        self.chain_size = other.chain_size.copy()
        self.visited = other.visited.copy()
        self.holder = other.holder.copy()
        self.round_index = other.round_index

    def functional(self, device: torch.device | str = "cpu"
                   ) -> PlannerState:
        """Tensor view on ``device`` for the device planner."""
        return PlannerState(
            dol=torch.as_tensor(self.dol, dtype=torch.float32,
                                device=device),
            chain_size=torch.as_tensor(self.chain_size, dtype=torch.float32,
                                       device=device),
            visited=torch.as_tensor(self.visited, dtype=torch.bool,
                                    device=device),
            holder=torch.as_tensor(self.holder, dtype=torch.int64,
                                   device=device))

    def update_from(self, fstate: PlannerState, rounds_advanced: int = 0
                    ) -> None:
        """Adopt a post-plan :class:`PlannerState` (in place, host arrays)."""
        self.dol = fstate.dol.cpu().numpy().astype(_F32)
        self.chain_size = fstate.chain_size.cpu().numpy().astype(_F32)
        self.visited = fstate.visited.cpu().numpy().astype(bool)
        self.holder = fstate.holder.cpu().numpy().astype(np.int64)
        self.round_index += int(rounds_advanced)
