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
  values is exact, and rounded once to float32.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["DiffusionState", "PlannerState", "update_dol", "iid_distance",
           "iid_distance_candidates", "update_dol_t", "iid_distance_t",
           "iid_distance_candidates_t", "xla_sum", "xla_sum_t"]

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


def iid_distance(dol: np.ndarray, metric: str = "w1_norm") -> np.ndarray:
    """IID distance ``δ(ψ) = dist(ψ, U)`` with a trailing class axis."""
    if metric != "w1_norm":
        raise NotImplementedError(
            f"IID metric {metric!r}: the Appendix-C metrics (kld, jsd, "
            f"w1_true) are queued as ROADMAP item A15")
    dol = np.asarray(dol, _F32)
    return _w1_norm(dol, dol.shape[-1])


def iid_distance_candidates(dol: np.ndarray, chain_size: np.ndarray,
                            dsi: np.ndarray, data_size: np.ndarray,
                            metric: str = "w1_norm") -> np.ndarray:
    """(M, N) IID distance model m would have after client i trains it."""
    cand, _ = update_dol(np.asarray(dol, _F32)[:, None, :],
                         np.asarray(chain_size, _F32)[:, None],
                         np.asarray(dsi, _F32)[None, :, :],
                         np.asarray(data_size, _F32)[None, :])
    return iid_distance(cand, metric)


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


def iid_distance_t(dol: torch.Tensor, metric: str = "w1_norm"
                   ) -> torch.Tensor:
    """Tensor twin of :func:`iid_distance`."""
    if metric != "w1_norm":
        raise NotImplementedError(
            f"IID metric {metric!r}: the Appendix-C metrics (kld, jsd, "
            f"w1_true) are queued as ROADMAP item A15")
    return _w1_norm_t(dol.to(torch.float32))


def iid_distance_candidates_t(dol: torch.Tensor, chain_size: torch.Tensor,
                              dsi: torch.Tensor, data_size: torch.Tensor,
                              metric: str = "w1_norm") -> torch.Tensor:
    """Tensor twin of :func:`iid_distance_candidates`: the (M, N, C)
    broadcast composite, (M, N) out."""
    cand, _ = update_dol_t(dol[:, None, :], chain_size[:, None],
                           dsi[None, :, :], data_size[None, :])
    return iid_distance_t(cand, metric)


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
