"""Degree-of-Learning (DoL) and IID-distance primitives of FedDif (Sec. III-B).

Counterpart of the host half of ``repro.core.dol``: the Eq.-(2) DoL update,
the Eq.-(B.1) IID distance ``‖ψ − U‖₂`` and the mutable
:class:`DiffusionState` the host planner runs on.

The reference computes this math in jnp float32, and the planner's auction
decisions hang on it: one ulp can flip a near-tie bid and change a hop.  So
it is reproduced here bit for bit in numpy float32:

* the Eq.-(2) update is elementwise float32 (multiply, multiply, add,
  divide), exactly as the reference's eager jnp ops;
* the norm matches XLA's CPU reduction of ``jnp.linalg.norm``: a sequential
  fused multiply-add over the class axis, ``acc = fma(x_j, x_j, acc)``.  The
  fma is emulated in float64, where the product of two float32 values is
  exact, and rounded once to float32.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["DiffusionState", "update_dol", "iid_distance",
           "iid_distance_candidates"]

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


def _w1_norm(p: np.ndarray, num_classes: int) -> np.ndarray:
    """Eq. (B.1): ``‖ψ − U‖₂``, summed in XLA's order (see module doc)."""
    d = p - _F32(1.0 / num_classes)
    acc = np.zeros(d.shape[:-1], _F32)
    for j in range(d.shape[-1]):
        x = d[..., j].astype(np.float64)
        acc = (x * x + acc.astype(np.float64)).astype(_F32)
    return np.sqrt(acc)


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
