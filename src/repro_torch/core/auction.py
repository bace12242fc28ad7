"""Auction-based winner selection — Sec. V, Algorithm 1.

Counterpart of ``repro.core.auction``.  Each diffusion round: every PUE
values every model by the IID-distance decrement it would give (Eq. 32);
the BS weights edges ``c(m, i) = v / B̃`` (Eq. 36), zeroed where (18b)
positive decrement, (18c) no retraining or (18e)/(39) QoS and outage fail;
Kuhn–Munkres finds the max-weight matching (Eq. 38); the bandwidth budget
(18f) is enforced FCFS by decreasing efficiency.  Second-price payments are
recorded for incentive analysis only.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.channels.resources import (outage_probability,
                                            required_bandwidth,
                                            spectral_efficiency)
from repro_torch.core import dol as dol_lib
from repro_torch.core.matching import max_weight_matching

__all__ = ["AuctionConfig", "AuctionResult", "compute_bids",
           "fuse_learning_value", "run_auction"]


@dataclasses.dataclass
class AuctionConfig:
    gamma_min: float = 1.0          # minimum tolerable QoS (bit/s/Hz)
    outage_max: float = 0.05        # P_out ≤ 5 % (Sec. V-C)
    metric: str = "w1_norm"         # IID-distance metric
    bandwidth_budget: float = np.inf  # Eq. (18f) cap on Σ B (Hz·s units)
    model_bits: float = 1e6         # S — size of one serialized model
    allow_retraining: bool = False  # Appendix C-D: drop constraint (18c)


@dataclasses.dataclass
class AuctionResult:
    pairs: list[tuple[int, int]]            # (model, next-trainer PUE)
    bandwidth: dict[int, float]             # model -> B̃ (Eq. 37)
    efficiency: float                       # E(i*, B*) (Eq. 16)
    decrements: dict[int, float]            # model -> δ (Eq. 17)
    payments: dict[int, float]              # model -> second price
    bids: np.ndarray                        # (M, N) valuation matrix
    feasible: np.ndarray                    # (M, N) bool


def compute_bids(state: dol_lib.DiffusionState, dsi: np.ndarray,
                 data_sizes: np.ndarray, metric: str = "w1_norm"
                 ) -> np.ndarray:
    """Valuation matrix v[m, i] (Eq. 32): current minus candidate IID
    distance, float32 as in the reference."""
    cur = dol_lib.iid_distance(state.dol, metric)                   # (M,)
    cand = dol_lib.iid_distance_candidates(state.dol, state.chain_size,
                                           dsi, data_sizes, metric)  # (M,N)
    return cur[:, None] - cand


def fuse_learning_value(bids: np.ndarray, values: np.ndarray | None,
                        value_weight: float) -> np.ndarray:
    """Learning-value bid fusion ``bids · (1 + w · value[i])``, the host
    oracle of ``kernels.ops.bid_value_fuse``.  ``values`` is a per-client
    predictive-uncertainty score in [0, 1]; with no values or ``w = 0`` the
    bids come back untouched."""
    if values is None or value_weight == 0.0:
        return bids
    return bids * (1.0 + value_weight * np.asarray(values)[None, :])


def run_auction(state: dol_lib.DiffusionState, dsi: np.ndarray,
                data_sizes: np.ndarray, gains_sq: np.ndarray,
                mean_snr: np.ndarray, snr: np.ndarray,
                config: AuctionConfig, values: np.ndarray | None = None,
                value_weight: float = 0.0) -> AuctionResult:
    """One diffusion-configuration step (Algorithm 1).

    ``gains_sq`` (N, N) sampled |g|²; ``mean_snr`` (N, N) large-scale mean
    SNR for the Eq.-39 outage; ``snr`` (N, N) instantaneous SNR for the
    Eq.-14 rate; ``values``/``value_weight`` fuse the learning value into
    the bids (:func:`fuse_learning_value`)."""
    m_models, n_pues = state.visited.shape
    bids = compute_bids(state, dsi, data_sizes, config.metric)      # (M,N)
    bids = fuse_learning_value(bids, values, value_weight)

    gamma = spectral_efficiency(snr)                                 # (N,N)
    hold = state.holder                          # edge (m, i): holder(m) → i
    gamma_edge = gamma[hold][:, np.arange(n_pues)]                   # (M,N)
    pout_edge = outage_probability(config.gamma_min, mean_snr[hold]) # (M,N)

    feasible = np.ones((m_models, n_pues), dtype=bool)
    feasible &= bids > 0.0                                   # (18b)
    if not config.allow_retraining:
        feasible &= ~state.visited                           # (18c)
    feasible &= gamma_edge >= config.gamma_min               # (18e) QoS
    feasible &= pout_edge <= config.outage_max               # (39) outage
    feasible[np.arange(m_models), hold] = False              # no self-link

    bw = required_bandwidth(config.model_bits, gamma_edge)           # (M,N)
    with np.errstate(divide="ignore", invalid="ignore"):
        weight = np.where(feasible & np.isfinite(bw) & (bw > 0),
                          bids / bw, 0.0)                            # Eq. 36

    pairs = max_weight_matching(weight)  # (18d): the matching is 1-1

    # (18f) bandwidth budget: FCFS over matched edges by decreasing efficiency.
    pairs.sort(key=lambda mi: -weight[mi[0], mi[1]])
    chosen: list[tuple[int, int]] = []
    budget = config.bandwidth_budget
    for m, i in pairs:
        cost = bw[m, i]
        if cost <= budget:
            chosen.append((m, i))
            budget -= cost

    decrements = {m: float(bids[m, i]) for m, i in chosen}
    bandwidth = {m: float(bw[m, i]) for m, i in chosen}

    # Second price: the second-best feasible valuation, capped at the
    # winner's own bid.
    payments = {}
    for m, i in chosen:
        others = np.sort(bids[m][feasible[m]])[::-1]
        second = float(others[1]) if others.size > 1 else 0.0
        payments[m] = min(second, float(bids[m, i]))

    eff = 0.0
    if chosen:
        eff = float(np.mean([decrements[m] / bandwidth[m] for m, _ in chosen
                             if bandwidth[m] > 0]))
    return AuctionResult(pairs=chosen, bandwidth=bandwidth, efficiency=eff,
                         decrements=decrements, payments=payments,
                         bids=bids, feasible=feasible)
