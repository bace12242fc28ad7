"""Diffusion-round planner — the control plane of Algorithm 2 (lines 14–26).

Counterpart of ``repro.core.diffusion``.
:meth:`DiffusionPlanner.plan_communication_round` runs the DoL-broadcast →
bid → auction → schedule loop until ``W1(ψ, U) ≤ ε`` holds for every model
(or no feasible pair remains) and returns a :class:`DiffusionPlan`.  The
plan is pure scheduling; no training happens here.  ``mode="host"`` runs
the numpy loop with the Hungarian matching; ``mode="jax"`` (the reference's
name, kept as specs and sweeps carry it) runs the device planner of
:mod:`repro_torch.core.planner` on the planner's device.  The plan cache of
the reference is queued in ROADMAP.md (A6).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.channels.fading import ChannelModel
from repro_torch.channels.resources import spectral_efficiency
from repro_torch.channels.topology import CellTopology
from repro_torch.core import dol as dol_lib
from repro_torch.core.auction import AuctionConfig, run_auction

__all__ = ["DiffusionHop", "DiffusionPlan", "DiffusionPlanner",
           "PLANNER_MODES"]

PLANNER_MODES = ("host", "jax")


@dataclasses.dataclass
class DiffusionHop:
    model: int
    src: int
    dst: int
    gamma: float            # spectral efficiency of the scheduled link
    bandwidth: float        # Eq. 15 cost (Hz·s)
    decrement: float        # δ (Eq. 17)
    round_index: int


@dataclasses.dataclass
class DiffusionPlan:
    hops: list[DiffusionHop]
    num_rounds: int
    final_iid_distance: np.ndarray      # (M,)
    efficiency_per_round: list[float]

    def hops_in_round(self, k: int) -> list[DiffusionHop]:
        return [h for h in self.hops if h.round_index == k]


class DiffusionPlanner:
    """Plans all diffusion rounds of one communication round.

    The device mode runs on ``device``: the CUDA device unless the caller
    passes ``device="cpu"`` (resolved at planning time, so a host-mode
    planner never needs one).

    ``stats`` accumulates, over the planner's life, the ``plans`` made and
    their wall ``seconds`` (host clock; the device mode ends every plan by
    reading it back), and for the device mode the ``loop_iterations`` of
    its diffusion-round loop (one host read each), the auction's
    ``auction_iterations`` (bidding iterations) and its
    ``auction_host_reads``."""

    def __init__(self, topology: CellTopology | None = None,
                 channel: ChannelModel | None = None,
                 auction: AuctionConfig | None = None,
                 epsilon: float = 0.04,
                 max_rounds: int | None = None,
                 mode: str = "host",
                 device: torch.device | str | None = None):
        if mode not in PLANNER_MODES:
            raise ValueError(f"planner mode {mode!r}: expected one of "
                             f"{PLANNER_MODES}")
        self.topology = topology or CellTopology()
        self.channel = channel or ChannelModel()
        self.auction = auction or AuctionConfig()
        self.epsilon = epsilon          # minimum tolerable IID distance
        self.max_rounds = max_rounds
        self.mode = mode                # "host" oracle | "jax" device plane
        self.device = device            # the device mode's; None = CUDA
        self.stats: dict = {"plans": 0, "seconds": 0.0}

    def plan_communication_round(
            self, state: dol_lib.DiffusionState, dsi: np.ndarray,
            data_sizes: np.ndarray, rng: np.random.Generator,
            positions: np.ndarray | None = None,
            values: np.ndarray | None = None,
            value_weight: float = 0.0) -> DiffusionPlan:
        """Run auctions until halting; mutates ``state`` (DoLs, visited
        sets, holders).  ``values``/``value_weight`` fuse the per-client
        learning value into the bids.  The host mode consumes ``rng`` as
        the reference's host mode does (one gain draw per diffusion round);
        the device mode pre-draws ``max_rounds`` rounds of it, as the
        reference's ``mode="jax"`` does."""
        t0 = time.perf_counter()
        if self.mode == "jax":
            from repro_torch.core.planner import plan_communication_round_jax
            plan = plan_communication_round_jax(
                self, state, dsi, data_sizes, rng, positions=positions,
                values=values, value_weight=value_weight)
        else:
            plan = self._plan_host(state, dsi, data_sizes, rng, positions,
                                   values, value_weight)
        self.stats["plans"] += 1
        self.stats["seconds"] += time.perf_counter() - t0
        return plan

    def _plan_host(self, state, dsi, data_sizes, rng, positions, values,
                   value_weight) -> DiffusionPlan:
        n = dsi.shape[0]
        if positions is None:
            positions = self.topology.sample_positions(rng, n)
        dist = self.topology.pairwise_distances(positions)
        beta = 10 ** (self.channel.large_scale_db(dist) / 10.0)
        mean_snr = self.channel.snr(beta)   # Rayleigh power marginalized

        hops: list[DiffusionHop] = []
        eff_hist: list[float] = []
        # Worst case O(N(N-1)) rounds (Sec. V-D).
        max_rounds = self.max_rounds or n * (n - 1)
        k = 0
        while k < max_rounds:
            iid = state.iid_distances(self.auction.metric)
            active = iid > self.epsilon
            if not self.auction.allow_retraining:
                # Models at chain length N visited everyone (full diffusion).
                active &= ~state.visited.all(axis=1)
            if not active.any():
                break
            gains = self.channel.sample_gains(dist, rng)
            snr = self.channel.snr(gains)
            result = run_auction(state, dsi, data_sizes, gains, mean_snr,
                                 snr, self.auction, values=values,
                                 value_weight=value_weight)
            scheduled = [(m, i) for m, i in result.pairs if active[m]]
            if not scheduled:
                break
            k += 1
            gamma = spectral_efficiency(snr)
            for m, i in scheduled:
                src = int(state.holder[m])
                hops.append(DiffusionHop(
                    model=m, src=src, dst=i,
                    gamma=float(gamma[src, i]),
                    bandwidth=result.bandwidth[m],
                    decrement=result.decrements[m],
                    round_index=k - 1))
                state.record_training(m, i, dsi[i], float(data_sizes[i]))
            eff_hist.append(result.efficiency)
        state.round_index += k
        return DiffusionPlan(hops=hops, num_rounds=k,
                             final_iid_distance=state.iid_distances(
                                 self.auction.metric),
                             efficiency_per_round=eff_hist)
