"""Diffusion-round planner — the control plane of Algorithm 2 (lines 14–26).

Counterpart of ``repro.core.diffusion``.
:meth:`DiffusionPlanner.plan_communication_round` runs the DoL-broadcast →
bid → auction → schedule loop until ``W1(ψ, U) ≤ ε`` holds for every model
(or no feasible pair remains) and returns a :class:`DiffusionPlan`.  The
plan is pure scheduling; no training happens here.  ``mode="host"`` runs
the numpy loop with the Hungarian matching; ``mode="jax"`` (the reference's
name, kept as specs and sweeps carry it) runs the device planner of
:mod:`repro_torch.core.planner` on the planner's device.  Either mode
consults a :class:`PlanCache` when given one and a key
(:func:`feddif_cache_key`): a hit replays the stored plan and post-plan
state instead of planning.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.channels.fading import ChannelModel
from repro_torch.channels.resources import spectral_efficiency
from repro_torch.channels.topology import CellTopology
from repro_torch.core import dol as dol_lib
from repro_torch.core.auction import AuctionConfig, run_auction

__all__ = ["DiffusionHop", "DiffusionPlan", "DiffusionPlanner", "PlanCache",
           "plan_cache_key", "feddif_cache_key", "PLANNER_MODES"]

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
    num_models: int | None = None       # M — set by the planner

    def hops_in_round(self, k: int) -> list[DiffusionHop]:
        return [h for h in self.hops if h.round_index == k]


def plan_cache_key(topology_seed: int, round_index: int, dsi: np.ndarray,
                   data_sizes: np.ndarray, epsilon: float, gamma_min: float,
                   metric: str, extra: tuple = ()) -> tuple:
    """Cache key for one communication round's :class:`DiffusionPlan`.

    A plan is a pure function of the control-plane inputs: the channel draw
    (from ``(topology_seed, round_index)``), the client DSIs and data sizes
    (fixed by the data seed) and the planner knobs.  It does not depend on
    the model-init seed, so replicate seeds of one sweep cell can share
    plans."""
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(dsi, np.float32).tobytes())
    h.update(np.ascontiguousarray(data_sizes, np.float64).tobytes())
    return (int(topology_seed), int(round_index), float(epsilon),
            float(gamma_min), str(metric), h.hexdigest(), tuple(extra))


def feddif_cache_key(cfg, t: int, dsi: np.ndarray, data_sizes: np.ndarray,
                     model_bits: float, auction: AuctionConfig,
                     values: np.ndarray | None = None) -> tuple:
    """The :func:`plan_cache_key` of a FedDif round, key for key the
    reference's: the sizing knobs, the whole :class:`AuctionConfig`
    surface, the world scenario, the learning-value weight and the planner
    mode (host and device plans never share a line).  When the value signal
    is on, the digest of the round's ``values`` joins the key; they depend
    on the model params, so such plans are not shared across seeds."""
    vdigest = ""
    if values is not None and getattr(cfg, "uncertainty_weight", 0.0):
        vdigest = hashlib.sha1(
            np.ascontiguousarray(values, np.float32).tobytes()).hexdigest()
    return plan_cache_key(
        cfg.topology_seed, t, dsi, data_sizes, cfg.epsilon, cfg.gamma_min,
        cfg.metric,
        extra=(cfg.num_clients, cfg.num_models, float(model_bits),
               cfg.max_diffusion_rounds, cfg.allow_retraining, cfg.underlay,
               float(auction.outage_max), float(auction.bandwidth_budget),
               getattr(cfg, "planner", "host"),
               getattr(cfg, "scenario", "static"),
               float(getattr(cfg, "uncertainty_weight", 0.0)), vdigest))


class PlanCache:
    """LRU memo of ``(DiffusionPlan, post-plan DiffusionState)`` snapshots.

    :meth:`DiffusionPlanner.plan_communication_round` consults it when given
    a key: on a hit it returns the stored plan and fast-forwards the
    caller's :class:`~repro_torch.core.dol.DiffusionState` to the stored
    post-plan snapshot, skipping the auction loop.  :meth:`state_dict` /
    :meth:`load_state_dict` round-trip it through plain JSON-able data, in
    the reference's layout."""

    def __init__(self, max_entries: int = 256):
        self.max_entries = max_entries
        self._store: OrderedDict[tuple, tuple] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._store)

    def __contains__(self, key: tuple) -> bool:
        """Presence probe that touches neither the counters nor LRU order."""
        return key in self._store

    def lookup(self, key: tuple):
        """Return ``(plan, post_state)`` or ``None``; counts hits/misses."""
        entry = self._store.get(key)
        if entry is None:
            self.misses += 1
            return None
        self._store.move_to_end(key)
        self.hits += 1
        return entry

    def store(self, key: tuple, plan: DiffusionPlan,
              post_state: dol_lib.DiffusionState) -> None:
        self._store[key] = (plan, post_state.snapshot())
        self._store.move_to_end(key)
        while len(self._store) > self.max_entries:
            self._store.popitem(last=False)

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "entries": len(self._store)}

    def state_dict(self) -> dict:
        entries = []
        for key, (plan, state) in self._store.items():
            entries.append({
                "key": _key_jsonable(key),
                "plan": {
                    "hops": [[h.model, h.src, h.dst, h.gamma, h.bandwidth,
                              h.decrement, h.round_index]
                             for h in plan.hops],
                    "num_rounds": int(plan.num_rounds),
                    "final_iid_distance":
                        np.asarray(plan.final_iid_distance,
                                   np.float32).tolist(),
                    "efficiency_per_round":
                        [float(e) for e in plan.efficiency_per_round],
                    "num_models": plan.num_models,
                },
                "state": {
                    "dol": np.asarray(state.dol, np.float32).tolist(),
                    "chain_size":
                        np.asarray(state.chain_size, np.float32).tolist(),
                    "visited": np.asarray(state.visited, bool).tolist(),
                    "holder": np.asarray(state.holder, np.int64).tolist(),
                    "round_index": int(state.round_index),
                },
            })
        return {"version": 1, "max_entries": self.max_entries,
                "hits": self.hits, "misses": self.misses,
                "entries": entries}

    def load_state_dict(self, state: dict) -> None:
        """Merge serialized entries into this cache (counters adopted too)."""
        self.max_entries = int(state.get("max_entries", self.max_entries))
        self.hits = int(state.get("hits", 0))
        self.misses = int(state.get("misses", 0))
        for e in state["entries"]:
            key = _key_from_jsonable(e["key"])
            p, s = e["plan"], e["state"]
            plan = DiffusionPlan(
                hops=[DiffusionHop(model=int(h[0]), src=int(h[1]),
                                   dst=int(h[2]), gamma=float(h[3]),
                                   bandwidth=float(h[4]),
                                   decrement=float(h[5]),
                                   round_index=int(h[6]))
                      for h in p["hops"]],
                num_rounds=int(p["num_rounds"]),
                final_iid_distance=np.asarray(p["final_iid_distance"],
                                              np.float32),
                efficiency_per_round=[float(x)
                                      for x in p["efficiency_per_round"]],
                num_models=(None if p["num_models"] is None
                            else int(p["num_models"])))
            post = dol_lib.DiffusionState(
                dol=np.asarray(s["dol"], np.float32),
                chain_size=np.asarray(s["chain_size"], np.float32),
                visited=np.asarray(s["visited"], bool),
                holder=np.asarray(s["holder"], np.int64),
                round_index=int(s["round_index"]))
            self._store[key] = (plan, post)
            self._store.move_to_end(key)
        while len(self._store) > self.max_entries:
            self._store.popitem(last=False)

    @classmethod
    def from_state_dict(cls, state: dict) -> "PlanCache":
        cache = cls(max_entries=int(state.get("max_entries", 256)))
        cache.load_state_dict(state)
        return cache


def _key_jsonable(key):
    """Keys are nested tuples of scalars; JSON keeps every scalar type, only
    tuples become lists."""
    if isinstance(key, tuple):
        return [_key_jsonable(k) for k in key]
    return key


def _key_from_jsonable(key):
    if isinstance(key, list):
        return tuple(_key_from_jsonable(k) for k in key)
    return key


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
                 device: torch.device | str | None = None,
                 underlay: bool = False):
        if mode not in PLANNER_MODES:
            raise ValueError(f"planner mode {mode!r}: expected one of "
                             f"{PLANNER_MODES}")
        if mode == "jax" and underlay:
            raise ValueError("planner mode 'jax' does not model underlay "
                             "CUE interference (Appendix C-F); use 'host'")
        self.topology = topology or CellTopology()
        self.channel = channel or ChannelModel()
        self.auction = auction or AuctionConfig()
        self.epsilon = epsilon          # minimum tolerable IID distance
        self.max_rounds = max_rounds
        self.underlay = underlay        # Appendix C-F: D2D reuses CUE PRBs
        self.mode = mode                # "host" oracle | "jax" device plane
        self.device = device            # the device mode's; None = CUDA
        self.stats: dict = {"plans": 0, "seconds": 0.0}

    def plan_communication_round(
            self, state: dol_lib.DiffusionState, dsi: np.ndarray,
            data_sizes: np.ndarray, rng: np.random.Generator,
            positions: np.ndarray | None = None,
            cache: PlanCache | None = None,
            cache_key: tuple | None = None,
            interference: np.ndarray | float = 0.0,
            values: np.ndarray | None = None,
            value_weight: float = 0.0,
            world=None, step_m: float = 0.0) -> DiffusionPlan:
        """Run auctions until halting; mutates ``state`` (DoLs, visited
        sets, holders).  ``values``/``value_weight`` fuse the per-client
        learning value into the bids.  ``interference`` is the world's
        per-receiver co-channel power (multicell, frozen within the round);
        ``world`` and ``step_m`` (mobile) step the random-waypoint world one
        deterministic substep per diffusion round, moving every link's
        pathloss under the auction.  With ``underlay`` each diffusion round
        draws a Poisson CUE count and their interference after the gains.
        All default off: the static plan.  The host mode consumes ``rng`` as
        the reference's host mode does (one gain draw per diffusion round);
        the device mode pre-draws ``max_rounds`` rounds of it, as the
        reference's ``mode="jax"`` does.

        With ``cache`` and ``cache_key`` (:func:`feddif_cache_key`), a hit
        returns the cached plan and fast-forwards ``state`` to the cached
        post-plan snapshot, drawing nothing from ``rng``; a miss plans and
        stores.  Only plans made count in :attr:`stats`."""
        use_cache = cache is not None and cache_key is not None
        if use_cache:
            entry = cache.lookup(cache_key)
            if entry is not None:
                plan, post_state = entry
                state.restore(post_state)
                return plan
        t0 = time.perf_counter()
        if self.mode == "jax":
            from repro_torch.core.planner import plan_communication_round_jax
            plan = plan_communication_round_jax(
                self, state, dsi, data_sizes, rng, positions=positions,
                interference=interference, values=values,
                value_weight=value_weight, world=world, step_m=step_m)
        else:
            plan = self._plan_host(state, dsi, data_sizes, rng, positions,
                                   interference, values, value_weight,
                                   world, step_m)
        self.stats["plans"] += 1
        self.stats["seconds"] += time.perf_counter() - t0
        if use_cache:
            cache.store(cache_key, plan, state)
        return plan

    def _plan_host(self, state, dsi, data_sizes, rng, positions,
                   interference, values, value_weight, world, step_m
                   ) -> DiffusionPlan:
        n = dsi.shape[0]
        pos = way = None
        if world is not None:
            pos = np.asarray(world.positions, np.float64)
            way = np.asarray(world.waypoints, np.float64)
            positions = pos
        elif positions is None:
            positions = self.topology.sample_positions(rng, n)
        dist = self.topology.pairwise_distances(positions)
        beta = 10 ** (self.channel.large_scale_db(dist) / 10.0)
        # Rayleigh power marginalized
        mean_snr = self.channel.snr(beta, interference)

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
            if world is not None:
                # One random-waypoint substep of the world (mobile).
                delta = way - pos
                d = np.linalg.norm(delta, axis=-1, keepdims=True)
                frac = np.minimum(step_m, d) / np.maximum(d, 1e-9)
                pos = pos + delta * frac
                dist = self.topology.pairwise_distances(pos)
                beta = 10 ** (self.channel.large_scale_db(dist) / 10.0)
                mean_snr = self.channel.snr(beta, interference)
            gains = self.channel.sample_gains(dist, rng)
            cue_interference = 0.0
            if self.underlay:
                n_cues = rng.poisson(self.topology.cue_rate)
                cue_interference = self.channel.sample_cue_interference(
                    rng, n_cues, self.topology.radius_m)
            snr = self.channel.snr(gains, interference + cue_interference)
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
                             efficiency_per_round=eff_hist,
                             num_models=int(state.dol.shape[0]))
