"""The time-evolving wireless world behind every scenario.

Counterpart of ``repro.channels.world``.  Placement, mobility, serving-cell
assignment, interference and per-client energy live in one state with two
planes:

* :class:`WorldState` — a NamedTuple of arrays (numpy on the host, tensors
  in the device planner) with the transition :func:`step`, which the
  device planner runs once per diffusion round in the mobile scenario;
* :class:`HostWorld` — the stateful host-side world the FL control plane
  advances once per communication round off the per-round control stream.

Scenarios (``FLConfig.scenario``):

``static``
    The paper's world: :meth:`HostWorld.advance_round` consumes exactly
    ``topology.sample_positions(rng, n)``, no interference, no energy
    budget — the draws of every run before the world existed (the
    degeneracy contract).
``mobile``
    Random-waypoint traces: clients move toward a waypoint at ``speed_mps``
    and redraw it on arrival.  The host advances ``round_s`` of world time
    between communication rounds; within a round the planner steps
    ``substep_s`` per diffusion round, deterministically.
``multicell``
    ``num_cells`` cells on a ring; each client redraws uniformly in its home
    cell every round, is served by the nearest center (handoff), and every
    link sees the co-channel interference of the non-serving centers
    (Eq. 14 as SINR).
``energy_capped``
    Static placement (the same draws) plus a finite per-client transmit
    energy budget; depleted clients stop training and transmitting (churn
    semantics — the wire already committed is still charged).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.channels.fading import ChannelModel
from repro_torch.channels.resources import TX_POWER_W, spectral_efficiency
from repro_torch.channels.topology import CellTopology

__all__ = ["SCENARIOS", "WorldConfig", "WorldState", "HostWorld",
           "cell_centers", "init_world", "step", "receiver_interference_w",
           "per_client_energy_j", "DEFAULT_ENERGY_BUDGET_J"]

SCENARIOS = ("static", "mobile", "multicell", "energy_capped")

#: Default per-client transmit-energy budget (J) of ``energy_capped``.
DEFAULT_ENERGY_BUDGET_J = 2.0


@dataclasses.dataclass(frozen=True)
class WorldConfig:
    """The scenario's knobs (hashable)."""
    scenario: str = "static"
    speed_mps: float = 15.0        # random-waypoint speed
    substep_s: float = 1.0         # world time per diffusion round (planner)
    round_s: float = 10.0          # world time per communication round
    num_cells: int = 3             # multicell ring size
    cell_spacing_factor: float = 2.0   # ring radius in cell radii
    energy_budget_j: float = float("inf")

    def __post_init__(self):
        if self.scenario not in SCENARIOS:
            raise ValueError(f"unknown scenario {self.scenario!r}; expected "
                             f"one of {SCENARIOS}")

    @property
    def step_m(self) -> float:
        """Distance moved per planner substep (mobile scenario)."""
        return self.speed_mps * self.substep_s

    @classmethod
    def for_scenario(cls, scenario: str,
                     energy_budget_j: float | None = None) -> "WorldConfig":
        if energy_budget_j is None:
            energy_budget_j = (DEFAULT_ENERGY_BUDGET_J
                               if scenario == "energy_capped"
                               else float("inf"))
        return cls(scenario=scenario, energy_budget_j=energy_budget_j)


class WorldState(NamedTuple):
    """The evolving world: numpy arrays on the host, tensors on a device."""
    positions: object     # (..., n, 2) client positions [m]
    waypoints: object     # (..., n, 2) random-waypoint targets [m]
    serving: object       # (..., n) int serving-cell index
    energy_j: object      # (..., n) cumulative UE transmit energy [J]
    t: object             # substep counter


def cell_centers(cfg: WorldConfig, radius_m: float) -> np.ndarray:
    """(K, 2) cell centers: the origin plus a ring at spacing · radius."""
    k = max(int(cfg.num_cells), 1)
    if k == 1:
        return np.zeros((1, 2))
    ring = cfg.cell_spacing_factor * radius_m
    ang = 2.0 * np.pi * np.arange(k - 1) / (k - 1)
    ring_xy = ring * np.stack([np.cos(ang), np.sin(ang)], axis=-1)
    return np.concatenate([np.zeros((1, 2)), ring_xy], axis=0)


def init_world(cfg: WorldConfig, topology: CellTopology,
               rng: np.random.Generator, n: int) -> WorldState:
    """Host-side initial world (numpy arrays)."""
    if cfg.scenario == "multicell":
        centers = cell_centers(cfg, topology.radius_m)
        home = np.arange(n) % len(centers)
        pos = topology.sample_positions(rng, n) + centers[home]
        serving = _nearest_center(pos, centers)
    else:
        pos = topology.sample_positions(rng, n)
        serving = np.zeros(n, dtype=np.int32)
    way = (topology.sample_positions(rng, n) if cfg.scenario == "mobile"
           else pos.copy())
    return WorldState(positions=pos, waypoints=way, serving=serving,
                      energy_j=np.zeros(n), t=np.int32(0))


def _norm2_t(x: torch.Tensor) -> torch.Tensor:
    """float32 Euclidean norm over a trailing axis of 2, in the order XLA-CPU
    compiles ``jnp.linalg.norm`` inside the reference's jitted planner:
    ``sqrt(fma(x₁, x₁, x₀²))``, the root correctly rounded."""
    x0, x1 = x[..., 0].double(), x[..., 1].double()
    acc = (x0 * x0).float().double()
    return torch.sqrt((x1 * x1 + acc).float().double()).float()


def step(world: WorldState, generator: torch.Generator | None = None, *,
         step_m: float, radius_m: float = 250.0) -> WorldState:
    """One random-waypoint substep on tensors: clients advance ``step_m``
    meters toward their waypoint and stop on arrival.

    Without ``generator`` the transition is deterministic — the form the
    device planner runs in its loop, in the float32 bits of the reference's
    jitted step.  With one, arrived clients redraw a uniform-disc waypoint
    from it (the steady-state mobility form; its draws are torch's, not
    ``jax.random``'s)."""
    pos, way = world.positions, world.waypoints
    delta = way - pos
    d = _norm2_t(delta)[..., None]
    step_t = torch.tensor(step_m, dtype=torch.float32, device=pos.device)
    frac = torch.minimum(step_t, d) / torch.clamp(d, min=1e-9)
    # pos + delta·frac contracts to one fused multiply-add under jit.
    pos = (delta.double() * frac.double() + pos.double()).float()
    if generator is not None:
        shape = tuple(pos.shape[:-1])
        gdev = generator.device
        r = radius_m * torch.sqrt(torch.rand(shape, generator=generator,
                                             device=gdev)).to(pos.device)
        th = (2.0 * torch.pi * torch.rand(shape, generator=generator,
                                          device=gdev)).to(pos.device)
        cand = torch.stack([r * torch.cos(th), r * torch.sin(th)], dim=-1)
        arrived = d[..., 0] <= step_m
        way = torch.where(arrived[..., None], cand.to(way.dtype), way)
    return WorldState(positions=pos, waypoints=way, serving=world.serving,
                      energy_j=world.energy_j, t=world.t + 1)


def _nearest_center(pos: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """SINR handoff: equal-power centers with one pathloss exponent make
    argmax mean SINR the nearest center."""
    d = np.linalg.norm(pos[:, None, :] - centers[None, :, :], axis=-1)
    return np.argmin(d, axis=1).astype(np.int32)


def receiver_interference_w(pos: np.ndarray, serving: np.ndarray,
                            centers: np.ndarray, channel: ChannelModel
                            ) -> np.ndarray:
    """Per-receiver co-channel interference (W): the large-scale received
    power of every non-serving cell center (Rayleigh marginalized, as the
    mean SNR of Eq. 39).  Deterministic given positions, so both planner
    modes see the same values."""
    d = np.linalg.norm(pos[:, None, :] - centers[None, :, :], axis=-1)
    beta = 10.0 ** (channel.large_scale_db(np.maximum(d, 1.0)) / 10.0)
    rx = beta * channel.params.tx_power_w          # (n, K)
    total = rx.sum(axis=1)
    own = np.take_along_axis(rx, serving[:, None].astype(int), axis=1)[:, 0]
    return total - own


@dataclasses.dataclass
class HostWorld:
    """The stateful host-side world the FL control plane advances per round.

    Every draw comes from the per-round stream the caller passes in, and the
    ``static`` scenario draws exactly what the static world always drew
    (``topology.sample_positions``, then the uplink gains): the degeneracy
    contract."""
    cfg: WorldConfig
    topology: CellTopology
    channel: ChannelModel
    num_clients: int
    state: WorldState | None = None
    rounds_advanced: int = 0

    @classmethod
    def create(cls, scenario: str, topology: CellTopology,
               channel: ChannelModel, num_clients: int,
               energy_budget_j: float | None = None) -> "HostWorld":
        cfg = WorldConfig.for_scenario(scenario,
                                       energy_budget_j=energy_budget_j)
        return cls(cfg=cfg, topology=topology, channel=channel,
                   num_clients=num_clients)

    # ------------------------------------------------------- round advance

    def advance_round(self, rng: np.random.Generator) -> np.ndarray:
        """Advance one communication round; returns (n, 2) positions."""
        n, cfg = self.num_clients, self.cfg
        if cfg.scenario in ("static", "energy_capped"):
            pos = self.topology.sample_positions(rng, n)
            self.state = WorldState(positions=pos, waypoints=pos.copy(),
                                    serving=np.zeros(n, dtype=np.int32),
                                    energy_j=self._energy(),
                                    t=np.int32(self.rounds_advanced))
        elif cfg.scenario == "mobile":
            if self.state is None:
                self.state = init_world(cfg, self.topology, rng, n)
            else:
                st = self.state
                delta = st.waypoints - st.positions
                d = np.linalg.norm(delta, axis=-1, keepdims=True)
                move = cfg.speed_mps * cfg.round_s
                frac = np.minimum(move, d) / np.maximum(d, 1e-9)
                pos = st.positions + delta * frac
                # Candidate waypoints are drawn every round however many
                # clients arrived, so the stream stays fixed per (seed, t).
                cand = self.topology.sample_positions(rng, n)
                arrived = d[:, 0] <= move
                way = np.where(arrived[:, None], cand, st.waypoints)
                self.state = WorldState(positions=pos, waypoints=way,
                                        serving=st.serving,
                                        energy_j=st.energy_j, t=st.t + 1)
        else:                                           # multicell
            centers = self._centers()
            home = np.arange(n) % len(centers)
            pos = self.topology.sample_positions(rng, n) + centers[home]
            self.state = WorldState(positions=pos, waypoints=pos.copy(),
                                    serving=_nearest_center(pos, centers),
                                    energy_j=self._energy(),
                                    t=np.int32(self.rounds_advanced))
        self.rounds_advanced += 1
        return np.asarray(self.state.positions)

    def _energy(self) -> np.ndarray:
        return (self.state.energy_j if self.state is not None
                else np.zeros(self.num_clients))

    def _centers(self) -> np.ndarray:
        return cell_centers(self.cfg, self.topology.radius_m)

    # -------------------------------------------------------- channel view

    def interference(self) -> np.ndarray | float:
        """Per-receiver co-channel interference this round (W); the scalar
        0.0 outside multicell, so the static SNR arithmetic is unchanged."""
        if self.cfg.scenario != "multicell" or self.state is None:
            return 0.0
        return receiver_interference_w(np.asarray(self.state.positions),
                                       np.asarray(self.state.serving),
                                       self._centers(), self.channel)

    def uplink_gamma(self, rng: np.random.Generator) -> np.ndarray:
        """Per-client uplink spectral efficiency to the serving BS: one
        Rayleigh draw at the distance to the origin (static) or to the
        serving center, under the inter-cell interference seen at that
        center (multicell)."""
        pos = np.asarray(self.state.positions)
        if self.cfg.scenario == "multicell":
            centers = self._centers()
            serving = np.asarray(self.state.serving)
            d = np.maximum(np.linalg.norm(pos - centers[serving], axis=-1),
                           1.0)
            rx = (10.0 ** (self.channel.large_scale_db(
                np.maximum(np.linalg.norm(
                    centers[serving][:, None, :] - centers[None, :, :],
                    axis=-1), 1.0)) / 10.0) * self.channel.params.tx_power_w)
            own = np.take_along_axis(rx, serving[:, None].astype(int),
                                     axis=1)[:, 0]
            interference = rx.sum(axis=1) - own
        else:
            d = np.maximum(np.linalg.norm(pos, axis=-1), 1.0)
            interference = 0.0
        gains = self.channel.sample_gains(d, rng)
        return spectral_efficiency(self.channel.snr(gains, interference))

    # ------------------------------------------------------------- energy

    @property
    def has_energy_cap(self) -> bool:
        return bool(np.isfinite(self.cfg.energy_budget_j))

    def depleted(self) -> np.ndarray:
        """(n,) mask of clients whose transmit energy spent the budget in
        earlier rounds — the ones the scheduler drops this round."""
        if self.state is None:
            return np.zeros(self.num_clients, dtype=bool)
        return np.asarray(self.state.energy_j) >= self.cfg.energy_budget_j

    def charge_energy(self, per_client_j: np.ndarray) -> None:
        """Add this round's per-client transmit energy."""
        self.state = self.state._replace(
            energy_j=np.asarray(self.state.energy_j)
            + np.asarray(per_client_j))

    # ----------------------------------------------------------- planning

    def planner_world(self) -> WorldState | None:
        """The within-round world handed to the diffusion planner, in
        float32 as the device planner takes it.  Only the mobile scenario
        moves within a round; the others are described by the round's
        positions and interference."""
        if self.cfg.scenario != "mobile" or self.state is None:
            return None
        st = self.state
        return WorldState(
            positions=np.asarray(st.positions, np.float32),
            waypoints=np.asarray(st.waypoints, np.float32),
            serving=np.asarray(st.serving, np.int32),
            energy_j=np.asarray(st.energy_j, np.float32),
            t=np.int32(st.t))

    # ------------------------------------------------------ checkpointing

    def state_dict(self) -> dict | None:
        """The world as plain JSON-able data (round checkpoints)."""
        if self.state is None:
            return None
        st = self.state
        return {"positions": np.asarray(st.positions, np.float64).tolist(),
                "waypoints": np.asarray(st.waypoints, np.float64).tolist(),
                "serving": np.asarray(st.serving, np.int64).tolist(),
                "energy_j": np.asarray(st.energy_j, np.float64).tolist(),
                "t": int(st.t), "rounds_advanced": int(self.rounds_advanced)}

    def load_state_dict(self, state: dict) -> None:
        n = self.num_clients
        self.state = WorldState(
            positions=np.asarray(state["positions"],
                                 np.float64).reshape(n, 2),
            waypoints=np.asarray(state["waypoints"],
                                 np.float64).reshape(n, 2),
            serving=np.asarray(state["serving"], np.int32),
            energy_j=np.asarray(state["energy_j"], np.float64),
            t=np.int32(state["t"]))
        self.rounds_advanced = int(state["rounds_advanced"])


def per_client_energy_j(schedule, num_clients: int,
                        bandwidth_hz: float) -> np.ndarray:
    """A round schedule's wire as per-client transmit energy (J):
    ``P_tx · bits / (γ·B)`` per D2D hop and uplink, the ledger's joule
    arithmetic.  Events with no known transmitter (``src < 0``, the BS
    downlink) charge no client."""
    e = np.zeros(num_clients)
    for ev in schedule.wire:
        if ev.kind in ("d2d", "uplink") and ev.src >= 0:
            g = max(float(ev.gamma), 1e-9)
            e[ev.src] += TX_POWER_W * float(ev.bits) / (g * bandwidth_hz)
    return e
