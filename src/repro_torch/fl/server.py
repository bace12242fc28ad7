"""FL server runtime: :func:`run_federated` on the fleet plane.

Counterpart of ``repro.fl.server``.  Each communication round runs in three
stages, as in the reference:

1. **schedule** — ``SCHEDULERS[cfg.strategy]`` turns the round's
   control-plane inputs (partition DSIs, wireless draw, QoS knobs) into a
   :class:`~repro_torch.core.schedule.RoundSchedule`;
2. **charge** — :func:`~repro_torch.core.schedule.charge_schedule` replays
   its wire events into the :class:`ResourceLedger`;
3. **execute** — :class:`~repro_torch.fl.executors.FleetExecutor` runs the
   ops on the client-stacked params on the device.

This slice covers the strategies ``fedavg``, ``feddif``, ``stc`` and
``feddif_stc`` with the host or the device planner (``planner="jax"``),
learning-value bids (``uncertainty_weight > 0``) and int8-packed hops
(``hop_quant="int8"``) in the static world.  Every other
:class:`FLConfig` value raises ``NotImplementedError`` naming the ROADMAP
item that ports it; nothing falls back to something else.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.channels.fading import ChannelModel
from repro_torch.channels.resources import (GAMMA_FLOOR, ResourceLedger,
                                            spectral_efficiency)
from repro_torch.channels.topology import CellTopology
from repro_torch.core.aggregation import model_bits as model_bits_of
from repro_torch.core.auction import AuctionConfig
from repro_torch.core.diffusion import DiffusionPlanner
from repro_torch.core.schedule import WireEvent, charge_schedule
from repro_torch.device import resolve_device
from repro_torch.fl.adapters import packed_bits
from repro_torch.fl.executors import FleetExecutor
from repro_torch.fl.schedulers import (SCHEDULERS, RoundContext,
                                       apply_round_churn)
from repro_torch.tree import tree_map

Params = Any

__all__ = ["FLConfig", "RunResult", "run_federated", "STRATEGIES",
           "HOP_QUANTS", "check_supported", "static_round_draws"]

STRATEGIES = tuple(SCHEDULERS)
#: D2D hop wire formats: fp32 params, or int8 codes + a scale per row-block.
HOP_QUANTS = ("none", "int8")


@dataclasses.dataclass
class FLConfig:
    """The reference's ``FLConfig`` fields.  :func:`check_supported` lists
    the values this slice runs; fields that only unported strategies or
    planes read (``prox_mu``, ``tthf_*``, ``random_walk_hops``,
    ``shard_*``, ``mesh_model_axis``) are ignored here, as the reference's
    fleet plane ignores them for these strategies."""
    strategy: str = "feddif"
    num_clients: int = 10
    num_models: int = 10               # M (FedDif trains M ≤ N models)
    rounds: int = 30                   # T communication rounds
    local_epochs: int = 1
    lr: float = 0.01
    momentum: float = 0.9
    batch_size: int = 16
    epsilon: float = 0.04              # min tolerable IID distance
    gamma_min: float = 1.0             # min tolerable QoS (bit/s/Hz)
    metric: str = "w1_norm"
    diffusion_ratio: float = 1.0
    stc_sparsity: float = 0.01
    prox_mu: float = 0.01
    tthf_cluster_size: int = 5
    tthf_global_period: int = 4
    bits_per_param: int = 32
    seed: int = 0
    topology_seed: int | None = None   # decouple wireless draw from model seed
    random_walk_hops: int = 3
    max_diffusion_rounds: int | None = None
    eval_every: int = 1
    executor: str = "fleet"            # the port's data plane
    shard_microbatch: int = 32
    mesh_model_axis: int = 1
    shard_overlap: str = "auto"
    shard_hop_transport: str = "auto"
    profile_phases: bool = False
    churn_rate: float = 0.0
    scenario: str = "static"
    uncertainty_weight: float = 0.0
    energy_budget_j: float | None = None
    planner: str = "host"
    allow_retraining: bool = False
    underlay: bool = False
    checkpoint_every: int = 0
    hop_quant: str = "none"
    engine: Any = None


# (field, value this slice runs, ROADMAP item that ports the others)
_UNPORTED = (
    ("executor", "fleet", "A6 (host executor) / A12 (sharded plane)"),
    ("engine", None, "A6 (fl/engine.py)"),
    ("scenario", "static", "A11 (world scenarios)"),
    ("energy_budget_j", None, "A11 (world scenarios)"),
    ("churn_rate", 0.0, "A11 (churn)"),
    ("checkpoint_every", 0, "A10 (experiments + durability)"),
    ("metric", "w1_norm", "A15 (Appendix-C metrics)"),
    ("underlay", False, "A15 (underlay planner)"),
    ("profile_phases", False, "A15 (phase profiling)"),
)


def check_supported(cfg: FLConfig) -> None:
    """Raise ``NotImplementedError`` for any value this slice does not run."""
    if cfg.strategy not in STRATEGIES:
        raise NotImplementedError(
            f"strategy {cfg.strategy!r} is ROADMAP item A6 (this slice runs "
            f"{STRATEGIES})")
    for field, value, item in _UNPORTED:
        if getattr(cfg, field) != value:
            raise NotImplementedError(
                f"FLConfig.{field}={getattr(cfg, field)!r} is ROADMAP item "
                f"{item}; this slice runs {field}={value!r}")
    if cfg.hop_quant not in HOP_QUANTS:
        raise ValueError(f"hop_quant={cfg.hop_quant!r}; expected one of "
                         f"{HOP_QUANTS}")
    if cfg.num_models > cfg.num_clients:
        raise ValueError(
            f"num_models={cfg.num_models} > num_clients={cfg.num_clients}; "
            f"FedDif requires M ≤ N (set num_models <= num_clients)")


@dataclasses.dataclass
class RunResult:
    """What one run returns: final params, the Eq.-15 ledger, the
    per-round curves and the planner's :attr:`DiffusionPlanner.stats`."""
    final_params: Params
    ledger: ResourceLedger
    accuracy: list
    loss: list
    diffusion_rounds: list
    iid_distance: list
    round_wall_s: list
    planner_stats: dict = dataclasses.field(default_factory=dict)


def static_round_draws(topology: CellTopology, channel: ChannelModel,
                       rng: np.random.Generator, n: int
                       ) -> tuple[np.ndarray, np.ndarray]:
    """One round of the static world: fresh uniform positions, then one
    Rayleigh draw of each user's uplink to the BS at the origin.  Returns
    ``(positions, uplink γ)`` with γ floored at ``GAMMA_FLOOR`` — the draws
    of the reference's ``HostWorld`` in the ``static`` scenario."""
    pos = topology.sample_positions(rng, n)
    d = np.maximum(np.linalg.norm(pos, axis=-1), 1.0)
    gains = channel.sample_gains(d, rng)
    up_gamma = spectral_efficiency(channel.snr(gains))
    return pos, np.maximum(up_gamma, GAMMA_FLOOR)


def run_federated(init_fn: Callable[[torch.Generator], Params],
                  loss_fn: Callable,
                  client_batches: Sequence[Callable[[], list[dict]]],
                  dsi: np.ndarray, data_sizes: np.ndarray,
                  eval_fn: Callable[[Params], tuple[float, float]],
                  cfg: FLConfig, device: str | torch.device | None = None,
                  value_fn: Callable[[Params], np.ndarray] | None = None,
                  base_bits: float = 0.0) -> RunResult:
    """Run one FL experiment on ``device`` (the CUDA device by default).

    ``init_fn`` takes a ``torch.Generator`` seeded with ``cfg.seed`` and
    returns the initial params (moved to ``device`` here).  The control
    plane consumes ``np.random.default_rng(cfg.seed)`` — or, with
    ``cfg.topology_seed`` set, ``default_rng([topology_seed, t])`` per round
    — in the reference's order: positions, uplink gains, then the
    scheduler's draws.  ``value_fn`` (params → (N,) learning value in
    [0, 1]) is called once per round when ``cfg.uncertainty_weight > 0``;
    FedDif fuses its values into the bids.  ``base_bits`` is the size of
    the frozen base under an adapter view (``fl/adapters.py``): it is
    charged once, as a round-0 downlink."""
    check_supported(cfg)
    dev = resolve_device(device)
    n = cfg.num_clients
    rng = np.random.default_rng(cfg.seed)
    topology = CellTopology(num_pues=n)
    channel = ChannelModel()
    auction = AuctionConfig(gamma_min=cfg.gamma_min, metric=cfg.metric,
                            allow_retraining=cfg.allow_retraining)
    planner = DiffusionPlanner(topology, channel, auction,
                               epsilon=cfg.epsilon,
                               max_rounds=cfg.max_diffusion_rounds,
                               mode=cfg.planner, device=dev)
    executor = FleetExecutor(loss_fn, client_batches, cfg, dev)
    ledger = ResourceLedger()

    gen = torch.Generator().manual_seed(cfg.seed)
    global_params = tree_map(lambda x: x.to(dev), init_fn(gen))
    bits = model_bits_of(global_params, cfg.bits_per_param)
    # What one D2D hop moves: the int8-packed wire size under hop_quant,
    # the fp32 payload otherwise.  The auction prices hops (Eq. 15) at it;
    # up/downlinks keep charging ``bits``.
    hop_bits = (packed_bits(global_params) if cfg.hop_quant == "int8"
                else bits)
    auction.model_bits = hop_bits

    acc_hist, loss_hist, dif_hist, iid_hist = [], [], [], []
    round_wall: list[float] = []
    for t in range(cfg.rounds):
        ctrl_rng = (np.random.default_rng([cfg.topology_seed, t])
                    if cfg.topology_seed is not None else rng)
        pos, up_gamma = static_round_draws(topology, channel, ctrl_rng, n)
        learning_value = None
        if value_fn is not None and cfg.uncertainty_weight > 0.0:
            learning_value = np.asarray(value_fn(global_params), np.float64)
        ctx = RoundContext(cfg=cfg, t=t, dsi=dsi, data_sizes=data_sizes,
                           pos=pos, rng=ctrl_rng, up_gamma=up_gamma,
                           topology=topology, channel=channel,
                           planner=planner, model_bits=bits,
                           param_template=global_params, hop_bits=hop_bits,
                           learning_value=learning_value)
        schedule = SCHEDULERS[cfg.strategy](ctx)
        if t == 0 and base_bits > 0.0:
            # The frozen base ships once, on the round-0 downlink.
            schedule.wire.append(WireEvent("downlink", float(base_bits),
                                           float(np.median(up_gamma)), n))
        schedule = apply_round_churn(ctx, schedule)
        charge_schedule(ledger, schedule)
        t_exec = time.perf_counter()
        global_params = executor.run_round(schedule, global_params)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        round_wall.append(time.perf_counter() - t_exec)
        dif_hist.append(schedule.diffusion_rounds)
        iid_hist.append(schedule.mean_iid)
        if (t + 1) % cfg.eval_every == 0 or t == cfg.rounds - 1:
            a, l = eval_fn(global_params)
            acc_hist.append(float(a))
            loss_hist.append(float(l))

    return RunResult(final_params=global_params, ledger=ledger,
                     accuracy=acc_hist, loss=loss_hist,
                     diffusion_rounds=dif_hist, iid_distance=iid_hist,
                     round_wall_s=round_wall,
                     planner_stats=dict(planner.stats))
