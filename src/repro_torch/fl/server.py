"""FL server runtime: :func:`run_federated` on the host or the fleet plane.

Counterpart of ``repro.fl.server``.  Each communication round runs in three
stages, as in the reference:

1. **schedule** — ``SCHEDULERS[cfg.strategy]`` turns the round's
   control-plane inputs (partition DSIs, wireless draw, QoS knobs) into a
   :class:`~repro_torch.core.schedule.RoundSchedule`;
2. **charge** — :func:`~repro_torch.core.schedule.charge_schedule` replays
   its wire events into the :class:`ResourceLedger`;
3. **execute** — the executor of the resolved engine
   (:func:`~repro_torch.fl.engine.resolve_engine`,
   :func:`~repro_torch.fl.executors.make_executor`) runs the ops on the
   device: ``"host"`` one param tree per slot (the reference's default),
   ``"fleet"`` the client-stacked tree.

All ten strategies run, with the host or the device planner
(``planner="jax"``), learning-value bids (``uncertainty_weight > 0``),
int8-packed hops (``hop_quant="int8"``) and a :class:`~repro_torch.core.
diffusion.PlanCache`, in the static world.  Every other :class:`FLConfig`
value raises ``NotImplementedError`` naming the ROADMAP item that ports it;
nothing falls back to something else.
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
from repro_torch.core.diffusion import DiffusionPlanner, PlanCache
from repro_torch.core.schedule import WireEvent, charge_schedule
from repro_torch.device import resolve_device
from repro_torch.fl.adapters import packed_bits
from repro_torch.fl.client import make_local_update
from repro_torch.fl.engine import (EngineSpec, RunHistory, RunResult,
                                   resolve_engine)
from repro_torch.fl.executors import make_executor
from repro_torch.fl.fedprox import make_prox_local_update
from repro_torch.fl.schedulers import (PROX_STRATEGIES, SCHEDULERS,
                                       RoundContext, apply_round_churn)
from repro_torch.tree import tree_map

Params = Any

__all__ = ["FLConfig", "RunResult", "EngineSpec",
           "run_federated", "STRATEGIES", "HOP_QUANTS", "check_supported",
           "static_round_draws"]

STRATEGIES = ("feddif", "fedavg", "fedswap", "stc", "tthf", "gossip",
              "feddif_stc", "fedprox", "feddif_prox", "d2d_random_walk")
#: D2D hop wire formats: fp32 params, or int8 codes + a scale per row-block.
HOP_QUANTS = ("none", "int8")


@dataclasses.dataclass
class FLConfig:
    """The reference's ``FLConfig`` fields and defaults.
    :func:`check_supported` lists the values the port runs; the sharded
    plane's fields (``shard_*``, ``mesh_model_axis``) come with that plane
    (ROADMAP A12).  ``engine`` (a spec or a preset name) wins over the
    legacy ``executor``/``planner`` fields."""
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
    executor: str = "host"             # "host" (reference) | "fleet"
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


# (field, value the port runs, ROADMAP item that ports the others)
_UNPORTED = (
    ("scenario", "static", "A11 (world scenarios)"),
    ("energy_budget_j", None, "A11 (world scenarios)"),
    ("churn_rate", 0.0, "A11 (churn)"),
    ("checkpoint_every", 0, "A10b (durability)"),
    ("metric", "w1_norm", "A15 (Appendix-C metrics)"),
    ("underlay", False, "A15 (underlay planner)"),
    ("profile_phases", False, "A15 (phase profiling)"),
)


# Engine modes the port does not run, with their ROADMAP items.
_UNPORTED_MODES = {"async": "A11 (the buffered-async plane)",
                   "sharded": "A12 (the sharded plane)"}


def check_supported(cfg: FLConfig) -> EngineSpec:
    """Raise ``NotImplementedError`` for any value the port does not run;
    return the resolved :class:`EngineSpec`."""
    if cfg.strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {cfg.strategy!r}; expected one "
                         f"of {STRATEGIES}")
    espec = resolve_engine(cfg)
    if espec.mode in _UNPORTED_MODES:
        raise NotImplementedError(
            f"engine mode {espec.mode!r} is ROADMAP item "
            f"{_UNPORTED_MODES[espec.mode]}; the port runs 'host' and "
            f"'fleet'")
    for field, value, item in _UNPORTED:
        if getattr(cfg, field) != value:
            raise NotImplementedError(
                f"FLConfig.{field}={getattr(cfg, field)!r} is ROADMAP item "
                f"{item}; the port runs {field}={value!r}")
    if cfg.hop_quant not in HOP_QUANTS:
        raise ValueError(f"hop_quant={cfg.hop_quant!r}; expected one of "
                         f"{HOP_QUANTS}")
    if cfg.num_models > cfg.num_clients:
        raise ValueError(
            f"num_models={cfg.num_models} > num_clients={cfg.num_clients}; "
            f"FedDif requires M ≤ N (set num_models <= num_clients)")
    return espec


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
                  base_bits: float = 0.0,
                  plan_cache: PlanCache | None = None) -> RunResult:
    """Run one FL experiment on ``device`` (the CUDA device by default).

    ``init_fn`` takes a ``torch.Generator`` seeded with ``cfg.seed`` and
    returns the initial params (moved to ``device`` here).  The control
    plane consumes ``np.random.default_rng(cfg.seed)`` — or, with
    ``cfg.topology_seed`` set, ``default_rng([topology_seed, t])`` per round
    — in the reference's order: positions, uplink gains, then the
    scheduler's draws.  The engine (:func:`resolve_engine`) picks the data
    plane and the planner; the local solver is FedProx's for
    :data:`PROX_STRATEGIES`; persistent schedules (gossip, TT-HF) carry the
    slots from round to round.  ``value_fn`` (params → (N,) learning value
    in [0, 1]) is called once per round when ``cfg.uncertainty_weight >
    0``; FedDif fuses its values into the bids.  ``base_bits`` is the size
    of the frozen base under an adapter view (``fl/adapters.py``), charged
    once as a round-0 downlink.  ``plan_cache`` memoizes FedDif plans
    across runs when ``cfg.topology_seed`` is set."""
    espec = check_supported(cfg)
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
                               mode=espec.planner, device=dev)
    if cfg.strategy in PROX_STRATEGIES:
        local_update = make_prox_local_update(loss_fn, cfg.prox_mu,
                                              cfg.momentum)
    else:
        local_update = make_local_update(loss_fn, cfg.momentum)
    executor = make_executor(espec.mode, loss_fn, local_update,
                             client_batches, cfg, dev)
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

    hist = RunHistory()
    slots = None            # persistent per-slot state (gossip / tthf)
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
                           param_template=global_params,
                           plan_cache=plan_cache, hop_bits=hop_bits,
                           learning_value=learning_value)
        schedule = SCHEDULERS[cfg.strategy](ctx)
        if t == 0 and base_bits > 0.0:
            # The frozen base ships once, on the round-0 downlink.
            schedule.wire.append(WireEvent("downlink", float(base_bits),
                                           float(np.median(up_gamma)), n))
        schedule = apply_round_churn(ctx, schedule)
        charge_schedule(ledger, schedule)
        t_exec = time.perf_counter()
        global_params, slots = executor.run_round(schedule, global_params,
                                                  slots)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        hist.round_wall_s.append(time.perf_counter() - t_exec)
        hist.diffusion_rounds.append(schedule.diffusion_rounds)
        hist.iid_distance.append(schedule.mean_iid)
        if (t + 1) % cfg.eval_every == 0 or t == cfg.rounds - 1:
            a, l = eval_fn(global_params)
            hist.accuracy.append(float(a))
            hist.loss.append(float(l))

    return RunResult(params=global_params, ledger=ledger, history=hist,
                     engine=espec, config=cfg,
                     planner_stats=dict(planner.stats))
