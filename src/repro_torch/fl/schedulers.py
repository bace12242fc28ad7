"""Per-strategy schedulers: one communication round -> :class:`RoundSchedule`.

Counterpart of ``repro.fl.schedulers`` for all ten strategies.  A scheduler
is a pure function of the round's control-plane inputs and consumes
``ctx.rng`` in exactly the reference's order (positions → gains →
per-diffusion-round draws), so both packages derive the same schedule from
the same seeds.  ``fedprox`` and ``feddif_prox`` share the schedules of
``fedavg`` and ``feddif``; only their local solver differs
(:data:`PROX_STRATEGIES`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.channels.fading import ChannelModel
from repro_torch.channels.resources import GAMMA_FLOOR, spectral_efficiency
from repro_torch.channels.topology import CellTopology
from repro_torch.core.diffusion import (DiffusionPlanner, PlanCache,
                                        feddif_cache_key)
from repro_torch.core.dol import DiffusionState, iid_distance, xla_sum
from repro_torch.core.schedule import (MixOp, PermuteOp, RoundSchedule,
                                       TrainOp, WireEvent, apply_churn,
                                       complete_round_permutation)
from repro_torch.fl.compression import compressed_bits

__all__ = ["RoundContext", "SCHEDULERS", "PROX_STRATEGIES",
           "apply_round_churn", "apply_energy_cap"]

#: Strategies whose local solver is the FedProx proximal step.
PROX_STRATEGIES = ("fedprox", "feddif_prox")


@dataclasses.dataclass
class RoundContext:
    """Everything a scheduler may consult for one communication round ``t``.
    ``param_template`` is used for shapes only (STC bit accounting);
    ``plan_cache`` memoizes FedDif plans across replicate seeds when
    ``cfg.topology_seed`` is set."""
    cfg: "FLConfig"                      # noqa: F821 — import cycle
    t: int
    dsi: np.ndarray
    data_sizes: np.ndarray
    pos: np.ndarray
    rng: np.random.Generator
    up_gamma: np.ndarray
    topology: CellTopology
    channel: ChannelModel
    planner: DiffusionPlanner
    model_bits: float
    param_template: object
    plan_cache: PlanCache | None = None
    # Per-hop D2D payload bits when the wire format differs from fp32
    # params (int8-packed adapter hops, FLConfig.hop_quant); None charges
    # model_bits.  Up/downlinks always charge model_bits.
    hop_bits: float | None = None
    # The round's wireless world (channels/world.HostWorld) and its
    # per-receiver co-channel power: the scalar 0.0 outside multicell, so
    # the static SNR arithmetic is unchanged.
    world: object | None = None
    interference: np.ndarray | float = 0.0
    # Per-client learning value in [0, 1] (fl/experiment.py's probe), fused
    # into the FedDif bids with FLConfig.uncertainty_weight.
    learning_value: np.ndarray | None = None
    _dist: np.ndarray | None = dataclasses.field(default=None, repr=False)

    def d2d_bits(self) -> float:
        """Eq.-15 payload size S of one D2D hop under the active wire
        format (``repro_torch.fl.adapters.packed_bits`` for int8 hops)."""
        return self.model_bits if self.hop_bits is None else self.hop_bits

    def pair_distances(self) -> np.ndarray:
        """(N, N) distances of this round's positions, computed once
        (fedswap and the random walk draw gains over it many times)."""
        if self._dist is None:
            self._dist = self.topology.pairwise_distances(self.pos)
        return self._dist


def _xla_mean(x: np.ndarray) -> float:
    """fp32 mean as ``jnp.mean`` computes it on XLA-CPU: the fp32 sum in
    XLA's order (:func:`~repro_torch.core.dol.xla_sum`: in order up to 32
    terms, windows of 32 beyond) times fp32(1/N) (ROADMAP C2)."""
    flat = np.asarray(x, np.float32).ravel()
    return float(xla_sum(flat) * np.float32(1.0 / flat.size))


def _mean_partition_iid(ctx: RoundContext) -> float:
    """Mean IID distance of the clients' own partitions.  The reference
    takes ``np.mean`` of a jax array, which is ``jnp.mean``."""
    return _xla_mean(iid_distance(np.asarray(ctx.dsi), ctx.cfg.metric))


def _downlink(ctx: RoundContext) -> WireEvent:
    return WireEvent("downlink", ctx.model_bits,
                     float(np.median(ctx.up_gamma)), ctx.cfg.num_clients)


def _uplink(ctx: RoundContext, client: int,
            bits: float | None = None) -> WireEvent:
    return WireEvent("uplink", ctx.model_bits if bits is None else bits,
                     float(ctx.up_gamma[client]), src=int(client))


def _pair_gamma(ctx: RoundContext) -> np.ndarray:
    """One D2D channel draw over the round's positions (Sec. III-D), as
    spectral efficiency.  ``ctx.interference`` (multicell) enters the SINR;
    its (n,) form broadcasts over the receiver (column) axis."""
    gains = ctx.channel.sample_gains(ctx.pair_distances(), ctx.rng)
    return spectral_efficiency(ctx.channel.snr(gains, ctx.interference))


#: Stream tag separating the churn draw from every other [seed, t] consumer.
_CHURN_STREAM = 0xC4


def apply_round_churn(ctx: RoundContext,
                      schedule: RoundSchedule) -> RoundSchedule:
    """Draw this round's churn mask and apply it to the schedule.

    The mask comes from a dedicated stream
    ``default_rng([topology_seed (or seed), t, _CHURN_STREAM])``, not from
    ``ctx.rng``, whose position after the scheduler depends on plan-cache
    hits and the planner mode: a config drops the same clients in round
    ``t`` whatever runs it.  Each client drops with probability
    ``cfg.churn_rate``; at 0 nothing is drawn and the schedule is returned
    as it is.  :func:`~repro_torch.core.schedule.apply_churn` gives the
    dropped clients' semantics."""
    rate = float(ctx.cfg.churn_rate)
    if rate <= 0.0:
        return schedule
    seed = (ctx.cfg.topology_seed if ctx.cfg.topology_seed is not None
            else ctx.cfg.seed)
    rng = np.random.default_rng([seed, ctx.t, _CHURN_STREAM])
    return apply_churn(schedule, rng.random(ctx.cfg.num_clients) < rate)


def apply_energy_cap(ctx: RoundContext, schedule: RoundSchedule,
                     depleted: np.ndarray) -> RoundSchedule:
    """Drop the clients whose transmit-energy budget was spent in earlier
    rounds (the ``energy_capped`` scenario), with the churn semantics.  The
    mask is a function of past schedules: no stream is drawn."""
    depleted = np.asarray(depleted, dtype=bool)
    if not depleted.any():
        return schedule
    return apply_churn(schedule, depleted)


def schedule_fedavg(ctx: RoundContext) -> RoundSchedule:
    """FedAvg (and FedProx — same schedule, proximal local solver):
    broadcast, local update everywhere, weighted uplink aggregation."""
    n = ctx.cfg.num_clients
    return RoundSchedule(
        num_slots=n,
        ops=[TrainOp(np.ones(n, dtype=bool))],
        wire=[_downlink(ctx)] + [_uplink(ctx, i) for i in range(n)],
        agg=[(i, float(ctx.data_sizes[i])) for i in range(n)],
        mean_iid=_mean_partition_iid(ctx))


def schedule_stc(ctx: RoundContext) -> RoundSchedule:
    """STC: full-model downlink, sparse-ternary-compressed delta uplink."""
    n = ctx.cfg.num_clients
    up_bits = compressed_bits(ctx.param_template, ctx.cfg.stc_sparsity)
    return RoundSchedule(
        num_slots=n,
        ops=[TrainOp(np.ones(n, dtype=bool))],
        wire=[_downlink(ctx)] + [_uplink(ctx, i, up_bits) for i in range(n)],
        agg=[(i, float(ctx.data_sizes[i])) for i in range(n)],
        agg_mode="stc_delta",
        stc_sparsity=ctx.cfg.stc_sparsity,
        mean_iid=_mean_partition_iid(ctx))


def schedule_feddif(ctx: RoundContext) -> RoundSchedule:
    """FedDif (Algorithm 2): initial training by the holders, the
    auction-planned diffusion rounds, chain-weighted aggregation.
    ``feddif_stc`` ships STC-compressed deltas on every hop; ``feddif_prox``
    swaps the local solver (the schedule is identical)."""
    cfg = ctx.cfg
    n, m = cfg.num_clients, cfg.num_models
    compress = cfg.strategy == "feddif_stc"
    hop_bits = (compressed_bits(ctx.param_template, cfg.stc_sparsity)
                if compress else ctx.d2d_bits())

    state = DiffusionState.init(m, n, ctx.dsi.shape[1])
    init_mask = np.zeros(n, dtype=bool)
    for mi in range(m):
        holder = int(state.holder[mi])
        init_mask[holder] = True
        state.record_training(mi, holder, ctx.dsi[holder],
                              float(ctx.data_sizes[holder]))
    ops: list = [TrainOp(init_mask)]
    wire: list = [_downlink(ctx)]

    cache_key = None
    if ctx.plan_cache is not None and cfg.topology_seed is not None:
        cache_key = feddif_cache_key(cfg, ctx.t, ctx.dsi, ctx.data_sizes,
                                     ctx.d2d_bits(), ctx.planner.auction,
                                     values=ctx.learning_value)
    # The world's plan inputs: the per-receiver interference (multicell),
    # and the within-round world with its substep (mobile).
    planner_world = (ctx.world.planner_world()
                     if ctx.world is not None else None)
    step_m = ctx.world.cfg.step_m if planner_world is not None else 0.0
    plan = ctx.planner.plan_communication_round(
        state, ctx.dsi, ctx.data_sizes, ctx.rng, positions=ctx.pos,
        cache=ctx.plan_cache, cache_key=cache_key,
        interference=ctx.interference, values=ctx.learning_value,
        value_weight=float(cfg.uncertainty_weight),
        world=planner_world, step_m=step_m)

    slot_of_model = np.arange(m) % max(n, 1)
    for k in range(plan.num_rounds):
        hops = plan.hops_in_round(k)
        for h in hops:
            wire.append(WireEvent("d2d", hop_bits,
                                  max(h.gamma, GAMMA_FLOOR), src=int(h.src)))
        src_of_dst, mask, slot_of_model = complete_round_permutation(
            [(h.model, h.dst) for h in hops], slot_of_model, n)
        ops.append(PermuteOp(src_of_dst, mask, compress=compress))

    for mi in range(m):
        wire.append(_uplink(ctx, int(state.holder[mi])))
    return RoundSchedule(
        num_slots=n,
        ops=ops,
        wire=wire,
        agg=[(int(slot_of_model[mi]), float(state.chain_size[mi]))
             for mi in range(m)],
        stc_sparsity=cfg.stc_sparsity,
        diffusion_rounds=plan.num_rounds,
        mean_iid=float(np.mean(plan.final_iid_distance)))


def schedule_fedswap(ctx: RoundContext) -> RoundSchedule:
    """FedSwap: random full swaps until every model visited every PUE
    (full diffusion, no auction)."""
    cfg = ctx.cfg
    n = cfg.num_clients
    holder = np.arange(n)
    visited = np.eye(n, dtype=bool)
    slot_of_model = np.arange(n)
    ops: list = [TrainOp(np.ones(n, dtype=bool))]
    wire: list = [_downlink(ctx)]
    swaps = 0
    while not visited.all():
        perm = ctx.rng.permutation(n)
        gamma = _pair_gamma(ctx)
        hops, mask = [], np.zeros(n, dtype=bool)
        for mi in range(n):
            src, dst = int(holder[mi]), int(perm[mi])
            if src == dst:
                continue
            wire.append(WireEvent("d2d", ctx.d2d_bits(),
                                  max(float(gamma[src, dst]), GAMMA_FLOOR),
                                  src=src))
            holder[mi] = dst
            hops.append((mi, dst))
            if not visited[mi, dst]:
                mask[dst] = True
                visited[mi, dst] = True
        src_of_dst, _, slot_of_model = complete_round_permutation(
            hops, slot_of_model, n)
        ops.append(PermuteOp(src_of_dst, mask))
        swaps += 1
        if swaps > 4 * n:
            break
    for mi in range(n):
        wire.append(_uplink(ctx, int(holder[mi])))
    return RoundSchedule(
        num_slots=n,
        ops=ops,
        wire=wire,
        agg=[(int(slot_of_model[mi]), float(ctx.data_sizes[mi]))
             for mi in range(n)],
        diffusion_rounds=swaps)


def schedule_d2d_random_walk(ctx: RoundContext) -> RoundSchedule:
    """Auction-free diffusion ablation: models take random feasible D2D hops
    (FedDif's mobility without its planning).  Hops of one walk round that
    collide on a destination are serialized into destination-unique waves,
    in model order, for the slot-bijection executors."""
    cfg = ctx.cfg
    n, m = cfg.num_clients, cfg.num_models
    holder = np.arange(m) % n
    visited = np.zeros((m, n), dtype=bool)
    init_mask = np.zeros(n, dtype=bool)
    for mi in range(m):
        h = int(holder[mi])
        init_mask[h] = True
        visited[mi, h] = True
    ops: list = [TrainOp(init_mask)]
    wire: list = [_downlink(ctx)]
    slot_of_model = np.arange(m) % max(n, 1)
    hops_done = 0
    for _ in range(cfg.random_walk_hops):
        gamma = _pair_gamma(ctx)
        round_hops: list[tuple[int, int]] = []
        for mi in range(m):
            src = int(holder[mi])
            cand = [j for j in range(n)
                    if j != src and not visited[mi, j]
                    and gamma[src, j] >= cfg.gamma_min]
            if not cand:
                continue
            dst = int(ctx.rng.choice(cand))
            wire.append(WireEvent("d2d", ctx.d2d_bits(),
                                  max(float(gamma[src, dst]), GAMMA_FLOOR),
                                  src=src))
            holder[mi] = dst
            visited[mi, dst] = True
            round_hops.append((mi, dst))
        if not round_hops:
            break
        hops_done += 1
        waves: list[list[tuple[int, int]]] = []
        for model, dst in round_hops:
            for wave in waves:
                if all(d != dst for _, d in wave):
                    wave.append((model, dst))
                    break
            else:
                waves.append([(model, dst)])
        for wave in waves:
            src_of_dst, mask, slot_of_model = complete_round_permutation(
                wave, slot_of_model, n)
            ops.append(PermuteOp(src_of_dst, mask))
    for mi in range(m):
        wire.append(_uplink(ctx, int(holder[mi])))
    # Chain weights and DoL follow Eq. (2): each model's mixture of the DSIs
    # it visited, weighted by client data size.
    sizes = np.asarray(ctx.data_sizes, np.float64)
    chain_sizes = visited @ sizes
    dol = (visited * sizes[None, :]) @ np.asarray(ctx.dsi)
    dol = dol / np.maximum(chain_sizes[:, None], 1e-9)
    return RoundSchedule(
        num_slots=n,
        ops=ops,
        wire=wire,
        agg=[(int(slot_of_model[mi]), float(chain_sizes[mi]))
             for mi in range(m)],
        diffusion_rounds=hops_done,
        mean_iid=float(np.mean(np.asarray(iid_distance(dol, cfg.metric)))))


def schedule_tthf(ctx: RoundContext) -> RoundSchedule:
    """TT-HF-like: local updates and intra-cluster D2D consensus every
    round; global aggregation (uplink + broadcast reset) only every
    ``tthf_global_period`` rounds.  Slots persist across rounds."""
    cfg = ctx.cfg
    n, cs = cfg.num_clients, cfg.tthf_cluster_size
    clusters = [list(range(i, min(i + cs, n))) for i in range(0, n, cs)]
    gamma = _pair_gamma(ctx)
    ops: list = [TrainOp(np.ones(n, dtype=bool))]
    wire: list = []
    groups = []
    for cl in clusters:
        head = cl[0]
        for i in cl[1:]:
            wire.append(WireEvent("d2d", ctx.model_bits,
                                  max(float(gamma[i, head]), GAMMA_FLOOR),
                                  src=i))
        groups.append((tuple(cl), tuple(float(ctx.data_sizes[i])
                                        for i in cl)))
    ops.append(MixOp(tuple(groups)))
    if (ctx.t + 1) % cfg.tthf_global_period == 0:
        for cl in clusters:
            wire.append(_uplink(ctx, cl[0]))
        wire.append(_downlink(ctx))
        ops.append(MixOp(((tuple(range(n)),
                           tuple(float(s) for s in ctx.data_sizes)),)))
    return RoundSchedule(
        num_slots=n,
        ops=ops,
        wire=wire,
        agg=[(i, float(ctx.data_sizes[i])) for i in range(n)],
        persistent=True)


def schedule_gossip(ctx: RoundContext) -> RoundSchedule:
    """D-PSGD-style gossip (Appendix C Scenario 1): train locally, average
    with one random neighbour over D2D — fully decentralized, no BS.
    Slots persist across rounds."""
    cfg = ctx.cfg
    n = cfg.num_clients
    gamma = _pair_gamma(ctx)
    perm = ctx.rng.permutation(n)
    wire: list = []
    groups = []
    for a in range(0, n - 1, 2):
        i, j = int(perm[a]), int(perm[a + 1])
        wire.append(WireEvent("d2d", ctx.model_bits,
                              max(float(gamma[i, j]), GAMMA_FLOOR), src=i))
        wire.append(WireEvent("d2d", ctx.model_bits,
                              max(float(gamma[j, i]), GAMMA_FLOOR), src=j))
        groups.append(((i, j), (float(ctx.data_sizes[i]),
                                float(ctx.data_sizes[j]))))
    return RoundSchedule(
        num_slots=n,
        ops=[TrainOp(np.ones(n, dtype=bool)), MixOp(tuple(groups))],
        wire=wire,
        agg=[(i, float(ctx.data_sizes[i])) for i in range(n)],
        persistent=True,
        diffusion_rounds=1)


SCHEDULERS: dict[str, Callable[[RoundContext], RoundSchedule]] = {
    "feddif": schedule_feddif,
    "feddif_stc": schedule_feddif,
    "feddif_prox": schedule_feddif,
    "fedavg": schedule_fedavg,
    "fedprox": schedule_fedavg,
    "stc": schedule_stc,
    "fedswap": schedule_fedswap,
    "tthf": schedule_tthf,
    "gossip": schedule_gossip,
    "d2d_random_walk": schedule_d2d_random_walk,
}
