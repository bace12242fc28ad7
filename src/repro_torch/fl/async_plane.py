"""Buffered-async (FedBuff-style) round plane: the event-driven engine.

Counterpart of ``repro.fl.async_plane``.  The sync planes put a barrier at
the end of every round, so one straggler stalls the fleet.  This plane
replays the same :class:`~repro_torch.core.schedule.RoundSchedule` through
a deterministic event queue instead:

1. **Dispatch.**  Each server tick ``t`` builds its round as
   ``run_federated`` does (the same control-plane streams, scheduler,
   churn, energy cap and ledger charging), then annotates the schedule with
   arrival times (:func:`~repro_torch.core.schedule.annotate_arrivals`).
   A slot's session lasts its data rows × ``delay_scale`` × a lognormal
   per-round jitter ÷ the client's persistent speed; a D2D hop and an
   uplink last payload bits / (γ · PRB_HZ), γ from one Rayleigh draw over
   the round's geometry (Eqs. 12–14).  The draws are ``jax.random``'s, bit
   for bit (:mod:`repro_torch.core.threefry`, keyed ``fold_in(PRNGKey(
   seed), t)``), in the float32 ops of the reference's eager jnp twins
   (:func:`_arrival_model`), so the event order is the reference's and a
   resumed run redraws the same delays with no stored position.
2. **Park.**  Hops whose payload would reach the carrier after
   ``AsyncSpec.hop_deadline_s`` are parked: the carrier keeps the late
   model but skips its session; the wire events stay charged (Eq. 15).
3. **Buffer.**  The round's ops run on an inner sync data plane (the host
   or the fleet executor, ``EngineSpec.inner_data_plane``: the fleet plane
   from 64 clients on), so every kernel of those planes runs here as it
   does there; each aggregation contribution (a copy of its slot's tree,
   ``slot_state``) is pushed into a min-heap keyed ``(arrival, seq)``.
4. **Tick.**  The server aggregates the first K arrivals
   (``AsyncSpec.resolve_k``) with staleness-discounted weights
   ``w · alpha / (1 + s)^beta``, ``s`` the ticks since the contribution was
   issued, through ``core.aggregation.fedavg``; the virtual clock advances
   to the K-th arrival.  Contributions older than ``max_staleness`` are
   dropped.  After the last dispatch round, drain ticks flush the buffer.

With K = everything, a zero delay model and the discount off, every tick
pops the round's contributions in issue order with unit discount, so its
aggregation is the host executor's own ``fedavg`` call: params, ledger and
curves equal the sync host plane's (the degeneracy contract).

In front sits the population sampler (``AsyncSpec.population > 0``): each
tick draws its cohort of ``num_clients`` users from a simulated population
(:class:`~repro_torch.fl.population.Population`) and maps them onto the
Dirichlet shards.  Persistent strategies (gossip, TT-HF) and the STC
uplink's ``stc_delta`` aggregation tie the aggregate to one barrier's slot
snapshot, so the plane refuses them with a ``ValueError``.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.channels.fading import ChannelModel
from repro_torch.channels.resources import (GAMMA_FLOOR, PRB_HZ,
                                            ResourceLedger,
                                            spectral_efficiency_f32)
from repro_torch.channels.topology import CellTopology
from repro_torch.channels.world import HostWorld, per_client_energy_j
from repro_torch.core import aggregation as agg
from repro_torch.core import threefry
from repro_torch.core.auction import AuctionConfig
from repro_torch.core.diffusion import DiffusionPlanner, PlanCache
from repro_torch.core.schedule import (ArrivalModel, annotate_arrivals,
                                       charge_schedule)
from repro_torch.fl.adapters import packed_bits
from repro_torch.fl.client import make_local_update
from repro_torch.fl.engine import AsyncSpec, EngineSpec, RunHistory, RunResult
from repro_torch.fl.executors import make_executor
from repro_torch.fl.fedprox import make_prox_local_update
from repro_torch.fl.population import Population
from repro_torch.fl.schedulers import PROX_STRATEGIES, RoundContext
from repro_torch.fl.server import schedule_round
from repro_torch.tree import tree_map

Params = Any

__all__ = ["run_buffered_async", "ASYNC_COMPATIBLE_AGG"]

#: The aggregation the plane can reorder: raw params of non-persistent
#: rounds.
ASYNC_COMPATIBLE_AGG = "params"

# PRNG stream tags folded into the round key, as the reference's.
_STREAM_COMPUTE = 1
_STREAM_D2D = 2

_F32 = np.float32


@dataclasses.dataclass(order=True)
class _Contribution:
    """One buffered aggregation contribution, heap-ordered by arrival."""
    arrival_s: float
    seq: int
    round: int = dataclasses.field(compare=False)
    slot: int = dataclasses.field(compare=False)
    weight: float = dataclasses.field(compare=False)
    tree: Any = dataclasses.field(compare=False, repr=False)


def _arrival_model(b: AsyncSpec, seed: int, t: int, pos: np.ndarray,
                   up_gamma: np.ndarray, channel: ChannelModel,
                   data_rows: np.ndarray, speed: np.ndarray,
                   hop_bits: float, model_bits: float,
                   interference: np.ndarray | float = 0.0) -> ArrivalModel:
    """Round ``t``'s delay world, in the reference's float32 bits.

    Pure in ``(seed, t)``: the key is ``fold_in(PRNGKey(seed), t)``.
    ``delay_scale == 0`` is the zero model, drawing nothing.  Each step is
    one eager jnp op of the reference, rounded to float32 on its own:
    ``jitter = exp(fp32(σ)·z − fp32(σ²/2))``, ``train = ((fp32(ds)·rows)·
    jitter)/speed``; ``γ = max(log2(1 + SNR), fp32(GAMMA_FLOOR))`` on the
    Rayleigh gains of the float32 distances, ``hop = fp32(bits)/(γ·
    fp32(PRB_HZ))``; the uplink in float64."""
    n = len(pos)
    if b.delay_scale <= 0.0:
        return ArrivalModel.zeros(n)
    key = threefry.fold_in(threefry.PRNGKey(int(seed)), int(t))
    z = threefry.normal(threefry.fold_in(key, _STREAM_COMPUTE), (n,))
    sig = float(b.delay_sigma)
    jitter = threefry.xla_exp(_F32(sig) * z - _F32(0.5 * sig * sig))
    train_s = ((_F32(b.delay_scale) * np.asarray(data_rows, _F32)) * jitter
               / np.asarray(speed, _F32))
    kd = threefry.fold_in(key, _STREAM_D2D)
    dist = CellTopology.pairwise_distances_f32(pos)
    gains = channel.sample_gains_keyed(kd, np.maximum(dist, _F32(1.0)))
    gamma = np.maximum(
        spectral_efficiency_f32(channel.snr_f32(gains, interference)),
        _F32(GAMMA_FLOOR))
    hop_s = _F32(hop_bits) / (gamma * _F32(PRB_HZ))
    uplink_s = float(model_bits) / (np.asarray(up_gamma, np.float64)
                                    * PRB_HZ)
    return ArrivalModel(train_s=np.asarray(train_s, np.float64),
                        hop_s=np.asarray(hop_s, np.float64),
                        uplink_s=np.asarray(uplink_s, np.float64))


def _discounted_fedavg(popped: list[_Contribution], tick: int,
                       b: AsyncSpec) -> tuple[Params | None, float]:
    """One tick's aggregate with staleness-discounted weights, through
    ``core.aggregation.fedavg`` (float64 normalisation, float32 sum), and
    the tick's mean staleness.  A tick of zero-weight contributions only
    (empty shards train in zero seconds) leaves the global unchanged:
    ``(None, staleness)``."""
    staleness = [max(0, tick - c.round) for c in popped]
    weights = [c.weight * b.discount(s) for c, s in zip(popped, staleness)]
    if not sum(weights) > 0.0:
        return None, float(np.mean(staleness))
    return (agg.fedavg([c.tree for c in popped], weights),
            float(np.mean(staleness)))


def _pack_buffer(pending: list[_Contribution], vtime: float, next_seq: int
                 ) -> tuple[Any, dict]:
    """The pending contributions as one host tree stacked on a leading
    entry axis (the npz's ``abuf``) and their JSON entry metadata, in
    ``(arrival, seq)`` order."""
    entries = sorted(pending)
    meta = {"count": len(entries),
            "virtual_s": float(vtime),
            "next_seq": int(next_seq),
            "arrival_s": [float(c.arrival_s) for c in entries],
            "seq": [int(c.seq) for c in entries],
            "round": [int(c.round) for c in entries],
            "slot": [int(c.slot) for c in entries],
            "weight": [float(c.weight) for c in entries]}
    if not entries:
        return None, meta
    stacked = tree_map(lambda *xs: torch.stack([x.detach().cpu()
                                                for x in xs]),
                       *[c.tree for c in entries])
    return stacked, meta


def _unpack_buffer(buffer_tree: Any, meta: dict, device: torch.device
                   ) -> list[_Contribution]:
    out = []
    for i in range(int(meta.get("count", 0))):
        tree = tree_map(lambda x: x[i].to(device).contiguous(), buffer_tree)
        out.append(_Contribution(
            arrival_s=float(meta["arrival_s"][i]), seq=int(meta["seq"][i]),
            round=int(meta["round"][i]), slot=int(meta["slot"][i]),
            weight=float(meta["weight"][i]), tree=tree))
    return out


def run_buffered_async(init_fn: Callable, loss_fn: Callable,
                       client_batches: Sequence[Callable],
                       dsi: np.ndarray, data_sizes: np.ndarray,
                       eval_fn: Callable, cfg, espec: EngineSpec,
                       device: torch.device,
                       plan_cache: PlanCache | None = None,
                       checkpointer=None, base_bits: float = 0.0,
                       value_fn: Callable | None = None) -> RunResult:
    """Event-driven counterpart of ``run_federated``'s round loop, called
    by it when the resolved engine mode is ``"async"``: the same arguments,
    the resolved :class:`EngineSpec` and the device."""
    b = espec.buffered
    n = int(cfg.num_clients)
    rng = np.random.default_rng(cfg.seed)
    topology = CellTopology(num_pues=n)
    channel = ChannelModel()
    auction = AuctionConfig(gamma_min=cfg.gamma_min, metric=cfg.metric,
                            allow_retraining=cfg.allow_retraining)
    planner = DiffusionPlanner(topology, channel, auction,
                               epsilon=cfg.epsilon,
                               max_rounds=cfg.max_diffusion_rounds,
                               mode=espec.planner, device=device,
                               underlay=cfg.underlay)
    if cfg.strategy in PROX_STRATEGIES:
        local_update = make_prox_local_update(loss_fn, cfg.prox_mu,
                                              cfg.momentum)
    else:
        local_update = make_local_update(loss_fn, cfg.momentum)
    # The same evolving world as the sync loop: the arrival model reads its
    # interference, so delay SINRs and rate SINRs agree.
    world = HostWorld.create(cfg.scenario, topology, channel, n,
                             energy_budget_j=cfg.energy_budget_j)
    # Delay and cohort draws follow the topology seed when set (replicate
    # seeds then share cohorts and delays, and plans stay cacheable).
    ctrl_seed = (cfg.topology_seed if cfg.topology_seed is not None
                 else cfg.seed)

    # Population front end: slot c draws whatever shard the tick's cohort
    # gave it, through one indirection the batch closures read at call time.
    pop = None
    cohort = np.arange(n, dtype=np.int64)
    if b.population > 0:
        pop = Population(int(b.population), len(client_batches),
                         seed=int(ctrl_seed), avail_alpha=b.avail_alpha,
                         avail_beta=b.avail_beta, speed_sigma=b.speed_sigma)
        batches_view = [(lambda c=c: client_batches[int(cohort[c])]())
                        for c in range(n)]
    else:
        batches_view = list(client_batches[:n])

    inner = make_executor(espec.inner_data_plane(n), loss_fn, local_update,
                          batches_view, cfg, device)
    ledger = ResourceLedger()
    gen = torch.Generator().manual_seed(cfg.seed)
    global_params = tree_map(lambda x: x.to(device), init_fn(gen))
    model_bits = agg.model_bits(global_params, cfg.bits_per_param)
    hop_bits = (packed_bits(global_params) if cfg.hop_quant == "int8"
                else model_bits)
    auction.model_bits = hop_bits

    hist = RunHistory()
    pending: list[_Contribution] = []
    seq = 0
    vtime = 0.0
    start_t = 0
    if checkpointer is not None:
        state = checkpointer.restore(inner, global_params, cfg)
        if state is not None:
            start_t = state.step
            global_params, ledger = state.params, state.ledger
            hist = RunHistory(accuracy=state.acc_hist, loss=state.loss_hist,
                              diffusion_rounds=state.dif_hist,
                              iid_distance=state.iid_hist,
                              round_wall_s=state.round_wall,
                              **(state.async_hist or {}))
            checkpointer.apply_rng_state(rng, state.rng_state)
            checkpointer.restore_world(world, state)
            vtime = float(state.buffer_meta["virtual_s"])
            seq = int(state.buffer_meta["next_seq"])
            pending = _unpack_buffer(state.buffer_tree, state.buffer_meta,
                                     device)
            heapq.heapify(pending)

    def server_tick(t: int, num_new: int) -> None:
        """Aggregate the first K arrivals; advance the virtual clock."""
        nonlocal global_params, vtime
        if not pending:
            return
        k = min(b.resolve_k(num_new if num_new > 0 else len(pending)),
                len(pending))
        popped: list[_Contribution] = []
        while pending and len(popped) < k:
            c = heapq.heappop(pending)
            if b.max_staleness is not None \
                    and t - c.round > b.max_staleness:
                continue
            popped.append(c)
        if not popped:
            return
        vtime = max(vtime, popped[-1].arrival_s)
        new_params, mean_stale = _discounted_fedavg(popped, t, b)
        if new_params is not None:
            global_params = new_params
        hist.virtual_s.append(float(vtime))
        hist.arrivals.append(len(popped))
        hist.staleness.append(mean_stale)

    for t in range(start_t, cfg.rounds):
        t_exec = time.perf_counter()
        if pop is not None:
            draw = pop.sample_cohort(t, n)
            cohort[:] = draw.shards
            speed = draw.speed
        else:
            speed = np.ones(n)
        dsi_t = np.asarray(dsi)[cohort]
        sizes_t = np.asarray(data_sizes)[cohort]

        # Control plane: the sync loop's streams.
        ctrl_rng = (np.random.default_rng([cfg.topology_seed, t])
                    if cfg.topology_seed is not None else rng)
        pos = world.advance_round(ctrl_rng)
        up_gamma = np.maximum(world.uplink_gamma(ctrl_rng), GAMMA_FLOOR)
        learning_value = None
        if value_fn is not None and cfg.uncertainty_weight > 0.0:
            learning_value = np.asarray(value_fn(global_params), np.float64)
        ctx = RoundContext(cfg=cfg, t=t, dsi=dsi_t, data_sizes=sizes_t,
                           pos=pos, rng=ctrl_rng, up_gamma=up_gamma,
                           topology=topology, channel=channel,
                           planner=planner, model_bits=model_bits,
                           param_template=global_params,
                           plan_cache=plan_cache, hop_bits=hop_bits,
                           world=world, interference=world.interference(),
                           learning_value=learning_value)
        schedule = schedule_round(ctx, base_bits)
        if schedule.persistent or schedule.agg_mode != ASYNC_COMPATIBLE_AGG:
            raise ValueError(
                f"strategy {cfg.strategy!r} needs persistent slot state or "
                f"agg_mode={schedule.agg_mode!r}; the buffered-async engine "
                f"supports non-persistent params-aggregation strategies "
                f"(feddif / fedavg / fedswap / d2d_random_walk / prox "
                f"variants) — run it on a sync engine instead")

        # Arrival annotation and Eq.-15 charging.
        model = _arrival_model(b, ctrl_seed, t, pos, up_gamma, channel,
                               sizes_t, speed, hop_bits, model_bits,
                               interference=world.interference())
        schedule, arrival_s, parked = annotate_arrivals(
            schedule, model, hop_deadline_s=b.hop_deadline_s)
        charge_schedule(ledger, schedule)
        if world.has_energy_cap:
            world.charge_energy(per_client_energy_j(schedule, n, PRB_HZ))

        # Dispatch: the inner plane's op replay, contributions queued.
        slots = inner.run_ops(schedule, global_params, None)
        for slot, w in schedule.agg:
            heapq.heappush(pending, _Contribution(
                arrival_s=vtime + float(arrival_s[slot]), seq=seq,
                round=t, slot=int(slot), weight=float(w),
                tree=inner.slot_state(slots, int(slot))))
            seq += 1

        server_tick(t, num_new=len(schedule.agg))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        hist.round_wall_s.append(time.perf_counter() - t_exec)
        hist.diffusion_rounds.append(schedule.diffusion_rounds)
        hist.iid_distance.append(schedule.mean_iid)
        hist.parked_hops.append(parked)

        if (t + 1) % cfg.eval_every == 0 or t == cfg.rounds - 1:
            a, l = eval_fn(global_params)
            hist.accuracy.append(float(a))
            hist.loss.append(float(l))

        if checkpointer is not None and checkpointer.due(t + 1, cfg.rounds):
            btree, bmeta = _pack_buffer(pending, vtime, seq)
            checkpointer.save(
                t + 1, inner, global_params, None, ledger, cfg,
                acc_hist=hist.accuracy, loss_hist=hist.loss,
                dif_hist=hist.diffusion_rounds, iid_hist=hist.iid_distance,
                round_wall=hist.round_wall_s, rng=rng, world=world,
                async_hist={"virtual_s": hist.virtual_s,
                            "arrivals": hist.arrivals,
                            "staleness": hist.staleness,
                            "parked_hops": hist.parked_hops},
                buffer_tree=btree, buffer_meta=bmeta)

    # Drain: flush what is still buffered after the last dispatch round, K
    # at a time, evaluating after each tick so the curves follow the
    # virtual clock.  Empty at once in the degenerate (barrier) setting.
    t = cfg.rounds
    while pending:
        server_tick(t, num_new=0)
        a, l = eval_fn(global_params)
        hist.accuracy.append(float(a))
        hist.loss.append(float(l))
        t += 1

    return RunResult(params=global_params, ledger=ledger, history=hist,
                     engine=espec, config=cfg,
                     planner_stats=dict(planner.stats))
