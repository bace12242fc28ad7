"""Per-strategy schedulers: one communication round -> :class:`RoundSchedule`.

Counterpart of ``repro.fl.schedulers`` for ``fedavg``, ``stc``, ``feddif``
and ``feddif_stc``.  A scheduler is a pure function of the round's
control-plane inputs and consumes ``ctx.rng`` in exactly the reference's
order (positions → gains → per-diffusion-round draws), so both packages
derive the same schedule from the same seeds.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.channels.fading import ChannelModel
from repro_torch.channels.resources import GAMMA_FLOOR
from repro_torch.channels.topology import CellTopology
from repro_torch.core.diffusion import DiffusionPlanner
from repro_torch.core.dol import DiffusionState, iid_distance
from repro_torch.core.schedule import (PermuteOp, RoundSchedule, TrainOp,
                                       WireEvent, complete_round_permutation)
from repro_torch.fl.compression import compressed_bits

__all__ = ["RoundContext", "SCHEDULERS", "apply_round_churn"]


@dataclasses.dataclass
class RoundContext:
    """Everything a scheduler may consult for one communication round ``t``.
    ``param_template`` is used for shapes only (STC bit accounting)."""
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
    # Per-hop D2D payload bits when the wire format differs from fp32
    # params (int8-packed adapter hops, FLConfig.hop_quant); None charges
    # model_bits.  Up/downlinks always charge model_bits.
    hop_bits: float | None = None
    # Per-client learning value in [0, 1] (fl/experiment.py's probe), fused
    # into the FedDif bids with FLConfig.uncertainty_weight.
    learning_value: np.ndarray | None = None

    def d2d_bits(self) -> float:
        """Eq.-15 payload size S of one D2D hop under the active wire
        format (``repro_torch.fl.adapters.packed_bits`` for int8 hops)."""
        return self.model_bits if self.hop_bits is None else self.hop_bits


def _mean_partition_iid(ctx: RoundContext) -> float:
    return float(np.mean(iid_distance(np.asarray(ctx.dsi), ctx.cfg.metric)))


def _downlink(ctx: RoundContext) -> WireEvent:
    return WireEvent("downlink", ctx.model_bits,
                     float(np.median(ctx.up_gamma)), ctx.cfg.num_clients)


def _uplink(ctx: RoundContext, client: int,
            bits: float | None = None) -> WireEvent:
    return WireEvent("uplink", ctx.model_bits if bits is None else bits,
                     float(ctx.up_gamma[client]), src=int(client))


def apply_round_churn(ctx: RoundContext,
                      schedule: RoundSchedule) -> RoundSchedule:
    """The churn hook: at ``churn_rate = 0`` it draws nothing and returns the
    schedule unchanged, as the reference does."""
    if float(ctx.cfg.churn_rate) > 0.0:
        raise NotImplementedError("churn_rate > 0 is ROADMAP item A11")
    return schedule


def schedule_fedavg(ctx: RoundContext) -> RoundSchedule:
    """FedAvg: broadcast, local update everywhere, weighted uplink
    aggregation."""
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
    ``feddif_stc`` ships STC-compressed deltas on every hop."""
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

    plan = ctx.planner.plan_communication_round(
        state, ctx.dsi, ctx.data_sizes, ctx.rng, positions=ctx.pos,
        values=ctx.learning_value,
        value_weight=float(cfg.uncertainty_weight))

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


SCHEDULERS: dict[str, Callable[[RoundContext], RoundSchedule]] = {
    "feddif": schedule_feddif,
    "feddif_stc": schedule_feddif,
    "fedavg": schedule_fedavg,
    "stc": schedule_stc,
}
