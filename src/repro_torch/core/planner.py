"""The device planner: FedDif's bid → auction → schedule loop on tensors.

Counterpart of ``repro.core.planner`` (the reference's ``planner="jax"``),
for the static world.  The whole communication round runs on one device,
on fixed-shape padded hop buffers, with the Bertsekas auction
(:func:`repro_torch.core.matching.auction_assign`) as the matching and the
Eq.-32 bids of each bid round from :func:`repro_torch.kernels.ops.bid_fused`
(candidate IID distances, their subtraction from the models' own and, with
a learning value, its factor): one hand-written kernel launch on the card,
the plain composite on the CPU.

The reference's ``lax.while_loop`` becomes a Python loop with one host read
per diffusion round: the auction's outcome (matched edges, their costs and
weights) comes back to the host, where the (18f) FCFS budget pass and the
halting decision run in float32 numpy.  The auction itself reads its phase
condition once per bidding iteration; ``stats`` counts both.

Parity contract, as the reference's: both planner modes consume the same
host-drawn channel realizations (:func:`draw_gamma_sequence` pre-draws
``max_rounds`` Rayleigh rounds from the caller's numpy Generator in the
lazy host loop's order), so on the CPU the decoded hop lists equal the host
planner's.  On the card the bids come from the centered contraction, whose
rounding differs from the composite's: plans there are held to the
reference's equivalence rule (same rounds, same hop count, total Eq.-17
decrement within 1e-6 relative), not to exact hop lists.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.channels.resources import (outage_probability_t,
                                            required_bandwidth_t,
                                            spectral_efficiency)
from repro_torch.core.dol import PlannerState, iid_distance_t
from repro_torch.core.matching import auction_assign
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kernel_ops

__all__ = ["PlanInputs", "PlanOutputs", "draw_gamma_sequence",
           "plan_round_inputs", "decode_plan", "plan_rounds_batched",
           "plan_communication_round_jax"]


class PlanInputs(NamedTuple):
    """One communication round's planner inputs, tensors on one device.
    The knobs ``epsilon`` … ``model_bits`` are 0-d float32 tensors;
    ``value_weight`` is a host float (the bid kernel takes it by
    value)."""
    dol0: torch.Tensor           # (M, C) post-initial-training DoLs
    chain_size0: torch.Tensor    # (M,)
    visited0: torch.Tensor       # (M, N) bool
    holder0: torch.Tensor        # (M,) int64
    dsi: torch.Tensor            # (N, C)
    data_sizes: torch.Tensor     # (N,)
    gamma_seq: torch.Tensor      # (R, N, N) per-round spectral efficiency
    mean_snr: torch.Tensor       # (N, N) large-scale-only SNR (Eq. 39)
    epsilon: torch.Tensor        # () halting tolerance
    gamma_min: torch.Tensor      # () constraint (18e)
    outage_max: torch.Tensor     # () Eq. (39) cap
    bandwidth_budget: torch.Tensor  # () constraint (18f)
    model_bits: torch.Tensor     # () S in Eq. (15)
    value: torch.Tensor | None = None   # (N,) learning value in [0, 1]
    value_weight: float = 0.0           # fusion weight w


class PlanOutputs(NamedTuple):
    """Padded plan tensors: row k of each (R, M) buffer holds diffusion
    round k, valid where ``scheduled[k]`` (and k < ``num_rounds``)."""
    num_rounds: int
    dst: torch.Tensor        # (R, M) int64
    scheduled: torch.Tensor  # (R, M) bool
    src: torch.Tensor        # (R, M) int64
    decrement: torch.Tensor  # (R, M) δ (Eq. 17)
    weight: torch.Tensor     # (R, M) Eq. 36 edge weight (hop ordering)
    efficiency: torch.Tensor  # (R,) E(i*, B*) per round (Eq. 16)
    state: PlannerState      # post-plan diffusion state
    final_iid: torch.Tensor  # (M,)
    converged: bool          # False if an auction hit its iteration cap


def _fcfs(order: np.ndarray, matched: np.ndarray, cost: np.ndarray,
          budget: np.float32) -> np.ndarray:
    """(18f) FCFS over matched edges in ``order``: an edge that does not fit
    is skipped, later (cheaper) ones may still fit.  float32 throughout."""
    chosen = np.zeros(matched.shape, bool)
    for model in order:
        if matched[model] and cost[model] <= budget:
            chosen[model] = True
            budget = np.float32(budget - cost[model])
    return chosen


def _plan_rounds(inp: PlanInputs, *, metric: str, allow_retraining: bool,
                 stats: dict | None = None) -> PlanOutputs:
    """One communication round's diffusion rounds on ``inp``'s device.

    Each diffusion round: IID distances, bids (Eq. 32, plus the learning
    value), feasibility (18b/c/e + Eq. 39), Eq.-36 weights, the auction
    (Eq. 38), the FCFS budget pass and the Eq.-2 fold of the scheduled hops.
    The loop halts, as the reference's does, on the first round that
    schedules no still-active model; that round's row is written too.
    ``stats`` (if given) accumulates ``loop_iterations`` (diffusion
    rounds run, the halting one included: one host read each) and the
    ``auction_iterations`` and ``auction_host_reads``."""
    max_rounds, n, _ = inp.gamma_seq.shape
    m = inp.dol0.shape[0]
    dev = inp.dol0.device
    mi = torch.arange(m, device=dev)
    pout = outage_probability_t(inp.gamma_min, inp.mean_snr)    # (N, N)
    st = PlannerState(dol=inp.dol0.to(torch.float32),
                      chain_size=inp.chain_size0.to(torch.float32),
                      visited=inp.visited0.to(torch.bool),
                      holder=inp.holder0.to(torch.int64))

    def zeros(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    dst_b, src_b = zeros((max_rounds, m), torch.int64), zeros(
        (max_rounds, m), torch.int64)
    sched_b = zeros((max_rounds, m), torch.bool)
    dec_b, weight_b = zeros((max_rounds, m)), zeros((max_rounds, m))
    eff_b = zeros((max_rounds,))
    converged = torch.tensor(True, device=dev)
    budget = np.float32(inp.bandwidth_budget.item())
    k = 0
    while k < max_rounds:
        gamma = inp.gamma_seq[k]
        iid = iid_distance_t(st.dol, metric)
        active = iid > inp.epsilon
        if not allow_retraining:
            # Models at chain length N visited everyone (full diffusion).
            active &= ~st.visited.all(dim=1)

        bids = kernel_ops.bid_fused(iid, st.dol, st.chain_size, inp.dsi,
                                    inp.data_sizes, inp.value,
                                    inp.value_weight, metric=metric)  # (M, N)
        gamma_edge = gamma[st.holder]                            # (M, N)
        feas = bids > 0.0
        if not allow_retraining:
            feas &= ~st.visited
        feas &= gamma_edge >= inp.gamma_min
        feas &= pout[st.holder] <= inp.outage_max
        feas[mi, st.holder] = False             # no self-transmission
        bw = required_bandwidth_t(inp.model_bits, gamma_edge)
        wmat = torch.where(feas & torch.isfinite(bw) & (bw > 0.0),
                           bids / bw, 0.0)                       # Eq. 36

        dst0, auc_ok = auction_assign(wmat, stats=stats)         # Eq. 38
        matched = dst0 >= 0
        dstc = torch.clamp(dst0, 0, n - 1)
        w_sel = torch.where(matched, wmat[mi, dstc], -torch.inf)
        bw_sel = torch.where(matched, bw[mi, dstc], 0.0)
        dec_sel = torch.where(matched, bids[mi, dstc], 0.0)

        # The round's one host read: FCFS, efficiency and halting run there.
        host = torch.stack([w_sel, bw_sel, dec_sel, matched.float(),
                            active.float()]).cpu().numpy()
        w_h, bw_h, dec_h = host[0], host[1], host[2]
        matched_h, active_h = host[3] > 0, host[4] > 0
        order = np.argsort(-w_h, kind="stable")
        chosen = _fcfs(order, matched_h, bw_h, budget) & matched_h
        useful = chosen & (bw_h > 0.0)
        n_eff = int(useful.sum())
        eff = (np.float32(np.sum(np.where(useful, dec_h / np.maximum(
            bw_h, np.float32(1e-30)), np.float32(0.0)), dtype=np.float32)
            / np.float32(n_eff)) if n_eff > 0 else np.float32(0.0))
        # Only still-active models hop (an inactive one may have competed
        # for PUEs and budget in the matching, as on the host).
        scheduled = chosen & active_h
        do = bool(active_h.any() and scheduled.any())
        sched = torch.as_tensor(scheduled & do, device=dev)

        dst_b[k], sched_b[k], src_b[k] = dstc, sched, st.holder
        dec_b[k], weight_b[k] = dec_sel, w_sel
        eff_b[k] = float(eff)
        converged = converged & auc_ok
        if stats is not None:
            stats["loop_iterations"] = stats.get("loop_iterations", 0) + 1
        if not do:
            break
        st = st.record_round(dstc, sched, inp.dsi, inp.data_sizes)
        k += 1
    return PlanOutputs(num_rounds=k, dst=dst_b, scheduled=sched_b, src=src_b,
                       decrement=dec_b, weight=weight_b, efficiency=eff_b,
                       state=st,
                       final_iid=iid_distance_t(st.dol, metric),
                       converged=bool(converged))


def plan_rounds_batched(inputs: list[PlanInputs], metric: str,
                        allow_retraining: bool,
                        stats: dict | None = None) -> list[PlanOutputs]:
    """Plan a batch of cells and rounds: one :class:`PlanOutputs` per item,
    each what :func:`_plan_rounds` gives it alone.

    The reference vmaps its device loop over the batch.  Here each diffusion
    round reads the host once, so the items are planned one after another;
    ``stats`` adds up their counters.  As in the reference, the items must
    share (N, M, C, max_rounds) and the static knobs (``metric``,
    ``allow_retraining``); ε, γ_min, outage, budget and S may differ."""
    shapes = {(tuple(inp.gamma_seq.shape), tuple(inp.dol0.shape),
               inp.value is None) for inp in inputs}
    if len(shapes) > 1:
        raise ValueError(f"plan_rounds_batched: items of different shapes "
                         f"((R, N, N), (M, C), no value) {sorted(shapes)}")
    return [_plan_rounds(inp, metric=metric,
                         allow_retraining=allow_retraining, stats=stats)
            for inp in inputs]


# ---------------------------------------------------------------- host glue


def draw_gamma_sequence(channel, dist: np.ndarray, rng: np.random.Generator,
                        max_rounds: int) -> np.ndarray:
    """Pre-draw ``max_rounds`` Rayleigh rounds of γ from the host Generator.

    Draw k equals the lazy host loop's draw for diffusion round k (numpy
    Generators are sequential), so both planner modes see the same
    channels; the device mode consumes the stream ``max_rounds`` draws deep
    wherever its loop halts."""
    gains = np.stack([channel.sample_gains(dist, rng)
                      for _ in range(max_rounds)])
    return spectral_efficiency(channel.snr(gains))


def plan_round_inputs(planner, state, dsi: np.ndarray,
                      data_sizes: np.ndarray, rng: np.random.Generator,
                      positions: np.ndarray | None = None,
                      values: np.ndarray | None = None,
                      value_weight: float = 0.0
                      ) -> tuple[PlanInputs, np.ndarray]:
    """:class:`PlanInputs` on ``planner.device`` (the CUDA device unless it
    is ``"cpu"``), built as the host planner would see them, and the
    float64 channel draws ``gamma_seq64`` that :func:`decode_plan` stamps
    hops with (bit-identical ledger charges).  ``state`` is the host
    :class:`~repro_torch.core.dol.DiffusionState` after initial
    training."""
    dev = resolve_device(planner.device)
    n = dsi.shape[0]
    chan = planner.channel
    if positions is None:
        positions = planner.topology.sample_positions(rng, n)
    dist = planner.topology.pairwise_distances(positions)
    beta = 10 ** (chan.large_scale_db(dist) / 10.0)
    mean_snr = chan.snr(beta)
    max_rounds = planner.max_rounds or n * (n - 1)
    seq = draw_gamma_sequence(chan, dist, rng, max_rounds)
    a = planner.auction
    use_value = values is not None and value_weight != 0.0

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    st = state.functional(dev)
    return PlanInputs(
        dol0=st.dol, chain_size0=st.chain_size, visited0=st.visited,
        holder0=st.holder, dsi=f32(dsi), data_sizes=f32(data_sizes),
        gamma_seq=f32(seq), mean_snr=f32(mean_snr),
        epsilon=f32(planner.epsilon), gamma_min=f32(a.gamma_min),
        outage_max=f32(a.outage_max),
        bandwidth_budget=f32(a.bandwidth_budget),
        model_bits=f32(a.model_bits),
        value=f32(values) if use_value else None,
        value_weight=float(value_weight) if use_value else 0.0), seq


def decode_plan(out: PlanOutputs, gamma_seq64: np.ndarray,
                model_bits: float):
    """Padded plan tensors → host :class:`~repro_torch.core.diffusion
    .DiffusionPlan`.  Hops within a round come in decreasing Eq.-36 weight,
    the host planner's FCFS order.  Hop γ and Eq.-15 bandwidth are read
    from the float64 draws and S, so ledger charges are the host
    planner's bits."""
    from repro_torch.core.diffusion import DiffusionHop, DiffusionPlan
    k = out.num_rounds
    sched = out.scheduled.cpu().numpy()
    dst, src = out.dst.cpu().numpy(), out.src.cpu().numpy()
    dec, weight = out.decrement.cpu().numpy(), out.weight.cpu().numpy()
    eff = out.efficiency.cpu().numpy()
    hops = []
    for r in range(k):
        models = [int(m) for m in np.flatnonzero(sched[r])]
        models.sort(key=lambda m: -weight[r, m])
        for m in models:
            s, d = int(src[r, m]), int(dst[r, m])
            g = float(gamma_seq64[r, s, d])
            b = float(model_bits) / g
            hops.append(DiffusionHop(
                model=m, src=s, dst=d, gamma=g, bandwidth=b,
                decrement=float(dec[r, m]), round_index=r))
    return DiffusionPlan(
        hops=hops, num_rounds=k,
        final_iid_distance=out.final_iid.cpu().numpy(),
        efficiency_per_round=[float(e) for e in eff[:k]],
        num_models=int(out.final_iid.shape[0]))


def plan_communication_round_jax(planner, state, dsi: np.ndarray,
                                 data_sizes: np.ndarray,
                                 rng: np.random.Generator,
                                 positions: np.ndarray | None = None,
                                 values: np.ndarray | None = None,
                                 value_weight: float = 0.0, world=None):
    """Device-mode twin of ``DiffusionPlanner.plan_communication_round``:
    the same contract (mutates ``state``), the whole loop on
    ``planner.device``.  Warns, as the reference does, when an auction hit
    its iteration cap."""
    if world is not None:
        raise NotImplementedError(
            "the mobile world inside the device planner's loop is ROADMAP "
            "item A11")
    inp, gamma64 = plan_round_inputs(planner, state, dsi, data_sizes, rng,
                                     positions, values=values,
                                     value_weight=value_weight)
    out = _plan_rounds(inp, metric=planner.auction.metric,
                      allow_retraining=planner.auction.allow_retraining,
                      stats=planner.stats)
    if not out.converged:
        warnings.warn("device planner: an auction hit its iteration cap; "
                      "the plan may schedule fewer hops than the host "
                      "oracle", RuntimeWarning, stacklevel=2)
    plan = decode_plan(out, gamma64, planner.auction.model_bits)
    state.update_from(out.state, rounds_advanced=out.num_rounds)
    return plan
