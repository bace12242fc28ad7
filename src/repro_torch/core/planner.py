"""The device planner: FedDif's bid → auction → schedule loop on tensors.

Counterpart of ``repro.core.planner`` (the reference's ``planner="jax"``).
The whole communication round runs on one device,
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

The world (``repro_torch.channels.world``) enters as the reference's does:
the multicell interference is folded into the pre-drawn γ sequence on the
host; the mobile world is stepped once per diffusion round inside the loop
(:func:`~repro_torch.channels.world.step`), and Eqs. 12–14/39 are
recomputed from the stepped positions in float32, in the bits XLA-CPU
gives the reference's jitted loop (:func:`_mobile_channel`); ``gamma_seq``
then carries the raw Exp(1) Rayleigh powers.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.channels.resources import (outage_probability_t,
                                            required_bandwidth_t,
                                            spectral_efficiency)
from repro_torch.channels.world import WorldState, _norm2_t
from repro_torch.channels.world import step as world_step
from repro_torch.core.dol import (PlannerState, _fma_t, iid_distance_t,
                                  xla_log_t)
from repro_torch.core.matching import auction_assign
from repro_torch.core.threefry import xla_powf_t
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kernel_ops

__all__ = ["PlanInputs", "PlanOutputs", "draw_gamma_sequence",
           "draw_fading_sequence", "device_gamma_sequence",
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
    gamma_seq: torch.Tensor      # (R, N, N) per-round spectral efficiency,
    #                              or the raw Exp(1) powers |h|² when the
    #                              mobile world recomputes γ in the loop
    mean_snr: torch.Tensor       # (N, N) large-scale-only SNR (Eq. 39)
    epsilon: torch.Tensor        # () halting tolerance
    gamma_min: torch.Tensor      # () constraint (18e)
    outage_max: torch.Tensor     # () Eq. (39) cap
    bandwidth_budget: torch.Tensor  # () constraint (18f)
    model_bits: torch.Tensor     # () S in Eq. (15)
    value: torch.Tensor | None = None   # (N,) learning value in [0, 1]
    value_weight: float = 0.0           # fusion weight w
    world: WorldState | None = None     # float32 world (mobile scenario)
    chan: tuple | None = None           # (p/σ², β₀ dB, κ, d₀) as float32
    #                                     values, for Eqs. 12–14 in the loop


class PlanOutputs(NamedTuple):
    """Padded plan tensors: row k of each (R, M) buffer holds diffusion
    round k, valid where ``scheduled[k]`` (and k < ``num_rounds``)."""
    num_rounds: int
    dst: torch.Tensor        # (R, M) int64
    scheduled: torch.Tensor  # (R, M) bool
    src: torch.Tensor        # (R, M) int64
    gamma: torch.Tensor      # (R, M) link spectral efficiency of the hop
    bandwidth: torch.Tensor  # (R, M) Eq. 15 cost
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


_F32 = np.float32
#: float32 constants of the reference's jitted Eqs. 12–14: ``log10(x)``
#: becomes ``log(x)·fp32(1/ln 10)`` and ``log2`` ``log(x)·fp32(1/ln 2)``
#: (XLA turns a division by a constant into a product with its reciprocal),
#: and ``β₀ − 10·κ·log10(x)`` is reassociated to ``β₀ − log(x)·(κ·c)``
#: with ``c = fp32(10·fp32(1/ln 10))``.
_INV_LN10 = float(_F32(1.0 / np.log(10.0)))
_INV_LN2 = float(_F32(1.0 / np.log(2.0)))
_DB10 = _F32(_F32(10.0) * _F32(1.0 / np.log(10.0)))
_TENTH = float(_F32(0.1))


def _chan_f32(channel) -> tuple:
    """The float32 constants ``(p/σ², β₀, κ, d₀)`` of the jitted Eqs.
    12–14."""
    p = channel.params
    return tuple(float(_F32(v)) for v in (
        p.tx_power_w / p.noise_w, p.beta0_db, p.kappa, p.d0_m))


def _mean_snr_t(dist: torch.Tensor, chan: tuple) -> torch.Tensor:
    """The large-scale-only mean SNR of float32 distances, in the bits
    XLA-CPU gives the reference's jitted loop:
    ``fp32(10^(ls·fp32(0.1)))·p/σ²`` with ``ls = fma(−log(x), κ·c, β₀)``
    and ``x = max(d, d₀)/d₀`` (the log is :func:`xla_log_t`; the power is
    glibc's ``powf``, which XLA-CPU calls: :func:`xla_powf_t`)."""
    p_over_noise, beta0_db, kappa, d0 = chan
    x = torch.clamp(dist, min=d0) / d0
    k = float(_F32(_F32(kappa) * _DB10))
    ls = _fma_t(-xla_log_t(x), x.new_tensor(k), x.new_tensor(beta0_db))
    return xla_powf_t(10.0, ls * _TENTH) * float(p_over_noise)


def _mobile_channel(positions: torch.Tensor, chan: tuple
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Eqs. 12–14 from stepped float32 positions: the (N, N) distances
    (unit diagonal) and their :func:`_mean_snr_t`.  Returns
    ``(dist, mean_snr)``."""
    n = positions.shape[0]
    dist = _norm2_t(positions[:, None, :] - positions[None, :, :])
    eye = torch.eye(n, dtype=torch.bool, device=positions.device)
    dist = torch.where(eye, 1.0, dist)
    return dist, _mean_snr_t(dist, chan)


def _mobile_gamma(mean_snr: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """Eq. 14 ``log2(1 + SNR̄·|h|²)`` as the reference's jitted loop gives
    it: ``log(fma(SNR̄, |h|², 1))·fp32(1/ln 2)``."""
    one = mean_snr.new_tensor(1.0)
    return xla_log_t(_fma_t(mean_snr, h2, one)) * _INV_LN2


def _plan_rounds(inp: PlanInputs, *, metric: str, allow_retraining: bool,
                 mobility: bool = False, step_m: float = 0.0,
                 stats: dict | None = None) -> PlanOutputs:
    """One communication round's diffusion rounds on ``inp``'s device.

    Each diffusion round: IID distances, bids (Eq. 32, plus the learning
    value), feasibility (18b/c/e + Eq. 39), Eq.-36 weights, the auction
    (Eq. 38), the FCFS budget pass and the Eq.-2 fold of the scheduled hops.
    The loop halts, as the reference's does, on the first round that
    schedules no still-active model; that round's row is written too.
    ``mobility`` steps ``inp.world`` by ``step_m`` meters at the start of
    every diffusion round and recomputes the round's γ and outage from the
    stepped positions (``inp.gamma_seq`` then holds |h|²).
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
    gamma_b, bw_b = zeros((max_rounds, m)), zeros((max_rounds, m))
    world = inp.world if mobility else None
    eff_b = zeros((max_rounds,))
    converged = torch.tensor(True, device=dev)
    budget = np.float32(inp.bandwidth_budget.item())
    k = 0
    while k < max_rounds:
        if mobility:
            # One deterministic random-waypoint substep, then Eqs. 12–14/39
            # from the stepped positions.
            world = world_step(world, step_m=step_m)
            _, mean_snr_k = _mobile_channel(world.positions, inp.chan)
            pout_k = outage_probability_t(inp.gamma_min, mean_snr_k)
            gamma = _mobile_gamma(mean_snr_k, inp.gamma_seq[k])
        else:
            pout_k = pout
            gamma = inp.gamma_seq[k]
        # One distance for the mask and the bids, in the bid expression's
        # forms (the reference computes it once in that program).
        iid = iid_distance_t(st.dol, metric, site="bid_iid")
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
        feas &= pout_k[st.holder] <= inp.outage_max
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
        gamma_b[k], bw_b[k] = gamma[st.holder, dstc], bw_sel
        eff_b[k] = float(eff)
        converged = converged & auc_ok
        if stats is not None:
            stats["loop_iterations"] = stats.get("loop_iterations", 0) + 1
        if not do:
            break
        st = st.record_round(dstc, sched, inp.dsi, inp.data_sizes)
        k += 1
    return PlanOutputs(num_rounds=k, dst=dst_b, scheduled=sched_b, src=src_b,
                       gamma=gamma_b, bandwidth=bw_b,
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
    ``allow_retraining``); ε, γ_min, outage, budget and S may differ.  As
    in the reference, batched items are static-world items (no mobile
    world)."""
    if any(inp.world is not None for inp in inputs):
        raise ValueError("plan_rounds_batched: the mobile world is planned "
                         "round by round (plan_communication_round_jax)")
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
                        max_rounds: int,
                        interference: np.ndarray | float = 0.0
                        ) -> np.ndarray:
    """Pre-draw ``max_rounds`` Rayleigh rounds of γ from the host Generator.

    Draw k equals the lazy host loop's draw for diffusion round k (numpy
    Generators are sequential), so both planner modes see the same
    channels; the device mode consumes the stream ``max_rounds`` draws deep
    wherever its loop halts.  ``interference`` (multicell, frozen within
    the round) is folded into the SINR here."""
    gains = np.stack([channel.sample_gains(dist, rng)
                      for _ in range(max_rounds)])
    return spectral_efficiency(channel.snr(gains, interference))


def draw_fading_sequence(rng: np.random.Generator, n: int,
                         max_rounds: int) -> np.ndarray:
    """(R, N, N) raw Exp(1) Rayleigh powers |h|², stream for stream the
    draws inside ``channel.sample_gains`` (one ``rng.exponential`` of the
    distance shape per call).  The mobile world recomputes β — hence γ —
    from its stepped positions inside the planner loop."""
    return np.stack([rng.exponential(scale=1.0, size=(n, n))
                     for _ in range(max_rounds)])


def device_gamma_sequence(channel, generator: torch.Generator,
                          dist: torch.Tensor, max_rounds: int
                          ) -> torch.Tensor:
    """A channel draw on ``dist``'s device with no host stream: ``max_rounds``
    Rayleigh rounds of float32 γ from ``generator`` (torch's draws, so not
    the numpy stream's: for device-only planning at scale, not for
    parity), through Eqs. 12–14 in float32 as the mobile loop computes
    them (:func:`_mean_snr_t`, :func:`_mobile_gamma`)."""
    d = dist.to(torch.float32)
    h2 = torch.empty((max_rounds,) + tuple(d.shape), dtype=torch.float32,
                     device=generator.device).exponential_(
                         1.0, generator=generator).to(d.device)
    return _mobile_gamma(_mean_snr_t(d, _chan_f32(channel)), h2)


def plan_round_inputs(planner, state, dsi: np.ndarray,
                      data_sizes: np.ndarray, rng: np.random.Generator,
                      positions: np.ndarray | None = None,
                      values: np.ndarray | None = None,
                      value_weight: float = 0.0,
                      interference: np.ndarray | float = 0.0,
                      world: WorldState | None = None
                      ) -> tuple[PlanInputs, np.ndarray | None]:
    """:class:`PlanInputs` on ``planner.device`` (the CUDA device unless it
    is ``"cpu"``), built as the host planner would see them, and the
    float64 channel draws ``gamma_seq64`` that :func:`decode_plan` stamps
    hops with (bit-identical ledger charges).  ``state`` is the host
    :class:`~repro_torch.core.dol.DiffusionState` after initial
    training.  ``interference`` (multicell) is folded into the draws;
    ``world`` (a float32 host world, mobile) switches to the in-loop form:
    ``gamma_seq`` holds |h|², the channel constants ride in ``chan`` and
    ``gamma_seq64`` is ``None`` (γ is the loop's float32)."""
    dev = resolve_device(planner.device)
    n = dsi.shape[0]
    chan = planner.channel
    if world is not None:
        positions = np.asarray(world.positions)
    elif positions is None:
        positions = planner.topology.sample_positions(rng, n)
    dist = planner.topology.pairwise_distances(positions)
    beta = 10 ** (chan.large_scale_db(dist) / 10.0)
    mean_snr = chan.snr(beta, interference)
    max_rounds = planner.max_rounds or n * (n - 1)
    if world is not None:
        seq = draw_fading_sequence(rng, n, max_rounds)
        gamma_seq64 = None
        chan_vec = _chan_f32(chan)
    else:
        seq = draw_gamma_sequence(chan, dist, rng, max_rounds, interference)
        gamma_seq64 = seq
        chan_vec = None
    a = planner.auction
    use_value = values is not None and value_weight != 0.0

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    dev_world = None
    if world is not None:
        dev_world = WorldState(
            positions=f32(world.positions), waypoints=f32(world.waypoints),
            serving=torch.as_tensor(np.asarray(world.serving, np.int64),
                                    device=dev),
            energy_j=f32(world.energy_j), t=int(world.t))
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
        value_weight=float(value_weight) if use_value else 0.0,
        world=dev_world, chan=chan_vec), gamma_seq64


def decode_plan(out: PlanOutputs, gamma_seq64: np.ndarray | None,
                model_bits: float):
    """Padded plan tensors → host :class:`~repro_torch.core.diffusion
    .DiffusionPlan`.  Hops within a round come in decreasing Eq.-36 weight,
    the host planner's FCFS order.  With the float64 draws, hop γ and
    Eq.-15 bandwidth are read from them and S, so ledger charges are the
    host planner's bits; without them (the mobile world) they are the
    loop's float32 values, as in the reference."""
    from repro_torch.core.diffusion import DiffusionHop, DiffusionPlan
    k = out.num_rounds
    sched = out.scheduled.cpu().numpy()
    dst, src = out.dst.cpu().numpy(), out.src.cpu().numpy()
    dec, weight = out.decrement.cpu().numpy(), out.weight.cpu().numpy()
    gamma, bw = out.gamma.cpu().numpy(), out.bandwidth.cpu().numpy()
    eff = out.efficiency.cpu().numpy()
    hops = []
    for r in range(k):
        models = [int(m) for m in np.flatnonzero(sched[r])]
        models.sort(key=lambda m: -weight[r, m])
        for m in models:
            s, d = int(src[r, m]), int(dst[r, m])
            if gamma_seq64 is not None:
                g = float(gamma_seq64[r, s, d])
                b = float(model_bits) / g
            else:
                g, b = float(gamma[r, m]), float(bw[r, m])
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
                                 interference: np.ndarray | float = 0.0,
                                 values: np.ndarray | None = None,
                                 value_weight: float = 0.0, world=None,
                                 step_m: float = 0.0):
    """Device-mode twin of ``DiffusionPlanner.plan_communication_round``:
    the same contract (mutates ``state``), the whole loop on
    ``planner.device``.  Refuses the underlay with the reference's
    ``ValueError``; warns, as the reference does, when an auction hit its
    iteration cap."""
    if getattr(planner, "underlay", False):
        raise ValueError("the jax planner does not model underlay CUE "
                         "interference; use planner='host' for underlay "
                         "scenarios (Appendix C-F)")
    inp, gamma64 = plan_round_inputs(planner, state, dsi, data_sizes, rng,
                                     positions, values=values,
                                     value_weight=value_weight,
                                     interference=interference, world=world)
    out = _plan_rounds(inp, metric=planner.auction.metric,
                       allow_retraining=planner.auction.allow_retraining,
                       mobility=world is not None, step_m=float(step_m),
                       stats=planner.stats)
    if not out.converged:
        warnings.warn("device planner: an auction hit its iteration cap; "
                      "the plan may schedule fewer hops than the host "
                      "oracle", RuntimeWarning, stacklevel=2)
    plan = decode_plan(out, gamma64, planner.auction.model_bits)
    state.update_from(out.state, rounds_advanced=out.num_rounds)
    return plan
