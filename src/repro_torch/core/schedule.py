"""RoundSchedule — the strategy-agnostic IR between schedulers and executors.

Counterpart of ``repro.core.schedule``.  A scheduler expresses one
communication round as slot-level *ops* (train / permute+train /
group-mix), the *wire events* to charge against the
:class:`~repro_torch.channels.resources.ResourceLedger`, and the final
aggregation weights.  Scheduling is pure numpy: the same object is charged
once (:func:`charge_schedule`) and replayed by the executor on the device.

Slot ``c`` always draws client ``c``'s batches.  Partial hop sets are
completed to slot bijections by :func:`complete_round_permutation`
(displaced idle models are parked on free slots, which the ledger never
charges).

The buffered-async plane annotates a schedule with arrival times
(:class:`ArrivalModel`, :func:`annotate_arrivals`): when each slot's payload
is ready, which late hops it parks, and when each contribution reaches the
server.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["WireEvent", "TrainOp", "PermuteOp", "MixOp", "RoundSchedule",
           "complete_round_permutation", "charge_schedule", "apply_churn",
           "ArrivalModel", "annotate_arrivals"]


@dataclasses.dataclass(frozen=True)
class WireEvent:
    """One charged transmission: ``kind`` in {"d2d", "uplink", "downlink"}.
    ``gamma`` is already clamped to the feasibility floor; ``src`` is the
    sending client slot (-1: the BS)."""
    kind: str
    bits: float
    gamma: float
    n_users: int = 1
    src: int = -1


@dataclasses.dataclass(frozen=True)
class TrainOp:
    """Local update at every slot where ``train_mask`` is True."""
    train_mask: np.ndarray          # (C,) bool


@dataclasses.dataclass(frozen=True)
class PermuteOp:
    """One diffusion round: slot ``c`` receives the model held by slot
    ``src_of_dst[c]``, then the slots in ``train_mask`` train.

    ``compress`` marks STC-compressed hops (``feddif_stc``): payloads feeding
    a trained destination become ``ref + STC(params − ref)`` before the
    move, ``ref`` being the round-start global every PUE holds."""
    src_of_dst: np.ndarray          # (C,) int — bijection over slots
    train_mask: np.ndarray          # (C,) bool
    compress: bool = False

    def compress_src_mask(self) -> np.ndarray:
        """(C,) bool — slots whose outgoing payload is STC-compressed."""
        mask = np.zeros_like(self.train_mask)
        mask[self.src_of_dst[self.train_mask]] = True
        return mask


@dataclasses.dataclass(frozen=True)
class MixOp:
    """In-place group averaging: every slot in a group is overwritten by the
    group's data-size-weighted mean (gossip pairs, TT-HF clusters, the BS
    broadcast when one group spans all slots)."""
    groups: tuple                   # of (members: tuple[int], weights: tuple[float])

    def matrix(self, num_slots: int) -> np.ndarray:
        """(C, C) row-stochastic mixing matrix for the stacked executor:
        identity rows outside every group, each member's row the group's
        weights normalized in float64 and cast to fp32."""
        w = np.eye(num_slots, dtype=np.float32)
        for members, weights in self.groups:
            ws = np.asarray(weights, np.float64)
            ws = (ws / ws.sum()).astype(np.float32)
            for i in members:
                w[i, :] = 0.0
                w[i, list(members)] = ws
        return w


@dataclasses.dataclass
class RoundSchedule:
    """One communication round, strategy-agnostic.

    ``agg`` holds ordered ``(slot, weight)`` pairs of the Eq.-(11)
    aggregation; ``agg_mode`` is "params" or "stc_delta" (weighted mean of
    STC-compressed deltas against the round-start global — the STC uplink).
    With ``persistent=True`` (gossip, TT-HF) slots carry their state across
    communication rounds and the aggregate is only reported (evaluated);
    otherwise each round starts from a broadcast of the global."""
    num_slots: int
    ops: list
    wire: list
    agg: list
    agg_mode: str = "params"
    persistent: bool = False
    stc_sparsity: float = 0.01
    diffusion_rounds: int = 0
    mean_iid: float = 0.0

    def slot_weights(self) -> np.ndarray:
        """Dense (C,) aggregation weight vector (zero for empty slots)."""
        w = np.zeros(self.num_slots, np.float64)
        for slot, weight in self.agg:
            w[slot] += weight
        return w


def complete_round_permutation(hops: list, slot_of_model: np.ndarray,
                               num_slots: int
                               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Complete ``(model, dst_client)`` hops into a slot bijection.

    Returns ``(src_of_dst, train_mask, new_slot_of_model)``.  Unscheduled
    sources stay put when possible, otherwise they are parked on a free
    destination."""
    mask = np.zeros(num_slots, dtype=bool)
    dst_of_src = np.full(num_slots, -1, dtype=np.int64)
    used_dst: set[int] = set()
    for model, dst in hops:
        src = int(slot_of_model[model])
        assert dst not in used_dst, "matching must be 1-1 over dsts"
        assert dst_of_src[src] == -1, "slot invariant violated"
        dst_of_src[src] = dst
        used_dst.add(int(dst))
        mask[dst] = True
    free = [d for d in range(num_slots) if d not in used_dst]
    for src in range(num_slots):
        if dst_of_src[src] >= 0:
            continue
        if src not in used_dst:
            dst_of_src[src] = src
            used_dst.add(src)
            free.remove(src)
        else:
            dst_of_src[src] = free.pop(0)
            used_dst.add(int(dst_of_src[src]))
    assert sorted(dst_of_src.tolist()) == list(range(num_slots)), dst_of_src
    new_slot_of_model = dst_of_src[slot_of_model]
    src_of_dst = np.argsort(dst_of_src)
    return src_of_dst, mask, new_slot_of_model


def charge_schedule(ledger, schedule: RoundSchedule) -> None:
    """Replay a schedule's wire events into a ResourceLedger — the one
    charging path, so communication cost belongs to the schedule."""
    for ev in schedule.wire:
        if ev.kind == "d2d":
            ledger.charge_d2d(ev.bits, ev.gamma)
        elif ev.kind == "uplink":
            ledger.charge_uplink(ev.bits, ev.gamma)
        elif ev.kind == "downlink":
            ledger.charge_downlink(ev.bits, ev.gamma, ev.n_users)
        else:
            raise ValueError(f"unknown wire event kind {ev.kind!r}")


def apply_churn(schedule: RoundSchedule, drop: np.ndarray) -> RoundSchedule:
    """Straggler/churn dropout: dropped clients neither train nor aggregate.

    ``drop`` is a (C,) bool mask of the clients that fail to complete the
    round.  The returned schedule clears them from every Train/Permute
    ``train_mask``, removes their ``agg`` entries (zero aggregation weight)
    and leaves ``wire`` as it is: their scheduled airtime was spent before
    the deadline, so the ledger charges the full schedule on every
    executor.  If dropout would empty the aggregation, the round is left
    unchanged."""
    drop = np.asarray(drop, dtype=bool)
    assert drop.shape == (schedule.num_slots,), drop.shape
    agg2 = [(s, w) for s, w in schedule.agg if not drop[s]]
    if not agg2 or not drop.any():
        return schedule
    ops2: list = []
    for op in schedule.ops:
        if isinstance(op, TrainOp):
            ops2.append(TrainOp(op.train_mask & ~drop))
        elif isinstance(op, PermuteOp):
            ops2.append(dataclasses.replace(op,
                                            train_mask=op.train_mask & ~drop))
        else:
            ops2.append(op)
    return dataclasses.replace(schedule, ops=ops2, agg=agg2)


@dataclasses.dataclass(frozen=True)
class ArrivalModel:
    """Per-slot timing world of one round, in seconds: ``train_s[c]`` one
    local session at slot ``c``, ``hop_s[s, d]`` the D2D time of one hop
    payload from ``s`` to ``d``, ``uplink_s[c]`` slot ``c``'s uplink of its
    contribution.  :meth:`zeros` makes every arrival instantaneous (the
    sync-degenerate configuration)."""
    train_s: np.ndarray     # (C,)
    hop_s: np.ndarray       # (C, C)
    uplink_s: np.ndarray    # (C,)

    @classmethod
    def zeros(cls, num_slots: int) -> "ArrivalModel":
        return cls(train_s=np.zeros(num_slots),
                   hop_s=np.zeros((num_slots, num_slots)),
                   uplink_s=np.zeros(num_slots))


def annotate_arrivals(schedule: RoundSchedule, model: ArrivalModel,
                      hop_deadline_s: float | None = None
                      ) -> tuple[RoundSchedule, np.ndarray, int]:
    """Propagate per-slot ready times through the schedule's ops.

    A ``TrainOp`` adds ``train_s`` at every masked slot; a ``PermuteOp``
    moves readiness along the hop (``ready[src] + hop_s[src, dst]`` for a
    genuine move, nothing for a parked identity move, which the ledger
    never charges either), then adds the destination's session; a ``MixOp``
    is a group barrier at the group's latest slot plus its slowest pairwise
    exchange.  With ``hop_deadline_s``, a hop whose payload would reach its
    carrier later than the deadline is parked: the carrier keeps the late
    model but skips its session (its ``train_mask`` bit clears, as under
    churn), and the wire events stay charged.

    Returns ``(schedule', arrival_s, parked)``: ``arrival_s[c]`` is slot
    ``c``'s contribution arrival at the server (ready + uplink) after the
    round's dispatch, ``parked`` the count of cleared hop-session bits.
    With no parked hop the schedule passes through unchanged."""
    c = schedule.num_slots
    ready = np.zeros(c, np.float64)
    idx = np.arange(c)
    parked = 0
    ops2: list = []
    for op in schedule.ops:
        if isinstance(op, TrainOp):
            ready = ready + np.where(op.train_mask, model.train_s, 0.0)
            ops2.append(op)
        elif isinstance(op, PermuteOp):
            src = np.asarray(op.src_of_dst, np.int64)
            moved = src != idx
            incoming = ready[src] + np.where(moved, model.hop_s[src, idx],
                                             0.0)
            mask = np.asarray(op.train_mask, bool)
            if hop_deadline_s is not None:
                late = incoming > float(hop_deadline_s)
                parked += int(np.count_nonzero(late & mask))
                mask = mask & ~late
                ops2.append(dataclasses.replace(op, train_mask=mask))
            else:
                ops2.append(op)
            ready = incoming + np.where(mask, model.train_s, 0.0)
        elif isinstance(op, MixOp):
            for members, _ in op.groups:
                mem = list(members)
                exchange = max((float(model.hop_s[i, j])
                                for i in mem for j in mem if i != j),
                               default=0.0)
                ready[mem] = float(ready[mem].max()) + exchange
            ops2.append(op)
        else:
            raise TypeError(f"unknown op {type(op).__name__}")
    arrival = ready + model.uplink_s
    if parked == 0:
        return schedule, arrival, 0
    return dataclasses.replace(schedule, ops=ops2), arrival, parked
