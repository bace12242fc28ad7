"""SPMD FedDif runtime of the port — a thin CLI over the RoundSchedule layer
and the client-stacked LM data plane.

The FedDif scheduler (``fl/schedulers.py::schedule_feddif``) plans each
communication round on the host — auctions, DoL bookkeeping, wire
accounting — and this module replays its
:class:`~repro_torch.core.schedule.RoundSchedule` on an LM fleet with
``distributed/fedshard.py``'s data plane: the vmapped local update
(:func:`~repro_torch.distributed.fedshard.make_fleet_train_step`) per
``TrainOp``, a hop and the masked train
(:func:`~repro_torch.distributed.fedshard.make_diffusion_step`) per
``PermuteOp``, and the Eq.-11 aggregation
(:func:`~repro_torch.distributed.fedshard.fleet_aggregate`) with the
schedule's chain weights.  :func:`~repro_torch.core.schedule.
charge_schedule` charges the ledger, as for every FL engine.

    PYTHONPATH=src python -m repro_torch.launch.fl_spmd --clients 4 --rounds 3
    PYTHONPATH=src python -m repro_torch.launch.fl_spmd --device cpu

Counterpart of ``repro.launch.fl_spmd``, on the smoke config of ``--arch``
as the reference runs it, with its round lines and the loss history, plus
``--device`` (the CUDA device by default, ``cpu`` on request, never a
fallback).  The control stream ``default_rng(seed)`` is drawn in the
reference's order: the corpus partition, then per round the positions and
the uplink gains (``fl/server.py::static_round_draws``, the reference's
``sample_positions`` then ``_uplink_gamma``), the planner's draws and each
client's batch, so hop lists and ledgers are the reference's bit for bit.
On the card one fleet step launches each zoo kernel, and its backward,
once per layer for all the clients.  The client-sharded mesh
(``--shard-clients``) is ROADMAP item A12.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.channels.fading import ChannelModel
from repro_torch.channels.resources import ResourceLedger
from repro_torch.channels.topology import CellTopology
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.core import aggregation as agg
from repro_torch.core.auction import AuctionConfig
from repro_torch.core.diffusion import DiffusionPlanner
from repro_torch.core.schedule import PermuteOp, TrainOp, charge_schedule
from repro_torch.data.partitioner import dirichlet_partition
from repro_torch.data.synthetic import class_labels_for_lm, lm_corpus
from repro_torch.device import resolve_device
from repro_torch.distributed.fedshard import (fleet_aggregate,
                                              make_diffusion_step,
                                              make_fleet_train_step)
from repro_torch.fl.schedulers import RoundContext, schedule_feddif
from repro_torch.fl.server import FLConfig, static_round_draws
from repro_torch.models.zoo import build_model
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.trainstep import TrainState
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["run_spmd_feddif", "main"]


def _stack_states(params, opt: opt_lib.Optimizer, n: int) -> TrainState:
    """One model replica per client slot (the BS clones the global
    model)."""
    one = TrainState(params=params, opt_state=opt.init(params),
                     step=torch.zeros((), dtype=torch.int32,
                                      device=tree_leaves(params)[0].device))

    def stack(x):
        return x[None].expand((n,) + tuple(x.shape)).clone()
    return TrainState(params=tree_map(stack, one.params),
                      opt_state=tree_map(stack, one.opt_state),
                      step=stack(one.step))


def run_spmd_feddif(arch: str = "smollm_360m", clients: int = 4,
                    rounds: int = 3, alpha: float = 0.5, seq_len: int = 64,
                    batch: int = 4, lr: float = 0.01, epsilon: float = 0.04,
                    seed: int = 0, shard_clients: bool = False, log=print,
                    device: str | torch.device | None = None,
                    init_fn: Callable | None = None):
    """Returns ``(state, loss history, ledger)``: the client-stacked
    :class:`TrainState` after the last aggregation, each round's mean
    client loss and the charged :class:`ResourceLedger`.  ``init_fn``
    (a ``torch.Generator`` seeded with ``seed`` → params) defaults to the
    zoo's init."""
    if shard_clients:
        raise NotImplementedError(
            "the client-sharded mesh (--shard-clients) is ROADMAP item A12")
    dev = resolve_device(device)
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    opt = opt_lib.sgd()
    rng = np.random.default_rng(seed)

    # --- non-IID client corpora -------------------------------------
    corpus = lm_corpus(200_000, vocab=cfg.vocab_size, seed=seed)
    n_docs = len(corpus) // seq_len
    docs = corpus[:n_docs * seq_len].reshape(n_docs, seq_len)
    labels = class_labels_for_lm(corpus, 10, seq_len)
    part = dirichlet_partition(labels, clients, alpha, rng)

    def fleet_batch() -> dict:
        per = []
        for c in range(clients):
            ix = rng.choice(part.indices[c], size=batch,
                            replace=len(part.indices[c]) < batch)
            per.append(docs[ix])
        stacked = np.stack(per)                       # (C, B, seq_len)
        return {"tokens": torch.from_numpy(stacked[:, :, :-1]).to(dev),
                "labels": torch.from_numpy(stacked[:, :, 1:]).to(dev)}

    # --- the data plane ---------------------------------------------
    fleet_step = make_fleet_train_step(model, opt, lr, remat=False)
    diff_step = make_diffusion_step(model, opt, lr, remat=False)

    # --- the host control plane (shared with the FL simulator) ------
    fl_cfg = FLConfig(strategy="feddif", num_clients=clients,
                      num_models=clients, rounds=rounds, lr=lr,
                      epsilon=epsilon, seed=seed)
    topology = CellTopology(num_pues=clients)
    channel = ChannelModel()
    auction = AuctionConfig(gamma_min=fl_cfg.gamma_min)
    planner = DiffusionPlanner(topology, channel, auction, epsilon=epsilon)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = (init_fn or model.init)(gen)
    state = _stack_states(tree_map(lambda x: x.to(dev), params), opt,
                          clients)
    model_bits = agg.model_bits(state.params)
    auction.model_bits = model_bits
    ledger = ResourceLedger()
    history = []

    for t in range(rounds):
        t0 = time.time()
        pos, up_gamma = static_round_draws(topology, channel, rng, clients)
        ctx = RoundContext(cfg=fl_cfg, t=t, dsi=part.dsi,
                           data_sizes=part.data_sizes, pos=pos, rng=rng,
                           up_gamma=up_gamma, topology=topology,
                           channel=channel, planner=planner,
                           model_bits=model_bits, param_template=None)
        schedule = schedule_feddif(ctx)
        charge_schedule(ledger, schedule)

        metrics = {"loss": torch.zeros((clients,), device=dev)}
        for op in schedule.ops:
            if isinstance(op, TrainOp):          # the initial fleet update
                state, metrics = fleet_step(state, fleet_batch())
            elif isinstance(op, PermuteOp):      # one diffusion round
                state, metrics = diff_step(
                    state, fleet_batch(),
                    torch.as_tensor(np.asarray(op.src_of_dst),
                                    dtype=torch.int64, device=dev),
                    torch.as_tensor(np.asarray(op.train_mask), device=dev),
                    None)
        # Eq.-11 aggregation and broadcast, chain-data-size weighted.
        weights = torch.as_tensor(np.asarray(schedule.slot_weights(),
                                             np.float32), device=dev)
        state = TrainState(params=fleet_aggregate(state.params, weights),
                           opt_state=state.opt_state, step=state.step)
        loss = float(torch.mean(metrics["loss"]))
        history.append(loss)
        log(f"round {t + 1}: diffusion_rounds={schedule.diffusion_rounds} "
            f"mean_client_loss={loss:.4f} "
            f"final_iid={schedule.mean_iid:.4f} "
            f"subframes={ledger.subframes} "
            f"({time.time() - t0:.1f}s)")
    return state, history, ledger


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.fl_spmd")
    ap.add_argument("--arch", choices=ARCH_IDS, default="smollm_360m")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--shard-clients", action="store_true",
                    help="shard the client axis over a mesh (ROADMAP A12: "
                         "not ported, raises)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    _, hist, _ = run_spmd_feddif(args.arch, args.clients, args.rounds,
                                 args.alpha, args.seq_len, args.batch,
                                 shard_clients=args.shard_clients,
                                 device=args.device)
    print("loss history:", [round(h, 3) for h in hist])


if __name__ == "__main__":
    main()
