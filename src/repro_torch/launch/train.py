"""End-to-end FL-LM training entry point of the port.

Trains a zoo LM with FedDif (or FedAvg, FedSwap, STC) over Dirichlet
non-IID client shards of a synthetic corpus, charging communication to the
wireless ledger, and checkpoints the global model:

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_360m \\
        --smoke --rounds 8 --clients 4 --steps-per-round 8
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu

Counterpart of ``repro.launch.train``, with its flags and its lines of
output (the model line, one line a round, the ledger line) plus
``--device``: the CUDA device by default, ``cpu`` on request, never a
fallback.  The numpy stream is drawn in the reference's order: the corpus,
the partition, then each client's ``rng.choice`` of documents when the
server asks for its batches, so both packages train on the same batches.
The local solver is the FL client's (``fl/client.py``: SGD, momentum 0.9,
clip 10) through ``torch.func.grad_and_value`` of ``model.loss`` without
remat, as the reference's; on the card its gradients run through the
zoo's backward kernels.  ``--ckpt-dir`` writes the global params in the
reference's checkpoint format (``train/checkpoint.py``).
:func:`run_train` is the same run as a function, with an optional
``init_fn`` (a ``torch.Generator`` → params; the zoo's init by default).
"""
from __future__ import annotations

import argparse
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data.partitioner import dirichlet_partition
from repro_torch.data.synthetic import class_labels_for_lm, lm_corpus
from repro_torch.device import resolve_device
from repro_torch.fl.engine import RunResult
from repro_torch.fl.server import FLConfig, run_federated
from repro_torch.models.zoo import build_model
from repro_torch.train import save_checkpoint

__all__ = ["run_train", "main", "STRATEGIES"]

STRATEGIES = ["feddif", "fedavg", "fedswap", "stc"]


def run_train(arch: str = "smollm_360m", smoke: bool = False,
              strategy: str = "feddif", rounds: int = 8, clients: int = 4,
              steps_per_round: int = 8, seq_len: int = 128, batch: int = 8,
              alpha: float = 0.5, lr: float = 0.01, engine: str | None = None,
              ckpt_dir: str | None = None, seed: int = 0,
              device: str | torch.device | None = None,
              init_fn: Callable | None = None, log=print) -> RunResult:
    """One training run; returns :func:`run_federated`'s result."""
    if strategy not in STRATEGIES:
        raise ValueError(f"strategy {strategy!r}: expected one of "
                         f"{STRATEGIES}")
    dev = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if cfg.frontend is not None:
        raise SystemExit(f"{arch} needs frontend embeddings; use a text "
                         f"arch here.")
    model = build_model(cfg)
    log(f"arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M "
        f"(config geometry)")

    # --- data: synthetic corpus, Dirichlet-partitioned by pseudo-class ---
    rng = np.random.default_rng(seed)
    corpus = lm_corpus(400_000, vocab=cfg.vocab_size, seed=seed)
    n_docs = len(corpus) // seq_len
    docs = corpus[:n_docs * seq_len].reshape(n_docs, seq_len)
    labels = class_labels_for_lm(corpus, 10, seq_len)
    held = docs[: max(8, batch)]
    docs, labels = docs[len(held):], labels[len(held):]
    part = dirichlet_partition(labels, clients, alpha, rng)
    want = steps_per_round * batch

    def client_epoch(i):
        ix = part.indices[i]

        def gen():
            sel = rng.choice(ix, size=min(len(ix), want),
                             replace=len(ix) < want)
            out = []
            for s in range(0, len(sel), batch):
                chunk = docs[sel[s:s + batch]]
                if len(chunk) < batch:
                    break
                out.append({"tokens": chunk[:, :-1], "labels": chunk[:, 1:]})
            return out
        return gen

    batches = [client_epoch(i) for i in range(clients)]
    eval_batch = {"tokens": torch.from_numpy(held[:, :-1]).to(dev),
                  "labels": torch.from_numpy(held[:, 1:]).to(dev)}

    def eval_fn(params):
        with torch.no_grad():
            loss = float(model.loss(params, eval_batch, remat=False))
        return float(np.exp(-loss)), loss   # "accuracy" = exp(-loss) proxy

    def loss_fn(params, b):
        return model.loss(params, b, remat=False)

    fl = FLConfig(strategy=strategy, num_clients=clients,
                  num_models=clients, rounds=rounds, lr=lr, seed=seed,
                  engine=engine)
    t0 = time.time()
    result = run_federated(init_fn or model.init, loss_fn, batches,
                           part.dsi, part.data_sizes, eval_fn, fl,
                           device=dev)
    for i, loss in enumerate(result.loss):
        log(f"round {i+1}: eval_loss={loss:.4f} "
            f"dif_rounds={result.diffusion_rounds[i]}")
    ledger = result.ledger
    log(f"ledger: subframes={ledger.subframes} "
        f"models={ledger.transmitted_models} "
        f"bits={ledger.transmitted_bits:.3e} ({time.time()-t0:.0f}s)")
    if ckpt_dir:
        save_checkpoint(ckpt_dir, rounds, result.final_params,
                        {"arch": cfg.name, "strategy": strategy,
                         "loss_history": result.loss})
        log(f"global model checkpointed to {ckpt_dir}")
    return result


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", choices=ARCH_IDS, default="smollm_360m")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config")
    ap.add_argument("--strategy", default="feddif", choices=STRATEGIES)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--steps-per-round", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--engine", default=None,
                    help="EngineSpec preset (host/fleet/auto/async/"
                         "async_barrier); default: the host loop")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    run_train(args.arch, args.smoke, args.strategy, args.rounds,
              args.clients, args.steps_per_round, args.seq_len, args.batch,
              args.alpha, args.lr, args.engine, args.ckpt_dir, args.seed,
              args.device)


if __name__ == "__main__":
    main()
