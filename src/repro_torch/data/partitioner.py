"""Dirichlet non-IID partitioner (Sec. VI-A; Hsu et al. 2019).

Counterpart of ``repro.data.partitioner``: the same numpy draws in the same
order, so a seed gives the same shards, DSIs and data sizes.  Each client
draws a class mixture ``q_i ~ Dir(α·1_C)`` and samples the class pools
accordingly; ``α → ∞`` recovers IID.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["ClientPartition", "dirichlet_partition"]


@dataclasses.dataclass
class ClientPartition:
    indices: list[np.ndarray]          # per-client sample indices
    dsi: np.ndarray                    # (N, C) data-state information
    data_sizes: np.ndarray             # (N,)
    alpha: float


def dirichlet_partition(labels: np.ndarray, num_clients: int, alpha: float,
                        rng: np.random.Generator,
                        min_per_client: int = 8) -> ClientPartition:
    labels = np.asarray(labels)
    classes = np.unique(labels)
    c = len(classes)
    pools = {cl: rng.permutation(np.where(labels == cl)[0]).tolist()
             for cl in classes}
    base = len(labels) // num_clients

    # Target per-client class mixtures and (client, class) sample counts.
    mix = rng.dirichlet(np.full(c, alpha), size=num_clients)
    want = np.maximum(np.floor(mix * base).astype(int), 0)

    indices: list[list[int]] = [[] for _ in range(num_clients)]
    for j, cl in enumerate(classes):
        pool = pools[cl]
        w = want[:, j].astype(float)
        if w.sum() == 0:
            continue
        alloc = np.floor(w / w.sum() * min(len(pool), int(w.sum()))).astype(int)
        pos = 0
        for i in range(num_clients):
            take = min(alloc[i], len(pool) - pos)
            indices[i].extend(pool[pos:pos + take])
            pos += take

    # Ensure a minimum shard size (the paper's PUEs always hold data).
    leftovers = [idx for pool in pools.values() for idx in pool]
    used = set(i for sub in indices for i in sub)
    leftovers = [i for i in leftovers if i not in used]
    rng.shuffle(leftovers)
    for i in range(num_clients):
        while len(indices[i]) < min_per_client and leftovers:
            indices[i].append(leftovers.pop())

    idx_arrays = [np.asarray(sorted(ix), np.int64) for ix in indices]
    dsi = np.zeros((num_clients, c), np.float32)
    for i, ix in enumerate(idx_arrays):
        if len(ix):
            cnt = np.bincount(
                np.searchsorted(classes, labels[ix]), minlength=c)
            dsi[i] = cnt / max(cnt.sum(), 1)
    sizes = np.asarray([len(ix) for ix in idx_arrays], np.float64)
    return ClientPartition(indices=idx_arrays, dsi=dsi, data_sizes=sizes,
                           alpha=alpha)
