"""Per-client data pipeline: shuffled epoch iterators with a cyclic pad,
and the LM trainer's infinite (tokens, labels) stream.

Counterpart of ``repro.data.pipeline`` (host numpy, the same batches for
the same seed).  Batches are numpy dicts; the executors and trainers move
them to the device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from repro_torch.data.partitioner import ClientPartition
from repro_torch.data.synthetic import ImageDataset

__all__ = ["ClientLoader", "make_client_loaders", "lm_batches"]


@dataclasses.dataclass
class ClientLoader:
    x: np.ndarray
    y: np.ndarray
    batch_size: int
    seed: int
    _epoch: int = 0

    @property
    def epochs_drawn(self) -> int:
        """Epoch ``k`` shuffles with ``default_rng(seed + k)``; this is k.
        The stream is a counter, so a resumed run that :meth:`seek`-s back
        to a checkpointed position replays the same batch order."""
        return self._epoch

    def seek(self, epochs_drawn: int) -> None:
        """Reposition the shuffle stream (a resumed run restores the
        cursors :attr:`epochs_drawn` read at the checkpointed round)."""
        self._epoch = int(epochs_drawn)

    def num_batches(self) -> int:
        if not len(self.y):
            return 0
        return max(1, len(self.y) // self.batch_size)

    def epoch(self) -> Iterator[dict]:
        if not len(self.y):      # empty shard: no local session this client
            return
        rng = np.random.default_rng(self.seed + self._epoch)
        self._epoch += 1
        perm = rng.permutation(len(self.y))
        for i in range(self.num_batches()):
            idx = perm[i * self.batch_size:(i + 1) * self.batch_size]
            if len(idx) < self.batch_size:
                # Cyclic wrap-around pad: every batch has batch_size rows,
                # as the stacked executor needs rectangular steps.
                pad = np.resize(perm, self.batch_size - len(idx))
                idx = np.concatenate([idx, pad])
            yield {"x": self.x[idx], "y": self.y[idx]}

    def one_batch(self) -> dict:
        """The first batch of the next epoch (draws that epoch)."""
        if not len(self.y):
            raise ValueError("client shard is empty — no batch to draw")
        return next(self.epoch())


def make_client_loaders(ds: ImageDataset, part: ClientPartition,
                        batch_size: int, seed: int = 0) -> list[ClientLoader]:
    return [ClientLoader(ds.x[ix], ds.y[ix], batch_size, seed + 1000 * i)
            for i, ix in enumerate(part.indices)]


def lm_batches(tokens: np.ndarray, batch: int, seq_len: int, seed: int = 0
               ) -> Iterator[dict]:
    """Infinite iterator of (tokens, labels) LM batches: ``batch`` windows
    of ``seq_len`` tokens at uniform starts, labels the next-token shift,
    both int32."""
    rng = np.random.default_rng(seed)
    n = len(tokens) - seq_len - 1
    while True:
        starts = rng.integers(0, n, size=batch)
        xs = np.stack([tokens[s:s + seq_len] for s in starts])
        ys = np.stack([tokens[s + 1:s + seq_len + 1] for s in starts])
        yield {"tokens": xs.astype(np.int32), "labels": ys.astype(np.int32)}
