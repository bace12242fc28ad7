"""Synthetic image dataset standing in for CIFAR-10 / FMNIST.

Counterpart of ``repro.data.synthetic`` (numpy, identical draws for the
same seed): a C-class mixture of anisotropic Gaussians in a flattened
"image" space, passed through a shared random nonlinear warp so a linear
probe cannot fully solve it; and the ``lm`` task's token corpus with the
pseudo-classes that drive its Dirichlet partition.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["ImageDataset", "gaussian_image_dataset", "lm_corpus",
           "class_labels_for_lm"]


@dataclasses.dataclass
class ImageDataset:
    x: np.ndarray           # (N, D) float32
    y: np.ndarray           # (N,) int64
    num_classes: int

    def split(self, frac: float, rng: np.random.Generator):
        n = len(self.y)
        perm = rng.permutation(n)
        k = int(n * frac)
        tr, te = perm[k:], perm[:k]
        return (ImageDataset(self.x[tr], self.y[tr], self.num_classes),
                ImageDataset(self.x[te], self.y[te], self.num_classes))


def gaussian_image_dataset(num_samples: int = 20_000, num_classes: int = 10,
                           dim: int = 64, separation: float = 0.7,
                           noise: float = 1.5,
                           seed: int = 0) -> ImageDataset:
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(num_classes, dim)) * separation
    w1 = rng.normal(size=(dim, dim)) / np.sqrt(dim)
    y = rng.integers(0, num_classes, size=num_samples)
    x = means[y] + rng.normal(size=(num_samples, dim)) * noise
    x = np.tanh(x @ w1) + 0.1 * x
    return ImageDataset(x.astype(np.float32), y.astype(np.int64),
                        num_classes)


def lm_corpus(num_tokens: int = 1_000_000, vocab: int = 256,
              seed: int = 0) -> np.ndarray:
    """Zipf unigrams + planted deterministic bigram transitions."""
    rng = np.random.default_rng(seed)
    probs = 1.0 / np.arange(1, vocab + 1) ** 1.1
    probs /= probs.sum()
    base = rng.choice(vocab, size=num_tokens, p=probs)
    succ = rng.permutation(vocab)          # planted bigram map
    out = base.copy()
    follow = rng.random(num_tokens) < 0.5  # half the stream is predictable
    out[1:][follow[1:]] = succ[out[:-1][follow[1:]]]
    return out.astype(np.int32)


def class_labels_for_lm(tokens: np.ndarray, num_classes: int,
                        seq_len: int) -> np.ndarray:
    """Assign a pseudo-class to each length-``seq_len`` document (dominant
    token bucket) so the Dirichlet partitioner applies to LM data too."""
    n_docs = len(tokens) // seq_len
    docs = tokens[:n_docs * seq_len].reshape(n_docs, seq_len)
    return (docs.mean(axis=1) * num_classes /
            max(tokens.max(), 1)).astype(np.int64) % num_classes
