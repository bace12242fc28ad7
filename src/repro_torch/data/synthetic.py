"""Synthetic image dataset standing in for CIFAR-10 / FMNIST.

Counterpart of ``repro.data.synthetic`` (numpy, identical draws for the
same seed): a C-class mixture of anisotropic Gaussians in a flattened
"image" space, passed through a shared random nonlinear warp so a linear
probe cannot fully solve it.  The LM corpus of the reference arrives with
the ``lm`` task.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["ImageDataset", "gaussian_image_dataset"]


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
