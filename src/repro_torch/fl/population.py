"""Client population sampling: cohorts drawn from 10^5–10^6 simulated users.

Counterpart of ``repro.fl.population``, bit for bit.  The sync planes treat
``FLConfig.num_clients`` as the world size.  The buffered-async plane's
front end (``AsyncSpec.population > 0``) draws each tick's cohort of
``num_clients`` users from a large population instead:

* each of ``size`` users has a persistent availability weight
  (Beta(``avail_alpha``, ``avail_beta``)) and a persistent mean-1
  lognormal compute speed (``speed_sigma``), drawn once from the
  ``default_rng([seed, 0x9E])`` stream;
* :meth:`Population.sample_cohort` draws tick ``t``'s cohort of ``k``
  users without replacement, availability-weighted, by the
  Efraimidis–Spirakis exponential keys on ``default_rng([seed, t, 0xA7])``,
  so a resumed run redraws the same cohorts with no stored position;
* a user's data shard is ``user % num_shards``: the Dirichlet partition
  stays the world of distinct data distributions.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Population", "CohortDraw"]

# Stream tags apart from every other [seed, t] consumer (churn uses 0xC4).
_POP_STREAM = 0x9E
_COHORT_STREAM = 0xA7


@dataclasses.dataclass(frozen=True)
class CohortDraw:
    """One tick's cohort: population indices, data shards and speeds."""
    t: int
    users: np.ndarray       # (k,) int64
    shards: np.ndarray      # (k,) int64
    speed: np.ndarray       # (k,) float64, persistent speed ~ 1.0


class Population:
    """A fixed simulated user population with heterogeneous availability."""

    def __init__(self, size: int, num_shards: int, seed: int = 0,
                 avail_alpha: float = 2.0, avail_beta: float = 2.0,
                 speed_sigma: float = 0.5):
        assert size >= num_shards >= 1, (size, num_shards)
        self.size = int(size)
        self.num_shards = int(num_shards)
        self.seed = int(seed)
        rng = np.random.default_rng([self.seed, _POP_STREAM])
        self.availability = np.maximum(
            rng.beta(float(avail_alpha), float(avail_beta), self.size),
            1e-9)
        z = rng.standard_normal(self.size)
        s = float(speed_sigma)
        self.speed = np.exp(s * z - 0.5 * s * s)

    def shard_of(self, users: np.ndarray) -> np.ndarray:
        return np.asarray(users, np.int64) % self.num_shards

    def sample_cohort(self, t: int, k: int) -> CohortDraw:
        """Tick ``t``'s availability-weighted cohort of ``k`` users: each
        user draws the key ``E / w`` and the ``k`` smallest keys win."""
        assert 1 <= k <= self.size, (k, self.size)
        rng = np.random.default_rng([self.seed, int(t), _COHORT_STREAM])
        keys = rng.exponential(size=self.size) / self.availability
        if k == self.size:
            users = np.arange(self.size, dtype=np.int64)
        else:
            part = np.argpartition(keys, k)[:k]
            users = part[np.argsort(keys[part], kind="stable")].astype(
                np.int64)
        return CohortDraw(t=int(t), users=users, shards=self.shard_of(users),
                          speed=self.speed[users])
