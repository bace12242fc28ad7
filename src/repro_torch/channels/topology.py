"""Cell topology: PUE placement and CUE arrivals (Sec. VI-A).

Counterpart of the numpy half of ``repro.channels.topology``: users are
placed uniformly at random in a circular cell of radius 250 m each
communication round; cellular (non-participating) UEs arrive by a Poisson
point process and load the uplink band (constraint 18f) or, in the
underlay mode, interfere with the D2D links.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["CellTopology"]


@dataclasses.dataclass
class CellTopology:
    """Uniform-disc user placement + PPP background traffic."""
    radius_m: float = 250.0
    num_pues: int = 10
    cue_rate: float = 5.0          # mean CUEs per round (PPP intensity)
    cue_bandwidth_hz: float = 180e3  # one PRB per CUE, 3GPP numerology 0

    def sample_positions(self, rng: np.random.Generator, n: int | None = None
                         ) -> np.ndarray:
        """(n, 2) uniform positions on the disc (inverse-CDF radius)."""
        n = self.num_pues if n is None else n
        r = self.radius_m * np.sqrt(rng.uniform(size=n))
        theta = rng.uniform(0.0, 2 * np.pi, size=n)
        return self.positions_from_polar(r, theta)

    @staticmethod
    def positions_from_polar(r, theta):
        """(r, θ) → (n, 2) Cartesian positions."""
        return np.stack([r * np.cos(theta), r * np.sin(theta)], axis=-1)

    def pairwise_distances(self, pos: np.ndarray) -> np.ndarray:
        """(n, n) Euclidean distance matrix with a safe diagonal."""
        diff = pos[:, None, :] - pos[None, :, :]
        d = np.linalg.norm(diff, axis=-1)
        np.fill_diagonal(d, 1.0)  # self-links never used; avoid log(0)
        return d

    @staticmethod
    def pairwise_distances_f32(pos: np.ndarray) -> np.ndarray:
        """(n, n) float32 distances with a unit diagonal, in the bits of the
        reference's eager ``pairwise_distances_jax``: XLA-CPU's
        ``jnp.linalg.norm`` over the coordinate pair (``sqrt(fma(y, y,
        x²))``, the root correctly rounded)."""
        from repro_torch.core.dol import _sum_squares
        pos = np.asarray(pos, np.float32)
        d = np.sqrt(_sum_squares(pos[:, None, :] - pos[None, :, :]))
        np.fill_diagonal(d, np.float32(1.0))
        return d

    def sample_cue_load(self, rng: np.random.Generator) -> float:
        """Bandwidth (Hz) consumed by background CUEs this round (Σ B̃ in
        18f): one Poisson draw of the CUE count."""
        n_cues = rng.poisson(self.cue_rate)
        return float(n_cues) * self.cue_bandwidth_hz
