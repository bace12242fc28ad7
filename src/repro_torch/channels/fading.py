"""D2D channel model — Eqs. (12)–(14) of the paper.

Counterpart of the numpy half of ``repro.channels.fading``:
``g = sqrt(beta)·h`` with Rayleigh small-scale fading ``h ~ CN(0,1)`` and
log-distance large-scale fading ``beta[dB] = beta0 − 10·kappa·log10(d/d0)``.

The keyed float32 twins (:meth:`ChannelModel.sample_gains_keyed`,
:meth:`ChannelModel.snr_f32`) redraw the reference's ``sample_gains_jax``
and ``snr_jax`` as its buffered-async plane calls them, op by op outside
``jit``: each jnp op is its own XLA program, so nothing contracts across
ops; ``log10`` is XLA-CPU's ``log(x)·fp32(1/ln 10)``, the power ``10^x``
the C library's ``powf``, which XLA-CPU calls, and the Rayleigh powers
are ``jax.random.exponential``'s (:mod:`repro_torch.core.threefry`).
"""
from __future__ import annotations

import dataclasses

import numpy as np

_F32 = np.float32
_INV_LN10 = _F32(1.0 / np.log(10.0))

__all__ = ["ChannelParams", "ChannelModel"]


@dataclasses.dataclass
class ChannelParams:
    beta0_db: float = -30.0        # large-scale pathloss @ reference distance
    d0_m: float = 1.0              # reference distance
    kappa: float = 3.0             # pathloss exponent (urban)
    tx_power_dbm: float = 23.0     # UE max Tx power (3GPP)
    noise_psd_dbm_hz: float = -174.0   # AWGN PSD
    bandwidth_hz: float = 180e3    # per-PRB bandwidth (numerology 0)

    @property
    def tx_power_w(self) -> float:
        return 10 ** ((self.tx_power_dbm - 30.0) / 10.0)

    @property
    def noise_w(self) -> float:
        psd_w = 10 ** ((self.noise_psd_dbm_hz - 30.0) / 10.0)
        return psd_w * self.bandwidth_hz


class ChannelModel:
    """Samples channel gains and SNRs between user pairs."""

    def __init__(self, params: ChannelParams | None = None):
        self.params = params or ChannelParams()

    def large_scale_db(self, dist_m: np.ndarray) -> np.ndarray:
        """Eq. (13): beta in dB as a function of pairwise distance."""
        p = self.params
        return p.beta0_db - 10.0 * p.kappa * np.log10(
            np.maximum(dist_m, p.d0_m) / p.d0_m)

    def sample_gains(self, dist_m: np.ndarray, rng: np.random.Generator
                     ) -> np.ndarray:
        """Eq. (12): |g|² = beta·|h|², h ~ CN(0,1) (Rayleigh power ~Exp(1))."""
        beta = 10 ** (self.large_scale_db(dist_m) / 10.0)
        h2 = rng.exponential(scale=1.0, size=dist_m.shape)
        return beta * h2

    def snr(self, gains_sq: np.ndarray,
            interference: np.ndarray | float = 0.0) -> np.ndarray:
        """|g|² p / (sigma² + I) — Eq. (14) generalized to SINR."""
        p = self.params
        return gains_sq * p.tx_power_w / (p.noise_w + interference)

    # ------------------------------------------- keyed float32 twins

    def large_scale_db_f32(self, dist_m: np.ndarray) -> np.ndarray:
        """Eq. (13) in the float32 ops of the reference's eager
        ``large_scale_db_jax``: ``β₀ − fp32(10κ)·log10(max(d, d₀)/d₀)``."""
        from repro_torch.core.dol import xla_log
        p = self.params
        x = np.maximum(np.asarray(dist_m, _F32), _F32(p.d0_m)) / _F32(p.d0_m)
        log10 = xla_log(x) * _INV_LN10
        return _F32(p.beta0_db) - _F32(10.0 * p.kappa) * log10

    def sample_gains_keyed(self, key: np.ndarray, dist_m: np.ndarray
                           ) -> np.ndarray:
        """Eq. (12) keyed by a threefry ``key``: ``sample_gains_jax``'s
        float32 bits, ``10^(β_dB / 10) · Exp(1)``."""
        from repro_torch.core.threefry import exponential, xla_powf
        ls = self.large_scale_db_f32(dist_m) / _F32(10.0)
        return xla_powf(10.0, ls) * exponential(key, np.shape(dist_m))

    def snr_f32(self, gains_sq: np.ndarray,
                interference: np.ndarray | float = 0.0) -> np.ndarray:
        """:meth:`snr` on float32 gains as the reference's ``snr_jax``
        computes it: ``(g·fp32(p)) / fp32(σ² + I)``, the per-receiver
        interference summed in float64 and rounded once."""
        p = self.params
        den = np.asarray(p.noise_w + interference, np.float64).astype(_F32)
        return (np.asarray(gains_sq, _F32) * _F32(p.tx_power_w)) / den

    def sample_cue_interference(self, rng: np.random.Generator,
                                n_cues: int, cell_radius_m: float = 250.0
                                ) -> float:
        """Aggregate co-channel CUE power at a typical D2D receiver (the
        underlay mode, Appendix C-F): CUEs uniform on the disc, large-scale
        pathloss and a Rayleigh power per interferer."""
        if n_cues <= 0:
            return 0.0
        r = cell_radius_m * np.sqrt(rng.uniform(size=n_cues))
        beta = 10 ** (self.large_scale_db(np.maximum(r, 1.0)) / 10.0)
        h2 = rng.exponential(1.0, size=n_cues)
        return float(np.sum(beta * h2) * self.params.tx_power_w)
