"""Spectral-efficiency, bandwidth and sub-frame accounting — Eqs. (14),
(15), (39) and the evaluation metrics of Sec. VI.

Counterpart of the numpy half of ``repro.channels.resources``, including
:class:`ResourceLedger` (5G numerology 0: 1 ms sub-frames, 180 kHz PRBs; a
model of S bits at spectral efficiency γ over bandwidth B occupies
``ceil(S / (γ·B·T_sf))`` sub-frames).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["spectral_efficiency", "required_bandwidth", "outage_probability",
           "spectral_efficiency_f32", "spectral_efficiency_t", "required_bandwidth_t",
           "outage_probability_t", "ResourceLedger", "GAMMA_FLOOR",
           "TX_POWER_W", "PRB_HZ"]

SUBFRAME_S = 1e-3          # 1 ms
PRB_HZ = 180e3             # physical resource block bandwidth
GAMMA_FLOOR = 0.05         # feasibility floor applied before ledger charging
TX_POWER_W = 10 ** ((23.0 - 30.0) / 10.0)  # 23 dBm UE Tx power (3GPP)


def spectral_efficiency(snr: np.ndarray) -> np.ndarray:
    """Eq. (14): γ = log2(1 + SNR)  [bit/s/Hz]."""
    return np.log2(1.0 + snr)


def spectral_efficiency_f32(snr: np.ndarray) -> np.ndarray:
    """Eq. (14) on float32 SNRs as the reference's eager
    ``spectral_efficiency_jax`` computes it: ``1 + SNR`` rounded, then
    XLA-CPU's ``log2``, ``log(x)·fp32(1/ln 2)``."""
    from repro_torch.core.dol import xla_log
    x = np.float32(1.0) + np.asarray(snr, np.float32)
    return xla_log(x) * np.float32(1.0 / np.log(2.0))


def required_bandwidth(model_bits: float, gamma: np.ndarray) -> np.ndarray:
    """Eq. (15)/(37): B = S / γ in Hz·s; infeasible links (γ→0) cost ∞."""
    g = np.asarray(gamma, dtype=np.float64)
    with np.errstate(divide="ignore"):
        return np.where(g > 1e-9, model_bits / g, np.inf)


def outage_probability(gamma_min: np.ndarray | float, snr: np.ndarray
                       ) -> np.ndarray:
    """Eq. (39): Rayleigh outage ``1 − exp(−(2^γ_min − 1)/SNR̄)`` for the
    mean (large-scale only) SNR of the link."""
    thr = 2.0 ** np.asarray(gamma_min, np.float64) - 1.0
    snr = np.maximum(np.asarray(snr, np.float64), 1e-12)
    return 1.0 - np.exp(-thr / snr)


# ------------------------------------------------------------ tensor twins
#
# The device planner's float32 forms: the reference's jnp twins
# (``spectral_efficiency_jax`` …), whose arithmetic they copy as it is.  The
# numpy versions above stay the ledger's float64 oracle.


def spectral_efficiency_t(snr: torch.Tensor) -> torch.Tensor:
    """Eq. (14) on tensors: γ = log2(1 + SNR)."""
    return torch.log2(1.0 + snr)


def required_bandwidth_t(model_bits: torch.Tensor | float,
                         gamma: torch.Tensor) -> torch.Tensor:
    """Eq. (15)/(37) on tensors: B = S / γ, ∞ on dead links."""
    return torch.where(gamma > 1e-9,
                       model_bits / torch.clamp(gamma, min=1e-9),
                       torch.inf)


def outage_probability_t(gamma_min: torch.Tensor, snr: torch.Tensor
                         ) -> torch.Tensor:
    """Eq. (39) on tensors, float32 ``-expm1(-(2^γ_min − 1)/SNR̄)`` as the
    reference's jnp twin computes it (it drifts from the float64 numpy
    form by more than 1e-6; the planner is held to the jnp arithmetic)."""
    thr = torch.pow(2.0, gamma_min) - 1.0
    return -torch.expm1(-thr / torch.clamp(snr, min=1e-12))


@dataclasses.dataclass
class ResourceLedger:
    """Accumulates the paper's Table-II communication-efficiency metrics,
    plus UE transmit energy ``P_tx·S/(γ·B)`` per D2D hop / uplink."""
    subframes: int = 0
    transmitted_models: int = 0
    transmitted_bits: float = 0.0
    bandwidth_hz_s: float = 0.0     # Σ required bandwidth (Eq. 15 units)
    uplink_models: int = 0          # model uploads to the BS (aggregation)
    downlink_models: int = 0        # model broadcasts from the BS
    energy_j: float = 0.0           # Σ UE transmit energy (D2D + uplink)

    def charge_d2d(self, model_bits: float, gamma: float,
                   bandwidth_hz: float = PRB_HZ) -> int:
        """Charge one D2D model transmission; returns sub-frames consumed."""
        if not np.isfinite(gamma) or gamma <= 0:
            raise ValueError("cannot transmit over a zero-rate link")
        rate = gamma * bandwidth_hz                  # bit/s
        sf = int(np.ceil(model_bits / (rate * SUBFRAME_S)))
        self.subframes += sf
        self.transmitted_models += 1
        self.transmitted_bits += model_bits
        self.bandwidth_hz_s += model_bits / gamma
        self.energy_j += TX_POWER_W * model_bits / (gamma * bandwidth_hz)
        return sf

    def charge_uplink(self, model_bits: float, gamma: float,
                      bandwidth_hz: float = PRB_HZ) -> int:
        rate = max(gamma, 1e-9) * bandwidth_hz
        sf = int(np.ceil(model_bits / (rate * SUBFRAME_S)))
        self.subframes += sf
        self.uplink_models += 1
        self.transmitted_models += 1
        self.transmitted_bits += model_bits
        self.energy_j += TX_POWER_W * model_bits / rate
        return sf

    def charge_downlink(self, model_bits: float, gamma: float, n_users: int,
                        bandwidth_hz: float = PRB_HZ) -> int:
        """Broadcast costs one transmission regardless of n_users (PDSCH)."""
        rate = max(gamma, 1e-9) * bandwidth_hz
        sf = int(np.ceil(model_bits / (rate * SUBFRAME_S)))
        self.subframes += sf
        self.downlink_models += 1
        return sf

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)
