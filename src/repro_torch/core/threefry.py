"""JAX's default PRNG and the XLA-CPU float32 forms its samplers reach, in numpy.

The reference's buffered-async plane draws each round's delays from
``jax.random`` (``repro.fl.async_plane._arrival_model``): compute jitter
from ``normal`` and Rayleigh powers from ``exponential``, keyed
``fold_in(PRNGKey(seed), t)``.  The arrival times decide the event order
(which contributions a tick aggregates, which hops are parked, the virtual
clock), so the port redraws them bit for bit, without JAX:

* :func:`PRNGKey`, :func:`fold_in` and :func:`random_bits` are the
  ``threefry2x32`` hash of ``jax._src.prng`` on ``uint32`` arrays, with the
  partitionable bit path (``jax_threefry_partitionable=True``): the counts
  are the 64-bit iota split into high and low words, and 32-bit draws are
  the xor of the hash's two outputs;
* :func:`uniform` puts 23 random mantissa bits under exponent 0, subtracts
  1 and scales, ``max(lo, f·(hi − lo) + lo)`` with the scale contracted to
  one fused multiply-add, as XLA compiles ``_uniform``;
* :func:`normal` is ``√2·erf_inv(u)`` on ``u`` uniform in ``(−1, 1)``.
  XLA expands ``erf_inv`` into Giles' single-precision polynomial:
  ``w = −log1p(−u²)``, then ``w − 2.5`` or ``√w − 3`` and a degree-8 Horner
  step ``p = fma(p, w, c)`` per coefficient, times ``u``
  (:func:`xla_erf_inv`);
* :func:`exponential` is ``−log1p(−u)`` on ``u`` uniform in ``[0, 1)``.

XLA-CPU's ``log1p`` (:func:`xla_log1p`) is the Cephes rational form below
``√2 − 1`` (Horner steps contracted as ``fma(x, p, c)``, then
``(−½x² + x³·P/Q) + x``), and ``core.dol.xla_log(1 + x)`` above it.  Its ``exp`` (:func:`xla_exp`, what
an eager ``jnp.exp`` runs) is the Cephes polynomial with the range
reduction and each Horner step contracted.  Its ``pow`` (:func:`xla_powf`)
is a call to the C library's ``powf``, which is not correctly rounded
either (glibc's differs from the correctly rounded power in about 6 of
10,000 path losses of the cell's range), so the port calls the same
function.  None of these
is correctly rounded:
``jax.random.normal`` differs from ``√2·erfinv(u)`` rounded once in about
two thirds of draws, and ``exponential`` from ``−log1p(−u)`` rounded once
in about one in fourteen.  The fused multiply-adds are emulated in float64,
where the product of two float32 values is exact, and rounded once.

These are control-plane draws: they stay on the host in numpy, as every
other control-plane stream of the port.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools

import numpy as np

from repro_torch.core.dol import _fma, xla_log

__all__ = ["PRNGKey", "fold_in", "random_bits", "uniform", "normal",
           "exponential", "xla_erf_inv", "xla_log1p", "xla_exp",
           "xla_powf"]

_F32 = np.float32
_U32 = np.uint32

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = _U32(0x1BD11BDA)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(k1, k2, x1, x2) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of count words ``x1``, ``x2``
    under the key ``(k1, k2)``; all ``uint32``, broadcast."""
    k1, k2 = _U32(k1), _U32(k2)
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    with np.errstate(over="ignore"):
        x = [np.asarray(x1, _U32) + ks[0], np.asarray(x2, _U32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def PRNGKey(seed: int) -> np.ndarray:                      # noqa: N802
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: ``[0, seed]``."""
    return np.array([0, int(seed) & 0xFFFFFFFF], _U32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: the hash of the count pair
    ``(0, data)`` under ``key``."""
    a, b = threefry2x32(key[0], key[1], np.array([0], _U32),
                        np.array([int(data) & 0xFFFFFFFF], _U32))
    return np.array([a[0], b[0]], _U32)


def random_bits(key: np.ndarray, shape: tuple) -> np.ndarray:
    """32 random bits per entry of ``shape`` (the partitionable path)."""
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(_U32)
    lo = idx.astype(_U32)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return (b1 ^ b2).reshape(shape)


def uniform(key: np.ndarray, shape: tuple, minval=0.0, maxval=1.0
            ) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    lo, hi = _F32(minval), _F32(maxval)
    bits = (random_bits(key, shape) >> _U32(9)) | _U32(0x3F800000)
    f = bits.view(_F32) - _F32(1.0)
    return np.maximum(lo, _fma(f, hi - lo, lo))


# Giles' single-precision erf_inv as XLA expands it: coefficients for
# w < 5 and for w ≥ 5, highest degree first.
_ERFINV_LT5 = tuple(_F32(v) for v in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
    1.50140941))
_ERFINV_GE5 = tuple(_F32(v) for v in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
    2.83297682))

# XLA's log1p below √2 − 1: Cephes' rational form, coefficients in
# Horner order (constant term last).
_LOG1P_SMALL = _F32(0.41421356237309504880)
_LOG1P_NUM = tuple(_F32(v) for v in (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
    6.5787325942061044846969e0, 2.9911919328553073277375e1,
    6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1))
_LOG1P_DEN = tuple(_F32(v) for v in (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
    2.2176239823732856465394e2, 3.0909872225312059774938e2,
    2.1642788614495947685003e2, 6.0118660497603843919306e1))


def _horner(x: np.ndarray, coeffs: tuple) -> np.ndarray:
    p = np.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        p = _fma(x, p, c)
    return p


def xla_log1p(x) -> np.ndarray:
    """float32 ``log1p`` as XLA-CPU computes it (see the module doc)."""
    x = np.asarray(x, _F32)
    big = xla_log(_F32(1.0) + x)
    x2 = x * x
    ratio = _horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)
    small = (_F32(-0.5) * x2 + x2 * x * ratio) + x
    return np.where(np.abs(x) < _LOG1P_SMALL, small, big).astype(_F32)


def xla_erf_inv(x) -> np.ndarray:
    """float32 ``erf_inv`` as XLA expands and compiles it (Giles)."""
    x = np.asarray(x, _F32)
    w = -xla_log1p(-(x * x))
    lt = w < _F32(5.0)
    w2 = np.where(lt, w - _F32(2.5), np.sqrt(w) - _F32(3.0))
    p = np.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).astype(_F32)
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w2, np.where(lt, a, b).astype(_F32))
    out = p * x
    with np.errstate(invalid="ignore"):
        edge = x * _F32(np.inf)
    return np.where(np.abs(x) == _F32(1.0), edge, out).astype(_F32)


_SQRT2 = _F32(np.sqrt(2.0))
_NORMAL_LO = np.nextafter(_F32(-1.0), _F32(0.0))


def normal(key: np.ndarray, shape: tuple) -> np.ndarray:
    """``jax.random.normal(key, shape)`` in float32."""
    return (_SQRT2 * xla_erf_inv(uniform(key, shape, _NORMAL_LO, 1.0))
            ).astype(_F32)


def exponential(key: np.ndarray, shape: tuple) -> np.ndarray:
    """``jax.random.exponential(key, shape)`` in float32."""
    return (-xla_log1p(-uniform(key, shape))).astype(_F32)


# XLA-CPU's float32 exp: Cephes' expf.
_EXP_HI = _F32(88.3762626647950)
_EXP_LO = _F32(-88.3762626647949)
_LOG2E = _F32(1.44269504088896341)
_EXP_C1 = _F32(0.693359375)
_EXP_C2 = _F32(-2.12194440e-4)
_EXP_P = tuple(_F32(v) for v in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
    1.6666665459e-1, 5.0000001201e-1))


def xla_exp(x) -> np.ndarray:
    """float32 ``exp`` as XLA-CPU computes it: ``fx = ⌊fma(x, log2 e,
    ½)⌋`` clamped to ±127, ``r = fma(−C2, fx, fma(−C1, fx, x))``, a Horner
    polynomial in ``r`` with contracted steps, ``fma(p, r², r) + 1``, times
    ``2^fx``.  Bit-equal to ``jnp.exp`` where the result is a normal
    float32 below 2.2e38 (x in about [−87.3, 88.3]); XLA flushes subnormal
    results and overflows to inf beyond that, which this form does not."""
    x = np.clip(np.asarray(x, _F32), _EXP_LO, _EXP_HI)
    fx = np.clip(np.floor(_fma(x, _LOG2E, _F32(0.5))), _F32(-127.0),
                 _F32(127.0)).astype(_F32)
    r = _fma(-_EXP_C2, fx, _fma(-_EXP_C1, fx, x))
    p = _horner(r, _EXP_P)
    y = _fma(p, r * r, r) + _F32(1.0)
    with np.errstate(invalid="ignore"):
        scale = ((fx.astype(np.int32) + 127) << 23).view(_F32)
    return (y * scale).astype(_F32)


@functools.cache
def _libm_powf():
    """The C library's ``powf``, loaded on first use."""
    powf = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6").powf
    powf.restype = ctypes.c_float
    powf.argtypes = [ctypes.c_float, ctypes.c_float]
    return powf


def xla_powf(base, y) -> np.ndarray:
    """float32 ``base ** y`` as XLA-CPU computes it: elementwise calls to
    the C library's ``powf`` (its kernel calls the ``powf`` symbol)."""
    powf = _libm_powf()
    base, y = np.broadcast_arrays(np.asarray(base, _F32), np.asarray(y, _F32))
    out = np.fromiter((powf(float(a), float(b))
                       for a, b in zip(base.ravel(), y.ravel())),
                      dtype=_F32, count=base.size)
    return out.reshape(base.shape)
