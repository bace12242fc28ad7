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
function on the host and :func:`xla_powf_t`, glibc's algorithm as tensor
operations, on a device.  None of these
is correctly rounded:
``jax.random.normal`` differs from ``√2·erfinv(u)`` rounded once in about
two thirds of draws, and ``exponential`` from ``−log1p(−u)`` rounded once
in about one in fourteen.  The fused multiply-adds are emulated in float64,
where the product of two float32 values is exact, and rounded once.

These are control-plane draws: they stay on the host in numpy, as every
other control-plane stream of the port.  The serving sampler's draws run
on the logits' device instead: :func:`split_t`, :func:`random_bits_t`,
:func:`uniform_t`, :func:`gumbel_t` and :func:`categorical_t` are the same
hash and forms as tensor operations, the 32-bit words held in ``int64``.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math

import numpy as np
import torch

from repro_torch.core.dol import _fma, _fma_t, xla_log, xla_log_t

__all__ = ["PRNGKey", "fold_in", "random_bits", "uniform", "normal",
           "exponential", "xla_erf_inv", "xla_log1p", "xla_exp",
           "xla_exp_t", "xla_powf", "xla_powf_t", "threefry2x32_t", "split_t",
           "random_bits_t", "uniform_t", "gumbel_t", "categorical_t"]

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
_TINY = float(np.finfo(np.float32).tiny)
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


def xla_exp_t(x: torch.Tensor) -> torch.Tensor:
    """Tensor twin of :func:`xla_exp` on the tensor's device, with XLA's
    flush of subnormal results to 0 (so ``exp(−inf)`` is 0, as a masked
    softmax needs); overflow is not handled (x ≤ 88.3)."""
    xf = torch.clamp(x.to(torch.float32), _EXP_LO, _EXP_HI)

    def c(v):
        return xf.new_tensor(float(v))
    fx = torch.clamp(torch.floor(_fma_t(xf, c(_LOG2E), c(0.5))), -127.0,
                     127.0)
    r = _fma_t(c(-_EXP_C2), fx, _fma_t(c(-_EXP_C1), fx, xf))
    p = torch.full_like(r, float(_EXP_P[0]))
    for v in _EXP_P[1:]:
        p = _fma_t(r, p, c(v))
    y = _fma_t(p, r * r, r) + 1.0
    out = y * ((fx.to(torch.int32) + 127) << 23).view(torch.float32)
    return torch.where(out < _TINY, 0.0, out)


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


# glibc's powf (2.28 on; ARM's optimized-routines algorithm), read from the
# C library's own tables: log2(x) from 16 (1/c, log2 c) pairs and a
# degree-5 polynomial, y·log2(x) rounded, exp2 from 32 table entries
# ``asuint64(2^(i/32)) − (i << 47)`` and a degree-3 polynomial, all in
# float64, then one rounding to float32.
_POWF_OFF = 0x3F330000
_POWF_INVC = tuple(float.fromhex(v) for v in (
    "0x1.661ec79f8f3bep+0", "0x1.571ed4aaf883dp+0", "0x1.49539f0f010bp+0",
    "0x1.3c995b0b80385p+0", "0x1.30d190c8864a5p+0", "0x1.25e227b0b8eap+0",
    "0x1.1bb4a4a1a343fp+0", "0x1.12358f08ae5bap+0", "0x1.0953f419900a7p+0",
    "0x1p+0", "0x1.e608cfd9a47acp-1", "0x1.ca4b31f026aap-1",
    "0x1.b2036576afce6p-1", "0x1.9c2d163a1aa2dp-1", "0x1.886e6037841edp-1",
    "0x1.767dcf5534862p-1"))
_POWF_LOGC = tuple(float.fromhex(v) for v in (
    "-0x1.efec65b963019p-2", "-0x1.b0b6832d4fca4p-2", "-0x1.7418b0a1fb77bp-2",
    "-0x1.39de91a6dcf7bp-2", "-0x1.01d9bf3f2b631p-2", "-0x1.97c1d1b3b7afp-3",
    "-0x1.2f9e393af3c9fp-3", "-0x1.960cbbf788d5cp-4", "-0x1.a6f9db6475fcep-5",
    "0x0p+0", "0x1.338ca9f24f53dp-4", "0x1.476a9543891bap-3",
    "0x1.e840b4ac4e4d2p-3", "0x1.40645f0c6651cp-2", "0x1.88e9c2c1b9ff8p-2",
    "0x1.ce0a44eb17bccp-2"))
_POWF_LOG2_POLY = tuple(float.fromhex(v) for v in (
    "0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2", "0x1.ec70a6ca7baddp-2",
    "-0x1.7154748bef6c8p-1", "0x1.71547652ab82bp+0"))
_EXP2F_POLY = tuple(float.fromhex(v) for v in (
    "0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3", "0x1.62e42ff0c52d6p-1"))
_EXP2F_TAB = tuple(int(v, 16) for v in (
    "3ff0000000000000", "3fefd9b0d3158574", "3fefb5586cf9890f",
    "3fef9301d0125b51", "3fef72b83c7d517b", "3fef54873168b9aa",
    "3fef387a6e756238", "3fef1e9df51fdee1", "3fef06fe0a31b715",
    "3feef1a7373aa9cb", "3feedea64c123422", "3feece086061892d",
    "3feebfdad5362a27", "3feeb42b569d4f82", "3feeab07dd485429",
    "3feea47eb03a5585", "3feea09e667f3bcd", "3fee9f75e8ec5f74",
    "3feea11473eb0187", "3feea589994cce13", "3feeace5422aa0db",
    "3feeb737b0cdc5e5", "3feec49182a3f090", "3feed503b23e255d",
    "3feee89f995ad3ad", "3feeff76f2fb5e47", "3fef199bdd85529c",
    "3fef3720dcef9069", "3fef5818dcfba487", "3fef7c97337b9b5f",
    "3fefa4afa2a490da", "3fefd0765b6e4540"))
_EXP2F_SHIFT = float.fromhex("0x1.8p+47")         # 0x1.8p52 / 32
_POWF_OFLOW = float.fromhex("0x1.fffffffd1d571p+6")
_VELTKAMP = 134217729.0                             # 2^27 + 1


def _f64_bits(v: float) -> int:
    return int(np.array(v, np.float64).view(np.int64))


def _split64(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    c = x * _VELTKAMP
    hi = c - (c - x)
    return hi, x - hi


def _two_sum64(a: torch.Tensor, b: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _fma64(a, b, c) -> torch.Tensor:
    """float64 ``fma(a, b, c)`` from separately rounded operations: the
    exact product (Dekker), the exact sum with ``c`` (Knuth), its tail
    rounded to odd, then one rounding to nearest (Boldo and Melquiond's
    emulation, exact without underflow).  Each eager op rounds on its own
    on both the CPU and the card, so the bits are the same on both."""
    a, b, c = torch.broadcast_tensors(a, b, c)
    p = a * b
    ah, al = _split64(a)
    bh, bl = _split64(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s, t = _two_sum64(c, p)
    v, w = _two_sum64(t, e)
    bits = v.view(torch.int64)
    away = torch.where((w > 0) == (v > 0), 1, -1)
    v = torch.where((w != 0) & ((bits & 1) == 0), (bits + away).view(
        torch.float64), v)
    return s + v


def xla_powf_t(base, y) -> torch.Tensor:
    """Tensor twin of :func:`xla_powf` on the inputs' device: glibc's
    ``powf`` for a positive finite ``base`` and a finite ``y``, in the bits
    of its x86-64 FMA build, whose compiler contracts each ``a·b + c`` of
    the two polynomials and of ``z·(1/c) − 1`` into a fused multiply-add
    (:func:`_fma64`) and rounds ``y·log2(x)``, which feeds a bit test too.
    A result past float32's range is ``inf``, one under 2^-150 is 0, as
    glibc's."""
    y = torch.as_tensor(y, dtype=torch.float32)
    base = torch.as_tensor(base, dtype=torch.float32, device=y.device)
    base, y = torch.broadcast_tensors(base, y)
    f64 = torch.float64
    dev = y.device
    ix = base.view(torch.int32).to(torch.int64)
    sub = ix < 0x00800000                               # subnormal base
    ix = torch.where(sub, (base * 2.0 ** 23).view(torch.int32).to(
        torch.int64) - (23 << 23), ix)
    tmp = ix - _POWF_OFF
    i = (tmp >> 19) & 15
    top = tmp & 0xFF800000
    z = ((ix - top) & 0xFFFFFFFF).to(torch.int32).view(torch.float32).to(f64)
    k = ((top ^ 0x80000000) - 0x80000000) >> 23
    invc = torch.tensor(_POWF_INVC, dtype=f64, device=dev)[i]
    logc = torch.tensor(_POWF_LOGC, dtype=f64, device=dev)[i]
    r = _fma64(z, invc, torch.tensor(-1.0, dtype=f64, device=dev))
    a = [torch.tensor(v, dtype=f64, device=dev) for v in _POWF_LOG2_POLY]
    r2 = r * r
    q = _fma64(_fma64(a[2], r, a[3]), r2, _fma64(a[4], r, logc + k.to(f64)))
    logx = _fma64(_fma64(a[0], r, a[1]), r2 * r2, q)
    ylogx = y.to(f64) * logx
    kd = ylogx + _EXP2F_SHIFT
    ki = kd.view(torch.int64) - _f64_bits(_EXP2F_SHIFT)   # round(32·ylogx)
    r = ylogx - (kd - _EXP2F_SHIFT)
    tab = torch.tensor(_EXP2F_TAB, dtype=torch.int64, device=dev)
    s = (tab[ki & 31] + ki * (1 << 47)).view(f64)
    c = [torch.tensor(v, dtype=f64, device=dev) for v in _EXP2F_POLY]
    p = _fma64(_fma64(c[0], r, c[1]), r * r,
               _fma64(c[2], r, torch.tensor(1.0, dtype=f64, device=dev)))
    out = (p * s).to(torch.float32)
    out = torch.where(ylogx > _POWF_OFLOW, torch.inf, out)
    return torch.where(ylogx <= -150.0, 0.0, out)


# --------------------------------------------------- tensor forms (sampler)

_M32 = 0xFFFFFFFF


def _rotl_t(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _M32


def threefry2x32_t(k1, k2, x1: torch.Tensor, x2: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`threefry2x32` on ``int64`` tensors holding 32-bit words; the
    key words may be 0-d tensors or ints.  Runs on the tensors' device."""
    ks = (k1, k2, k1 ^ k2 ^ int(_KS_PARITY))
    x = [(x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = _rotl_t(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x[0], x[1]


def split_t(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` (the partitionable form) of a (2,)
    ``int64`` key tensor: row i is the hash of the count pair ``(0, i)``."""
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32_t(key[0], key[1], torch.zeros_like(lo), lo)
    return torch.stack([b1, b2], dim=1)


def random_bits_t(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """:func:`random_bits` on the key's device, as ``int64`` words."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32_t(key[0], key[1], idx >> 32, idx & _M32)
    return (b1 ^ b2).reshape(shape)


def uniform_t(key: torch.Tensor, shape: tuple, minval=0.0, maxval=1.0
              ) -> torch.Tensor:
    """:func:`uniform` on the key's device."""
    lo, hi = _F32(minval), _F32(maxval)
    bits = (random_bits_t(key, shape) >> 9) | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    out = _fma_t(f, f.new_tensor(float(hi - lo)), f.new_tensor(float(lo)))
    return torch.clamp(out, min=float(lo))



def gumbel_t(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` in float32, mode ``"low"``:
    ``−log(−log(u))`` with ``u`` uniform in ``[tiny, 1)`` and XLA-CPU's
    float32 log (:func:`repro_torch.core.dol.xla_log_t`)."""
    return -xla_log_t(-xla_log_t(uniform_t(key, shape, _TINY, 1.0)))


def categorical_t(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` (``replace=True``):
    the Gumbel-max draw ``argmax(gumbel + logits)`` over the last axis."""
    logits = logits.to(torch.float32)
    return torch.argmax(gumbel_t(key, tuple(logits.shape)) + logits, dim=-1)
