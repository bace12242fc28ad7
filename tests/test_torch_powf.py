"""glibc's ``powf`` as tensor operations (``core/threefry.py::xla_powf_t``)
and the mobile device planner's mean SNR built on it (ROADMAP C8).

XLA-CPU computes the reference's ``10.0 ** x`` by calling the C library's
``powf``; the port holds :func:`xla_powf_t` to that very function, called
through ctypes (:func:`xla_powf`), bit for bit:

* on 2^22 draws over the planner's exponents (path losses of 1 to 600 m,
  ``ls/10`` in [−12.1, −2.9]) and 2^20 over float32's whole range of
  powers of ten;
* on dense sweeps of consecutive float32 exponents around the mobile
  cell's path losses at 1, 10, 50, 100, 250 and 500 m;
* on other bases (subnormal, below and above 1) and past float32's range
  (inf and 0, as glibc's);
* and ``core/planner.py::_mean_snr_t`` on 2^18 distances against the
  reference planner's jitted Eq.-(12)–(14) expression, including the
  distances where the correctly rounded power it used before parts from
  glibc's (about 6 in 10,000).

The float64 fused multiply-add the FMA build of ``powf`` contracts to is
emulated from separately rounded operations; it is held to exact rational
arithmetic here.
"""
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.channels.fading import ChannelModel as JChannel
from repro_torch.channels.fading import ChannelModel
from repro_torch.core import planner as pl
from repro_torch.core import threefry as tf


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _assert_bits(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    bad = np.flatnonzero(got.view(np.uint32) != want.view(np.uint32))
    assert bad.size == 0, (bad.size, bad[:5])


def _powf_t(base, y):
    return tf.xla_powf_t(torch.as_tensor(base), torch.from_numpy(
        np.ascontiguousarray(y, np.float32))).numpy()


@pytest.mark.parametrize("lo,hi,n", [(-12.1, -2.9, 1 << 22),
                                     (-44.8, 38.5, 1 << 20)])
def test_powf_t_matches_glibc_on_draws(lo, hi, n):
    y = np.random.default_rng(n).uniform(lo, hi, n).astype(np.float32)
    _assert_bits(_powf_t(10.0, y), tf.xla_powf(10.0, y))


def test_powf_t_matches_glibc_on_dense_sweeps_of_path_losses():
    """2^16 consecutive float32 exponents centred on each distance's
    ``ls/10`` (β₀ = −30 dB, κ = 3, d₀ = 1 m)."""
    for d in (1.0, 10.0, 50.0, 100.0, 250.0, 500.0):
        centre = np.float32((-30.0 - 30.0 * np.log10(d)) / 10.0)
        bits = centre.view(np.int32) + np.arange(-(1 << 15), 1 << 15,
                                                 dtype=np.int32)
        y = bits.view(np.float32)
        _assert_bits(_powf_t(10.0, y), tf.xla_powf(10.0, y))


def test_powf_t_other_bases_and_range_ends():
    rng = np.random.default_rng(3)
    base = np.exp(rng.uniform(-100.0, 85.0, 1 << 16)).astype(np.float32)
    base = np.concatenate([base, np.float32([1e-40, 1.4e-45, 0.5, 1.0, 2.0,
                                             3.4e38])])
    y = rng.uniform(-4.0, 4.0, base.size).astype(np.float32)
    _assert_bits(_powf_t(torch.from_numpy(base), y), tf.xla_powf(base, y))
    edges = np.float32([38.5, 38.6, 39.0, 100.0, -37.9, -38.0, -44.8, -45.2,
                        -46.0, -100.0, 0.0, -0.0, 1e-8])
    got = _powf_t(10.0, edges)
    _assert_bits(got, tf.xla_powf(10.0, edges))
    assert np.isinf(got[2]) and got[-4] == 0.0


def test_fma64_is_exact():
    """The emulated float64 fma against exact rational arithmetic, on
    products near cancellation with the addend and on generic triples."""
    rng = np.random.default_rng(4)
    n = 20000
    a = rng.standard_normal(n) * 2.0 ** rng.integers(-30, 31, n)
    b = rng.standard_normal(n) * 2.0 ** rng.integers(-30, 31, n)
    c = -(a * b) * (1 + rng.standard_normal(n) * 2.0 ** rng.integers(
        -60, 0, n))
    c = np.where(np.arange(n) % 2 == 0, c, rng.standard_normal(n))
    got = tf._fma64(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    want = [float(Fraction(x) * Fraction(y) + Fraction(z))
            for x, y, z in zip(a, b, c)]
    assert np.array_equal(got, np.array(want))


@jax.jit
def _reference_mean_snr(dist, chan):
    # The reference planner's mobile Eqs. 12–14 (src/repro/core/planner.py,
    # the loop body under ``mobility``), as one jitted expression.
    p_over_noise, beta0_db, kappa, d0 = chan[0], chan[1], chan[2], chan[3]
    ls_db = beta0_db - 10.0 * kappa * jnp.log10(jnp.maximum(dist, d0) / d0)
    return 10.0 ** (ls_db / 10.0) * p_over_noise


def test_mean_snr_matches_reference_where_the_exact_power_did_not():
    p = JChannel().params
    chan = jnp.asarray([p.tx_power_w / p.noise_w, p.beta0_db, p.kappa,
                        p.d0_m], jnp.float32)
    dist = np.random.default_rng(5).uniform(0.5, 600.0, 1 << 18).astype(
        np.float32)
    want = np.asarray(_reference_mean_snr(jnp.asarray(dist), chan))
    t_chan = pl._chan_f32(ChannelModel())
    got = pl._mean_snr_t(torch.from_numpy(dist), t_chan).numpy()
    _assert_bits(got, want)
    # The correctly rounded power of the same exponents parts from glibc's
    # in a few inputs in ten thousand: the inputs C8 was about.
    x = torch.clamp(torch.from_numpy(dist), min=t_chan[3]) / t_chan[3]
    k = float(np.float32(np.float32(t_chan[2]) * pl._DB10))
    ls = pl._fma_t(-pl.xla_log_t(x), x.new_tensor(k),
                   x.new_tensor(t_chan[1])) * pl._TENTH
    exact = torch.pow(torch.tensor(10.0, dtype=torch.float64),
                      ls.double()).float().numpy()
    glibc = tf.xla_powf(10.0, ls.numpy())
    parted = exact.view(np.uint32) != glibc.view(np.uint32)
    assert 1e-4 < parted.mean() < 2e-3, parted.mean()
    _assert_bits(_powf_t(10.0, ls.numpy()[parted]), glibc[parted])
