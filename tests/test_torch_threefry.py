"""JAX's PRNG and the async plane's delay draws in the port, against ``jax``.

* ``core.threefry``: ``PRNGKey`` and ``fold_in`` key for key; ``uniform``
  (with ``minval``/``maxval``), ``normal`` and ``exponential`` bit for bit
  against ``jax.random`` over seeds 0–4, t ∈ {0, 1, 7, 1000}, both stream
  tags and n ∈ {1, 4, 8, 16, 20}, and on 2^18 draws of one key;
* XLA-CPU's float32 ``exp`` (eager ``jnp.exp``), ``log1p`` and
  ``erf_inv`` bit for bit, and that the draws are not the correctly
  rounded forms (why the port emulates XLA's);
* the keyed float32 channel twins (distances, Rayleigh gains, SINR, Eq. 14)
  against the reference's eager jnp twins, with no and with per-receiver
  interference;
* the whole ``_arrival_model`` (``train_s``, ``hop_s``, ``uplink_s``) bit
  for bit against ``repro.fl.async_plane._arrival_model`` over the same
  seeds, rounds and sizes, in a static world and with interference.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.channels.fading import ChannelModel as JChannel
from repro.channels.resources import spectral_efficiency_jax
from repro.channels.topology import CellTopology as JTopology
from repro.fl import async_plane as jasync
from repro.fl.engine import AsyncSpec as JAsyncSpec
from repro_torch.channels.fading import ChannelModel
from repro_torch.channels.resources import spectral_efficiency_f32
from repro_torch.channels.topology import CellTopology
from repro_torch.core import threefry as tf
from repro_torch.fl import async_plane as tasync
from repro_torch.fl.engine import AsyncSpec

SEEDS = range(5)
ROUNDS = (0, 1, 7, 1000)
SIZES = (1, 4, 8, 16, 20)


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
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), (
        np.flatnonzero(got.view(np.uint32) != want.view(np.uint32))[:10])


def _keys():
    for seed in SEEDS:
        for t in ROUNDS:
            jk = jax.random.fold_in(jax.random.PRNGKey(seed), t)
            tk = tf.fold_in(tf.PRNGKey(seed), t)
            for tag in (1, 2):
                yield (jax.random.fold_in(jk, tag), tf.fold_in(tk, tag))


def test_prng_key_and_fold_in_match_jax():
    for seed in (*SEEDS, 12345, 2 ** 31 - 1):
        assert np.array_equal(np.asarray(jax.random.PRNGKey(seed)),
                              tf.PRNGKey(seed))
    n = 0
    for jk, tk in _keys():
        assert tk.dtype == np.uint32
        assert np.array_equal(np.asarray(jk), tk)
        n += 1
    assert n == 2 * len(SEEDS) * len(ROUNDS)


def test_random_bits_match_jax():
    for jk, tk in _keys():
        for shape in ((1,), (20,), (4, 5)):
            want = jax.random.bits(jk, shape, jnp.uint32)
            assert np.array_equal(np.asarray(want), tf.random_bits(tk, shape))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (0.0, 2 * np.pi),
                                   (-3.5, 250.0)])
def test_uniform_matches_jax(lo, hi):
    for jk, tk in _keys():
        for n in SIZES:
            _assert_bits(tf.uniform(tk, (n,), lo, hi),
                         jax.random.uniform(jk, (n,), minval=lo, maxval=hi))


@pytest.mark.parametrize("n", SIZES)
def test_normal_matches_jax(n):
    for jk, tk in _keys():
        _assert_bits(tf.normal(tk, (n,)), jax.random.normal(jk, (n,)))


@pytest.mark.parametrize("n", SIZES)
def test_exponential_matches_jax(n):
    for jk, tk in _keys():
        _assert_bits(tf.exponential(tk, (n, n)),
                     jax.random.exponential(jk, (n, n)))


def test_many_draws_match_jax_and_are_not_correctly_rounded():
    """2^18 draws of one key, bit for bit; and the correctly rounded
    ``√2·erfinv(u)`` / ``−log1p(−u)`` differ from them (the reason the
    port emulates XLA's forms)."""
    n = 1 << 18
    jk, tk = jax.random.PRNGKey(2026), tf.PRNGKey(2026)
    z = tf.normal(tk, (n,))
    e = tf.exponential(tk, (n,))
    _assert_bits(z, jax.random.normal(jk, (n,)))
    _assert_bits(e, jax.random.exponential(jk, (n,)))
    u = tf.uniform(tk, (n,), np.nextafter(np.float32(-1), np.float32(0)), 1)
    from scipy.special import erfinv
    exact_z = (math.sqrt(2.0) * erfinv(u.astype(np.float64))).astype(
        np.float32)
    assert (exact_z != z).mean() > 0.3
    exact_e = (-np.log1p(-tf.uniform(tk, (n,)).astype(np.float64))).astype(
        np.float32)
    assert (exact_e != e).mean() > 0.02


def test_xla_float_forms_match_jnp():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(1 << 16) * 20.0).astype(np.float32)
    x = np.clip(x, -87.0, 88.0)
    for n in (1, 3, 8, 17, x.size):
        _assert_bits(tf.xla_exp(x[:n]), jnp.exp(x[:n]))
    v = rng.uniform(-1.0, 1.0, 1 << 16).astype(np.float32)
    v = np.concatenate([v, np.float32([0.0, -0.0, 0.41421354, -0.41421354,
                                       0.5, -0.99999994, 0.99999994])])
    _assert_bits(tf.xla_log1p(v), jnp.log1p(v))
    big = rng.uniform(0.0, 1e4, 1 << 12).astype(np.float32)
    _assert_bits(tf.xla_log1p(big), jnp.log1p(big))
    _assert_bits(tf.xla_erf_inv(v), jax.lax.erf_inv(jnp.asarray(v)))


# ---------------------------------------------------- keyed channel twins

def _positions(rng, n):
    return CellTopology(num_pues=n).sample_positions(rng, n)


def _interference(rng, n):
    return rng.uniform(1e-14, 1e-11, n)


@pytest.mark.parametrize("n", SIZES)
def test_keyed_channel_twins_match_reference(n):
    rng = np.random.default_rng(n)
    pos = _positions(rng, n)
    want_d = JTopology.pairwise_distances_jax(jnp.asarray(pos, jnp.float32))
    dist = CellTopology.pairwise_distances_f32(pos)
    _assert_bits(dist, want_d)
    jch, tch = JChannel(), ChannelModel()
    for jk, tk in list(_keys())[:6]:
        d1 = np.maximum(dist, np.float32(1.0))
        want_g = jch.sample_gains_jax(jk, jnp.maximum(want_d, 1.0))
        gains = tch.sample_gains_keyed(tk, d1)
        _assert_bits(gains, want_g)
        for interference in (0.0, _interference(rng, n)):
            want_s = jch.snr_jax(want_g, interference)
            snr = tch.snr_f32(gains, interference)
            _assert_bits(snr, want_s)
            _assert_bits(spectral_efficiency_f32(snr),
                         spectral_efficiency_jax(want_s))


# ---------------------------------------------------------- arrival model

def _arrival_args(rng, n):
    pos = _positions(rng, n)
    up_gamma = np.maximum(rng.exponential(3.0, n), 0.05)
    rows = rng.integers(0, 400, n)
    speed = np.exp(0.5 * rng.standard_normal(n) - 0.125)
    return pos, up_gamma, rows, speed


@pytest.mark.parametrize("world", ["static", "interference"])
@pytest.mark.parametrize("n", SIZES)
def test_arrival_model_matches_reference(n, world):
    """``train_s``, ``hop_s`` and ``uplink_s`` bit for bit for every seed
    and round, at two jitter sigmas and two payloads (one not a float32)."""
    rng = np.random.default_rng(100 + n)
    jch, tch = JChannel(), ChannelModel()
    for seed in SEEDS:
        pos, up_gamma, rows, speed = _arrival_args(rng, n)
        interference = (0.0 if world == "static"
                        else _interference(rng, n))
        for t in ROUNDS:
            sigma = (1.0, 0.37)[t % 2]
            hop_bits = (835904.0, 2.0 ** 25 + 3.0)[seed % 2]
            jb = JAsyncSpec(delay_scale=0.01, delay_sigma=sigma)
            tb = AsyncSpec(delay_scale=0.01, delay_sigma=sigma)
            want = jasync._arrival_model(jb, seed, t, pos, up_gamma, jch,
                                         rows, speed, hop_bits, 835904.0,
                                         interference=interference)
            got = tasync._arrival_model(tb, seed, t, pos, up_gamma, tch,
                                        rows, speed, hop_bits, 835904.0,
                                        interference=interference)
            for field in ("train_s", "hop_s", "uplink_s"):
                a, b = getattr(got, field), getattr(want, field)
                assert a.dtype == b.dtype == np.float64
                assert np.array_equal(a, b), (field, seed, t)


def test_zero_delay_model_draws_nothing():
    b = AsyncSpec()
    rng = np.random.default_rng(0)
    pos, up_gamma, rows, speed = _arrival_args(rng, 5)
    m = tasync._arrival_model(b, 0, 0, pos, up_gamma, ChannelModel(), rows,
                              speed, 1.0, 1.0)
    assert not m.train_s.any() and not m.hop_s.any()
    assert not m.uplink_s.any() and m.hop_s.shape == (5, 5)
