"""The fused whole-tensor STC (one launch per leaf on the card): its plain
versions against the JAX package, on the CPU.

``stc_radix_threshold_ref`` — the kernel's radix select, 8-bit digits on
the int32 view of |x| — must give τ bit for bit equal to ``stc_threshold``
(``torch.topk``) and to the reference's τ (``jnp.sort(|x|)[n − k]`` and
``lax.top_k``'s k-th value) on tie-free data, quarter steps, τ = 0, k = 1
and k = n, n = 1, ragged n, subnormals and ±0.  ``stc_fused_ref`` must keep
exactly the support of ``repro.fl.compression.stc_compress_leaf``, hold μ
within rtol 1e-6 of the top-k mean and equal ``stc_apply_ref`` at its own
μ.  The CUDA kernel is checked against these plain versions on the card by
``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl import compression as jcomp
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import stc_compress as tstc


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _case(kind, n, rng):
    if kind == "tie_free":
        mags = rng.permutation(np.linspace(0.001, 1.0, n))
        return (mags * rng.choice([-1.0, 1.0], size=n)).astype(np.float32)
    if kind == "normal":
        return (rng.normal(size=n) * 0.05).astype(np.float32)
    if kind == "quarter_steps":
        return (rng.integers(-4, 5, size=n) / 4).astype(np.float32)
    if kind == "tau_zero":                 # fewer than k nonzeros
        x = np.zeros(n, np.float32)
        m = max(1, n // 200)
        x[rng.choice(n, m, replace=False)] = rng.normal(size=m)
        return x
    if kind == "subnormal":                # magnitudes of 1 to 40 ulps of 0
        bits = rng.integers(1, 40, size=n).astype(np.int32)
        signs = rng.choice([-1.0, 1.0], size=n).astype(np.float32)
        return bits.view(np.float32) * signs
    if kind == "signed_zeros":             # ±0 with a few values
        x = np.where(rng.random(n) < 0.5, np.float32(-0.0), np.float32(0.0))
        x[rng.choice(n, max(1, n // 50), replace=False)] = 0.5
        return x.astype(np.float32)
    raise ValueError(kind)


KINDS = ("tie_free", "normal", "quarter_steps", "tau_zero", "subnormal",
         "signed_zeros")
THRESHOLD_CASES = [(kind, n, k) for kind in KINDS
                   for n, k in ((16384, 163), (16383, 1), (1280, 12),
                                (10, 1), (10, 10), (1, 1), (777, 777),
                                (5000, 2500))]


@pytest.mark.parametrize("kind,n,k", THRESHOLD_CASES)
def test_radix_threshold_is_the_kth_largest_magnitude(kind, n, k):
    """The radix select's τ equals ``stc_threshold``'s and the reference's
    (``lax.top_k(|x|, k)[0][k − 1]``, the rule of the reference's STC, and
    ``jnp.sort(|x|)[n − k]``, the Pallas path's) bit for bit.  XLA:CPU
    compares floats with subnormals flushed to zero, so its sort leaves
    subnormal magnitudes unordered (see the next test): on subnormal data
    τ is held to ``lax.top_k``, which orders them, and ``torch.topk``."""
    x = _case(kind, n, np.random.default_rng(n * 7 + k + len(kind)))
    got = tref.stc_radix_threshold_ref(torch.from_numpy(x), k)
    assert got.shape == (1,) and got.dtype == torch.float32
    mag = jnp.abs(jnp.asarray(x))
    wants = [np.asarray(jax.lax.top_k(mag, k)[0][k - 1]),
             torch.topk(torch.from_numpy(x).abs(), k).values[k - 1].numpy()]
    if max(1, int(n * (k / n))) == k:
        wants.append(tref.stc_threshold(torch.from_numpy(x), k / n).numpy())
    if kind != "subnormal":
        wants.append(np.asarray(jnp.sort(mag)[n - k]))
    for want in wants:
        np.testing.assert_array_equal(_bits(got.numpy()).reshape(()),
                                      _bits(want).reshape(()))


def test_xla_cpu_sort_does_not_order_subnormals():
    """Why the subnormal cases above skip ``jnp.sort``: on XLA:CPU it sees
    every subnormal magnitude as 0 and keeps their order, while
    ``lax.top_k`` and the radix select order them by value."""
    x = np.array([5, 1, 34, 2, 7], np.int32).view(np.float32)
    mag = jnp.abs(jnp.asarray(x))
    assert list(_bits(jnp.sort(mag))) == [5, 1, 34, 2, 7]
    assert list(_bits(jax.lax.top_k(mag, 5)[0])) == [34, 7, 5, 2, 1]
    assert [int(tref.stc_radix_threshold_ref(torch.from_numpy(x), k)
                .view(torch.int32)[0]) for k in range(1, 6)] == [34, 7, 5,
                                                                 2, 1]


def test_radix_threshold_keys_minus_zero_as_zero():
    """−0 keys as +0 (|x| first): with every value ±0, τ is +0."""
    x = torch.tensor([-0.0, 0.0, -0.0, -0.0])
    for k in range(1, 5):
        got = tref.stc_radix_threshold_ref(x, k)
        assert int(got.view(torch.int32)[0]) == 0


FUSED_CASES = [(kind, n, sparsity) for kind in KINDS
               for n, sparsity in ((16384, 0.01), (8192, 0.01), (1280, 0.01),
                                   (128, 0.01), (10, 0.01), (3001, 0.05))]


@pytest.mark.parametrize("kind,n,sparsity", FUSED_CASES)
def test_fused_ref_matches_reference_stc(kind, n, sparsity):
    """``stc_fused_ref``: exactly the support of the reference's host STC
    (``lax.top_k``'s k entries, less the zeros among them), μ within rtol
    1e-6 of the top-k mean, ``out`` equal to ``stc_apply_ref`` at its own
    μ, and τ, sum and count consistent with ``stc_reduce_ref``.  On
    subnormal data XLA:CPU flushes the reference's μ to 0, so there the
    support is held to ``lax.top_k``'s indices alone, and μ, a subnormal
    with few significant bits, to within half an ulp (2⁻¹⁵⁰) of the top-k
    mean."""
    x = _case(kind, n, np.random.default_rng(n + len(kind)))
    k = max(1, int(n * sparsity))
    xt = torch.from_numpy(x)
    out, thr, ssum, cnt = tref.stc_fused_ref(xt, k)
    assert out.shape == (n,) and out.dtype == torch.float32
    assert thr.shape == ssum.shape == cnt.shape == (1,)
    assert cnt.dtype == torch.int32
    top = np.zeros(n, bool)
    top[np.asarray(jax.lax.top_k(jnp.abs(jnp.asarray(x)), k)[1])] = True
    np.testing.assert_array_equal(out.numpy() != 0, top & (x != 0))
    mu = tref.stc_mu_ref(ssum, cnt, thr, k)
    mu_k = float(torch.topk(xt.abs(), k).values.double().mean())
    if kind == "subnormal":
        assert abs(float(mu[0]) - mu_k) <= 2.0 ** -150
    else:
        np.testing.assert_allclose(float(mu[0]), mu_k, rtol=1e-6)
    np.testing.assert_array_equal(
        _bits(out.numpy()), _bits(tref.stc_apply_ref(xt, thr, mu, k).numpy()))
    r_sum, r_cnt = tref.stc_reduce_ref(xt, thr)
    assert torch.equal(ssum, r_sum) and torch.equal(cnt, r_cnt)
    if kind != "subnormal":
        want = np.asarray(jcomp.stc_compress_leaf(jnp.asarray(x), sparsity))
        np.testing.assert_array_equal(out.numpy() != 0, want != 0)
        np.testing.assert_allclose(out.numpy(), want, rtol=1e-6, atol=0)


def test_fused_ref_keeps_the_first_ties_in_index_order():
    """Seven magnitudes tie at the k-th largest: the first four in index
    order survive (``lax.top_k``'s rule), as in the exact-k STC."""
    rng = np.random.default_rng(11)
    x = _case("tie_free", 4096, rng)
    order = np.argsort(-np.abs(x), kind="stable")
    k = 40
    x[order[36:43]] = np.sign(x[order[36:43]]) * np.abs(x[order[36]])
    out, thr, _, cnt = tref.stc_fused_ref(torch.from_numpy(x), k)
    assert int(cnt[0]) == k + 3 and float(thr[0]) == abs(x[order[36]])
    tied = np.flatnonzero(np.abs(x) == thr.numpy()[0])
    kept = out.numpy() != 0
    assert kept.sum() == k and kept[tied[:4]].all() and not kept[tied[4:]].any()
    want = np.asarray(jcomp.stc_compress_leaf(jnp.asarray(x), k / 4096))
    np.testing.assert_array_equal(kept, want != 0)


def test_stc_compress_routing_on_the_cpu():
    """On a CPU tensor ``ops.stc_compress`` takes the plain version of
    record at any size, the fused kernel's range included; N_FUSED is the
    kernel's cluster of 8 blocks of 16384 elements."""
    assert tstc.N_FUSED == 8 * 16384
    x = torch.from_numpy(_case("normal", 16384, np.random.default_rng(2)))
    assert torch.equal(tops.stc_compress(x, 0.01),
                       tref.stc_compress_ref(x, 0.01))
    k = max(1, int(x.numel() * 0.01))
    assert torch.equal(tref.stc_fused_ref(x, k)[0] != 0,
                       tref.stc_compress_ref(x, 0.01) != 0)
