"""The fused per-row STC of the fleet plane (one launch per leaf on the
card): its plain versions against the JAX package, on the CPU.

``stc_radix_threshold_ref`` over the last axis — the kernel's radix select
run per row on ``|x_c − ref|`` — must give each row's τ bit for bit equal
to ``torch.topk``'s (``stc_rows_threshold``) and to the reference's
(``jnp.sort(|Δ|, axis=1)[:, n − k]``, and ``lax.top_k``'s k-th value) on
tie-free rows, ties at τ, quarter steps, τ = 0, ±0 deltas and subnormal
deltas, k = 1 and k = n, n from 1 to 16383.  ``stc_rows_fused_ref`` must
keep the support of ``repro.kernels.ref.stc_rows_ref``, pass unmasked rows
through bit for bit, keep a −0 in ``ref`` as the reference does and hold
μ within rtol 1e-6 of the reference's.  The CUDA kernel is checked against
these plain versions on the card by ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import diffusion as tdiff
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.stc_compress import N_FUSED


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _delta_row(kind, n, k, rng):
    """One row of deltas of the given kind, exact on a 2^-14 grid (or, for
    the subnormal and signed-zero kinds, against a zero ref)."""
    if kind == "tie_free":                 # distinct magnitudes
        step = 2.0 ** -max(1, (n - 1).bit_length())
        mags = (rng.permutation(n) + 1) * step
        return mags * rng.choice([-1.0, 1.0], size=n)
    if kind == "tied_at_kth":              # seven magnitudes tie at the k-th
        d = _delta_row("tie_free", n, k, rng)
        order = np.argsort(-np.abs(d), kind="stable")
        at = order[max(0, k - 4):k + 3]
        d[at] = np.sign(d[at]) * np.abs(d[order[max(0, k - 4)]])
        return d
    if kind == "quarter_steps":
        return rng.integers(-4, 5, size=n) / 4
    if kind == "tau_zero":                 # fewer than k nonzero deltas
        d = np.zeros(n)
        m = max(0, min(k - 1, n // 200))
        d[rng.choice(n, m, replace=False)] = rng.integers(1, 2 ** 10,
                                                          size=m) / 2 ** 10
        return d
    raise ValueError(kind)


def _rows(kind, c, n, k, rng):
    """x (c, n) and ref (n,) fp32 whose Δ = x − ref is exact, and Δ as
    computed in fp32.  Subnormal deltas (1 to 40 ulps of 0) and ±0 deltas
    sit on a ref of ±0; the others on a ref on the 2^-14 grid with a few
    −0 entries."""
    if kind in ("subnormal", "signed_zeros"):
        ref = np.where(rng.random(n) < 0.5, -0.0, 0.0).astype(np.float32)
        if kind == "subnormal":
            bits = rng.integers(1, 40, size=(c, n)).astype(np.int32)
            x = bits.view(np.float32) * rng.choice([-1.0, 1.0], size=(c, n))
        else:
            x = np.where(rng.random((c, n)) < 0.5, -0.0, 0.0)
            for row in x:
                row[rng.choice(n, max(1, n // 50), replace=False)] = 0.5
        x = x.astype(np.float32)
    else:
        ref = (rng.integers(-2 ** 15, 2 ** 15, size=n) / 2 ** 14).astype(
            np.float32)
        ref[rng.random(n) < 0.05] = -0.0
        ref[n // 2] = -0.0
        x = np.stack([ref + _delta_row(kind, n, k, rng)
                      for _ in range(c)]).astype(np.float32)
    with np.errstate(all="ignore"):
        d = (x - ref[None, :]).astype(np.float32)
    return x, ref, d


KINDS = ("tie_free", "tied_at_kth", "quarter_steps", "tau_zero",
         "signed_zeros", "subnormal")
THRESHOLD_CASES = [(kind, n, k) for kind in KINDS
                   for n, k in ((16383, 163), (16383, 1), (1280, 12),
                                (1280, 1280), (128, 1), (128, 128), (10, 1),
                                (10, 10), (1, 1))]


@pytest.mark.parametrize("kind,n,k", THRESHOLD_CASES)
def test_row_radix_threshold_is_each_rows_kth_largest(kind, n, k):
    """Each row's radix τ equals ``torch.topk``'s and the reference's —
    ``lax.top_k(|Δ|, k)[0][:, k − 1]`` (the reference STC's rule) and
    ``jnp.sort(|Δ|, axis=1)[:, n − k]`` (the Pallas path's) — bit for bit,
    also as ``stc_rows_fused_ref`` selects it from x and ref.  XLA:CPU's
    sort leaves subnormal magnitudes unordered, so on subnormal deltas τ
    is held to ``lax.top_k`` and ``torch.topk``."""
    rng = np.random.default_rng(n * 5 + k + len(kind))
    x, ref, d = _rows(kind, 3, n, k, rng)
    got = tref.stc_radix_threshold_ref(torch.from_numpy(d), k)
    assert got.shape == (3,) and got.dtype == torch.float32
    xt, rt = torch.from_numpy(x), torch.from_numpy(ref)
    fused_thr = tref.stc_rows_fused_ref(
        xt, rt, torch.ones(3, dtype=torch.int32), k)[1]
    mag = jnp.abs(jnp.asarray(d))
    wants = [np.asarray(jax.lax.top_k(mag, k)[0][:, k - 1]),
             torch.topk(torch.from_numpy(d).abs(), k, dim=1).values[:, k - 1]
             .numpy()]
    if max(1, int(n * (k / n))) == k:
        wants.append(tref.stc_rows_threshold(xt, rt, k / n).numpy())
    if kind != "subnormal":
        wants.append(np.asarray(jnp.sort(mag, axis=1)[:, n - k]))
    for want in wants:
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
        np.testing.assert_array_equal(_bits(fused_thr.numpy()), _bits(want))


def test_row_radix_threshold_keeps_the_1d_shape():
    """A 1-D tensor is one row and gives (1,), as the host plane's fused
    STC reads it; rows of a 2-D tensor give one τ each."""
    x = torch.tensor([0.5, -2.0, 1.0, -0.25])
    assert tref.stc_radix_threshold_ref(x, 2).tolist() == [1.0]
    assert tref.stc_radix_threshold_ref(torch.stack([x, -x / 2]),
                                        1).tolist() == [2.0, 1.0]


FUSED_CASES = [(kind, n, sparsity)
               for kind in ("tie_free", "tied_at_kth", "quarter_steps",
                            "tau_zero", "signed_zeros")
               for n, sparsity in ((16384, 0.01), (8192, 0.01), (1280, 0.01),
                                   (128, 0.01), (10, 0.01), (3001, 0.05))]


@pytest.mark.parametrize("kind,n,sparsity", FUSED_CASES)
def test_rows_fused_ref_matches_reference_stc_rows(kind, n, sparsity):
    """``stc_rows_fused_ref`` against the reference's ``stc_rows_ref``: the
    same support on the masked rows (``lax.top_k``'s k entries, less the
    zero deltas among them), unmasked rows bit for bit x, every entry off
    the survivors where ref is −0 bit for bit the reference's, μ_c within
    rtol 1e-6 of the reference's top-k mean, and ``out`` equal to
    ``stc_rows_apply_ref`` at its own (τ, sum, count); τ, sum and count
    are 0 on unmasked rows."""
    k = max(1, int(n * sparsity))
    rng = np.random.default_rng(n + 3 * len(kind))
    x, ref, d = _rows(kind, 4, n, k, rng)
    mask = np.array([1, 0, 1, 1], np.int32)
    xt, rt, mt = (torch.from_numpy(x), torch.from_numpy(ref),
                  torch.from_numpy(mask))
    out, thr, ssum, cnt = tref.stc_rows_fused_ref(xt, rt, mt, k)
    assert out.shape == (4, n) and out.dtype == torch.float32
    assert thr.shape == ssum.shape == cnt.shape == (4,)
    assert cnt.dtype == torch.int32
    assert float(thr[1]) == float(ssum[1]) == int(cnt[1]) == 0
    want = np.asarray(jref.stc_rows_ref(jnp.asarray(x), jnp.asarray(ref),
                                        jnp.asarray(mask.astype(bool)),
                                        sparsity))
    got = out.numpy()
    on = mask.astype(bool)
    np.testing.assert_array_equal(_bits(got[~on]), _bits(x[~on]))
    np.testing.assert_array_equal(_bits(want[~on]), _bits(x[~on]))
    top = np.zeros((4, n), bool)
    np.put_along_axis(top, np.asarray(jax.lax.top_k(jnp.abs(jnp.asarray(d)),
                                                    k)[1]), True, axis=1)
    support = top & (d != 0)
    np.testing.assert_array_equal((got != ref[None, :])[on], support[on])
    np.testing.assert_array_equal((want != ref[None, :])[on], support[on])
    # Off the survivors a −0 in ref comes out as ref + 0, +0, as in the
    # reference (on them it is ±μ, held by the μ bar below).
    neg0 = on[:, None] & ~support & (_bits(ref) == _bits(-0.0))[None, :]
    assert neg0.any()
    np.testing.assert_array_equal(_bits(got[neg0]), _bits(want[neg0]))
    mu = tref.stc_mu_ref(ssum, cnt, thr, k).numpy()
    mu_ref = np.asarray(jnp.mean(jax.lax.top_k(jnp.abs(jnp.asarray(d)),
                                               k)[0], axis=1))
    np.testing.assert_allclose(mu[on], mu_ref[on], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(
        _bits(got), _bits(tref.stc_rows_apply_ref(xt, rt, thr, ssum, cnt, mt,
                                                  k).numpy()))
    r_sum, r_cnt = tref.stc_rows_reduce_ref(xt, rt, thr)
    assert torch.equal(ssum[on], r_sum[on])
    assert torch.equal(cnt[on], r_cnt[on].to(torch.int32))


@pytest.mark.parametrize("mask_dtype", [torch.bool, torch.int32])
def test_stc_topk_on_the_cpu_is_the_plain_version(mask_dtype):
    """On CPU tensors ``ops.stc_topk`` is ``stc_rows_ref`` bit for bit at
    any row length, the fused kernel's range included, with the mask as
    bool or as the int32 the kernels read; it launches nothing."""
    rng = np.random.default_rng(7)
    x, ref, _ = _rows("quarter_steps", 4, 1280, 12, rng)
    mask = torch.tensor([1, 1, 0, 1]).to(mask_dtype)
    before = dict(tdiff.LAUNCHES)
    got = tops.stc_topk(torch.from_numpy(x), torch.from_numpy(ref), mask,
                        0.01)
    assert tdiff.LAUNCHES == before
    want = tref.stc_rows_ref(torch.from_numpy(x), torch.from_numpy(ref),
                             mask.to(torch.bool), 0.01)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want.numpy()))


def _i32(c):
    return torch.ones(c, dtype=torch.int32)


REJECTED = {
    "cpu_tensors": ((torch.zeros(4, 8), torch.zeros(8), _i32(4), 1), "CUDA"),
    "k_zero": ((torch.zeros(4, 8), torch.zeros(8), _i32(4), 0), "k=0"),
    "k_past_n": ((torch.zeros(4, 8), torch.zeros(8), _i32(4), 9), "k=9"),
    "n_past_n_fused": ((torch.empty((2, N_FUSED + 1), device="meta"),
                        torch.empty(N_FUSED + 1, device="meta"), _i32(2), 1),
                       "do not fit"),
    "c_past_grid": ((torch.empty((65536, 8), device="meta"),
                     torch.empty(8, device="meta"), _i32(65536), 1),
                    "exceeds"),
}


@pytest.mark.parametrize("case", sorted(REJECTED))
def test_rows_fused_cuda_rejects_without_a_gpu(case):
    """The wrapper refuses CPU tensors, k outside [1, n], rows past N_FUSED
    and more rows than the grid's 65,535 before it needs nvcc or a card
    (sizes are checked before devices; meta tensors hold no data)."""
    args, match = REJECTED[case]
    with pytest.raises(ValueError, match=match):
        tdiff.stc_rows_fused_cuda(*args)
    assert tdiff.MAX_ROWS == 65535 and N_FUSED == 8 * 16384
