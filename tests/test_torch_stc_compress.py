"""Whole-tensor STC (B7): the port's plain versions and dispatch against the
JAX package, on the CPU.

The plain versions of the two kernel passes (``stc_reduce_ref``,
``stc_apply_ref``) are held to the Pallas bodies (``stc_reduce_pallas``,
``stc_apply_pallas``) run in interpret mode: survivor count exact, survivor
sum within 1e-6 relative (fp32 sums in another order), the apply bit for
bit.  n = 100000 crosses the Pallas kernel's 64k block, so its ``n_valid``
tail mask is exercised.  ``ops.stc_compress`` and ``fl.compression`` are
held to ``repro.fl.compression`` and to ``repro.kernels.ops.stc_compress``
on the Pallas path, on tie-free data, within 1e-6; on tied data (quarter
steps) and at τ = 0 the plain versions, whole-tensor and per row, equal the
reference's bit for bit (``lax.top_k``'s tie rule, ``jnp.mean``'s μ).  The
CUDA kernels are checked against these plain versions on the card by
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl import compression as jcomp
from repro.kernels import ref as jref
from repro.kernels import ops as jops
from repro.kernels.stc_compress import stc_apply_pallas, stc_reduce_pallas
from repro_torch.fl import compression as tcomp
from repro_torch.kernels import build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import stc_compress as tstc
from repro_torch.kernels.launch import LAUNCHES


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tie_free(rng, shape):
    """Distinct magnitudes with random signs: no tie at any threshold."""
    n = int(np.prod(shape))
    mags = rng.permutation(np.linspace(0.001, 1.0, n))
    x = (mags * rng.choice([-1.0, 1.0], size=n)).astype(np.float32)
    assert len(np.unique(np.abs(x))) == n
    return x.reshape(shape)


@pytest.mark.parametrize("n", [555, 4096, 10000, 100000])
def test_reduce_and_apply_plain_match_pallas(n):
    rng = np.random.default_rng(n)
    x = rng.normal(size=n).astype(np.float32)
    thr = np.float32(np.sort(np.abs(x))[n - max(1, n // 100)])
    s, c = tref.stc_reduce_ref(torch.from_numpy(x), torch.tensor([thr]))
    ps, pc = stc_reduce_pallas(jnp.asarray(x), jnp.asarray(thr),
                               interpret=True)
    assert s.shape == c.shape == (1,) and c.dtype == torch.int32
    assert int(c[0]) == int(pc) == int((np.abs(x) >= thr).sum())
    np.testing.assert_allclose(float(s[0]), float(ps), rtol=1e-6)
    mu = np.float32(ps) / np.float32(max(float(pc), 1.0))
    out = tref.stc_apply_ref(torch.from_numpy(x), torch.tensor([thr]),
                             torch.tensor([mu]), max(1, n // 100))
    want = np.asarray(stc_apply_pallas(jnp.asarray(x), jnp.asarray(thr),
                                       jnp.asarray(mu), interpret=True))
    assert out.shape == (n,) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy().view(np.int32),
                                  want.view(np.int32))


@pytest.mark.parametrize("shape,sparsity", [((16384,), 0.01),
                                            ((64, 128), 0.01), ((10,), 0.01),
                                            ((7, 33), 0.05), ((3, 5, 7), 0.2)])
def test_stc_compress_matches_reference(shape, sparsity):
    """ops.stc_compress and fl.compression.stc_compress_leaf on a CPU
    tensor (the plain version, exactly k kept) against the reference's host
    STC and its Pallas path: same support, same values within 1e-6."""
    x = _tie_free(np.random.default_rng(len(shape) * 100 + shape[0]), shape)
    got = tops.stc_compress(torch.from_numpy(x), sparsity).numpy()
    leaf = tcomp.stc_compress_leaf(torch.from_numpy(x), sparsity).numpy()
    want = np.asarray(jcomp.stc_compress_leaf(jnp.asarray(x), sparsity))
    pallas = np.asarray(jops.stc_compress(
        jnp.asarray(x), sparsity, implementation="pallas_interpret"))
    k = max(1, int(x.size * sparsity))
    assert got.shape == shape and int((got != 0).sum()) == k
    np.testing.assert_array_equal(got != 0, want != 0)
    for other in (leaf, want, pallas):
        np.testing.assert_allclose(got, other, atol=1e-6, rtol=0)


def test_stc_compress_tree_matches_reference():
    rng = np.random.default_rng(5)
    tree = {"w": [_tie_free(rng, (32, 16)), _tie_free(rng, (16,))],
            "b": _tie_free(rng, (10,))}
    got = tcomp.stc_compress({k: ([torch.from_numpy(a) for a in v]
                                  if isinstance(v, list)
                                  else torch.from_numpy(v))
                              for k, v in tree.items()}, 0.05)
    want = jcomp.stc_compress(tree, 0.05)
    for a, b in ((got["b"], want["b"]), (got["w"][0], want["w"][0]),
                 (got["w"][1], want["w"][1])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=0)
    assert tcomp.compressed_bits(got, 0.05) == jcomp.compressed_bits(
        want, 0.05)


def test_threshold_is_the_kth_largest_magnitude():
    x = torch.from_numpy(_tie_free(np.random.default_rng(1), (1000,)))
    thr = tref.stc_threshold(x, 0.01)
    assert thr.shape == (1,)
    assert float(thr[0]) == float(torch.sort(x.abs()).values[-10])
    # k = max(1, int(n·sparsity)): one survivor for a 10-element leaf.
    assert float(tref.stc_threshold(x[:10], 0.01)[0]) == float(
        x[:10].abs().max())


def _zeros_leaf(rng):
    """Fewer nonzeros than k (rows no batch touched): τ = 0."""
    x = np.zeros(4096, np.float32)
    x[rng.choice(4096, 17, replace=False)] = _tie_free(rng, (17,))
    return x


def _tied_leaf(rng):
    """Seven magnitudes tie at the k-th largest (k = 40)."""
    x = _tie_free(rng, (4096,))
    order = np.argsort(-np.abs(x))
    x[order[36:43]] = np.sign(x[order[36:43]]) * np.abs(x[order[36]])
    return x


@pytest.mark.parametrize("make", [_zeros_leaf, _tied_leaf])
def test_kernel_mu_is_the_exact_k_mu(make):
    """The kernels' composition — reduce over every |x| ≥ τ, the apply's
    μ (``stc_mu_ref``), apply — against the exact-k STC of record.  Its μ
    is the mean of the top-k magnitudes at τ = 0 (where sum/count would be
    n/k times too small) and at a tie, and it keeps the same k entries:
    at a tie the first tied ones in index order."""
    x = torch.from_numpy(make(np.random.default_rng(7)))
    sparsity = 0.01
    k = max(1, int(x.numel() * sparsity))
    thr = tref.stc_threshold(x, sparsity)
    ssum, cnt = tref.stc_reduce_ref(x, thr)
    mu = tref.stc_mu_ref(ssum, cnt, thr, k)
    got = tref.stc_apply_ref(x, thr, mu, k)
    want = tref.stc_compress_ref(x, sparsity)
    mu_k = float(torch.topk(x.abs(), k).values.double().mean())
    np.testing.assert_allclose(float(mu[0]), mu_k, rtol=1e-6)
    np.testing.assert_allclose(want.abs().max().item(), mu_k, rtol=1e-6)
    extra = int(cnt[0]) - k
    assert extra > 0 if float(thr[0]) == 0.0 else extra == 3
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=0)
    if float(thr[0]) > 0.0:
        assert int((got != 0).sum()) == k
        assert torch.equal(got != 0, want != 0)


def _quarter_steps(rng, n):
    """Values in quarter steps of [−1, 1]: magnitudes tie everywhere."""
    return (rng.integers(-4, 5, size=n) / 4).astype(np.float32)


def _few_nonzeros(rng, n, sparsity):
    """Fewer nonzeros than k, in quarter steps: τ = 0."""
    x = np.zeros(n, np.float32)
    m = max(1, int(n * sparsity)) // 2
    x[rng.choice(n, m, replace=False)] = rng.choice([-1.0, -0.5, 0.25, 0.75],
                                                    size=m)
    return x


TIE_CASES = [(n, kind) for n in (100, 1000, 16384)
             for kind in ("quarter_steps", "tau_zero")]


def _tie_case(n, kind, sparsity, rows=None):
    rng = np.random.default_rng(n + len(kind))
    make = ((lambda: _quarter_steps(rng, n)) if kind == "quarter_steps"
            else (lambda: _few_nonzeros(rng, n, sparsity)))
    return make() if rows is None else np.stack([make() for _ in range(rows)])


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("sparsity", [0.01, 0.1])
@pytest.mark.parametrize("n,kind", TIE_CASES)
def test_stc_compress_ties_match_reference(n, kind, sparsity):
    """Tied magnitudes (quarter steps) and τ = 0 (fewer than k nonzeros):
    ``ref.stc_compress_ref``, ``ops.stc_compress`` and the port's
    ``fl.compression`` keep the k entries ``lax.top_k`` keeps (of equal
    magnitudes the lower index) at ``jnp.mean``'s μ — the reference's
    ``stc_compress_ref`` and ``stc_compress_leaf`` bit for bit."""
    x = _tie_case(n, kind, sparsity)
    k = max(1, int(n * sparsity))
    want = np.asarray(jref.stc_compress_ref(jnp.asarray(x), sparsity))
    np.testing.assert_array_equal(
        _bits(want), _bits(jcomp.stc_compress_leaf(jnp.asarray(x), sparsity)))
    xt = torch.from_numpy(x)
    for got in (tref.stc_compress_ref(xt, sparsity),
                tops.stc_compress(xt, sparsity),
                tcomp.stc_compress_leaf(xt, sparsity),
                tcomp.stc_compress({"w": xt}, sparsity)["w"]):
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    if kind == "quarter_steps":
        assert int((want != 0).sum()) == k
    else:
        assert float(tref.stc_threshold(xt, sparsity)[0]) == 0.0


@pytest.mark.parametrize("sparsity", [0.01, 0.1])
@pytest.mark.parametrize("n,kind", TIE_CASES)
def test_stc_rows_ties_match_reference(n, kind, sparsity):
    """The fleet plane's masked per-row STC on tied rows and τ = 0 rows:
    ``ref.stc_rows_ref`` and ``ops.stc_topk`` against the reference's
    ``stc_rows_ref`` bit for bit (the same k entries per row, the same μ)."""
    x = _tie_case(n, kind, sparsity, rows=4)
    ref_row = (_quarter_steps(np.random.default_rng(n), n)
               if kind == "quarter_steps" else np.zeros(n, np.float32))
    mask = np.array([True, False, True, True])
    want = np.asarray(jref.stc_rows_ref(jnp.asarray(x), jnp.asarray(ref_row),
                                        jnp.asarray(mask), sparsity))
    args = (torch.from_numpy(x), torch.from_numpy(ref_row),
            torch.from_numpy(mask), sparsity)
    for got in (tref.stc_rows_ref(*args), tops.stc_topk(*args)):
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("n,kind", TIE_CASES)
def test_kernel_plain_versions_keep_top_k_ties(n, kind):
    """The plain versions of the CUDA kernels — reduce, then apply with
    the exact-k μ — keep exactly the entries of the exact-k STC of record
    on tied data, whole-tensor (``stc_*_ref``) and per row
    (``stc_rows_*_ref``), with μ within 1e-6."""
    sparsity = 0.01
    k = max(1, int(n * sparsity))
    x = torch.from_numpy(_tie_case(n, kind, sparsity))
    thr = tref.stc_threshold(x, sparsity)
    ssum, cnt = tref.stc_reduce_ref(x, thr)
    got = tref.stc_apply_ref(x, thr, tref.stc_mu_ref(ssum, cnt, thr, k), k)
    want = tref.stc_compress_ref(x, sparsity)
    assert torch.equal(got != 0, want != 0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=0)

    rows = torch.from_numpy(_tie_case(n, kind, sparsity, rows=3))
    ref_row = torch.zeros(n)
    mask = torch.tensor([1, 0, 1], dtype=torch.int32)
    thr = tref.stc_rows_threshold(rows, ref_row, sparsity)
    ssum, cnt = tref.stc_rows_reduce_ref(rows, ref_row, thr)
    got = tref.stc_rows_apply_ref(rows, ref_row, thr, ssum, cnt, mask, k)
    want = tref.stc_rows_ref(rows, ref_row, mask, sparsity)
    assert torch.equal(got != 0, want != 0)
    assert torch.equal(got[1], rows[1])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=0)


def test_cuda_wrappers_refuse_cpu_tensors():
    """On a CPU tensor a CUDA wrapper raises before touching nvcc; the
    dispatch takes the plain version and launches nothing."""
    x, thr = torch.ones(8), torch.ones(1)
    with pytest.raises(ValueError, match="CUDA"):
        tstc.stc_reduce_cuda(x, thr)
    with pytest.raises(ValueError, match="CUDA"):
        tstc.stc_apply_cuda(x, thr, torch.ones(1),
                            torch.ones(1, dtype=torch.int32),
                            torch.zeros(1025, dtype=torch.int32), 1)
    with pytest.raises(ValueError, match="CUDA"):
        tstc.stc_fused_cuda(x, 4)
    with pytest.raises(ValueError, match="CUDA"):
        tstc.stc_compress_cuda(x, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        tstc.stc_compress_cuda(torch.ones(tstc.N_FUSED + 1), 0.01)
    assert {"stc_reduce", "stc_apply", "stc_fused"} <= set(LAUNCHES)
    before = dict(LAUNCHES)
    tops.stc_compress(torch.arange(8.0), 0.5)
    assert LAUNCHES == before
    assert build.SOURCES["stc_compress"] == "stc_compress.cu"
    assert (build.CSRC / "stc_compress.cu").is_file()
    assert set(build._SIGNATURES["stc_compress"]) == {
        "repro_stc_reduce_f32", "repro_stc_apply_f32",
        "repro_stc_reduce_max_blocks", "repro_stc_fused_f32",
        "repro_stc_fused_max_n", "repro_stc_rows_fused_f32"}
