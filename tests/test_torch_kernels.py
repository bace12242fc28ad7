"""The port's kernel modules against the JAX package's, on the CPU.

Plain PyTorch versions (``repro_torch.kernels.ref``) and the device dispatch
(``repro_torch.kernels.ops``) are held to ``repro.kernels.ref`` and to the
Pallas bodies run in interpret mode, on the same numpy inputs.  The CUDA
kernels themselves are checked against these plain versions on the card by
``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.diffusion import (mix_aggregate_pallas, stack_ravel,
                                     stc_rows_pallas)
from repro_torch.kernels import diffusion as tdiff
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tie_free(rng, c, n):
    """ref + distinct-magnitude deltas: no |Δ| ties at any threshold."""
    ref = rng.normal(size=n).astype(np.float32)
    mags = rng.permutation(np.linspace(0.01, 1.0, c * n)).reshape(c, n)
    signs = rng.choice([-1.0, 1.0], size=(c, n))
    x = (ref[None, :] + mags * signs).astype(np.float32)
    delta = x - ref[None, :]
    assert len(np.unique(np.abs(delta), axis=None)) == c * n
    return x, ref


# ------------------------------------------------------------ mix_aggregate

@pytest.mark.parametrize("c", [1, 5, 37])
@pytest.mark.parametrize("f", [100, 1000])
@pytest.mark.parametrize("g_is_c", [False, True])
def test_mix_aggregate_plain_matches_reference(c, f, g_is_c):
    """Plain mix_aggregate vs repro's ref and its Pallas body (interpret),
    G ∈ {1, C}; fp32 sums of ≤ 37 terms, atol 1e-5."""
    rng = np.random.default_rng(c * 1000 + f + g_is_c)
    g = c if g_is_c else 1
    x = rng.normal(size=(c, f)).astype(np.float32)
    w = rng.random(size=(g, c)).astype(np.float32)
    out = tops.mix_aggregate(torch.from_numpy(x), torch.from_numpy(w))
    assert out.shape == (g, f) and out.dtype == torch.float32
    want = np.asarray(jref.mix_aggregate_ref(jnp.asarray(x), jnp.asarray(w)))
    pallas = np.asarray(mix_aggregate_pallas(jnp.asarray(x), jnp.asarray(w),
                                             interpret=True))
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(out.numpy(), pallas, atol=1e-5, rtol=0)


@pytest.mark.parametrize("collapse", [False, True])
def test_mix_aggregate_tree_matches_reference(collapse):
    rng = np.random.default_rng(3)
    tree = {"w": rng.normal(size=(6, 17, 3)).astype(np.float32),
            "b": [rng.normal(size=(6, 9)).astype(np.float32),
                  rng.normal(size=(6, 2, 2)).astype(np.float32)]}
    w = rng.random(size=(1 if collapse else 6, 6)).astype(np.float32)
    want = jops.mix_aggregate_tree(jax.tree.map(jnp.asarray, tree),
                                   jnp.asarray(w), collapse=collapse,
                                   implementation="ref")
    got = tops.mix_aggregate_tree(
        {"w": torch.from_numpy(tree["w"]),
         "b": [torch.from_numpy(t) for t in tree["b"]]},
        torch.from_numpy(w), collapse=collapse)
    for a, b in zip(jax.tree.leaves(want),
                    [got["b"][0], got["b"][1], got["w"]]):
        assert tuple(b.shape) == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)


def test_mix_aggregate_tree_collapse_needs_one_row():
    params = {"w": torch.zeros((4, 3))}
    with pytest.raises(ValueError, match="collapse"):
        tops.mix_aggregate_tree(params, torch.ones((4, 4)), collapse=True)


# ---------------------------------------------------------------- stc_rows

@pytest.mark.parametrize("c,n,sparsity", [(4, 100, 0.01), (5, 1000, 0.01),
                                          (3, 4097, 0.1), (6, 10, 0.3)])
def test_stc_rows_plain_matches_reference(c, n, sparsity):
    """Plain stc_rows (exact-k top-k) vs repro's stc_rows_ref and the Pallas
    kernels (keep every |Δ| ≥ τ) on tie-free data, where both semantics
    select the same survivors; μ is a mean of ≤ 410 fp32 terms."""
    rng = np.random.default_rng(n + c)
    x, ref = _tie_free(rng, c, n)
    mask = rng.random(c) < 0.6
    mask[0], mask[-1] = True, False
    got = tops.stc_topk(torch.from_numpy(x), torch.from_numpy(ref),
                        torch.from_numpy(mask), sparsity).numpy()
    want = np.asarray(jref.stc_rows_ref(jnp.asarray(x), jnp.asarray(ref),
                                        jnp.asarray(mask), sparsity))
    pallas = np.asarray(stc_rows_pallas(jnp.asarray(x), jnp.asarray(ref),
                                        jnp.asarray(mask), sparsity,
                                        interpret=True))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, pallas, atol=1e-6, rtol=0)
    # Unmasked rows pass through bit for bit; masked rows keep k survivors.
    np.testing.assert_array_equal(got[~mask], x[~mask])
    k = max(1, int(n * sparsity))
    assert ((got[mask] != ref[None, :]).sum(axis=1) == k).all()


@pytest.mark.parametrize("c,n", [(4, 100), (3, 4097)])
def test_stc_rows_kernel_bodies_plain_versions(c, n):
    """The plain versions of the two CUDA bodies — τ, then reduce, then
    apply — compose to the Pallas semantics and survivor counts."""
    rng = np.random.default_rng(c * n)
    x, ref = _tie_free(rng, c, n)
    mask = np.arange(c) % 2 == 0
    xt, rt = torch.from_numpy(x), torch.from_numpy(ref)
    thr = tref.stc_rows_threshold(xt, rt, 0.05)
    ssum, cnt = tref.stc_rows_reduce_ref(xt, rt, thr)
    assert (cnt.numpy() == max(1, int(n * 0.05))).all()
    got = tref.stc_rows_apply_ref(xt, rt, thr, ssum, cnt,
                                  torch.from_numpy(mask.astype(np.int32)),
                                  max(1, int(n * 0.05)))
    pallas = np.asarray(stc_rows_pallas(jnp.asarray(x), jnp.asarray(ref),
                                        jnp.asarray(mask), 0.05,
                                        interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, atol=1e-6, rtol=0)


def test_stc_compress_ref_matches_reference():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(7, 33)).astype(np.float32)
    got = tref.stc_compress_ref(torch.from_numpy(x), 0.05).numpy()
    want = np.asarray(jref.stc_compress_ref(jnp.asarray(x), 0.05))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


# ---------------------------------------------------- stack_ravel / unravel

def _tree(rng, c):
    return {"head": [{"w": rng.normal(size=(c, 4, 3)).astype(np.float32),
                      "b": rng.normal(size=(c, 3)).astype(np.float32)}],
            "c1": rng.normal(size=(c, 3, 3, 1, 2)).astype(np.float32)}


def test_stack_ravel_layout_matches_reference():
    rng = np.random.default_rng(5)
    tree = _tree(rng, 4)
    flat_j, _ = stack_ravel(jax.tree.map(jnp.asarray, tree))
    flat_t, _ = tdiff.stack_ravel(jax.tree.map(torch.from_numpy, tree))
    np.testing.assert_array_equal(flat_t.numpy(), np.asarray(flat_j))


@pytest.mark.parametrize("collapse,keep_float32", [
    (False, False), (False, True), (True, False), (True, True)])
def test_stack_unravel_round_trip(collapse, keep_float32):
    rng = np.random.default_rng(6)
    tree = jax.tree.map(torch.from_numpy, _tree(rng, 1 if collapse else 3))
    tree["c1"] = tree["c1"].to(torch.float64)
    flat, spec = tdiff.stack_ravel(tree)
    assert flat.dtype == torch.float32
    back = tdiff.stack_unravel(flat, spec, collapse=collapse,
                               keep_float32=keep_float32)
    want_c1 = torch.float32 if keep_float32 else torch.float64
    assert back["c1"].dtype == want_c1
    for a, b in ((tree["c1"], back["c1"]),
                 (tree["head"][0]["w"], back["head"][0]["w"]),
                 (tree["head"][0]["b"], back["head"][0]["b"])):
        want = a[0] if collapse else a
        assert tuple(b.shape) == tuple(want.shape)
        np.testing.assert_array_equal(b.to(torch.float64).numpy(),
                                      want.to(torch.float32).to(
                                          torch.float64).numpy())


def test_stack_unravel_collapse_rejects_many_rows():
    flat, spec = tdiff.stack_ravel({"w": torch.zeros((3, 2))})
    with pytest.raises(ValueError, match="collapse"):
        tdiff.stack_unravel(flat, spec, collapse=True)


# ----------------------------------------------------------------- dispatch

def test_cuda_wrappers_take_cuda_tensors_only():
    """A CUDA wrapper launches its kernel or raises: given CPU tensors it
    refuses before touching nvcc."""
    x, w = torch.zeros((4, 8)), torch.ones((1, 4))
    with pytest.raises(ValueError, match="CUDA"):
        tdiff.mix_aggregate_cuda(x, w)
    with pytest.raises(ValueError, match="CUDA"):
        tdiff.stc_rows_reduce_cuda(x, torch.zeros(8), torch.zeros(4))
    with pytest.raises(ValueError, match="CUDA"):
        tdiff.stc_rows_cuda(x, torch.zeros(8), torch.ones(4, dtype=bool),
                            0.1)


def test_dispatch_follows_the_device_only():
    with pytest.raises(ValueError, match="device"):
        tops.mix_aggregate(torch.zeros((2, 3), device="meta"),
                           torch.zeros((1, 2), device="meta"))
    before = dict(tdiff.LAUNCHES)
    tops.mix_aggregate(torch.zeros((2, 3)), torch.ones((1, 2)))
    assert tdiff.LAUNCHES == before          # the plain version launched none
