"""The device planner's kernel modules against the JAX package's, on the CPU.

``dol_bid_scores``: both plain versions — the broadcast composite the CPU
path runs and the centered-contraction twin the CUDA kernel is held to on
the card — against ``repro.kernels.ref.dol_bid_scores_ref``,
``dol_bid_scores_xla_fused`` and the Pallas body in interpret mode, with
the reference's own bars (atol 2e-5; 1e-7 as DoLs converge to uniform).
``bid_value_fuse``: the plain version against the reference's.  The CUDA
wrappers take CUDA tensors only; on the card ``chip_smoke.py`` runs them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.diffusion import (bid_value_fuse_pallas,
                                     dol_bid_scores_pallas,
                                     dol_bid_scores_xla_fused)
from repro_torch.kernels import diffusion as tdiff
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _planner_inputs(m, n, c, seed):
    """As tests/test_diffusion_kernels.py: a never-trained model (dol 0,
    chain 0) and data sizes down to 0, so the δ terms are live."""
    rng = np.random.default_rng(seed)
    dol = rng.dirichlet(np.ones(c), size=m).astype(np.float32)
    chain = rng.integers(1, 500, size=m).astype(np.float32)
    dol[0], chain[0] = 0.0, 0.0
    dsi = rng.dirichlet(np.ones(c), size=n).astype(np.float32)
    sizes = rng.integers(0, 300, size=n).astype(np.float32)
    sizes[0] = 0.0
    return dol, chain, dsi, sizes


def _both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


@pytest.mark.parametrize("m,n,c", [
    (4, 10, 10), (16, 130, 5), (64, 256, 10), (8, 40, 3), (8, 44, 5),
    (8, 40, 8), (8, 24, 16), (8, 24, 32), (8, 24, 64)])
def test_dol_bid_scores_plain_versions_match_reference(m, n, c):
    j_in, t_in = _both(_planner_inputs(m, n, c, seed=m + n + c))
    want = np.asarray(jref.dol_bid_scores_ref(*j_in))
    composite = tref.dol_bid_scores_ref(*t_in).numpy()
    fused = tref.dol_bid_scores_fused_ref(*t_in).numpy()
    assert composite.shape == fused.shape == (m, n)
    # The composite is the reference's own arithmetic, with the norm summed
    # in XLA-CPU's order for each class count: it gives the reference's bits.
    np.testing.assert_array_equal(composite, want)
    # Both twins against every reference form at the reference's bar.
    np.testing.assert_allclose(composite, want, atol=2e-5, rtol=0)
    for other in (want, np.asarray(dol_bid_scores_xla_fused(*j_in)),
                  np.asarray(dol_bid_scores_pallas(*j_in, interpret=True))):
        np.testing.assert_allclose(fused, other, atol=2e-5, rtol=0)
    # The CPU dispatch takes the composite.
    np.testing.assert_array_equal(tops.dol_bid_scores(*t_in).numpy(),
                                  composite)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape", [
    (2, 5), (2, 2, 5), (3, 2, 5), (8, 2, 5), (16, 2, 5), (1000, 2, 5),
    (4, 1000, 2, 5), (1000, 2, 6), (1000, 2, 7), (1000, 2, 8)], ids=str)
def test_iid_distance_bits_match_reference(shape, seed):
    """C = 5 with a 2-long inner axis behind an outer one: XLA-CPU runs its
    vector loop over the classes there (ROADMAP C1); C = 6-8 at the same
    shape keep the inner-axis rule.  Both the numpy and the tensor norm give
    ``repro.core.dol.iid_distance``'s bits."""
    from repro.core import dol as jdol
    from repro_torch.core import dol as tdol
    rng = np.random.default_rng(seed)
    rows = int(np.prod(shape[:-1]))
    dol = rng.dirichlet(np.ones(shape[-1]), rows).astype(np.float32)
    dol = dol.reshape(shape)
    want = np.asarray(jdol.iid_distance(jnp.asarray(dol)))
    np.testing.assert_array_equal(tdol.iid_distance(dol), want)
    np.testing.assert_array_equal(
        tdol.iid_distance_t(torch.from_numpy(dol)).numpy(), want)


def test_dol_bid_scores_near_uniform_no_cancellation():
    """As DoLs converge to uniform (dist → 0) the centered expansion keeps
    its precision — the regime every diffusion round ends in."""
    rng = np.random.default_rng(3)
    m, n, c = 8, 12, 10
    dol = np.full((m, c), 1.0 / c) + rng.normal(size=(m, c)) * 1e-4
    dol = (dol / dol.sum(axis=1, keepdims=True)).astype(np.float32)
    chain = rng.integers(100, 500, size=m).astype(np.float32)
    dsi = np.full((n, c), 1.0 / c, np.float32)
    sizes = rng.integers(50, 100, size=n).astype(np.float32)
    j_in, t_in = _both((dol, chain, dsi, sizes))
    want = np.asarray(jref.dol_bid_scores_ref(*j_in))
    np.testing.assert_allclose(tref.dol_bid_scores_fused_ref(*t_in).numpy(),
                               want, atol=1e-7, rtol=0)
    np.testing.assert_allclose(
        np.asarray(dol_bid_scores_pallas(*j_in, interpret=True)), want,
        atol=1e-7, rtol=0)


def test_dol_bid_scores_other_metrics_are_refused():
    """The Appendix-C metrics take the composite, not the kernel, as in the
    reference: the port's composite against the reference's, within a few
    ulps (``tests/test_torch_appendix.py`` holds the bits of the planner's
    bid expression)."""
    j_in, t_in = _both(_planner_inputs(4, 8, 6, seed=0))
    for metric in ("kld", "jsd", "w1_true"):
        np.testing.assert_allclose(
            tops.dol_bid_scores(*t_in, metric=metric).numpy(),
            np.asarray(jref.dol_bid_scores_ref(*j_in, metric=metric)),
            atol=3e-7, rtol=0)


@pytest.mark.parametrize("m,n", [(3, 5), (16, 20), (130, 257)])
def test_bid_value_fuse_plain_matches_reference(m, n):
    rng = np.random.default_rng(m * n)
    bids = rng.normal(size=(m, n)).astype(np.float32)
    value = rng.uniform(size=n).astype(np.float32)
    want = np.asarray(jref.bid_value_fuse_ref(jnp.asarray(bids),
                                              jnp.asarray(value), 0.7))
    pallas = np.asarray(bid_value_fuse_pallas(jnp.asarray(bids),
                                              jnp.asarray(value), 0.7,
                                              interpret=True))
    got = tops.bid_value_fuse(torch.from_numpy(bids),
                              torch.from_numpy(value), 0.7).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, pallas, rtol=1e-6, atol=1e-6)


def test_bid_value_fuse_weight_zero_is_identity():
    rng = np.random.default_rng(1)
    bids = torch.from_numpy(rng.normal(size=(8, 12)).astype(np.float32))
    value = torch.from_numpy(rng.uniform(size=12).astype(np.float32))
    assert torch.equal(tref.bid_value_fuse_ref(bids, value, 0.0), bids)


def test_cuda_wrappers_refuse_cpu_tensors():
    dol, chain, dsi, sizes = (torch.from_numpy(a)
                              for a in _planner_inputs(4, 6, 5, seed=1))
    with pytest.raises(ValueError, match="CUDA"):
        tdiff.dol_bid_scores_cuda(dol, chain, dsi, sizes)
    with pytest.raises(ValueError, match="CUDA"):
        tdiff.bid_value_fuse_cuda(torch.zeros((4, 6)), torch.zeros(6), 0.5)
    assert set(tdiff.LAUNCHES) >= {"dol_bid_scores", "bid_value_fuse"}
