"""The device planner's one-launch bids (``bid_fused``) against the JAX
package's, on the CPU.

``bid_fused`` computes one bid round's Eq.-32 bids,
``(iid[:, None] − cand)·(1 + w·value[None, :])``.  Its plain twin
``ref.bid_fused_ref`` (the kernel's centered-contraction algebra) is held
to the reference's own chain — ``repro.core.dol.iid_distance`` minus
``dol_bid_scores_xla_fused`` or the Pallas body in interpret mode, then
``repro.kernels.ref.bid_value_fuse_ref`` — at the reference's bars (atol
2e-5; 1e-7 as DoLs converge to uniform).  ``ops.bid_fused`` on CPU
tensors must give, bit for bit, the chain the CPU planner ran before it:
the broadcast composite, the subtraction, ``bid_value_fuse_ref``.  The
CUDA wrapper takes CUDA tensors only; on the card ``chip_smoke.py`` holds
it to the old kernel chain bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dol as jdol
from repro.kernels import ref as jref
from repro.kernels.diffusion import (dol_bid_scores_pallas,
                                     dol_bid_scores_xla_fused)
from repro_torch.core.dol import iid_distance_t
from repro_torch.kernels import diffusion as tdiff
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

SHAPES = [(4, 10, 10), (16, 130, 5), (64, 256, 10), (8, 40, 3), (8, 44, 5),
          (8, 40, 8), (8, 24, 16), (8, 24, 32), (8, 24, 64)]
# No value, then the learning value at weights 0, 0.5 and 0.7.
WEIGHTS = [None, 0.0, 0.5, 0.7]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _planner_inputs(m, n, c, seed):
    """As tests/test_torch_planner_kernels.py: a never-trained model (dol 0,
    chain 0) and data sizes down to 0, so the δ terms are live."""
    rng = np.random.default_rng(seed)
    dol = rng.dirichlet(np.ones(c), size=m).astype(np.float32)
    chain = rng.integers(1, 500, size=m).astype(np.float32)
    dol[0], chain[0] = 0.0, 0.0
    dsi = rng.dirichlet(np.ones(c), size=n).astype(np.float32)
    sizes = rng.integers(0, 300, size=n).astype(np.float32)
    sizes[0] = 0.0
    return dol, chain, dsi, sizes


def _value(n, seed):
    return np.random.default_rng(seed + 1000).uniform(size=n).astype(
        np.float32)


def _reference_bids(dol, chain, dsi, sizes, value, weight, cand_fn):
    """The reference's chain: its iid, minus its candidate distances, then
    its value fusion."""
    j_in = [jnp.asarray(a) for a in (dol, chain, dsi, sizes)]
    iid = jdol.iid_distance(jnp.asarray(dol))
    bids = iid[:, None] - cand_fn(*j_in)
    if value is not None:
        bids = jref.bid_value_fuse_ref(bids, jnp.asarray(value), weight)
    return np.asarray(bids)


def _fused_ref(dol, chain, dsi, sizes, value, weight):
    t_in = [torch.from_numpy(a) for a in (dol, chain, dsi, sizes)]
    iid = iid_distance_t(t_in[0])
    return tref.bid_fused_ref(
        iid, *t_in, None if value is None else torch.from_numpy(value),
        0.0 if weight is None else weight).numpy()


@pytest.mark.parametrize("weight", WEIGHTS, ids=str)
@pytest.mark.parametrize("m,n,c", SHAPES)
def test_bid_fused_ref_matches_reference(m, n, c, weight):
    dol, chain, dsi, sizes = _planner_inputs(m, n, c, seed=m + n + c)
    value = None if weight is None else _value(n, m + n + c)
    got = _fused_ref(dol, chain, dsi, sizes, value, weight)
    assert got.shape == (m, n) and got.dtype == np.float32
    for cand_fn in (dol_bid_scores_xla_fused,
                    lambda *a: dol_bid_scores_pallas(*a, interpret=True)):
        want = _reference_bids(dol, chain, dsi, sizes, value, weight,
                               cand_fn)
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("weight", WEIGHTS, ids=str)
def test_bid_fused_ref_near_uniform_no_cancellation(weight):
    """As DoLs converge to uniform (dist → 0), the regime every diffusion
    round ends in, the fused bids keep the reference's 1e-7."""
    rng = np.random.default_rng(3)
    m, n, c = 8, 12, 10
    dol = np.full((m, c), 1.0 / c) + rng.normal(size=(m, c)) * 1e-4
    dol = (dol / dol.sum(axis=1, keepdims=True)).astype(np.float32)
    chain = rng.integers(100, 500, size=m).astype(np.float32)
    dsi = np.full((n, c), 1.0 / c, np.float32)
    sizes = rng.integers(50, 100, size=n).astype(np.float32)
    value = None if weight is None else _value(n, 3)
    got = _fused_ref(dol, chain, dsi, sizes, value, weight)
    for cand_fn in (jref.dol_bid_scores_ref,
                    lambda *a: dol_bid_scores_pallas(*a, interpret=True)):
        want = _reference_bids(dol, chain, dsi, sizes, value, weight,
                               cand_fn)
        np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)


@pytest.mark.parametrize("weight", WEIGHTS, ids=str)
@pytest.mark.parametrize("m,n,c", SHAPES)
def test_ops_bid_fused_on_cpu_is_the_old_chain(m, n, c, weight):
    """The CPU route is exactly the chain the CPU planner ran before
    ``bid_fused``: composite, subtraction, ``bid_value_fuse_ref`` — and so
    the reference's own bits."""
    dol, chain, dsi, sizes = (torch.from_numpy(a) for a in _planner_inputs(
        m, n, c, seed=m + n + c))
    value = (None if weight is None
             else torch.from_numpy(_value(n, m + n + c)))
    iid = iid_distance_t(dol)
    got = tops.bid_fused(iid, dol, chain, dsi, sizes, value,
                         0.0 if weight is None else weight)
    want = iid[:, None] - tref.dol_bid_scores_ref(dol, chain, dsi, sizes)
    if value is not None:
        want = tref.bid_value_fuse_ref(want, value, weight)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    ref_bits = _reference_bids(*(t.numpy() for t in (dol, chain, dsi,
                                                      sizes)),
                               None if value is None else value.numpy(),
                               weight, jref.dol_bid_scores_ref)
    np.testing.assert_array_equal(got.numpy(), ref_bits)


def test_ops_bid_fused_refuses_other_metrics(monkeypatch):
    """The Appendix-C metrics never reach the kernel: ``ops.bid_fused``
    routes them to the composite on either device, as the reference does
    (``tests/test_torch_appendix.py`` holds their bits), and a value
    factor then to ``ops.bid_value_fuse``, the wrapper of its own kernel,
    as the reference's planner sends it to its ``bid_value_fuse`` body."""
    dol, chain, dsi, sizes = (torch.from_numpy(a)
                              for a in _planner_inputs(4, 8, 6, seed=0))
    value = torch.from_numpy(_value(8, 5))
    calls = []
    shipped = tops.bid_value_fuse

    def counted(*args):
        calls.append(args)
        return shipped(*args)

    monkeypatch.setattr(tops, "bid_value_fuse", counted)
    for metric in ("kld", "jsd", "w1_true"):
        iid = iid_distance_t(dol, metric)
        got = tops.bid_fused(iid, dol, chain, dsi, sizes, metric=metric)
        want = iid[:, None] - tref.dol_bid_scores_ref(dol, chain, dsi, sizes,
                                                      metric)
        assert torch.equal(got, want) and not calls
        got = tops.bid_fused(iid, dol, chain, dsi, sizes, value, 0.5,
                             metric=metric)
        assert torch.equal(got, tref.bid_value_fuse_ref(want, value, 0.5))
        assert len(calls) == 1 and calls.pop()[2] == 0.5
    assert tdiff.LAUNCHES["bid_fused"] == 0


def test_bid_fused_cuda_refuses_cpu_tensors_and_mismatched_shapes():
    dol, chain, dsi, sizes = (torch.from_numpy(a)
                              for a in _planner_inputs(4, 6, 5, seed=1))
    iid, value = iid_distance_t(dol), torch.rand(6)
    with pytest.raises(ValueError, match="CUDA"):
        tdiff.bid_fused_cuda(iid, dol, chain, dsi, sizes)
    with pytest.raises(ValueError, match="CUDA"):
        tdiff.bid_fused_cuda(iid, dol, chain, dsi, sizes, value, 0.5)
    # Shapes are checked before devices.
    for args in ((iid[:3], dol, chain, dsi, sizes, None),
                 (iid, dol, chain[:3], dsi, sizes, None),
                 (iid, dol, chain, dsi[:, :4], sizes, None),
                 (iid, dol, chain, dsi, sizes[:5], None),
                 (iid, dol, chain, dsi, sizes, value[:5])):
        with pytest.raises(ValueError, match="do not match"):
            tdiff.bid_fused_cuda(*args, 0.5)
    assert tdiff.LAUNCHES["bid_fused"] == 0
    assert set(tdiff.LAUNCHES) >= {"bid_fused", "dol_bid_scores",
                                   "bid_value_fuse"}
