"""The port's client-stacked LM data plane against the JAX package's, on the
CPU: ``distributed/fedshard.py``'s ``fleet_aggregate``,
``make_fleet_train_step`` and ``make_diffusion_step`` against
``repro.distributed.fedshard`` at its default ``REPRO_PERF_OPTS`` (``all``:
the hop moves params only, over a bf16 wire).

Tolerances: the aggregation within atol 1e-6 (an fp32 contraction over 3
clients in another order); a hop with no training and no aggregation bit
for bit (a gather of bf16-rounded values); the optimizer state zeroed
exactly on every slot that does not train; after a fleet step (smollm-smoke,
fp32 compute, SGD) params within atol 2e-5, and momenta (one step's
gradients) within 2e-3 of their scale per leaf, the gradient bar of
``tests/test_torch_zoo_grad.py`` (measured ≤ 3.9e-4), losses within 2e-5.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke
from repro.distributed import fedshard as jfs
from repro.models.zoo import build_model as j_build
from repro.train import optimizer as jopt
from repro.train import trainstep as jts
from repro_torch.configs import get_smoke_config
from repro_torch.distributed import fedshard as tfs
from repro_torch.models.zoo import build_model, params_from_numpy
from repro_torch.train import optimizer as topt
from repro_torch.train.trainstep import TrainState
from repro_torch.tree import tree_leaves

ARCH, C, LR = "smollm_360m", 3, 0.05


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs():
    return (dataclasses.replace(j_get_smoke(ARCH), compute_dtype="float32"),
            dataclasses.replace(get_smoke_config(ARCH),
                                compute_dtype="float32"))


@functools.lru_cache(maxsize=None)
def _fleet_inputs():
    """Client-stacked params (the reference's init, scaled per client),
    non-zero momenta, steps and per-client batches, as numpy."""
    jcfg, _ = _cfgs()
    init = jax.tree.map(np.asarray, j_build(jcfg).init(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(11)
    scale = np.array([1.0, 0.9, 1.1], np.float32)
    params = jax.tree.map(
        lambda x: (scale.reshape((C,) + (1,) * x.ndim) * x[None]).astype(
            x.dtype), init)
    mu = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
        np.float32), params)
    tokens = rng.integers(0, jcfg.vocab_size, (C, 2, 12)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=2)}
    return params, mu, np.arange(C, dtype=np.int32), batch


def _j_state():
    params, mu, step, batch = _fleet_inputs()
    to_j = functools.partial(jax.tree.map, jnp.asarray)
    return (jts.TrainState(params=to_j(params), opt_state={"mu": to_j(mu)},
                           step=jnp.asarray(step)), to_j(batch))


def _t_state():
    params, mu, step, batch = _fleet_inputs()
    return (TrainState(params=params_from_numpy(params),
                       opt_state={"mu": params_from_numpy(mu)},
                       step=torch.from_numpy(step)),
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _leaves_np(tree):
    return [x.detach().float().numpy() for x in tree_leaves(tree)]


def test_fleet_aggregate_matches_reference():
    params, _, _, _ = _fleet_inputs()
    w = np.array([3.0, 1.0, 0.5], np.float32)
    want = jfs.fleet_aggregate(jax.tree.map(jnp.asarray, params),
                               jnp.asarray(w))
    got = tfs.fleet_aggregate(params_from_numpy(params), torch.from_numpy(w))
    for g, x in zip(_leaves_np(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, np.asarray(x), atol=1e-6, rtol=0)
        assert np.array_equal(g[0], g[1]) and np.array_equal(g[0], g[2])
    # All-zero weights: the 1e-9 floor, zeros everywhere.
    zero = tfs.fleet_aggregate(params_from_numpy(params), torch.zeros(C))
    assert all(float(x.abs().max()) == 0.0 for x in tree_leaves(zero))


@functools.lru_cache(maxsize=None)
def _reference_diffusion(with_weights, train):
    jcfg, _ = _cfgs()
    step = jax.jit(jfs.make_diffusion_step(j_build(jcfg), jopt.sgd(), LR,
                                           remat=False),
                   static_argnums=())
    state, batch = _j_state()
    src = jnp.asarray([2, 0, 1], jnp.int32)
    mask = jnp.asarray([True, False, True] if train else [False] * C)
    weights = jnp.asarray([1.0, 2.0, 3.0]) if with_weights else None
    out, metrics = step(state, batch, src, mask, weights)
    to_np = functools.partial(jax.tree.map, np.asarray)
    return to_np(out.params), to_np(out.opt_state), np.asarray(out.step), \
        np.asarray(metrics["loss"])


@pytest.mark.parametrize("with_weights,train", [(False, False),
                                                (False, True),
                                                (True, True)])
def test_diffusion_step_matches_reference(with_weights, train):
    want_p, want_o, want_step, want_loss = _reference_diffusion(with_weights,
                                                                train)
    _, cfg = _cfgs()
    step = tfs.make_diffusion_step(build_model(cfg), topt.sgd(), LR,
                                   remat=False)
    state, batch = _t_state()
    src = torch.tensor([2, 0, 1])
    mask = torch.tensor([True, False, True] if train else [False] * C)
    weights = torch.tensor([1.0, 2.0, 3.0]) if with_weights else None
    out, metrics = step(state, batch, src, mask, weights)
    got_p = _leaves_np(out.params)
    if not train:
        # The hop alone: a gather of bf16-rounded fp32 params, bit for bit.
        for g, w, x in zip(got_p, jax.tree.leaves(want_p),
                           tree_leaves(state.params)):
            np.testing.assert_array_equal(g, w)
            moved = x.to(torch.bfloat16).float()[src].numpy()
            np.testing.assert_array_equal(g, moved)
    else:
        for g, w in zip(got_p, jax.tree.leaves(want_p)):
            np.testing.assert_allclose(g, w, atol=2e-5, rtol=0)
    np.testing.assert_allclose(metrics["loss"].numpy(), want_loss,
                               atol=2e-5)
    np.testing.assert_array_equal(out.step.numpy(), want_step)
    for g, w in zip(_leaves_np(out.opt_state["mu"]),
                    jax.tree.leaves(want_o["mu"])):
        # Momentum restarts from zero at the receiver: slot 1 (no train)
        # holds zeros; the trained slots one step's gradient.
        assert float(np.abs(g[1]).max()) == 0.0
        np.testing.assert_allclose(g, w, atol=2e-3 * (np.abs(w).max() + 1e-9))


def test_fleet_train_step_matches_reference():
    jcfg, cfg = _cfgs()
    jstate, jbatch = _j_state()
    want, wm = jax.jit(jfs.make_fleet_train_step(
        j_build(jcfg), jopt.sgd(), LR, remat=False))(jstate, jbatch)
    state, batch = _t_state()
    got, gm = tfs.make_fleet_train_step(build_model(cfg), topt.sgd(), LR,
                                        remat=True)(state, batch)
    for g, w in zip(_leaves_np(got.params), jax.tree.leaves(want.params)):
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-5, rtol=0)
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(gm[key].numpy(), np.asarray(wm[key]),
                                   rtol=1e-4, atol=2e-5)
    np.testing.assert_array_equal(got.step.numpy(), np.asarray(want.step))
