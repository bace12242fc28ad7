"""The port's task models and fleet step against the JAX package's.

For each paper model, from the reference's own init (carried over with
``params_from_numpy``): logits, loss and gradients within atol 1e-5 (fp32
sums taken in another order), and one vmapped fleet step — clip at 10,
momentum SGD, the active-slot carry — against ``FleetExecutor._step``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad

from repro.fl import FLConfig as JConfig
from repro.fl.executors import FleetExecutor as JFleet
from repro.fl.models import build_task_model as j_build
from repro_torch.fl import FLConfig, params_from_numpy, params_to_numpy
from repro_torch.fl.executors import FleetExecutor
from repro_torch.fl.models import build_task_model
from repro_torch.tree import tree_leaves

TASKS = ["logistic", "svm", "fcn", "cnn", "lstm"]
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _batch(rng, b=16, dim=64, classes=10):
    return {"x": rng.normal(size=(b, dim)).astype(np.float32),
            "y": rng.integers(0, classes, size=b).astype(np.int64)}


def _close(a, b, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=atol, rtol=rtol)


@pytest.mark.parametrize("task", TASKS)
def test_logits_loss_and_grads_match(task):
    rng = np.random.default_rng(TASKS.index(task))
    jm, tm = j_build(task), build_task_model(task)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    tp = params_from_numpy(jp)
    # Same nesting and leaf order, leaf for leaf.
    assert ([tuple(x.shape) for x in tree_leaves(tp)]
            == [x.shape for x in jax.tree.leaves(jp)])
    batch = _batch(rng)
    jb = {"x": jnp.asarray(batch["x"]), "y": jnp.asarray(batch["y"])}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    _close(tm.logits(tp, tb["x"]).detach(), jm.logits(jp, jb["x"]))
    _close(tm.loss(tp, tb).detach(), jm.loss(jp, jb))
    jg = jax.grad(jm.loss)(jp, jb)
    tg = grad(tm.loss)(tp, tb)
    for a, b in zip(jax.tree.leaves(jg), tree_leaves(tg)):
        _close(b, a)


@pytest.mark.parametrize("task", TASKS)
def test_own_init_has_reference_shapes(task):
    tp = build_task_model(task).init(torch.Generator().manual_seed(0))
    jp = j_build(task).init(jax.random.PRNGKey(0))
    assert ([tuple(x.shape) for x in tree_leaves(tp)]
            == [x.shape for x in jax.tree.leaves(jp)])
    assert all(x.dtype == torch.float32 for x in tree_leaves(tp))


@pytest.mark.parametrize("task", TASKS)
def test_fleet_step_matches_reference(task):
    """One vmapped step on a 3-slot fleet: per-slot params and momentum,
    slot 1 inactive (carried bit for bit), slot 0 with inputs scaled so its
    gradient norm exceeds the clip of 10.  That slot's loss reaches ~70, so
    the comparison adds rtol 1e-6 (a few fp32 ulps) to atol 1e-5."""
    rng = np.random.default_rng(40 + TASKS.index(task))
    c = 3
    jm = j_build(task)
    base = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(2)))
    params = jax.tree.map(
        lambda x: np.stack([x + 0.01 * i * rng.normal(size=x.shape)
                            for i in range(c)]).astype(np.float32), base)
    mom = jax.tree.map(
        lambda x: (0.1 * rng.normal(size=x.shape)).astype(np.float32), params)
    xs = np.stack([_batch(rng)["x"] for _ in range(c)])
    xs[0] *= 50.0
    batch = {"x": xs, "y": rng.integers(0, 10, size=(c, 16)).astype(np.int64)}
    active = np.array([True, False, True])

    cfg = dict(strategy="fedavg", lr=0.05, momentum=0.9)
    jfleet = JFleet(jm.loss, [], JConfig(executor="fleet", **cfg))
    jp2, jmom2, jloss = jfleet._step(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, mom),
        {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(active),
        jax.tree.map(jnp.asarray, params))
    tfleet = FleetExecutor(build_task_model(task).loss, [], FLConfig(**cfg),
                           torch.device("cpu"))
    tp2, tmom2, tloss = tfleet._step(
        params_from_numpy(params), params_from_numpy(mom),
        {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.from_numpy(active))
    _close(tloss.detach(), jloss, rtol=1e-6)
    for a, b in zip(jax.tree.leaves(jp2), tree_leaves(params_to_numpy(tp2))):
        _close(b, a, rtol=1e-6)
    for a, b in zip(jax.tree.leaves(jmom2),
                    tree_leaves(params_to_numpy(tmom2))):
        _close(b, a, rtol=1e-6)
    for a, b in zip(jax.tree.leaves(params), tree_leaves(
            params_to_numpy(tp2))):
        np.testing.assert_array_equal(b[1], a[1])       # inactive slot
