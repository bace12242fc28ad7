"""The slice as a whole: the port's run_experiment on the fleet plane (CPU,
plain kernel versions) against ``repro.fl.run_experiment(engine="fleet")``.

Same config as ``tests/test_executors.py``'s ``_spec`` (fcn, N=M=5,
2 rounds, topology_seed 3), the reference's init carried into the port:
ledgers and diffusion rounds equal, final params within the reference's
own host-vs-fleet tolerance (atol 2e-4, rtol 2e-3), accuracy within 0.05.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.fl import ExperimentSpec as JSpec
from repro.fl import FLConfig as JConfig
from repro.fl import run_experiment as j_run
from repro.fl.models import build_task_model as j_build
from repro_torch.device import resolve_device
from repro_torch.fl import (ExperimentSpec, FLConfig, params_from_numpy,
                            params_to_numpy, run_experiment)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _specs(strategy, task="fcn", rounds=2, clients=5):
    fl = dict(strategy=strategy, rounds=rounds, num_clients=clients,
              num_models=clients, seed=0, topology_seed=3)
    data = dict(task=task, alpha=0.3, num_samples=1200)
    return (JSpec(fl=JConfig(engine="fleet", **fl), **data),
            ExperimentSpec(fl=FLConfig(executor="fleet", **fl), **data))


@pytest.mark.parametrize("strategy,task,rounds", [
    ("fedavg", "fcn", 2), ("feddif", "fcn", 2), ("feddif_stc", "fcn", 2),
    ("stc", "fcn", 2), ("feddif", "cnn", 1)])
def test_port_matches_reference_fleet(strategy, task, rounds):
    j_spec, t_spec = _specs(strategy, task, rounds)
    ref = j_run(j_spec)
    init = jax.tree.map(np.asarray,
                        j_build(task).init(jax.random.PRNGKey(0)))
    port = run_experiment(t_spec, device="cpu",
                          init_fn=lambda gen: params_from_numpy(init))
    assert port.ledger.as_dict() == ref.ledger.as_dict()
    assert port.diffusion_rounds == ref.diffusion_rounds
    np.testing.assert_allclose(port.iid_distance, ref.iid_distance, atol=1e-6)
    ref_leaves = jax.tree.leaves(ref.final_params)
    port_leaves = jax.tree.leaves(params_to_numpy(port.final_params))
    assert len(ref_leaves) == len(port_leaves)
    for a, b in zip(ref_leaves, port_leaves):
        np.testing.assert_allclose(b, np.asarray(a, np.float32),
                                   atol=2e-4, rtol=2e-3)
    np.testing.assert_allclose(port.accuracy, ref.accuracy, atol=0.05)
    assert len(port.round_wall_s) == rounds


def test_own_init_runs_and_learns():
    """The port's own init (a torch.Generator from cfg.seed): finite params,
    one accuracy per round, and the same init for the same seed."""
    _, spec = _specs("feddif", rounds=1)
    a = run_experiment(spec, device="cpu")
    b = run_experiment(spec, device="cpu")
    assert len(a.accuracy) == 1 and 0.0 <= a.accuracy[0] <= 1.0
    for x, y in zip(jax.tree.leaves(params_to_numpy(a.final_params)),
                    jax.tree.leaves(params_to_numpy(b.final_params))):
        assert np.isfinite(x).all()
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("change,item", [
    (dict(executor="sharded"), "A12"), (dict(engine="async"), None)])
def test_unported_config_values_raise(change, item):
    """The sharded plane raises naming A12; ``engine="async"`` runs the
    buffered-async plane (one round: one tick on its virtual clock)."""
    _, spec = _specs("feddif", rounds=1)
    spec = dataclasses.replace(spec, fl=dataclasses.replace(spec.fl,
                                                            **change))
    if item is None:
        res = run_experiment(spec, device="cpu")
        assert res.engine.mode == "async" and len(res.accuracy) >= 1
        assert len(res.history.virtual_s) >= 1
        return
    with pytest.raises(NotImplementedError, match=item):
        run_experiment(spec, device="cpu")


def test_device_planner_with_learning_values_matches_reference(monkeypatch):
    """feddif with the device planner and learning-value bids (fcn, 4
    clients, 2 rounds, topology_seed 3), the port on the CPU from the
    reference's init: equal ledgers and diffusion rounds, params within the
    fleet tolerance, and the round-0 learning values of both probes within
    1e-5."""
    import repro.fl.experiment as j_experiment
    import repro_torch.fl.experiment as t_experiment
    fl = dict(strategy="feddif", rounds=2, num_clients=4, num_models=4,
              seed=0, topology_seed=3, planner="jax", uncertainty_weight=0.5)
    data = dict(task="fcn", alpha=0.3, num_samples=1200)
    values = {"ref": [], "port": []}

    def spy(module, key):
        inner = module.run_federated

        def run(*args, value_fn=None, **kw):
            def recorded(params):
                out = value_fn(params)
                values[key].append(np.asarray(out, np.float64))
                return out
            return inner(*args, value_fn=recorded, **kw)
        monkeypatch.setattr(module, "run_federated", run)

    spy(j_experiment, "ref")
    spy(t_experiment, "port")
    ref = j_run(JSpec(fl=JConfig(engine="fleet", **fl), **data))
    init = jax.tree.map(np.asarray,
                        j_build("fcn").init(jax.random.PRNGKey(0)))
    port = run_experiment(ExperimentSpec(fl=FLConfig(executor="fleet", **fl),
                                         **data),
                          device="cpu",
                          init_fn=lambda gen: params_from_numpy(init))
    assert port.ledger.as_dict() == ref.ledger.as_dict()
    assert port.diffusion_rounds == ref.diffusion_rounds
    assert len(values["port"]) == len(values["ref"]) == 2
    np.testing.assert_allclose(values["port"][0], values["ref"][0],
                               atol=1e-5, rtol=0)
    assert 0.0 < values["port"][0].min() <= values["port"][0].max() <= 1.0
    for a, b in zip(jax.tree.leaves(ref.final_params),
                    jax.tree.leaves(params_to_numpy(port.final_params))):
        np.testing.assert_allclose(b, np.asarray(a, np.float32),
                                   atol=2e-4, rtol=2e-3)
    np.testing.assert_allclose(port.accuracy, ref.accuracy, atol=0.05)
    stats = port.planner_stats
    assert stats["plans"] == 2 and stats["auction_iterations"] > 0


def test_lm_task_raises():
    """The lm task constructs and validates; an unknown hop wire format
    is refused."""
    spec = ExperimentSpec(task="lm", dim=16, num_samples=64)
    assert spec.adapter_hops and spec.fl.hop_quant == "none"
    spec = dataclasses.replace(spec, fl=dataclasses.replace(
        spec.fl, hop_quant="int4", rounds=1, num_clients=2, num_models=2))
    with pytest.raises(ValueError, match="hop_quant"):
        run_experiment(spec, device="cpu")


def test_rejects_more_models_than_clients():
    _, spec = _specs("feddif", rounds=1, clients=4)
    spec = dataclasses.replace(spec, fl=dataclasses.replace(spec.fl,
                                                            num_models=8))
    with pytest.raises(ValueError, match="num_models"):
        run_experiment(spec, device="cpu")


def test_default_device_is_cuda_and_never_falls_back():
    """Without ``device="cpu"`` the entry points want the GPU: on a machine
    without one they raise rather than run on the CPU."""
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    _, spec = _specs("fedavg", rounds=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_experiment(spec)
