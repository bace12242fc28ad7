"""The slice as a whole: the port's run_experiment against the reference's,
every strategy on the host plane and the six strategies this slice adds on
the fleet plane (CPU, plain kernel versions).

Config of ``tests/test_executors.py``'s ``_spec`` (fcn, N=M=5, 1200
samples, 2 rounds, topology_seed 3, TT-HF clusters of 2 with a global
aggregation every 2 rounds), the reference's init carried into the port:
ledgers and diffusion rounds equal, final params within the reference's own
host-vs-fleet tolerance (atol 2e-4, rtol 2e-3), accuracy within 0.05.
"""
import jax
import numpy as np
import pytest
import torch

from repro.fl import ExperimentSpec as JSpec
from repro.fl import FLConfig as JConfig
from repro.fl import run_experiment as j_run
from repro.fl.models import build_task_model as j_build
from repro.fl.server import STRATEGIES as J_STRATEGIES
from repro_torch.fl import (STRATEGIES, ExperimentSpec, FLConfig,
                            params_from_numpy, params_to_numpy,
                            run_experiment)

NEW_STRATEGIES = ("fedswap", "tthf", "gossip", "fedprox", "feddif_prox",
                  "d2d_random_walk")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _check(strategy, engine):
    fl = dict(strategy=strategy, rounds=2, num_clients=5, num_models=5,
              seed=0, topology_seed=3, tthf_cluster_size=2,
              tthf_global_period=2, engine=engine)
    data = dict(task="fcn", alpha=0.3, num_samples=1200)
    ref = j_run(JSpec(fl=JConfig(**fl), **data))
    init = jax.tree.map(np.asarray,
                        j_build("fcn").init(jax.random.PRNGKey(0)))
    port = run_experiment(ExperimentSpec(fl=FLConfig(**fl), **data),
                          device="cpu",
                          init_fn=lambda gen: params_from_numpy(init))
    assert port.engine.mode == engine
    assert port.ledger.as_dict() == ref.ledger.as_dict()
    assert port.diffusion_rounds == ref.diffusion_rounds
    np.testing.assert_allclose(port.iid_distance, ref.iid_distance, atol=1e-6)
    ref_leaves = jax.tree.leaves(ref.final_params)
    port_leaves = jax.tree.leaves(params_to_numpy(port.final_params))
    assert len(ref_leaves) == len(port_leaves)
    for a, b in zip(ref_leaves, port_leaves):
        assert np.isfinite(b).all()
        np.testing.assert_allclose(b, np.asarray(a, np.float32),
                                   atol=2e-4, rtol=2e-3)
    np.testing.assert_allclose(port.accuracy, ref.accuracy, atol=0.05)
    assert len(port.round_wall_s) == 2


def test_every_reference_strategy_is_ported():
    assert set(STRATEGIES) == set(J_STRATEGIES)


@pytest.mark.parametrize("strategy", J_STRATEGIES)
def test_host_plane_matches_reference(strategy):
    _check(strategy, "host")


@pytest.mark.parametrize("strategy", NEW_STRATEGIES)
def test_fleet_plane_matches_reference(strategy):
    _check(strategy, "fleet")
