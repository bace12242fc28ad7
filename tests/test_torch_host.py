"""The port's host plane pieces against the JAX package's, on the CPU.

Eq.-11 aggregation (``core.aggregation``), the two local solvers
(``fl.client``, ``fl.fedprox``) on one session from injected params and
batches, ``MixOp.matrix``, the schedules of the six strategies this slice
adds (ops, wire events, aggregation, for seeds 0–2), the engine selection
(``fl.engine``), the plan cache (``core.diffusion.PlanCache``) and the
port's own host plane against its fleet plane.  Whole runs against the
reference are in ``tests/test_torch_host_runs.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.channels.fading import ChannelModel as JChannel
from repro.channels.resources import ResourceLedger as JLedger
from repro.channels.topology import CellTopology as JTopology
from repro.channels.world import HostWorld
from repro.core import aggregation as jagg
from repro.core.auction import AuctionConfig as JAuction
from repro.core.diffusion import DiffusionPlanner as JPlanner
from repro.core.diffusion import feddif_cache_key as j_cache_key
from repro.core.schedule import MixOp as JMixOp
from repro.core.schedule import charge_schedule as j_charge
from repro.fl import ExperimentSpec as JSpec
from repro.fl import FLConfig as JConfig
from repro.fl.client import make_local_update as j_local_update
from repro.fl.engine import ENGINE_PRESETS as J_PRESETS
from repro.fl.engine import resolve_engine as j_resolve
from repro.fl.experiment import load_experiment_data as j_load
from repro.fl.fedprox import make_prox_local_update as j_prox_update
from repro.fl.models import build_task_model as j_build
from repro.fl.schedulers import SCHEDULERS as J_SCHEDULERS
from repro.fl.schedulers import RoundContext as JContext
from repro_torch.channels.fading import ChannelModel
from repro_torch.channels.resources import ResourceLedger
from repro_torch.channels.topology import CellTopology
from repro_torch.core import aggregation as tagg
from repro_torch.core.auction import AuctionConfig
from repro_torch.core.diffusion import (DiffusionPlanner, PlanCache,
                                        feddif_cache_key)
from repro_torch.core.schedule import MixOp, charge_schedule
from repro_torch.fl import (ENGINE_PRESETS, EngineSpec, ExperimentSpec,
                            FLConfig, RunHistory, RunResult, params_from_numpy,
                            params_to_numpy, resolve_engine, run_experiment)
from repro_torch.fl.client import make_local_update
from repro_torch.fl.fedprox import make_prox_local_update
from repro_torch.fl.models import build_task_model
from repro_torch.fl.schedulers import SCHEDULERS, RoundContext, _xla_mean
from repro_torch.fl.server import static_round_draws
from repro_torch.tree import tree_leaves

NEW_STRATEGIES = ("fedswap", "tthf", "gossip", "fedprox", "feddif_prox",
                  "d2d_random_walk")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ref_init(task="fcn", seed=0):
    return jax.tree.map(np.asarray, j_build(task).init(
        jax.random.PRNGKey(seed)))


# --------------------------------------------------------------- aggregation

@pytest.mark.parametrize("weights", [[3.0, 1.0], [120.0, 7.0, 55.0, 9.0],
                                     [1.0]])
def test_fedavg_matches_reference_bitwise(weights):
    """Weights normalized in float64 and cast to fp32, leaves accumulated
    in fp32 in list order: the same rounded products and sums."""
    trees = [_ref_init(seed=i) for i in range(len(weights))]
    want = jagg.fedavg([jax.tree.map(jnp.asarray, t) for t in trees],
                       weights)
    got = tagg.fedavg([params_from_numpy(t) for t in trees], weights)
    for a, b in zip(jax.tree.leaves(want),
                    jax.tree.leaves(params_to_numpy(got))):
        np.testing.assert_array_equal(b, np.asarray(a))
    with pytest.raises(ValueError, match="positive"):
        tagg.fedavg([params_from_numpy(trees[0])], [0.0])


def test_weight_distance_and_divergence_bound():
    a, b = _ref_init(seed=0), _ref_init(seed=1)
    want = jagg.weight_distance(a, b)
    got = tagg.weight_distance(params_from_numpy(a), params_from_numpy(b))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    args = (0.3, np.array([1.0, 2.0, 0.5]), 0.01, 0.7,
            np.array([0.2, 0.4, 0.1]), 5)
    assert tagg.divergence_bound(*args) == jagg.divergence_bound(*args)
    unit = (0.3, np.zeros(3), 0.01, 0.7, np.array([0.2]), 5)
    assert tagg.divergence_bound(*unit) == jagg.divergence_bound(*unit)


# ------------------------------------------------------------- local solvers

@pytest.mark.parametrize("prox", [False, True])
def test_local_session_matches_reference(prox):
    """One session of 6 steps (momentum reset, clip 10, lr 0.05) from the
    reference's init on the same batches; the proximal run (μ = 0.5)
    anchors at a second init, so the term is live from the first step.
    The first batch is scaled ×50, so the clip binds.  Params within
    atol 2e-6 / rtol 1e-5 (fp32 sums in another order), mean loss 1e-5."""
    rng = np.random.default_rng(3 + prox)
    batches = [{"x": rng.normal(size=(16, 64)).astype(np.float32),
                "y": rng.integers(0, 10, size=16).astype(np.int64)}
               for _ in range(6)]
    batches[0]["x"] *= 50.0
    init, anchor = _ref_init(seed=0), _ref_init(seed=1)
    jm, tm = j_build("fcn"), build_task_model("fcn")
    if prox:
        jp, jloss = j_prox_update(jm.loss, 0.5, 0.9)(
            jax.tree.map(jnp.asarray, init), batches, 0.05,
            jax.tree.map(jnp.asarray, anchor))
        tp, tloss = make_prox_local_update(tm.loss, 0.5, 0.9)(
            params_from_numpy(init), batches, 0.05, params_from_numpy(anchor))
    else:
        jp, jloss = j_local_update(jm.loss, 0.9)(
            jax.tree.map(jnp.asarray, init), batches, 0.05)
        tp, tloss = make_local_update(tm.loss, 0.9)(
            params_from_numpy(init), batches, 0.05)
    assert isinstance(tloss, torch.Tensor) and tloss.dim() == 0
    np.testing.assert_allclose(float(tloss), jloss, rtol=1e-5)
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(params_to_numpy(tp))):
        np.testing.assert_allclose(b, np.asarray(a), atol=2e-6, rtol=1e-5)


def test_prox_anchor_defaults_to_incoming_params():
    """Without an anchor the proximal term starts at zero: the first step
    equals the plain solver's."""
    rng = np.random.default_rng(9)
    batch = [{"x": rng.normal(size=(16, 64)).astype(np.float32),
              "y": rng.integers(0, 10, size=16).astype(np.int64)}]
    tm = build_task_model("fcn")
    p = params_from_numpy(_ref_init())
    a, _ = make_prox_local_update(tm.loss, 0.5)(p, batch, 0.05)
    b, _ = make_local_update(tm.loss)(p, batch, 0.05)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)
    empty_params, loss = make_local_update(tm.loss)(p, [], 0.05)
    assert empty_params is p and float(loss) == 0.0


# ------------------------------------------------------------------ schedules

def test_mixop_matrix_matches_reference():
    groups = (((0, 2, 5), (3.0, 1.0, 7.0)), ((1, 4), (0.2, 0.6)))
    want = JMixOp(groups).matrix(7)
    got = MixOp(groups).matrix(7)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-6)
    np.testing.assert_array_equal(got[3], np.eye(7, dtype=np.float32)[3])


@pytest.mark.parametrize("n", [*range(1, 201), 256, 500, 512, 1000, 1024,
                               2048, 4096])
def test_partition_mean_is_jnp_mean(n):
    """The partition IID mean of fedavg/stc/fedprox schedules: the
    reference's ``np.mean`` of a jax array is ``jnp.mean``, whose bits the
    port reproduces at every N (10 random vectors per N): an in-order sum
    up to 32 terms, XLA's windows of 32 beyond (``fig7_scaling``'s N = 64
    to 4096)."""
    rng = np.random.default_rng(n)
    for _ in range(10):
        x = (rng.random(n) * rng.random()).astype(np.float32)
        assert _xla_mean(x) == float(np.mean(jnp.asarray(x)))


def _ops_equal(a, b):
    assert type(a).__name__ == type(b).__name__
    if hasattr(a, "groups"):
        assert a.groups == b.groups
        return
    np.testing.assert_array_equal(a.train_mask, b.train_mask)
    if hasattr(a, "src_of_dst"):
        np.testing.assert_array_equal(a.src_of_dst, b.src_of_dst)
        assert a.compress == b.compress


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("strategy", NEW_STRATEGIES)
def test_new_schedules_match_reference(strategy, seed):
    """Four rounds of each new strategy (TT-HF's global MixOp in round 3),
    driven by the same control stream: identical ops, wire events,
    aggregation entries, flags and ledgers, and the streams left in step."""
    n = 6
    kw = dict(task="fcn", alpha=0.3, num_samples=900, data_seed=seed)
    _, _, part, _ = j_load(JSpec(fl=JConfig(num_clients=n, num_models=n),
                                 **kw), with_loaders=False)
    template = _ref_init()
    knobs = dict(strategy=strategy, num_clients=n, num_models=n,
                 tthf_cluster_size=4, random_walk_hops=3)
    jcfg, tcfg = JConfig(**knobs), FLConfig(**knobs)
    j_world = HostWorld.create("static", JTopology(num_pues=n), JChannel(), n)
    j_plan = JPlanner(JTopology(num_pues=n), JChannel(),
                      JAuction(model_bits=26122 * 32))
    t_plan = DiffusionPlanner(CellTopology(num_pues=n), ChannelModel(),
                              AuctionConfig(model_bits=26122 * 32))
    jl, tl = JLedger(), ResourceLedger()
    for t in range(4):
        jr = np.random.default_rng([seed, t])
        tr = np.random.default_rng([seed, t])
        pos = j_world.advance_round(jr)
        up = np.maximum(j_world.uplink_gamma(jr), 0.05)
        tpos, tup = static_round_draws(CellTopology(num_pues=n),
                                       ChannelModel(), tr, n)
        jctx = JContext(cfg=jcfg, t=t, dsi=part.dsi,
                        data_sizes=part.data_sizes, pos=pos, rng=jr,
                        up_gamma=up, topology=j_plan.topology,
                        channel=j_plan.channel, planner=j_plan,
                        model_bits=26122 * 32.0, param_template=template)
        tctx = RoundContext(cfg=tcfg, t=t, dsi=part.dsi,
                            data_sizes=part.data_sizes, pos=tpos, rng=tr,
                            up_gamma=tup, topology=t_plan.topology,
                            channel=t_plan.channel, planner=t_plan,
                            model_bits=26122 * 32.0,
                            param_template=params_from_numpy(template))
        js, ts = J_SCHEDULERS[strategy](jctx), SCHEDULERS[strategy](tctx)
        assert js.wire and ([dataclasses.astuple(e) for e in js.wire]
                            == [dataclasses.astuple(e) for e in ts.wire])
        assert [tuple(a) for a in js.agg] == [tuple(a) for a in ts.agg]
        assert (js.num_slots, js.agg_mode, js.persistent, js.stc_sparsity,
                js.diffusion_rounds, js.mean_iid) == (
            ts.num_slots, ts.agg_mode, ts.persistent, ts.stc_sparsity,
            ts.diffusion_rounds, ts.mean_iid)
        assert len(js.ops) == len(ts.ops)
        for a, b in zip(js.ops, ts.ops):
            _ops_equal(a, b)
        j_charge(jl, js)
        charge_schedule(tl, ts)
        assert jl.as_dict() == tl.as_dict()
        assert jr.random() == tr.random()


# -------------------------------------------------------------------- engine

def _plane(spec):
    return spec.mode, spec.planner


def test_presets_and_resolution_match_reference():
    assert set(ENGINE_PRESETS) <= set(J_PRESETS)
    for name, spec in ENGINE_PRESETS.items():
        spec.validate()
        assert _plane(spec) == _plane(J_PRESETS[name])
        assert spec.describe() == J_PRESETS[name].describe()
    for knobs in (dict(), dict(executor="fleet", planner="jax"),
                  dict(executor="host", engine="fleet"),
                  dict(executor="sharded", num_clients=8),
                  dict(engine="async"), dict(engine="sharded"),
                  dict(engine="auto"), dict(engine="auto", num_clients=128)):
        kw = dict(strategy="fedavg", num_clients=4, num_models=4)
        kw.update(knobs)
        assert (_plane(resolve_engine(FLConfig(**kw)))
                == _plane(j_resolve(JConfig(**kw))))
    with pytest.raises(ValueError, match="unknown engine preset"):
        EngineSpec.preset("warp")
    with pytest.raises(TypeError):
        resolve_engine(FLConfig(engine=3))
    assert FLConfig().executor == JConfig().executor == "host"


def test_auto_resolves_by_size_and_device_count():
    spec = EngineSpec(mode="auto")
    multi = torch.cuda.device_count() > 1
    assert spec.auto(8).mode == "fleet"
    assert spec.auto(128).mode == ("sharded" if multi else "fleet")
    assert EngineSpec(mode="sharded").auto(8).mode == "fleet"
    assert EngineSpec(mode="host").auto(1000).mode == "host"


@pytest.mark.parametrize("knobs,item", [
    (dict(engine="async"), None), (dict(executor="async"), None),
    (dict(engine="sharded"), "A12"),
    (dict(engine=EngineSpec(mode="async")), None)])
def test_unported_engines_raise(knobs, item):
    """``sharded`` raises naming A12; every spelling of the async engine
    (the preset, the legacy field, a bare spec) runs the buffered-async
    plane."""
    spec = ExperimentSpec(task="fcn", num_samples=400, fl=FLConfig(
        strategy="fedavg", rounds=1, num_clients=2, num_models=2, **knobs))
    if item is None:
        res = run_experiment(spec, device="cpu")
        assert res.engine.mode == "async"
        assert res.history.arrivals and res.history.parked_hops == [0]
        return
    with pytest.raises(NotImplementedError, match=item):
        run_experiment(spec, device="cpu")


def test_runresult_legacy_surface():
    hist = RunHistory(accuracy=[0.1, 0.5, 0.7], loss=[2.0, 1.0, 0.5],
                      round_wall_s=[0.1, 0.1, 0.1])
    res = RunResult(params={"w": torch.ones(2)}, ledger="L", history=hist,
                    planner_stats={"plans": 3})
    params, ledger, h = res
    assert ledger == "L" and h is hist and res.final_params is params
    assert res.accuracy == [0.1, 0.5, 0.7] and res.loss[-1] == 0.5
    assert res.rounds_to_accuracy(0.5) == 2
    assert res.rounds_to_accuracy(0.9) is None
    assert res.round_wall_s == [0.1, 0.1, 0.1]
    assert res.planner_stats == {"plans": 3}


# ---------------------------------------------------------------- plan cache

def _cache_spec(seed, planner="host"):
    fl = dict(strategy="feddif", rounds=2, num_clients=4, num_models=4,
              seed=seed, topology_seed=7, planner=planner)
    return (JSpec(task="fcn", alpha=0.3, num_samples=800,
                  fl=JConfig(**fl)),
            ExperimentSpec(task="fcn", alpha=0.3, num_samples=800,
                           fl=FLConfig(**fl)))


@pytest.mark.parametrize("planner", ["host", "jax"])
def test_plan_cache_replays_across_replicate_seeds(planner):
    """Two replicate seeds of one cell share a PlanCache: the second run
    hits on every round, plans nothing, and keeps the first run's
    ledger.  The keys are the reference's feddif_cache_key, and
    state_dict / load_state_dict round-trip the entries."""
    cache = PlanCache()
    j_spec, spec = _cache_spec(0, planner)
    first = run_experiment(spec, plan_cache=cache, device="cpu")
    assert cache.stats() == {"hits": 0, "misses": 2, "entries": 2}
    second = run_experiment(_cache_spec(1, planner)[1], plan_cache=cache,
                            device="cpu")
    assert cache.stats() == {"hits": 2, "misses": 2, "entries": 2}
    assert second.planner_stats["plans"] == 0
    assert first.planner_stats["plans"] == 2
    assert first.ledger.as_dict() == second.ledger.as_dict()
    assert first.diffusion_rounds == second.diffusion_rounds

    _, _, part, _ = j_load(j_spec, with_loaders=False)
    bits = 26122 * 32.0
    for t in range(2):
        want = j_cache_key(j_spec.fl, t, part.dsi, part.data_sizes, bits,
                           JAuction())
        got = feddif_cache_key(spec.fl, t, part.dsi, part.data_sizes, bits,
                               AuctionConfig())
        assert got == want and got in cache

    restored = PlanCache.from_state_dict(cache.state_dict())
    assert restored.stats() == cache.stats()
    for key in cache._store:
        (p1, s1), (p2, s2) = cache._store[key], restored._store[key]
        assert [dataclasses.astuple(h) for h in p1.hops] == [
            dataclasses.astuple(h) for h in p2.hops]
        assert p1.num_models == p2.num_models == 4
        np.testing.assert_array_equal(s1.dol, s2.dol)
        np.testing.assert_array_equal(s1.visited, s2.visited)


def test_plan_cache_is_lru_bounded():
    cache = PlanCache(max_entries=2)
    _, spec = _cache_spec(0)
    run_experiment(dataclasses.replace(spec, fl=dataclasses.replace(
        spec.fl, rounds=3)), plan_cache=cache, device="cpu")
    assert len(cache) == 2 and cache.misses == 3


# ---------------------------------------------------- the port's two planes

def _plane_spec(strategy, executor, rounds=2):
    return ExperimentSpec(
        task="fcn", alpha=0.3, num_samples=1200,
        fl=FLConfig(strategy=strategy, rounds=rounds, num_clients=5,
                    num_models=5, seed=0, topology_seed=3, executor=executor,
                    tthf_cluster_size=2, tthf_global_period=2))


@pytest.mark.parametrize("strategy", ["feddif", "fedavg", "fedswap",
                                      "gossip", "tthf"])
def test_port_host_fleet_parity(strategy):
    """The port's two planes, one init: equal ledgers, params within the
    reference's own host-vs-fleet bar (atol 2e-4, rtol 2e-3)."""
    init = _ref_init()
    runs = [run_experiment(_plane_spec(strategy, ex), device="cpu",
                           init_fn=lambda g: params_from_numpy(init))
            for ex in ("host", "fleet")]
    host, fleet = runs
    assert host.engine.mode == "host" and fleet.engine.mode == "fleet"
    assert host.ledger.as_dict() == fleet.ledger.as_dict()
    assert host.diffusion_rounds == fleet.diffusion_rounds
    np.testing.assert_allclose(host.iid_distance, fleet.iid_distance,
                               atol=1e-6)
    for a, b in zip(tree_leaves(host.final_params),
                    tree_leaves(fleet.final_params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4,
                                   rtol=2e-3)
    np.testing.assert_allclose(host.accuracy, fleet.accuracy, atol=0.05)
