"""The port's numpy control plane against the JAX package's, bit for bit.

Datasets, partitions, DSIs and loader batches; position and gain draws;
the float32 DoL math, the matching, hop lists and post-plan states of the
host planner; RoundSchedules and ledgers of the four ported strategies.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.channels.fading import ChannelModel as JChannel
from repro.channels.resources import ResourceLedger as JLedger
from repro.channels.resources import (outage_probability as j_outage,
                                      required_bandwidth as j_bw,
                                      spectral_efficiency as j_se)
from repro.channels.topology import CellTopology as JTopology
from repro.channels.world import HostWorld
from repro.core import dol as jdol
from repro.core.auction import AuctionConfig as JAuction
from repro.core.diffusion import DiffusionPlanner as JPlanner
from repro.core.matching import hungarian_min_cost as j_hungarian
from repro.core.schedule import charge_schedule as j_charge
from repro.fl import ExperimentSpec as JSpec
from repro.fl import FLConfig as JConfig
from repro.fl.experiment import load_experiment_data as j_load
from repro.fl.models import build_task_model as j_build
from repro.fl.schedulers import SCHEDULERS as J_SCHEDULERS
from repro.fl.schedulers import RoundContext as JContext
from repro_torch.channels.fading import ChannelModel
from repro_torch.channels.resources import (ResourceLedger,
                                            outage_probability,
                                            required_bandwidth,
                                            spectral_efficiency)
from repro_torch.channels.topology import CellTopology
from repro_torch.core import dol as tdol
from repro_torch.core.auction import AuctionConfig
from repro_torch.core.diffusion import DiffusionPlanner
from repro_torch.core.matching import hungarian_min_cost
from repro_torch.core.schedule import charge_schedule
from repro_torch.fl import ExperimentSpec, FLConfig, params_from_numpy
from repro_torch.fl.experiment import load_experiment_data
from repro_torch.fl.schedulers import SCHEDULERS, RoundContext
from repro_torch.fl.server import static_round_draws


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------- data

@pytest.mark.parametrize("alpha,clients,seed", [(0.3, 5, 0), (1.0, 8, 3),
                                                (0.1, 12, 7)])
def test_experiment_data_is_identical(alpha, clients, seed):
    kw = dict(task="fcn", alpha=alpha, num_samples=900, data_seed=seed)
    j_train, j_test, j_part, j_loaders = j_load(
        JSpec(fl=JConfig(num_clients=clients, num_models=clients), **kw))
    t_train, t_test, t_part, t_loaders = load_experiment_data(
        ExperimentSpec(fl=FLConfig(num_clients=clients, num_models=clients),
                       **kw))
    for a, b in ((j_train, t_train), (j_test, t_test)):
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.y, b.y)
    np.testing.assert_array_equal(j_part.dsi, t_part.dsi)
    np.testing.assert_array_equal(j_part.data_sizes, t_part.data_sizes)
    for a, b in zip(j_part.indices, t_part.indices):
        np.testing.assert_array_equal(a, b)
    # Two epochs of every client's loader, cyclic pad included.
    for jl, tl in zip(j_loaders, t_loaders):
        for _ in range(2):
            jb, tb = list(jl.epoch()), list(tl.epoch())
            assert len(jb) == len(tb)
            for a, b in zip(jb, tb):
                np.testing.assert_array_equal(a["x"], b["x"])
                np.testing.assert_array_equal(a["y"], b["y"])
        assert jl.epochs_drawn == tl.epochs_drawn


def test_loader_pads_small_shards_cyclically():
    from repro.data.pipeline import ClientLoader as JLoader
    from repro_torch.data.pipeline import ClientLoader
    x = np.arange(5, dtype=np.float32)[:, None]
    y = np.arange(5)
    jb = list(JLoader(x, y, 16, seed=4).epoch())
    tb = list(ClientLoader(x, y, 16, seed=4).epoch())
    assert len(tb) == 1 and tb[0]["x"].shape == (16, 1)
    np.testing.assert_array_equal(jb[0]["y"], tb[0]["y"])


# ------------------------------------------------------------------ channels

@pytest.mark.parametrize("seed", range(3))
def test_position_and_gain_draws_are_identical(seed):
    n = 9
    jt, tt = JTopology(num_pues=n), CellTopology(num_pues=n)
    jc, tc = JChannel(), ChannelModel()
    jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
    jp, tp = jt.sample_positions(jr, n), tt.sample_positions(tr, n)
    np.testing.assert_array_equal(jp, tp)
    jd, td = jt.pairwise_distances(jp), tt.pairwise_distances(tp)
    np.testing.assert_array_equal(jd, td)
    jg, tg = jc.sample_gains(jd, jr), tc.sample_gains(td, tr)
    np.testing.assert_array_equal(jg, tg)
    np.testing.assert_array_equal(jc.snr(jg), tc.snr(tg))
    se = j_se(jc.snr(jg))
    np.testing.assert_array_equal(se, spectral_efficiency(tc.snr(tg)))
    np.testing.assert_array_equal(j_bw(1e6, se), required_bandwidth(1e6, se))
    np.testing.assert_array_equal(j_outage(1.0, jc.snr(jg)),
                                  outage_probability(1.0, tc.snr(tg)))


@pytest.mark.parametrize("seed", range(3))
def test_static_world_round_draws_are_identical(seed):
    """The port's static round (positions, uplink γ) draws what the
    reference's HostWorld does, and leaves the stream at the same place."""
    n = 8
    world = HostWorld.create("static", JTopology(num_pues=n), JChannel(), n)
    jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(2):
        jp = world.advance_round(jr)
        jg = np.maximum(world.uplink_gamma(jr), 0.05)
        tp, tg = static_round_draws(CellTopology(num_pues=n), ChannelModel(),
                                    tr, n)
        np.testing.assert_array_equal(jp, tp)
        np.testing.assert_array_equal(jg, tg)
    assert jr.random() == tr.random()


def test_ledger_charges_are_identical():
    jl, tl = JLedger(), ResourceLedger()
    for led in (jl, tl):
        led.charge_d2d(1.3e6, 2.5)
        led.charge_uplink(8e5, 0.7)
        led.charge_downlink(1.3e6, 3.1, 10)
    assert jl.as_dict() == tl.as_dict()
    with pytest.raises(ValueError):
        tl.charge_d2d(1.0, 0.0)


# ------------------------------------------------------------------ DoL math

@pytest.mark.parametrize("c", [10, 4])
def test_dol_math_is_bit_identical(c):
    """The float32 Eq.-2 update and Eq.-B.1 norm agree with the reference's
    jnp float32 to the bit, for single DoLs and the (M, N) candidates."""
    rng = np.random.default_rng(c)
    m, n = 12, 9
    dol = rng.dirichlet(np.ones(c) * 0.5, m).astype(np.float32)
    chain = rng.integers(0, 4000, m).astype(np.float32)
    dsi = rng.dirichlet(np.ones(c) * 0.3, n).astype(np.float32)
    sizes = rng.integers(8, 900, n).astype(np.float64)
    np.testing.assert_array_equal(tdol.iid_distance(dol),
                                  np.asarray(jdol.iid_distance(dol)))
    np.testing.assert_array_equal(
        tdol.iid_distance_candidates(dol, chain, dsi, sizes),
        np.asarray(jdol.iid_distance_candidates(dol, chain, dsi, sizes)))
    jd, js = jdol.update_dol(dol[0], chain[0], dsi[1], float(sizes[1]))
    td, ts = tdol.update_dol(dol[0], chain[0], dsi[1], float(sizes[1]))
    np.testing.assert_array_equal(np.asarray(jd), td)
    assert float(js) == float(ts)


def test_hungarian_matches_reference():
    rng = np.random.default_rng(2)
    for shape in ((5, 5), (4, 9), (9, 4)):
        cost = rng.normal(size=shape)
        for a, b in zip(j_hungarian(cost), hungarian_min_cost(cost)):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------- planner

def _mkstate(mod, n, m, c, dsi, sizes):
    state = mod.DiffusionState.init(m, n, c)
    for mi in range(m):
        state.record_training(mi, mi % n, dsi[mi % n], float(sizes[mi % n]))
    return state


@pytest.mark.parametrize("seed", range(6))
def test_host_planner_hops_and_states_are_identical(seed):
    """tests/test_planner_jax.py's default config (ε=0.04, γ_min=1,
    N=M=C=10): identical hop lists, hop fields and post-plan states."""
    n = m = c = 10
    rng = np.random.default_rng(seed)
    dsi = rng.dirichlet(np.ones(c) * 0.5, n).astype(np.float32)
    sizes = rng.integers(200, 800, n).astype(np.float64)
    pos = JTopology().sample_positions(np.random.default_rng(seed + 50), n)

    st_j = _mkstate(jdol, n, m, c, dsi, sizes)
    plan_j = JPlanner().plan_communication_round(
        st_j, dsi, sizes, np.random.default_rng(seed + 7), positions=pos)
    st_t = _mkstate(tdol, n, m, c, dsi, sizes)
    plan_t = DiffusionPlanner().plan_communication_round(
        st_t, dsi, sizes, np.random.default_rng(seed + 7), positions=pos)

    assert plan_j.num_rounds == plan_t.num_rounds > 0
    assert ([dataclasses.astuple(h) for h in plan_j.hops]
            == [dataclasses.astuple(h) for h in plan_t.hops])
    assert plan_j.efficiency_per_round == plan_t.efficiency_per_round
    np.testing.assert_array_equal(plan_j.final_iid_distance,
                                  plan_t.final_iid_distance)
    for field in ("dol", "chain_size", "visited", "holder"):
        np.testing.assert_array_equal(getattr(st_j, field),
                                      getattr(st_t, field))
    assert st_j.round_index == st_t.round_index


def test_host_planner_respects_knobs():
    """max_rounds and allow_retraining reach the port's planner loop as they
    do the reference's."""
    n = m = c = 6
    rng = np.random.default_rng(4)
    dsi = rng.dirichlet(np.ones(c) * 0.2, n).astype(np.float32)
    sizes = rng.integers(100, 600, n).astype(np.float64)
    pos = JTopology().sample_positions(np.random.default_rng(9), n)
    for kw in (dict(max_rounds=2), dict(epsilon=0.0)):
        for retrain in (False, True):
            st_j = _mkstate(jdol, n, m, c, dsi, sizes)
            plan_j = JPlanner(auction=JAuction(allow_retraining=retrain),
                              **kw).plan_communication_round(
                st_j, dsi, sizes, np.random.default_rng(1), positions=pos)
            st_t = _mkstate(tdol, n, m, c, dsi, sizes)
            plan_t = DiffusionPlanner(
                auction=AuctionConfig(allow_retraining=retrain),
                **kw).plan_communication_round(
                st_t, dsi, sizes, np.random.default_rng(1), positions=pos)
            assert ([dataclasses.astuple(h) for h in plan_j.hops]
                    == [dataclasses.astuple(h) for h in plan_t.hops])


# ----------------------------------------------------------------- schedules

def _ops_equal(a, b):
    assert type(a).__name__ == type(b).__name__
    np.testing.assert_array_equal(a.train_mask, b.train_mask)
    if hasattr(a, "src_of_dst"):
        np.testing.assert_array_equal(a.src_of_dst, b.src_of_dst)
        assert a.compress == b.compress


@pytest.mark.parametrize("strategy", ["fedavg", "feddif", "stc",
                                      "feddif_stc"])
def test_round_schedules_and_ledgers_are_identical(strategy):
    """Two rounds of each ported strategy, driven by the same control
    stream: identical RoundSchedules and ResourceLedger.as_dict()."""
    n = 6
    kw = dict(task="fcn", alpha=0.3, num_samples=900)
    _, _, part, _ = j_load(JSpec(fl=JConfig(num_clients=n, num_models=n),
                                 **kw), with_loaders=False)
    template = jax.tree.map(np.asarray,
                            j_build("fcn").init(jax.random.PRNGKey(0)))
    jcfg = JConfig(strategy=strategy, num_clients=n, num_models=n)
    tcfg = FLConfig(strategy=strategy, num_clients=n, num_models=n)
    j_world = HostWorld.create("static", JTopology(num_pues=n), JChannel(), n)
    j_plan = JPlanner(JTopology(num_pues=n), JChannel(),
                      JAuction(model_bits=26122 * 32))
    t_plan = DiffusionPlanner(CellTopology(num_pues=n), ChannelModel(),
                              AuctionConfig(model_bits=26122 * 32))
    jl, tl = JLedger(), ResourceLedger()
    for t in range(2):
        jr = np.random.default_rng([5, t])
        tr = np.random.default_rng([5, t])
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
        assert not js.persistent
        assert (js.agg_mode, js.stc_sparsity, js.diffusion_rounds,
                js.mean_iid) == (ts.agg_mode, ts.stc_sparsity,
                                 ts.diffusion_rounds, ts.mean_iid)
        assert len(js.ops) == len(ts.ops)
        for a, b in zip(js.ops, ts.ops):
            _ops_equal(a, b)
        j_charge(jl, js)
        charge_schedule(tl, ts)
        assert jl.as_dict() == tl.as_dict()
        assert jr.random() == tr.random()       # streams left in step
