"""The evolving wireless world, churn and the energy cap in the port, against
``repro`` (CPU).

* ``HostWorld`` per scenario round for round against the reference's:
  positions, waypoints, serving cells, interference, the uplink γ and the
  planner's float32 world; ``HostWorld("static")`` draws exactly
  ``static_round_draws``' stream (the degeneracy contract of
  ``tests/test_world.py``); the device step against the reference's jitted
  ``step`` bit for bit; ``per_client_energy_j``;
* the churn masks of ``apply_round_churn`` (their own stream) and
  ``apply_energy_cap``, its all-depleted case included;
* each scenario on both planners and both planes against the reference's
  runs from its init: ledgers equal (``energy_j`` included), params within
  atol 2e-4 / rtol 2e-3, accuracy within 0.05; churned runs too;
* mobile and energy-capped runs killed at a round checkpoint and resumed
  bit-equal to uninterrupted ones, from the world the checkpoint saved;
* the seed-stacked engine's refusals and ``_pick_engine``'s routing, and
  the ``fig_scenarios`` and ``fig7_scaling`` smoke grids against the
  reference's on the loop engine.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.experiments as jexp
from repro.channels import world as jworld
from repro.channels.fading import ChannelModel as JChannel
from repro.channels.topology import CellTopology as JTopology
from repro.core.schedule import RoundSchedule as JSchedule
from repro.core.schedule import TrainOp as JTrainOp
from repro.core.schedule import WireEvent as JWire
from repro.core.diffusion import PlanCache as JPlanCache
from repro.experiments import orchestrator as jorch
from repro.channels.resources import (
    spectral_efficiency_jax as j_spectral_efficiency)
from repro.core.planner import (
    device_gamma_sequence as j_device_gamma_sequence)
from repro.fl import schedulers as jsched
from repro.fl.server import _uplink_gamma as j_uplink_gamma
from repro.fl.models import build_task_model as j_build
import repro_torch.experiments as texp
from repro_torch.channels import world as tworld
from repro_torch.channels.resources import GAMMA_FLOOR
from repro_torch.channels.fading import ChannelModel
from repro_torch.channels.topology import CellTopology
from repro_torch.core.diffusion import PlanCache
from repro_torch.core.planner import device_gamma_sequence
from repro_torch.core.schedule import (PermuteOp, RoundSchedule, TrainOp,
                                       WireEvent, apply_churn)
from repro_torch.experiments import artifacts as tart
from repro_torch.experiments import orchestrator as torch_orch
from repro_torch.experiments.replicate import run_replicates_vmapped
from repro_torch.fl import ExperimentSpec, FLConfig, params_from_numpy
from repro_torch.fl import run_experiment
from repro_torch.fl import schedulers as tsched
from repro_torch.fl.resume import Preempted, RoundCheckpointer
from repro_torch.fl.server import static_round_draws
from repro_torch.train.checkpoint import load_metadata
from repro.experiments import artifacts as jart
from test_torch_appendix import assert_runs_match, run_both

SCENARIOS = ("mobile", "multicell", "energy_capped")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -------------------------------------------------------------- the world

@pytest.mark.parametrize("scenario", ("static",) + SCENARIOS)
def test_host_world_matches_reference(scenario):
    n = 7
    j = jworld.HostWorld.create(scenario, JTopology(num_pues=n), JChannel(),
                                n, energy_budget_j=0.3)
    t = tworld.HostWorld.create(scenario, CellTopology(num_pues=n),
                                ChannelModel(), n, energy_budget_j=0.3)
    assert t.has_energy_cap == j.has_energy_cap
    for r in range(4):
        jr, tr = (np.random.default_rng([5, r]) for _ in range(2))
        _eq(t.advance_round(tr), j.advance_round(jr))
        _eq(t.state.waypoints, j.state.waypoints)
        _eq(t.state.serving, j.state.serving)
        _eq(t.interference(), j.interference())
        _eq(t.uplink_gamma(tr), j.uplink_gamma(jr))
        pw, jw = t.planner_world(), j.planner_world()
        assert (pw is None) == (jw is None)
        if pw is not None:
            for a, b in zip(pw, jw):
                _eq(a, b)
        spend = np.linspace(0.0, 0.2, n)
        t.charge_energy(spend)
        j.charge_energy(spend)
        _eq(t.depleted(), j.depleted())
        assert t.rounds_advanced == j.rounds_advanced


def test_static_world_draws_the_static_stream():
    """The degeneracy contract: ``HostWorld("static")`` and so
    ``static_round_draws`` consume exactly the raw draws of the control
    plane before the world (``sample_positions``, then one Rayleigh uplink
    draw each, as the reference's ``_uplink_gamma`` makes them), and leave
    the stream where those leave it."""
    n = 9
    topo, chan = CellTopology(num_pues=n), ChannelModel()
    jtopo, jchan = JTopology(num_pues=n), JChannel()
    w = tworld.HostWorld.create("static", topo, chan, n)
    for r in range(3):
        a, b, c = (np.random.default_rng([2, r]) for _ in range(3))
        pos = jtopo.sample_positions(a, n)
        up = j_uplink_gamma(jchan, pos, a)
        _eq(w.advance_round(b), pos)
        _eq(w.uplink_gamma(b), up)
        spos, sup = static_round_draws(topo, chan, c, n)
        _eq(spos, pos)
        _eq(sup, np.maximum(up, GAMMA_FLOOR))
        assert a.random() == b.random() == c.random()
    assert w.interference() == 0.0 and w.planner_world() is None
    assert not w.has_energy_cap and not w.depleted().any()


def test_device_gamma_sequence_against_reference():
    """``device_gamma_sequence``: float32 (R, N, N) on ``dist``'s device;
    on torch's own Exp(1) draws its γ is the reference's float32 Eqs.
    12–14 (jitted) within 2e-6 relative, and over many rounds its
    per-link mean and spread are those of the reference's
    ``device_gamma_sequence`` on its own key (the streams differ)."""
    rng = np.random.default_rng(0)
    n = 6
    pos = rng.uniform(-250, 250, (n, 2))
    dist = np.linalg.norm(pos[:, None] - pos[None], axis=-1).astype(
        np.float32)
    chan, jchan = ChannelModel(), JChannel()
    got = device_gamma_sequence(chan, torch.Generator().manual_seed(3),
                                torch.from_numpy(dist), 5)
    assert got.shape == (5, n, n) and got.dtype == torch.float32
    assert got.device == torch.device("cpu")
    h2 = torch.empty((5, n, n)).exponential_(
        1.0, generator=torch.Generator().manual_seed(3))
    want = jax.jit(lambda d, h: j_spectral_efficiency(jchan.snr_jax(
        10.0 ** (jchan.large_scale_db_jax(d) / 10.0) * h)))(
            jnp.asarray(dist), jnp.asarray(h2.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                               atol=0)
    rounds = 4000
    big = device_gamma_sequence(chan, torch.Generator().manual_seed(1),
                                torch.from_numpy(dist), rounds).numpy()
    ref = np.asarray(j_device_gamma_sequence(
        jchan, jax.random.PRNGKey(1), jnp.asarray(dist), rounds))
    np.testing.assert_allclose(big.mean(0), ref.mean(0), rtol=0.02)
    np.testing.assert_allclose(big.std(0), ref.std(0), atol=0.15)


def test_device_step_matches_reference_jit():
    rng = np.random.default_rng(0)
    for n in (5, 20):
        pos = rng.uniform(-250, 250, (n, 2)).astype(np.float32)
        way = rng.uniform(-250, 250, (n, 2)).astype(np.float32)
        way[0] = pos[0] + 3.0                   # arrives within the step
        jw = jworld.WorldState(jnp.asarray(pos), jnp.asarray(way),
                               jnp.zeros(n, jnp.int32), jnp.zeros(n),
                               jnp.int32(0))
        tw = tworld.WorldState(torch.from_numpy(pos), torch.from_numpy(way),
                               None, None, 0)
        step = jax.jit(lambda w: jworld.step(w, step_m=15.0))
        for _ in range(3):
            jw, tw = step(jw), tworld.step(tw, step_m=15.0)
            _eq(tw.positions.numpy(), jw.positions)
        assert tw.t == 3
        gen = torch.Generator().manual_seed(0)
        keyed = tworld.step(tw, gen, step_m=15.0)
        assert keyed.positions.shape == (n, 2)
        moved = ~torch.all(keyed.waypoints == tw.waypoints, dim=-1)
        assert bool(moved[0]) and int(moved.sum()) < n


def test_cell_centers_interference_and_energy_split():
    cfg = tworld.WorldConfig(scenario="multicell", num_cells=4)
    jcfg = jworld.WorldConfig(scenario="multicell", num_cells=4)
    _eq(tworld.cell_centers(cfg, 250.0), jworld.cell_centers(jcfg, 250.0))
    pos = np.random.default_rng(1).uniform(-600, 600, (6, 2))
    serving = np.array([0, 1, 2, 3, 0, 1], np.int32)
    _eq(tworld.receiver_interference_w(pos, serving,
                                       tworld.cell_centers(cfg, 250.0),
                                       ChannelModel()),
        jworld.receiver_interference_w(pos, serving,
                                       jworld.cell_centers(jcfg, 250.0),
                                       JChannel()))
    wire = [("downlink", 1e6, 3.0, -1), ("uplink", 1e6, 2.5, 1),
            ("d2d", 5e5, 7.0, 2), ("d2d", 5e5, 0.0, 1),
            ("uplink", 2e6, 1.0, 4)]
    tsch = RoundSchedule(5, [], [WireEvent(k, b, g, src=s)
                                 for k, b, g, s in wire], [])
    jsch = JSchedule(5, [], [JWire(k, b, g, src=s) for k, b, g, s in wire],
                     [])
    _eq(tworld.per_client_energy_j(tsch, 5, 180e3),
        jworld.per_client_energy_j(jsch, 5, 180e3))
    with pytest.raises(ValueError, match="unknown scenario"):
        tworld.WorldConfig(scenario="orbit")


# ---------------------------------------------------------- churn, energy

def _ctx(mod, t=0, **cfg):
    return mod.RoundContext(cfg=FLConfig(**cfg), t=t, dsi=None,
                            data_sizes=None, pos=None, rng=None,
                            up_gamma=None, topology=None, channel=None,
                            planner=None, model_bits=0.0,
                            param_template=None)


def _schedule(n, mod_train, mod_sched):
    return mod_sched(num_slots=n, ops=[mod_train(np.ones(n, bool))], wire=[],
                     agg=[(i, float(i + 1)) for i in range(n)])


@pytest.mark.parametrize("seed,topo", [(0, None), (1, 3), (2, 11)])
def test_churn_masks_match_reference(seed, topo):
    n = 12
    for t in range(4):
        kw = dict(t=t, num_clients=n, num_models=n, churn_rate=0.3,
                  seed=seed, topology_seed=topo)
        tc, jc = _ctx(tsched, **kw), _ctx(jsched, **kw)
        got = tsched.apply_round_churn(tc, _schedule(n, TrainOp,
                                                     RoundSchedule))
        want = jsched.apply_round_churn(jc, _schedule(n, JTrainOp,
                                                      JSchedule))
        _eq(got.ops[0].train_mask, want.ops[0].train_mask)
        assert got.agg == want.agg
    tc = _ctx(tsched, num_clients=n, churn_rate=0.0)
    sched = _schedule(n, TrainOp, RoundSchedule)
    assert tsched.apply_round_churn(tc, sched) is sched


def test_apply_churn_and_energy_cap():
    n = 4
    perm = PermuteOp(np.array([1, 0, 2, 3]), np.array([True, True, False,
                                                       True]))
    sched = RoundSchedule(n, [TrainOp(np.ones(n, bool)), perm],
                          [WireEvent("d2d", 1.0, 2.0, src=0)],
                          [(0, 1.0), (1, 2.0), (3, 4.0)])
    drop = np.array([True, False, False, True])
    out = apply_churn(sched, drop)
    _eq(out.ops[0].train_mask, ~drop)
    _eq(out.ops[1].train_mask, [False, True, False, False])
    _eq(out.ops[1].src_of_dst, perm.src_of_dst)
    assert out.agg == [(1, 2.0)] and out.wire == sched.wire
    ctx = _ctx(tsched, num_clients=n)
    assert tsched.apply_energy_cap(ctx, sched, np.zeros(n, bool)) is sched
    _eq(tsched.apply_energy_cap(ctx, sched, drop).ops[0].train_mask, ~drop)
    # Every aggregating client depleted: the round is left as it was.
    assert tsched.apply_energy_cap(ctx, sched, np.ones(n, bool)) is sched


# ------------------------------------------------------------ scenario runs

@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("executor,planner", [("host", "host"),
                                              ("fleet", "host"),
                                              ("fleet", "jax")])
def test_scenario_runs_match_reference(scenario, executor, planner):
    ref, port = run_both(executor, planner, strategy="feddif",
                         scenario=scenario, num_clients=5, num_models=5)
    assert_runs_match(ref, port)
    assert port.ledger.energy_j > 0.0


@pytest.mark.parametrize("executor,kw", [
    ("host", dict(strategy="fedavg", scenario="multicell")),
    ("fleet", dict(strategy="d2d_random_walk", scenario="mobile")),
    ("host", dict(strategy="feddif", churn_rate=0.3)),
    ("fleet", dict(strategy="fedavg", churn_rate=0.3)),
    ("fleet", dict(strategy="feddif", scenario="energy_capped",
                   energy_budget_j=0.15, rounds=3))],
    ids=["fedavg-multicell", "walk-mobile", "feddif-churn",
         "fedavg-churn", "feddif-energy-binding"])
def test_world_and_churn_runs_match_reference(executor, kw):
    assert_runs_match(*run_both(executor, **kw))


def test_energy_budget_binds():
    """A budget of a hop or two drops depleted clients from later rounds:
    fewer trained slots than the uncapped run, the same wire charged."""
    base = dict(strategy="feddif", rounds=3, num_clients=6, num_models=6,
                topology_seed=3, scenario="energy_capped")
    spec = ExperimentSpec(task="fcn", alpha=0.3, num_samples=900,
                          fl=FLConfig(energy_budget_j=0.15, **base))
    capped = run_experiment(spec, device="cpu")
    free = run_experiment(dataclasses.replace(spec, fl=FLConfig(
        energy_budget_j=1e9, **base)), device="cpu")
    assert capped.ledger.subframes == free.ledger.subframes
    assert capped.accuracy != free.accuracy


# ------------------------------------------------------------------ resume

def _world_spec(scenario, **kw):
    fl = dict(strategy="feddif", num_clients=5, num_models=5, rounds=4,
              topology_seed=7, executor="fleet", checkpoint_every=1,
              scenario=scenario)
    fl.update(kw)
    return ExperimentSpec(task="logistic", num_samples=500, fl=FLConfig(**fl))


def _same(a, b):
    assert a.accuracy == b.accuracy and a.loss == b.loss
    assert a.ledger == b.ledger and a.diffusion_rounds == b.diffusion_rounds
    for x, y in zip(jax.tree.leaves(a.final_params),
                    jax.tree.leaves(b.final_params)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("scenario,kw", [
    ("mobile", {}), ("mobile", dict(topology_seed=None)),
    ("energy_capped", dict(energy_budget_j=0.05)),
    ("mobile", dict(planner="jax"))],
    ids=["mobile", "mobile-no-topology-seed", "energy-binding",
         "mobile-device-planner"])
def test_world_runs_resume_bit_equal(scenario, kw, tmp_path, monkeypatch):
    spec = _world_spec(scenario, **kw)
    clean = run_experiment(spec, device="cpu",
                           checkpoint_dir=str(tmp_path / "clean"))
    d = str(tmp_path / "killed")
    with monkeypatch.context() as m:
        m.setattr(RoundCheckpointer, "fail_after_save", 2)
        with pytest.raises(Preempted):
            run_experiment(spec, device="cpu", checkpoint_dir=d)
    assert load_metadata(d, 2)["world"]["rounds_advanced"] == 2
    _same(clean, run_experiment(spec, device="cpu", checkpoint_dir=d))


# ------------------------------------------------------ the sweep layer

def _cell(name, **fl):
    return texp.expand_sweep(name, smoke=True)[0].with_fl(**fl)


@pytest.mark.parametrize("fl,match", [
    (dict(churn_rate=0.1), "churn"), (dict(scenario="mobile"), "static"),
    (dict(scenario="energy_capped"), "static")])
def test_seed_stacked_engine_refuses_churn_and_worlds(fl, match):
    spec = _cell("fig3_alpha", topology_seed=1, **fl).spec
    with pytest.raises(ValueError, match=match):
        run_replicates_vmapped(spec, (0, 1), device="cpu")


def test_seed_stacked_engine_takes_metric_and_underlay():
    """``metric`` and ``underlay`` reach the stacked engine's planner: its
    ledgers equal the loop engine's."""
    cell = next(c for c in texp.expand_sweep("fig3_alpha", smoke=True,
                                             num_samples=300)
                if c.strategy == "feddif")
    cell = cell.with_fl(metric="jsd", underlay=True, rounds=1,
                        topology_seed=1)
    stacked = run_replicates_vmapped(cell.spec, (0, 1), device="cpu")
    loop = texp.run_cell(cell, (0,), engine="loop", device="cpu")
    led = stacked[0].ledger
    assert led.as_dict() == stacked[1].ledger.as_dict()
    assert loop["comm"]["subframes"] == led.subframes
    assert loop["comm"]["pusch_bandwidth_hz_s"] == led.bandwidth_hz_s
    assert loop["diffusion_rounds"] == stacked[0].diffusion_rounds


@pytest.mark.parametrize("name", ["fig_scenarios", "fig7_scaling"])
def test_pick_engine_routes_worlds_and_churn_to_the_loop(name):
    for smoke in (True, False):
        jcells = jexp.expand_sweep(name, smoke=smoke)
        for cell in texp.expand_sweep(name, smoke=smoke):
            want = jorch._pick_engine(
                next(c for c in jcells if c.label == cell.label), "auto")
            got = torch_orch._pick_engine(cell, "auto", 2)
            assert got == want
            if cell.spec.fl.scenario != "static" or cell.spec.fl.churn_rate:
                assert got == "loop"


def test_preplanner_skips_worlds_as_the_reference_does():
    """Only the static FedDif cell of fig_scenarios' smoke grid is
    pre-planned; the world cells plan cell by cell inside their runs."""
    kw = dict(smoke=True, num_samples=400, topology_seed=5)
    tcells = [c.with_fl(planner="jax")
              for c in texp.expand_sweep("fig_scenarios", **kw)]
    jcells = [c.with_fl(planner="jax")
              for c in jexp.expand_sweep("fig_scenarios", **kw)]
    got = torch_orch.prepopulate_plan_cache(tcells, PlanCache(),
                                            device="cpu")
    want = jorch.prepopulate_plan_cache(jcells, JPlanCache())
    for k in ("planned", "skipped", "batches"):
        assert got[k] == want[k], k
    assert got["planned"] == 2 and got["skipped"] == 8


SWEEPS = [("fig_scenarios", 600), ("fig7_scaling", 700)]


@pytest.mark.parametrize("name,samples", SWEEPS,
                         ids=[s[0] for s in SWEEPS])
def test_world_sweeps_match_reference(name, samples):
    kw = dict(smoke=True, seeds=(0,), out_dir=None, executor="host",
              planner="host", num_samples=samples)

    def init_for(spec):
        init = jax.tree.map(np.asarray, j_build(
            spec.task, spec.dim, spec.num_classes).init(
                jax.random.PRNGKey(spec.fl.seed)))
        return lambda gen: params_from_numpy(init)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jexp.run_sweep(name, engine="loop", **kw)
    got = texp.run_sweep(name, engine="loop", device="cpu",
                         init_for=init_for, **kw)
    g, w = tart.strip_volatile(got), jart.strip_volatile(want)
    assert g["failed_cells"] == [] and len(g["cells"]) == len(w["cells"])
    for gc, wc in zip(g["cells"], w["cells"]):
        for k in ("label", "value", "strategy", "comm", "diffusion_rounds"):
            assert gc[k] == wc[k], (gc["label"], k)
        np.testing.assert_allclose(gc["iid_distance"], wc["iid_distance"],
                                   atol=1e-6)
        np.testing.assert_allclose(gc["accuracy"], wc["accuracy"],
                                   atol=0.05)
