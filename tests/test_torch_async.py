"""The buffered-async round plane in the port, against ``repro``.

* ``annotate_arrivals`` bit for bit on planted schedules (train, hops,
  mixes) with and without a hop deadline; the population's traits and
  cohorts bit for bit;
* every contract of ``tests/test_async_plane.py`` on the port: degeneracy
  (K = all, zero delays, no discount) to the host executor at N = 20 for
  fedavg and feddif, under churn, and on the fleet inner plane; the
  refusals; the renormalising discount; the zero-weight tick; determinism;
  barrier against buffered; kill/resume with contributions pending (both
  inner planes, and the port finishing a run the reference's checkpoint
  left with a pending queue); the changed-engine refusal; hop parking; the
  population run;
* whole async runs against the reference's, fed the reference's init:
  ledgers, virtual clock, arrivals, staleness and parked hops equal;
  params within atol 2e-4 / rtol 2e-3; accuracy within 0.05;
* a contribution pending across two later rounds shares no storage with
  them and reaches its tick with the bits it left its slot with, on each
  inner plane;
* the engine fingerprints and ``RunResult.time_to_accuracy``.
"""
import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.core import schedule as jsched
from repro.fl import ExperimentSpec as JSpec
from repro.fl import FLConfig as JConfig
from repro.fl import run_experiment as j_run
from repro.fl.engine import ENGINE_PRESETS as J_PRESETS
from repro.fl.engine import AsyncSpec as JAsyncSpec
from repro.fl.engine import EngineSpec as JEngineSpec
from repro.fl.models import build_task_model as j_build
from repro.fl.population import Population as JPopulation
from repro_torch.core import schedule as tsched
from repro_torch.fl import (ExperimentSpec, FLConfig, params_from_numpy,
                            params_to_numpy, run_experiment)
from repro_torch.fl import async_plane, executors
from repro_torch.fl.engine import (ENGINE_PRESETS, AsyncSpec, EngineSpec,
                                   RunHistory, RunResult)
from repro_torch.fl.population import Population
from repro_torch.fl.resume import Preempted, RoundCheckpointer
from repro_torch.tree import tree_leaves


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _spec(strategy="fedavg", n=4, rounds=2, engine=None, samples=600,
          **fl_kw):
    return ExperimentSpec(
        task="fcn", alpha=0.5, num_samples=samples,
        fl=FLConfig(strategy=strategy, rounds=rounds, num_clients=n,
                    num_models=n, seed=0, topology_seed=0, eval_every=1,
                    engine=engine, **fl_kw))


def _run(spec, **kw):
    return run_experiment(spec, device="cpu", **kw)


def _trees_equal(a, b):
    return all(torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


_DEGENERATE = EngineSpec(mode="async", data_plane="host")
_BUFFERED = AsyncSpec(buffer_k=2, staleness_beta=0.5, delay_scale=0.01,
                      delay_sigma=1.0)


# ------------------------------------------------ schedules and population

def _planted(rng, c, pkg):
    """A schedule of a TrainOp, two PermuteOps and a MixOp in ``pkg``'s
    classes (the reference's or the port's)."""
    group = max(1, c // 2)
    ops = [pkg.TrainOp(rng.random(c) < 0.8),
           pkg.PermuteOp(rng.permutation(c), rng.random(c) < 0.7),
           pkg.PermuteOp(rng.permutation(c), rng.random(c) < 0.7),
           pkg.MixOp(((tuple(range(group)), tuple([1.0] * group)),))]
    agg = [(s, float(w)) for s, w in enumerate(rng.integers(1, 9, c))]
    return pkg.RoundSchedule(num_slots=c, ops=ops, wire=[], agg=agg)


@pytest.mark.parametrize("deadline", [None, 0.05, 1e-9])
def test_annotate_arrivals_matches_reference(deadline):
    for c in (1, 2, 5, 8, 16):
        for trial in range(4):
            seed = 97 * c + trial
            jsch = _planted(np.random.default_rng(seed), c, jsched)
            tsch = _planted(np.random.default_rng(seed), c, tsched)
            rng = np.random.default_rng(seed + 1)
            fields = dict(train_s=rng.exponential(0.02, c),
                          hop_s=rng.exponential(0.03, (c, c)),
                          uplink_s=rng.exponential(0.01, c))
            j2, jarr, jpark = jsched.annotate_arrivals(
                jsch, jsched.ArrivalModel(**fields), hop_deadline_s=deadline)
            t2, tarr, tpark = tsched.annotate_arrivals(
                tsch, tsched.ArrivalModel(**fields), hop_deadline_s=deadline)
            assert np.array_equal(tarr, jarr) and tpark == jpark
            assert (t2 is tsch) == (j2 is jsch)
            for a, b in zip(t2.ops, j2.ops):
                if hasattr(b, "train_mask"):
                    assert np.array_equal(a.train_mask, b.train_mask)
    zero = tsched.ArrivalModel.zeros(3)
    assert zero.hop_s.shape == (3, 3) and not zero.train_s.any()


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_population_cohorts_match_reference(seed):
    for size, shards in ((500, 10), (10_000, 16), (16, 16)):
        tp, jp = Population(size, shards, seed=seed), JPopulation(
            size, shards, seed=seed)
        assert np.array_equal(tp.availability, jp.availability)
        assert np.array_equal(tp.speed, jp.speed)
        for t in (0, 1, 7, 1000):
            for k in (1, 4, min(16, size), size):
                a, b = tp.sample_cohort(t, k), jp.sample_cohort(t, k)
                assert np.array_equal(a.users, b.users)
                assert np.array_equal(a.shards, b.shards)
                assert np.array_equal(a.speed, b.speed)


def test_population_cohorts_are_deterministic_and_availability_weighted():
    pop = Population(size=500, num_shards=10, seed=3)
    a = pop.sample_cohort(t=7, k=20)
    b = pop.sample_cohort(t=7, k=20)
    assert np.array_equal(a.users, b.users)
    assert len(set(a.users.tolist())) == 20
    assert np.array_equal(a.shards, pop.shard_of(a.users))
    assert a.shards.max() < 10 and a.users.max() < 500
    assert not np.array_equal(a.users, pop.sample_cohort(t=8, k=20).users)
    counts = np.zeros(500)
    for t in range(300):
        counts[pop.sample_cohort(t=t, k=20).users] += 1
    hi = pop.availability > np.quantile(pop.availability, 0.8)
    lo = pop.availability < np.quantile(pop.availability, 0.2)
    assert counts[hi].mean() > 2.0 * counts[lo].mean()


# ------------------------------------------------------ degeneracy contract

@pytest.mark.parametrize("strategy", ["fedavg", "feddif"])
def test_degenerate_async_bit_identical_to_host_n20(strategy):
    """K = all, zero delays, no discount, host inner plane: the event queue
    replays the sync host executor bit for bit at N = 20."""
    host = _run(_spec(strategy, n=20))
    async_ = _run(_spec(strategy, n=20, engine=_DEGENERATE))
    assert _trees_equal(host.params, async_.params)
    assert host.ledger.as_dict() == async_.ledger.as_dict()
    assert host.accuracy == async_.accuracy
    assert host.history.diffusion_rounds == async_.history.diffusion_rounds
    assert async_.history.virtual_s == [0.0, 0.0]
    assert async_.history.arrivals == [20, 20]
    assert all(s == 0.0 for s in async_.history.staleness)
    assert async_.history.parked_hops == [0, 0]


@pytest.mark.parametrize("strategy", ["fedavg", "feddif"])
def test_degenerate_async_on_the_fleet_plane(strategy):
    """The fleet inner plane: equal ledgers and curves' length to the fleet
    executor; params within the fleet plane's bar (its Eq. 11 is one
    ``mix_tree`` call, the tick's is ``fedavg``)."""
    fleet = _run(_spec(strategy, n=8, executor="fleet"))
    async_ = _run(_spec(strategy, n=8, engine=EngineSpec(
        mode="async", data_plane="fleet")))
    assert fleet.ledger.as_dict() == async_.ledger.as_dict()
    assert fleet.history.diffusion_rounds == async_.history.diffusion_rounds
    for a, b in zip(tree_leaves(fleet.params), tree_leaves(async_.params)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=2e-4,
                                   rtol=2e-3)
    np.testing.assert_allclose(async_.accuracy, fleet.accuracy, atol=0.05)
    assert async_.history.virtual_s == [0.0, 0.0]


def test_degenerate_async_matches_under_churn():
    host = _run(_spec("fedavg", n=6, churn_rate=0.3))
    async_ = _run(_spec("fedavg", n=6, churn_rate=0.3, engine=_DEGENERATE))
    assert _trees_equal(host.params, async_.params)
    assert host.ledger.as_dict() == async_.ledger.as_dict()


def test_async_rejects_persistent_and_delta_strategies():
    for strategy in ("gossip", "tthf", "stc"):
        with pytest.raises(ValueError, match="buffered-async"):
            _run(_spec(strategy, engine=_DEGENERATE))


# ------------------------------------------------ staleness normalization

def _contribs(rng, k, value=7.5, weight=None):
    return [async_plane._Contribution(
        arrival_s=float(rng.random()), seq=i, round=int(rng.integers(0, 5)),
        slot=i, weight=float(rng.uniform(0.1, 10.0)
                             if weight is None else weight),
        tree={"w": torch.full((3,), value)}) for i in range(k)]


def test_discounted_weights_renormalize_to_one():
    rng = np.random.default_rng(0)
    b = AsyncSpec(staleness_alpha=0.7, staleness_beta=1.3)
    for _ in range(25):
        popped = _contribs(rng, int(rng.integers(1, 9)))
        tick = 6
        out, stale = async_plane._discounted_fedavg(popped, tick, b)
        np.testing.assert_allclose(out["w"].numpy(), 7.5, rtol=1e-6)
        assert stale == np.mean([tick - c.round for c in popped])
        w = np.array([c.weight * b.discount(tick - c.round) for c in popped])
        np.testing.assert_allclose((w / w.sum()).sum(), 1.0, rtol=1e-12)


def test_zero_weight_tick_leaves_global_unchanged():
    popped = [async_plane._Contribution(
        arrival_s=0.0, seq=i, round=0, slot=i, weight=0.0,
        tree={"w": torch.ones(2)}) for i in range(3)]
    out, stale = async_plane._discounted_fedavg(popped, 1, AsyncSpec())
    assert out is None and stale == 1.0


def test_zero_staleness_discount_is_exactly_unity():
    b = AsyncSpec(staleness_alpha=1.0, staleness_beta=0.9)
    for w in np.random.default_rng(1).uniform(0.01, 100.0, 50):
        assert w * b.discount(0) == w
    assert b.discount(3) == JAsyncSpec(staleness_alpha=1.0,
                                       staleness_beta=0.9).discount(3)
    for m in (1, 3, 8, 17):
        for spec in (AsyncSpec(buffer_k=5), AsyncSpec(buffer_frac=0.5),
                     AsyncSpec()):
            jspec = JAsyncSpec(buffer_k=spec.buffer_k,
                               buffer_frac=spec.buffer_frac)
            assert spec.resolve_k(m) == jspec.resolve_k(m)


# ------------------------------------------------- event-queue determinism

def test_event_queue_deterministic_across_runs():
    spec = _spec("fedavg", n=6, rounds=3, engine="async", churn_rate=0.05)
    r1, r2 = _run(spec), _run(spec)
    assert r1.history.virtual_s == r2.history.virtual_s
    assert r1.history.arrivals == r2.history.arrivals
    assert r1.history.staleness == r2.history.staleness
    assert r1.accuracy == r2.accuracy
    assert _trees_equal(r1.params, r2.params)


def test_buffered_async_diverges_from_barrier_but_charges_same_ledger():
    barrier = _run(_spec("fedavg", n=6, rounds=3, engine="async_barrier"))
    buffered = _run(_spec("fedavg", n=6, rounds=3, engine="async"))
    assert barrier.ledger.as_dict() == buffered.ledger.as_dict()
    assert buffered.history.virtual_s[0] < barrier.history.virtual_s[0]
    assert max(barrier.history.staleness) == 0.0
    assert max(buffered.history.staleness) > 0.0


# ----------------------------------------------------------- kill / resume

@pytest.mark.parametrize("plane", ["host", "fleet"])
def test_async_kill_resume_bit_identical_with_pending_buffer(
        plane, tmp_path, monkeypatch):
    """Killed after round 2 of 4 with contributions pending (K = 2 < N):
    the resumed run is the clean run bit for bit."""
    eng = EngineSpec(mode="async", data_plane=plane, buffered=_BUFFERED)

    def mkspec():
        return _spec("fedavg", n=4, rounds=4, engine=eng, checkpoint_every=1)

    clean = _run(mkspec(), checkpoint_dir=str(tmp_path / "clean"))
    killed = str(tmp_path / "killed")
    monkeypatch.setattr(RoundCheckpointer, "fail_after_save", 2)
    with pytest.raises(Preempted):
        _run(mkspec(), checkpoint_dir=killed)
    from repro_torch.train.checkpoint import load_metadata
    assert load_metadata(killed, 2)["buffer"]["count"] > 0
    monkeypatch.setattr(RoundCheckpointer, "fail_after_save", None)
    resumed = _run(mkspec(), checkpoint_dir=killed)
    assert _trees_equal(clean.params, resumed.params)
    assert clean.ledger.as_dict() == resumed.ledger.as_dict()
    for k in ("virtual_s", "arrivals", "staleness", "parked_hops"):
        assert getattr(clean.history, k) == getattr(resumed.history, k)
    assert clean.accuracy == resumed.accuracy


def test_port_resumes_a_reference_async_checkpoint(tmp_path, monkeypatch):
    """The reference's async run is killed after round 2 with contributions
    pending; the port finishes it from the reference's files: the queue,
    its clock and the ledger come back, params within the fleet bar."""
    from repro.fl.resume import Preempted as JPreempted
    from repro.fl.resume import RoundCheckpointer as JCheckpointer
    eng = EngineSpec(mode="async", data_plane="host", buffered=_BUFFERED)
    kw = dict(strategy="fedavg", rounds=4, num_clients=4, num_models=4,
              seed=0, topology_seed=0, checkpoint_every=1)
    data = dict(task="fcn", alpha=0.5, num_samples=600)
    jspec = JSpec(fl=JConfig(engine=_jengine(eng), **kw), **data)
    clean = j_run(jspec)
    d = str(tmp_path / "ref")
    monkeypatch.setattr(JCheckpointer, "fail_after_save", 2)
    with pytest.raises(JPreempted):
        j_run(jspec, checkpoint_dir=d)
    monkeypatch.setattr(JCheckpointer, "fail_after_save", None)
    resumed = _run(ExperimentSpec(fl=FLConfig(engine=eng, **kw), **data),
                   checkpoint_dir=d)
    assert resumed.ledger.as_dict() == clean.ledger.as_dict()
    for k in ("virtual_s", "arrivals", "staleness", "parked_hops"):
        assert getattr(resumed.history, k) == getattr(clean.history, k), k
    assert resumed.accuracy[:2] == clean.accuracy[:2]      # restored
    np.testing.assert_allclose(resumed.accuracy, clean.accuracy, atol=0.05)
    for a, b in zip(jax.tree.leaves(clean.params),
                    jax.tree.leaves(params_to_numpy(resumed.params))):
        np.testing.assert_allclose(b, np.asarray(a), atol=2e-4, rtol=2e-3)


def test_resume_refuses_changed_engine(tmp_path, monkeypatch):
    eng = EngineSpec(mode="async", buffered=AsyncSpec(buffer_k=2))
    spec = _spec("fedavg", n=4, rounds=4, engine=eng, checkpoint_every=1)
    d = str(tmp_path / "ck")
    monkeypatch.setattr(RoundCheckpointer, "fail_after_save", 2)
    with pytest.raises(Preempted):
        _run(spec, checkpoint_dir=d)
    monkeypatch.setattr(RoundCheckpointer, "fail_after_save", None)
    other = dataclasses.replace(spec, fl=dataclasses.replace(
        spec.fl, engine=EngineSpec(mode="async",
                                   buffered=AsyncSpec(buffer_k=3))))
    with pytest.raises(ValueError, match="different config"):
        _run(other, checkpoint_dir=d)


# ------------------------------------------------------------- hop parking

def test_hop_deadline_parks_hops_but_charges_full_wire():
    base = EngineSpec(mode="async", data_plane="host", buffered=AsyncSpec(
        delay_scale=0.01, delay_sigma=0.5))
    tight = dataclasses.replace(base, buffered=dataclasses.replace(
        base.buffered, hop_deadline_s=1e-9))
    free = _run(_spec("d2d_random_walk", n=6, rounds=2, engine=base))
    parked = _run(_spec("d2d_random_walk", n=6, rounds=2, engine=tight))
    assert sum(free.history.parked_hops) == 0
    assert sum(parked.history.parked_hops) > 0
    assert free.ledger.as_dict() == parked.ledger.as_dict()
    assert not _trees_equal(free.params, parked.params)


def test_population_cohort_run_is_deterministic():
    eng = EngineSpec(mode="async", buffered=AsyncSpec(
        buffer_frac=0.5, delay_scale=0.01, delay_sigma=1.0, population=200))
    r1 = _run(_spec("fedavg", n=4, rounds=2, engine=eng))
    r2 = _run(_spec("fedavg", n=4, rounds=2, engine=eng))
    assert _trees_equal(r1.params, r2.params)
    assert r1.accuracy == r2.accuracy
    assert r1.history.virtual_s == r2.history.virtual_s


# ------------------------------------------------ against the reference

def _jengine(eng):
    if isinstance(eng, str):
        return eng
    b = eng.buffered
    return JEngineSpec(mode=eng.mode, planner=eng.planner,
                       data_plane=eng.data_plane,
                       buffered=JAsyncSpec(**dataclasses.asdict(b)))


def _run_both(strategy, n, rounds, eng, **fl):
    kw = dict(strategy=strategy, rounds=rounds, num_clients=n,
              num_models=n, seed=0, topology_seed=3, **fl)
    data = dict(task="fcn", alpha=0.5, num_samples=600)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref = j_run(JSpec(fl=JConfig(engine=_jengine(eng), **kw), **data))
    init = jax.tree.map(np.asarray, j_build("fcn").init(
        jax.random.PRNGKey(0)))
    port = _run(ExperimentSpec(fl=FLConfig(engine=eng, **kw), **data),
                init_fn=lambda gen: params_from_numpy(init))
    return ref, port


_CASES = {
    "fedavg-async": ("fedavg", 6, 3, "async", {}),
    "feddif-barrier": ("feddif", 6, 3, "async_barrier", {}),
    "feddif-async-fleet": ("feddif", 6, 3, EngineSpec(
        mode="async", data_plane="fleet",
        buffered=ENGINE_PRESETS["async"].buffered), {}),
    "walk-deadline": ("d2d_random_walk", 6, 2, EngineSpec(
        mode="async", data_plane="host", buffered=AsyncSpec(
            delay_scale=0.01, delay_sigma=0.5, hop_deadline_s=0.05)), {}),
    "feddif-multicell": ("feddif", 6, 2, "async",
                         dict(scenario="multicell")),
    "fedavg-churn-population": ("fedavg", 4, 3, EngineSpec(
        mode="async", buffered=AsyncSpec(
            buffer_frac=0.5, delay_scale=0.01, delay_sigma=1.0,
            population=300, max_staleness=1)), dict(churn_rate=0.1)),
    "feddif-int8": ("feddif", 6, 2, "async", dict(hop_quant="int8")),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_async_runs_match_reference(case):
    strategy, n, rounds, eng, fl = _CASES[case]
    ref, port = _run_both(strategy, n, rounds, eng, **fl)
    assert port.ledger.as_dict() == ref.ledger.as_dict()
    for k in ("virtual_s", "arrivals", "staleness", "parked_hops",
              "diffusion_rounds"):
        assert getattr(port.history, k) == getattr(ref.history, k), k
    assert len(port.history.virtual_s) > 0
    for a, b in zip(jax.tree.leaves(ref.params),
                    jax.tree.leaves(params_to_numpy(port.params))):
        np.testing.assert_allclose(b, np.asarray(a, np.float32), atol=2e-4,
                                   rtol=2e-3)
    assert len(port.accuracy) == len(ref.accuracy)
    np.testing.assert_allclose(port.accuracy, ref.accuracy, atol=0.05)
    if case == "walk-deadline":
        assert sum(port.history.parked_hops) > 0


# ------------------------------------------------------------- aliasing

@pytest.mark.parametrize("plane", ["host", "fleet"])
def test_pending_contributions_do_not_alias_later_rounds(plane,
                                                         monkeypatch):
    """K = 1 of 4 contributions per tick: round 0's contributions wait in
    the queue through rounds 1 and 2.  Each keeps storage of its own (none
    shared with any round's slots) and reaches its tick with the bits it
    left its slot with."""
    taken, slot_ptrs = [], []
    cls = {"host": executors.HostExecutor,
           "fleet": executors.FleetExecutor}[plane]
    run_ops, slot_state = cls.run_ops, cls.slot_state

    def spy_run_ops(self, sched, global_params, slots):
        out = run_ops(self, sched, global_params, slots)
        leaves = (tree_leaves(out) if plane == "fleet"
                  else [x for s in out for x in tree_leaves(s)])
        slot_ptrs.append({x.untyped_storage().data_ptr() for x in leaves})
        return out

    def spy_slot_state(self, slots, slot):
        tree = slot_state(self, slots, slot)
        taken.append((len(slot_ptrs) - 1, tree,
                      [x.clone() for x in tree_leaves(tree)]))
        return tree

    monkeypatch.setattr(cls, "run_ops", spy_run_ops)
    monkeypatch.setattr(cls, "slot_state", spy_slot_state)
    popped = []
    fedavg = async_plane.agg.fedavg

    def spy_fedavg(trees, weights):
        popped.extend(id(t) for t in trees)
        return fedavg(trees, weights)

    monkeypatch.setattr(async_plane.agg, "fedavg", spy_fedavg)
    eng = EngineSpec(mode="async", data_plane=plane, buffered=AsyncSpec(
        buffer_k=1, delay_scale=0.01, delay_sigma=1.0))
    res = _run(_spec("fedavg", n=4, rounds=3, engine=eng))
    assert len(taken) == 12 and len(slot_ptrs) == 3
    assert res.history.arrivals[:3] == [1, 1, 1]
    # Round 0's contributions outlive rounds 1 and 2 in the queue.
    order = {tid: i for i, tid in enumerate(popped)}
    late = [tree for r, tree, _ in taken if r == 0 and order[id(tree)] >= 2]
    assert late
    for r, tree, snap in taken:
        # The round it left and every later one (earlier rounds' freed
        # storage may be reused).
        live = set().union(*slot_ptrs[r:])
        for x, s in zip(tree_leaves(tree), snap):
            assert x.untyped_storage().data_ptr() not in live
            assert torch.equal(x, s)


# ---------------------------------------------------------- the engine

def test_engine_fingerprints_match_reference():
    for name, spec in ENGINE_PRESETS.items():
        assert spec.describe() == J_PRESETS[name].describe(), name
    custom = EngineSpec(mode="async", planner="jax", data_plane="fleet",
                        buffered=AsyncSpec(buffer_k=2, max_staleness=3,
                                           hop_deadline_s=0.5,
                                           population=1000))
    assert custom.describe() == _jengine(custom).describe()
    for n in (4, 63, 64, 1000):
        for dp in ("auto", "host", "fleet"):
            assert (EngineSpec(mode="async", data_plane=dp)
                    .inner_data_plane(n)
                    == JEngineSpec(mode="async", data_plane=dp)
                    .inner_data_plane(n))


def test_run_result_time_to_accuracy():
    hist = RunHistory(accuracy=[0.1, 0.5, 0.7], virtual_s=[0.3, 0.9])
    res = RunResult(params=None, ledger=None, history=hist)
    assert res.time_to_accuracy(0.5) == 0.9
    assert res.time_to_accuracy(0.7) == 0.9      # clock has fewer ticks
    assert res.time_to_accuracy(0.9) is None
    sync = RunResult(params=None, ledger=None,
                     history=RunHistory(accuracy=[0.2, 0.6]))
    assert sync.time_to_accuracy(0.5) == 2.0
