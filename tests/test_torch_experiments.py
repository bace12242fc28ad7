"""The port's sweep layer against ``repro.experiments`` (CPU).

Registry and expansion field for field; ``plan_rounds_batched`` per item
against ``_plan_rounds`` and its hop lists against the reference's batched
planner; the sweep pre-planner's counts, cache keys and plans; smoke
sweeps of the paper's figures on the loop engine from the reference's init
(ledgers, diffusion rounds and plan-cache hits equal, IID distance within
1e-6, accuracy within 0.05); ``fig_async`` and the async presets on the
buffered-async plane; the refusal (A12); the artifacts and the CLI.  The durable sweeps and the seed-stacked engine have their own files,
``test_torch_durability.py`` and ``test_torch_replicate.py``.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

import repro.experiments as jexp
from repro.channels.topology import CellTopology as JTopology
from repro.core import DiffusionPlanner as JPlanner
from repro.core import DiffusionState as JState
from repro.core import planner as jplanner
from repro.core.auction import AuctionConfig as JAuction
from repro.core.diffusion import PlanCache as JPlanCache
from repro.experiments import artifacts as jart
from repro.experiments.orchestrator import \
    prepopulate_plan_cache as j_prepopulate
from repro.fl.models import build_task_model as j_build
import repro_torch.experiments as texp
from repro_torch.core.auction import AuctionConfig
from repro_torch.core.diffusion import DiffusionPlanner, PlanCache
from repro_torch.core.dol import DiffusionState
from repro_torch.core import planner as tplanner
from repro_torch.experiments import artifacts as tart
from repro_torch.experiments import orchestrator, replicate
from repro_torch.fl import FLConfig, RunResult, params_from_numpy
from repro_torch.launch import sweep as sweep_cli

SAMPLES = 300


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ref_init_for(spec):
    """The reference's initial params of a cell's run, for ``init_for``."""
    init = jax.tree.map(np.asarray, j_build(
        spec.task, spec.dim, spec.num_classes).init(
            jax.random.PRNGKey(spec.fl.seed)))
    return lambda gen: params_from_numpy(init)


def _shared_fields(a, b):
    names = ({f.name for f in dataclasses.fields(a)}
             & {f.name for f in dataclasses.fields(b)})
    return {k: getattr(a, k) for k in names}, {k: getattr(b, k)
                                               for k in names}


# ------------------------------------------------------------------ registry

def test_sweep_names_match_reference():
    assert texp.sweep_names() == jexp.sweep_names()
    assert len(texp.sweep_names()) == 9


@pytest.mark.parametrize("name", jexp.sweep_names())
def test_sweep_def_matches_reference(name):
    got, want = texp.get_sweep(name), jexp.get_sweep(name)
    assert ([f.name for f in dataclasses.fields(got)]
            == [f.name for f in dataclasses.fields(want)])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("name", jexp.sweep_names())
@pytest.mark.parametrize("smoke", [True, False])
def test_expand_matches_reference(name, smoke):
    kw = dict(executor="fleet", planner="jax") if smoke else {}
    got = texp.expand_sweep(name, smoke=smoke, topology_seed=3, **kw)
    want = jexp.expand_sweep(name, smoke=smoke, topology_seed=3, **kw)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g.sweep, g.figure, g.axis, g.value, g.strategy, g.label) == (
            w.sweep, w.figure, w.axis, w.value, w.strategy, w.label)
        a, b = _shared_fields(g.spec, w.spec)
        a.pop("fl"), b.pop("fl")
        assert a == b and len(a) == 8
        a, b = _shared_fields(g.spec.fl, w.spec.fl)
        assert a == b and len(a) >= 30


def test_registry_refuses_unknown_values():
    with pytest.raises(ValueError, match="unknown strategy"):
        texp.SweepDef(name="x", figure="x", axis="alpha", values=(1.0,),
                      smoke_values=(1.0,), strategies=("warp",)).validate()
    with pytest.raises(ValueError, match="unknown scenario"):
        texp.SweepDef(name="x", figure="x", axis="scenario",
                      values=("moon",), smoke_values=()).validate()
    with pytest.raises(ValueError, match="subset"):
        texp.SweepDef(name="x", figure="x", axis="alpha", values=(1.0,),
                      smoke_values=(2.0,)).validate()
    with pytest.raises(ValueError, match="duplicate"):
        texp.register(texp.get_sweep("fig3_alpha"))
    with pytest.raises(KeyError, match="unknown sweep"):
        texp.get_sweep("fig99")


# ------------------------------------------------------ plan_rounds_batched

# (ε, γ_min, α of the DSIs) per item.
BATCH = ((0.0, 1.0, 0.1), (0.04, 2.0, 0.5), (0.1, 0.5, 1.0), (0.02, 4.0, 0.3))


def _batch_inputs(planner_cls, state_cls, auction_cls, inputs_fn, n=10,
                  **planner_kw):
    items = []
    for k, (eps, gmin, alpha) in enumerate(BATCH):
        rng = np.random.default_rng(k)
        dsi = rng.dirichlet(np.ones(10) * alpha, n).astype(np.float32)
        sizes = rng.integers(200, 800, n).astype(np.float64)
        pos = JTopology().sample_positions(np.random.default_rng(k + 50), n)
        auction = auction_cls(gamma_min=gmin, model_bits=8.4e5)
        planner = planner_cls(auction=auction, epsilon=eps, mode="jax",
                              **planner_kw)
        state = state_cls.init(n, n, 10)
        for mi in range(n):
            state.record_training(mi, mi, dsi[mi], float(sizes[mi]))
        inp, g64 = inputs_fn(planner, state, dsi, sizes,
                             np.random.default_rng(k + 7), positions=pos)
        items.append((inp, g64))
    return items


def _hops(plan):
    return [(h.model, h.src, h.dst, h.round_index, h.gamma, h.bandwidth)
            for h in plan.hops]


def test_plan_rounds_batched_matches_single_and_reference():
    items = _batch_inputs(DiffusionPlanner, DiffusionState, AuctionConfig,
                          tplanner.plan_round_inputs, device="cpu")
    stats, single_stats = {}, {}
    outs = tplanner.plan_rounds_batched([i for i, _ in items],
                                        metric="w1_norm",
                                        allow_retraining=False, stats=stats)
    jitems = _batch_inputs(JPlanner, JState, JAuction,
                           jplanner.plan_round_inputs)
    jouts = jplanner.plan_rounds_batched([i for i, _ in jitems],
                                         metric="w1_norm",
                                         allow_retraining=False)
    assert len(outs) == len(jouts) == len(BATCH)
    rounds = set()
    for (inp, g64), out, (_, jg64), jout in zip(items, outs, jitems, jouts):
        one = tplanner._plan_rounds(inp, metric="w1_norm",
                                    allow_retraining=False,
                                    stats=single_stats)
        assert out.num_rounds == one.num_rounds
        for a, b in zip(out, one):
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b)
        for a, b in zip(out.state, one.state):
            assert torch.equal(a, b)
        plan = tplanner.decode_plan(out, g64, 8.4e5)
        jplan = jplanner.decode_plan(jout, num_models=10, gamma_seq64=jg64,
                                     model_bits=8.4e5)
        assert out.num_rounds == int(jout.num_rounds) == plan.num_rounds
        assert _hops(plan) == _hops(jplan)
        rounds.add(plan.num_rounds)
    assert stats == single_stats and stats["loop_iterations"] > len(BATCH)
    assert len(rounds) > 1                     # the knobs steer the plans


def test_plan_rounds_batched_refuses_mixed_shapes():
    a = _batch_inputs(DiffusionPlanner, DiffusionState, AuctionConfig,
                      tplanner.plan_round_inputs, device="cpu")[0][0]
    b = _batch_inputs(DiffusionPlanner, DiffusionState, AuctionConfig,
                      tplanner.plan_round_inputs, n=8, device="cpu")[0][0]
    with pytest.raises(ValueError, match="different shapes"):
        tplanner.plan_rounds_batched([a, b], metric="w1_norm",
                                     allow_retraining=False)


# ---------------------------------------------------------- the pre-planner

@pytest.mark.parametrize("name", ["fig5_gamma_min", "fig3_alpha",
                                  "fig4_epsilon"])
def test_prepopulate_matches_reference(name):
    cells = texp.expand_sweep(name, planner="jax", num_samples=SAMPLES)
    jcells = jexp.expand_sweep(name, planner="jax", num_samples=SAMPLES)
    cache, jcache = PlanCache(), JPlanCache()
    pre = orchestrator.prepopulate_plan_cache(cells, cache, device="cpu")
    jpre = j_prepopulate(jcells, jcache)
    assert {k: pre[k] for k in jpre} == jpre
    assert pre["planned"] == 4 and pre["batches"] == 1
    assert pre["planner_stats"]["loop_iterations"] >= pre["planned"]
    assert list(cache._store) == list(jcache._store)
    for key, (plan, state) in cache._store.items():
        jplan, jstate = jcache._store[key]
        assert _hops(plan) == _hops(jplan)
        np.testing.assert_array_equal(state.holder, jstate.holder)
        np.testing.assert_array_equal(state.dol, jstate.dol)
    # A second pass finds every key and plans nothing.
    again = orchestrator.prepopulate_plan_cache(cells, cache, device="cpu")
    assert again["planned"] == 0 and again["batches"] == 0
    assert again["skipped"] == pre["skipped"] + pre["planned"]


# ------------------------------------------------------------ whole sweeps

# (sweep, executor, planner, seeds)
SWEEPS = [("fig3_alpha", "host", "host", (0, 1)),
          ("fig4_epsilon", "host", "host", (0,)),
          ("fig5_gamma_min", "host", "host", (0,)),
          ("fig5_gamma_min", "host", "jax", (0,)),
          ("fig6_tasks", "host", "host", (0,)),
          ("table2_strategies", "host", "host", (0,)),
          ("fig_lm", "host", "host", (0,)),
          ("fig5_gamma_min", "fleet", "jax", (0,)),
          ("fig_async", "host", "host", (0,))]


@pytest.mark.parametrize("name,executor,planner,seeds", SWEEPS,
                         ids=[f"{s[0]}-{s[1]}-{s[2]}" for s in SWEEPS])
def test_smoke_sweep_matches_reference(name, executor, planner, seeds):
    kw = dict(smoke=True, seeds=seeds, out_dir=None, executor=executor,
              planner=planner, num_samples=SAMPLES)
    want = jexp.run_sweep(name, engine="loop", **kw)
    got = texp.run_sweep(name, engine="loop", device="cpu",
                         init_for=_ref_init_for, **kw)
    g, w = tart.strip_volatile(got), jart.strip_volatile(want)
    for k in ("schema_version", "sweep", "figure", "axis", "mode",
              "executor", "planner", "seeds", "failed_cells"):
        assert g[k] == w[k], k
    assert g["failed_cells"] == [] and set(g) == set(w)
    assert len(g["cells"]) == len(w["cells"]) > 0
    for gc, wc, gfull, wfull in zip(g["cells"], w["cells"], got["cells"],
                                    want["cells"]):
        # The port's records of async cells add the event queue's curves.
        assert set(gc) - {"async"} == set(wc)
        assert ("async" in gc) == (gc["executor"] == "async")
        for k in ("label", "axis", "value", "strategy", "executor", "seeds",
                  "engine", "comm", "diffusion_rounds"):
            assert gc[k] == wc[k], (gc["label"], k)
        np.testing.assert_allclose(gc["iid_distance"], wc["iid_distance"],
                                   atol=1e-6)
        assert len(gc["accuracy"]) == len(seeds)
        for a, b in zip(gc["accuracy"], wc["accuracy"]):
            np.testing.assert_allclose(a, b, atol=0.05)
        assert np.isfinite(gc["loss"]).all()
        for k in ("hits", "misses"):
            assert gfull["plan_cache"][k] == wfull["plan_cache"][k]
    if planner == "jax":
        assert all(c["plan_cache"]["misses"] == 0 for c in got["cells"])
        assert got["plan_cache"]["hits"] > 0


def test_run_cell_with_a_fresh_cache_equals_the_preplanned_sweep():
    """The pre-planner's plans are the plans each cell would make itself."""
    art = texp.run_sweep("fig5_gamma_min", planner="jax", out_dir=None,
                         device="cpu", num_samples=SAMPLES)
    cells = texp.expand_sweep("fig5_gamma_min", planner="jax",
                              num_samples=SAMPLES)
    records = [texp.run_cell(c, (0,), PlanCache(), device="cpu")
               for c in cells]
    assert all(r["plan_cache"]["misses"] == 2 for r in records)
    for a, b in zip(tart.strip_volatile(art)["cells"],
                    tart.strip_volatile({"cells": records})["cells"]):
        assert a == b


# ------------------------------------------------- async plane, refusals


@pytest.mark.parametrize("name", ["fig_async"])
def test_unported_sweeps_refuse_before_running(name):
    """``fig_async`` is no longer refused: every cell runs on the async
    plane, the barrier arm with zero staleness, and each record carries the
    event queue's per-seed curves."""
    art = texp.run_sweep(name, out_dir=None, device="cpu",
                         num_samples=SAMPLES)
    assert art["failed_cells"] == [] and len(art["cells"]) == 4
    for cell in art["cells"]:
        assert cell["executor"] == "async" and cell["engine"] == "loop"
        curves = cell["async"]
        assert len(curves["virtual_s"]) == 1 and curves["virtual_s"][0]
        assert curves["virtual_s"][0] == sorted(curves["virtual_s"][0])
        if cell["value"] == "async_barrier":
            assert max(curves["staleness"][0]) == 0.0


@pytest.mark.parametrize("kw,item", [
    (dict(engine_preset="async"), None),
    (dict(engine_preset="async_barrier"), None),
    (dict(executor="sharded", engine="loop"), "A12")])
def test_run_sweep_refusals(kw, item, monkeypatch):
    """The async presets run every cell of a sweep on the buffered-async
    plane; a sharded sweep above the crossover is refused (A12) before a
    cell runs."""
    if item is None:
        art = texp.run_sweep("fig5_gamma_min", out_dir=None, device="cpu",
                             num_samples=SAMPLES, **kw)
        assert art["failed_cells"] == []
        assert [c["executor"] for c in art["cells"]] == ["async", "async"]
        assert all(c["async"]["virtual_s"][0] for c in art["cells"])
        return
    calls = []

    def fake(*a, **k):
        calls.append(a)
        raise AssertionError("run_experiment was called")

    monkeypatch.setattr(replicate, "run_experiment", fake)
    with pytest.raises(NotImplementedError, match=item):
        texp.run_sweep("fig5_gamma_min", out_dir=None, device="cpu", **kw)
    assert calls == []


def test_sharded_downgrades_below_the_crossover_and_raises_above():
    art = texp.run_sweep("fig5_gamma_min", executor="sharded", out_dir=None,
                         device="cpu", num_samples=SAMPLES)
    assert [c["executor"] for c in art["cells"]] == ["fleet", "fleet"]
    cell = texp.expand_sweep("fig3_alpha", executor="sharded",
                             num_samples=SAMPLES)[0]
    big = cell.with_fl(num_clients=orchestrator.SHARDED_CROSSOVER_N,
                       num_models=orchestrator.SHARDED_CROSSOVER_N)
    assert orchestrator._pick_executor(big, "auto") is big
    with pytest.raises(NotImplementedError, match="A12"):
        texp.run_cell(big, (0,), device="cpu")


def test_run_result_from_histories():
    res = RunResult.from_histories(
        accuracy=[0.1, 0.4], loss=[2.0, 1.0], ledger="L",
        diffusion_rounds=[3, 2], iid_distance=[0.2, 0.1],
        config=FLConfig(), final_params={"w": torch.ones(1)},
        round_wall_s=[0.5, 0.5])
    assert res.accuracy == [0.1, 0.4] and res.diffusion_rounds == [3, 2]
    assert res.round_wall_s == [0.5, 0.5] and res.ledger == "L"
    assert res.rounds_to_accuracy(0.3) == 2 and res.engine is None
    base = dict(accuracy=[], loss=[], ledger=None, diffusion_rounds=[],
                iid_distance=[])
    res = RunResult.from_histories(virtual_s=[1.0], arrivals=[3],
                                   staleness=[0.5], parked_hops=[0], **base)
    assert res.history.virtual_s == [1.0] and res.history.arrivals == [3]
    assert res.history.staleness == [0.5] and res.history.parked_hops == [0]
    assert RunResult.from_histories(
        phase_s=[{"train": 1.0}], **base).phase_s == [{"train": 1.0}]


# --------------------------------------------------------------- artifacts

def test_default_dir_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.delenv("REPRO_BENCH_DIR", raising=False)
    assert tart.default_out_dir() == os.path.join("benchmarks", "results",
                                                  "torch")
    assert tart.bench_path("fig3_alpha") == os.path.join(
        "benchmarks", "results", "torch", "BENCH_feddif_fig3_alpha.json")
    assert tart.bench_path("fig3_alpha") != jart.bench_path("fig3_alpha")
    monkeypatch.setenv("REPRO_BENCH_DIR", str(tmp_path))
    assert tart.default_out_dir() == str(tmp_path / "torch")
    assert jart.default_out_dir() == str(tmp_path)
    assert os.path.basename(tart.bench_path("x")) == os.path.basename(
        jart.bench_path("x"))
    art = texp.run_sweep("fig4_epsilon", device="cpu", num_samples=SAMPLES)
    assert art["path"] == str(tmp_path / "torch"
                              / "BENCH_feddif_fig4_epsilon.json")
    assert not (tmp_path / "BENCH_feddif_fig4_epsilon.json").exists()
    with open(art["path"]) as f:
        assert json.load(f)["failed_cells"] == []


def test_bench_write_is_atomic_under_partial_write(tmp_path, monkeypatch):
    tart.write_bench_json("torn", {"generation": 1}, str(tmp_path))

    def dying_dump(obj, f, **kw):
        f.write('{"generation": 2, "partial": [1, 2')
        raise OSError("disk full mid-write")

    with monkeypatch.context() as m:
        m.setattr(json, "dump", dying_dump)
        with pytest.raises(OSError):
            tart.write_bench_json("torn", {"generation": 2}, str(tmp_path))
    with open(tart.bench_file("torn", str(tmp_path))) as f:
        assert json.load(f) == {"generation": 1}
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]


def test_artifact_schema_matches_reference(tmp_path):
    kw = dict(sweep_name="s", figure="F", axis="alpha", smoke=True,
              seeds=[0], cells=[{"a": np.float32(1.5)}], executor="fleet",
              planner="jax", plan_cache_stats={"hits": 1}, wall_clock_s=2.0)
    got, want = tart.build_artifact(**kw), jart.build_artifact(**kw)
    assert set(got) == set(want) and got["failed_cells"] == []
    got.pop("created_unix"), want.pop("created_unix")
    assert got == want and tart.SCHEMA_VERSION == jart.SCHEMA_VERSION
    path = tart.write_artifact(dict(got), str(tmp_path))
    with open(path) as f:
        assert json.load(f)["cells"] == [{"a": 1.5}]
    curves = [[0.1, 0.5, 0.4], [0.2, 0.3]]
    assert tart.summarize_curves(curves) == jart.summarize_curves(curves)
    assert set(jart.__all__) <= set(tart.__all__)


def test_strip_volatile_drops_only_volatile_keys():
    art = texp.run_sweep("fig5_gamma_min", out_dir=None, device="cpu",
                         num_samples=SAMPLES)
    art["path"] = "p"
    s = tart.strip_volatile(art)
    assert set(art) - set(s) == {"created_unix", "wall_clock_s",
                                 "plan_cache", "path"}
    for full, c in zip(art["cells"], s["cells"]):
        assert set(full) - set(c) == {"wall_clock_s", "plan_cache"}
        assert c["comm"]["subframes"] > 0
    assert s == jart.strip_volatile(art)


# --------------------------------------------------------------------- CLI

def test_cli_list(capsys):
    assert sweep_cli.main(["--list"]) == 0
    out = capsys.readouterr().out
    for name in texp.sweep_names():
        assert name in out


def test_cli_runs_a_smoke_sweep_on_the_cpu(tmp_path, capsys):
    assert sweep_cli.main(["--sweep", "fig5_gamma_min", "--device", "cpu",
                           "--planner", "jax", "--num-samples", str(SAMPLES),
                           "--out-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "preplan,planned=4" in out and "failed=0" in out
    with open(tmp_path / "BENCH_feddif_fig5_gamma_min.json") as f:
        art = json.load(f)
    assert art["planner"] == "jax" and len(art["cells"]) == 2
    assert art["plan_cache"]["misses"] == 0


@pytest.mark.parametrize("argv", [["--sweep", "fig99"],
                                  ["--sweep", "fig3_alpha", "--seeds", "0"]])
def test_cli_bad_arguments_exit_2(argv, capsys):
    assert sweep_cli.main(argv) == 2
    assert "error" in capsys.readouterr().err


@pytest.mark.parametrize("argv,cells", [
    (["--sweep", "fig_async"], 4), (["--engine", "async"], 2)])
def test_cli_refusals(argv, cells, tmp_path, capsys):
    """``--sweep fig_async`` and ``--engine async`` run on the CPU (exit 0,
    every cell on the async plane)."""
    if "--sweep" not in argv:
        argv = ["--sweep", "fig5_gamma_min"] + argv
    assert sweep_cli.main(argv + ["--device", "cpu", "--num-samples",
                                  str(SAMPLES), "--out-dir",
                                  str(tmp_path)]) == 0
    assert "failed=0" in capsys.readouterr().out
    (path,) = tmp_path.glob("BENCH_feddif_*.json")
    with open(path) as f:
        art = json.load(f)
    assert len(art["cells"]) == cells
    assert all(c["executor"] == "async" for c in art["cells"])


def test_cli_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        sweep_cli.main(["--sweep", "fig5_gamma_min", "--out-dir", "unused"])
