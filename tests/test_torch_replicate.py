"""The seed-stacked replicate engine of the port against ``repro`` (CPU).

``run_replicates_vmapped`` against the reference's from the reference's
inits (``init_for``): ledgers, diffusion rounds and IID distances equal,
params within atol 2e-4 and rtol 2e-3, accuracy within 2e-3 (the
reference's own seed_vmap-vs-loop bar); against the port's loop engine
(the same ledgers, accuracy within 2e-3); its guards; ``_pick_engine``
against the reference's on every registered smoke cell at two seeds,
``fig_lm`` aside, and on the loop at one seed; ``auto``-vs-``auto`` smoke
sweeps at two seeds and the port's one-seed ``auto`` against the
reference's loop; and the reference's ``fig_lm`` routing defect: its
seed-stacked engine charges ``fig_lm``'s int8 adapter hops as full fp32
models, which the port's ``auto`` does not copy.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.experiments as jexp
from repro.core.diffusion import PlanCache as JPlanCache
from repro.experiments import orchestrator as jorch
from repro.experiments.replicate import \
    run_replicates_vmapped as j_vmapped
from repro.fl.models import build_task_model as j_build
import repro_torch.experiments as texp
from repro_torch.core.diffusion import PlanCache
from repro_torch.experiments import artifacts as tart
from repro_torch.experiments import orchestrator, replicate
from repro_torch.fl import params_from_numpy, params_to_numpy
from repro_torch.launch import sweep as sweep_cli
from repro_torch.tree import tree_leaves

SAMPLES = 300


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ref_init_for(spec):
    init = jax.tree.map(np.asarray, j_build(
        spec.task, spec.dim, spec.num_classes).init(
            jax.random.PRNGKey(spec.fl.seed)))
    return lambda gen: params_from_numpy(init)


def _cells(name, **kw):
    kw.setdefault("num_samples", SAMPLES)
    return (texp.expand_sweep(name, **kw), jexp.expand_sweep(name, **kw))


def _same_control_plane(a, b):
    assert a.ledger.as_dict() == b.ledger.as_dict()
    assert a.diffusion_rounds == b.diffusion_rounds
    assert a.iid_distance == b.iid_distance


# -------------------------------------------------- against the reference

# (sweep, planner, cell index)
VMAP_CELLS = [("fig3_alpha", "host", 0), ("fig3_alpha", "host", 1),
              ("fig3_alpha", "host", 3), ("fig5_gamma_min", "jax", 0)]


@pytest.mark.parametrize("name,planner,index", VMAP_CELLS)
def test_vmapped_matches_reference(name, planner, index):
    cells, jcells = _cells(name, planner=planner)
    cell, jcell = cells[index], jcells[index]
    cache, jcache = PlanCache(), JPlanCache()
    got = replicate.run_replicates_vmapped(cell.spec, (0, 1), cache,
                                           device="cpu",
                                           init_for=_ref_init_for)
    want = j_vmapped(jcell.spec, (0, 1), jcache)
    assert cache.stats() == jcache.stats()
    assert len(got) == len(want) == 2
    for s, (g, w) in enumerate(zip(got, want)):
        assert g.config.seed == w.config.seed == s
        _same_control_plane(g, w)
        np.testing.assert_allclose(g.accuracy, w.accuracy, atol=2e-3)
        np.testing.assert_allclose(g.loss, w.loss, atol=2e-4, rtol=2e-3)
        ref = jax.tree.leaves(w.final_params)
        port = jax.tree.leaves(params_to_numpy(g.final_params))
        assert len(ref) == len(port)
        for a, b in zip(ref, port):
            np.testing.assert_allclose(b, np.asarray(a), atol=2e-4,
                                       rtol=2e-3)
    # Replicates share the control plane and differ on the data plane.
    assert got[0].ledger.as_dict() == got[1].ledger.as_dict()
    assert got[0].loss != got[1].loss


@pytest.mark.parametrize("index", [0, 1])
def test_vmapped_matches_the_ports_loop(index):
    cell = texp.expand_sweep("fig3_alpha", num_samples=SAMPLES)[index]
    cache = PlanCache()
    vm = replicate.run_replicates_vmapped(cell.spec, (0, 1, 2), cache,
                                          device="cpu")
    loop = replicate.run_replicates_loop(cell.spec, (0, 1, 2), cache,
                                         device="cpu")
    if cell.strategy == "feddif":
        assert cache.stats()["hits"] >= 2 * cell.spec.fl.rounds
    for v, lp in zip(vm, loop):
        _same_control_plane(v, lp)
        np.testing.assert_allclose(v.accuracy, lp.accuracy, atol=2e-3)
        for a, b in zip(tree_leaves(v.params), tree_leaves(lp.params)):
            torch.testing.assert_close(a, b, atol=2e-4, rtol=2e-3)


# ----------------------------------------------------------------- guards

def _guarded(change=None, name="fig3_alpha", strategy="feddif", **spec_kw):
    cells = texp.expand_sweep(name, num_samples=SAMPLES)
    cell = next(c for c in cells if c.strategy == strategy)
    spec = cell.spec
    if change:
        spec = dataclasses.replace(spec, fl=dataclasses.replace(spec.fl,
                                                                **change))
    return dataclasses.replace(spec, **spec_kw)


@pytest.mark.parametrize("spec,match", [
    (lambda: _guarded(name="table2_strategies", strategy="d2d_random_walk"),
     "not seed-vmappable"),
    (lambda: _guarded(dict(topology_seed=None)), "topology_seed"),
    (lambda: _guarded(dict(churn_rate=0.1)), "churn"),
    (lambda: _guarded(dict(scenario="mobile")), "static"),
    (lambda: _guarded(dict(uncertainty_weight=0.5)), "learning values"),
    (lambda: _guarded(dict(hop_quant="int8")), "full fp32"),
    (lambda: _guarded(dict(hop_quant="none"), name="fig_lm"),
     "adapter view")],
    ids=["strategy", "topology_seed", "churn", "scenario",
         "uncertainty_weight", "hop_quant", "adapter_view"])
def test_vmapped_guards(spec, match, monkeypatch):
    monkeypatch.setattr(replicate, "load_experiment_data", None)
    with pytest.raises(ValueError, match=match):
        replicate.run_replicates_vmapped(spec(), (0,), device="cpu")


def test_full_model_adapter_view_is_vmappable():
    spec = _guarded(name="fig_lm")
    assert not replicate.hops_full_model(spec)
    full = dataclasses.replace(spec, adapter_hops=False, fl=dataclasses
                               .replace(spec.fl, hop_quant="none"))
    assert replicate.hops_full_model(full)


# ---------------------------------------------------------- engine routing

ROUTED = [n for n in jexp.sweep_names() if n != "fig_lm"]


@pytest.mark.parametrize("name", ROUTED)
def test_pick_engine_matches_reference(name):
    n = 0
    for executor in ("host", "fleet", "sharded"):
        cells, jcells = _cells(name, executor=executor)
        for cell, jcell in zip(cells, jcells):
            for engine in ("auto", "loop", "seed_vmap"):
                got = orchestrator._pick_engine(
                    orchestrator._pick_executor(cell, engine), engine, 2)
                want = jorch._pick_engine(
                    jorch._pick_executor(jcell, engine), engine)
                assert got == want, (cell.label, executor, engine)
                n += 1
    assert n > 0


@pytest.mark.parametrize("name", ROUTED)
def test_pick_engine_runs_one_seed_on_the_loop(name):
    """At one seed the port's ``auto`` departs from the reference's: there
    is no seed axis to batch, so every cell runs on the loop.  An explicit
    engine is routed as at two seeds."""
    cells, _ = _cells(name, executor="host")
    for cell in cells:
        assert orchestrator._pick_engine(cell, "auto", 1) == "loop"
        for engine in ("loop", "seed_vmap"):
            assert (orchestrator._pick_engine(cell, engine, 1)
                    == orchestrator._pick_engine(cell, engine, 2))


def test_pick_engine_sends_fig_lm_to_the_loop():
    cells, jcells = _cells("fig_lm")
    for cell, jcell in zip(cells, jcells):
        assert jorch._pick_engine(jcell, "auto") == "seed_vmap"
        assert orchestrator._pick_engine(cell, "auto", 2) == "loop"
    with pytest.raises(ValueError, match="unknown replication engine"):
        orchestrator._pick_engine(cells[0], "warp", 2)


# ------------------------------------------------------------ whole sweeps

def _assert_sweeps_match(got, want, seeds, acc_atol):
    g, w = tart.strip_volatile(got), jexp.strip_volatile(want)
    assert g["failed_cells"] == [] and len(g["cells"]) == len(w["cells"]) > 0
    for gc, wc, gfull, wfull in zip(g["cells"], w["cells"], got["cells"],
                                    want["cells"]):
        for k in ("label", "strategy", "executor", "seeds", "engine", "comm",
                  "diffusion_rounds"):
            assert gc[k] == wc[k], (gc["label"], k)
        np.testing.assert_allclose(gc["iid_distance"], wc["iid_distance"],
                                   atol=1e-6)
        assert len(gc["accuracy"]) == len(seeds)
        for a, b in zip(gc["accuracy"], wc["accuracy"]):
            np.testing.assert_allclose(a, b, atol=acc_atol)
        for k in ("hits", "misses"):
            assert gfull["plan_cache"][k] == wfull["plan_cache"][k]


@pytest.mark.parametrize("name,planner,seeds", [
    ("fig3_alpha", "host", (0, 1)), ("fig5_gamma_min", "host", (0, 1)),
    ("fig5_gamma_min", "jax", (0, 1))])
def test_auto_sweep_matches_reference_auto(name, planner, seeds):
    kw = dict(smoke=True, seeds=seeds, out_dir=None, planner=planner,
              num_samples=SAMPLES)
    want = jexp.run_sweep(name, **kw)
    got = texp.run_sweep(name, device="cpu", init_for=_ref_init_for, **kw)
    assert {c["engine"] for c in got["cells"]} == {"seed_vmap"}
    _assert_sweeps_match(got, want, seeds, acc_atol=2e-3)


@pytest.mark.parametrize("planner", ["host", "jax"])
def test_one_seed_auto_sweep_matches_reference_loop(planner):
    """One seed: the port's ``auto`` runs the loop and matches the
    reference's loop; its ledger and curves also match the reference's
    ``auto``, which stacks the one seed."""
    kw = dict(smoke=True, seeds=(0,), out_dir=None, planner=planner,
              num_samples=SAMPLES)
    got = texp.run_sweep("fig5_gamma_min", device="cpu",
                         init_for=_ref_init_for, **kw)
    assert {c["engine"] for c in got["cells"]} == {"loop"}
    _assert_sweeps_match(got, jexp.run_sweep("fig5_gamma_min", engine="loop",
                                             **kw), (0,), acc_atol=2e-3)
    want = jexp.strip_volatile(jexp.run_sweep("fig5_gamma_min", **kw))
    for gc, wc in zip(tart.strip_volatile(got)["cells"], want["cells"]):
        assert wc["engine"] == "seed_vmap"
        assert gc["comm"] == wc["comm"]
        assert gc["diffusion_rounds"] == wc["diffusion_rounds"]
        np.testing.assert_allclose(gc["accuracy"], wc["accuracy"],
                                   atol=2e-3)


def test_explicit_seed_vmap_engine_and_cli(tmp_path, capsys):
    art = texp.run_sweep("fig5_gamma_min", engine="seed_vmap", out_dir=None,
                         executor="fleet", device="cpu", num_samples=SAMPLES)
    assert {c["engine"] for c in art["cells"]} == {"loop"}   # fleet plane
    assert sweep_cli.main(["--sweep", "fig3_alpha", "--engine", "seed_vmap",
                           "--device", "cpu", "--seeds", "2",
                           "--num-samples", str(SAMPLES),
                           "--out-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert out.count("engine=seed_vmap") == 4 and "failed=0" in out
    with pytest.raises(ValueError, match="adapter view"):
        texp.run_sweep("fig_lm", engine="seed_vmap", out_dir=None,
                       device="cpu", num_samples=SAMPLES)


# --------------------------------------------------- the fig_lm defect

FIG_LM = dict(smoke=True, seeds=(0,), out_dir=None, num_samples=SAMPLES)


@pytest.fixture(scope="module")
def ref_fig_lm_loop():
    return jexp.run_sweep("fig_lm", engine="loop", **FIG_LM)


def test_reference_auto_charges_fig_lm_as_full_models(ref_fig_lm_loop):
    """The reference's ``auto`` sends fig_lm's FedAvg and FedDif cells to
    its seed-stacked engine, which trains and charges the full fp32 model
    instead of the int8-packed adapter: more bits and sub-frames than its
    own loop engine on every cell (ROADMAP C)."""
    auto = jexp.run_sweep("fig_lm", **FIG_LM)
    for a, lp in zip(auto["cells"], ref_fig_lm_loop["cells"]):
        assert a["engine"] == "seed_vmap" and lp["engine"] == "loop"
        assert (a["comm"]["transmitted_bits"]
                > 10 * lp["comm"]["transmitted_bits"])
        assert a["comm"]["subframes"] > lp["comm"]["subframes"]


def test_port_auto_routes_fig_lm_to_the_loop(ref_fig_lm_loop):
    got = texp.run_sweep("fig_lm", device="cpu", init_for=_ref_init_for,
                         **FIG_LM)
    assert {c["engine"] for c in got["cells"]} == {"loop"}
    _assert_sweeps_match(got, ref_fig_lm_loop, (0,), acc_atol=0.05)
