"""Durable runs and sweeps of the port against ``repro`` (CPU).

``repro_torch.train.checkpoint`` case for case as ``tests/test_checkpoint.py``
holds the reference's; a run killed at a round boundary (in-process
``Preempted``) and resumed equals one that never stopped, bit for bit
(params, ledger, curves), on both planes for a slotless (feddif) and a
persistent-slot (gossip) strategy; the port resumes a checkpoint directory
that the reference wrote (ledger equal, params within the host-vs-fleet
tolerance, atol 2e-4 and rtol 2e-3, of the reference's uninterrupted run);
``describe()`` is the reference's string; a checkpoint of the async plane
(its curves and pending buffer in the reference's keys) is refused by a
sync run's engine guard; the sweep manifest refuses a
fresh start over old state and a changed config, isolates a crashing cell
and heals it on resume; a durable sweep killed mid-grid, in process or by
SIGTERM to the CLI, resumes to the same artifact after ``strip_volatile``.
"""
import dataclasses
import json
import os
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from repro.fl import ExperimentSpec as JSpec
from repro.fl import FLConfig as JConfig
from repro.fl import run_experiment as j_run
from repro.fl.engine import EngineSpec as JEngineSpec
from repro.fl.engine import engine_fingerprint as j_fingerprint
from repro.fl.resume import Preempted as JPreempted
from repro.fl.resume import RoundCheckpointer as JCheckpointer
from repro.fl.resume import _CONFIG_GUARD as J_GUARD
from repro.data.pipeline import ClientLoader as JLoader
from repro_torch.data.pipeline import ClientLoader
from repro_torch.experiments import (SweepManifest, cell_slug,
                                     default_state_dir, strip_volatile)
from repro_torch.experiments import orchestrator
from repro_torch.experiments.orchestrator import run_sweep
from repro_torch.fl import (EngineSpec, ExperimentSpec, FLConfig,
                            params_to_numpy, run_experiment)
from repro_torch.fl.engine import AsyncSpec, engine_fingerprint
from repro_torch.fl.executors import FleetExecutor, HostExecutor
from repro_torch.fl.resume import _CONFIG_GUARD, Preempted, RoundCheckpointer
from repro_torch.train import (atomic_write_json, latest_step, load_metadata,
                               restore_checkpoint, restore_latest,
                               save_checkpoint, valid_steps)
from repro_torch.tree import tree_leaves, tree_map

ROUNDS = 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------- train/checkpoint

def _tree_equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _like(tree):
    return tree_map(torch.empty_like, tree)


def _mixed_tree():
    """Non-uniform tree: nested dicts, a list, mixed dtypes, a 0-d leaf."""
    return {
        "params": [{"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                    "b": torch.ones(4, dtype=torch.float64)},
                   {"w": torch.full((2, 2), -3, dtype=torch.int32)}],
        "counters": {"steps": torch.tensor(17, dtype=torch.int64),
                     "mask": torch.tensor([True, False, True])},
    }


def test_nonuniform_tree_roundtrip(tmp_path):
    tree = _mixed_tree()
    save_checkpoint(str(tmp_path), 5, tree, metadata={"note": "x"})
    out = restore_checkpoint(str(tmp_path), 5, _like(tree))
    assert _tree_equal(tree, out)
    assert load_metadata(str(tmp_path), 5)["note"] == "x"
    assert load_metadata(str(tmp_path), 5)["step"] == 5
    # The reference's keys: dict keys and sequence indices joined by "/".
    with np.load(tmp_path / "ckpt_00000005.npz") as data:
        assert sorted(data) == ["counters/mask", "counters/steps",
                                "params/0/b", "params/0/w", "params/1/w"]


def test_restore_validates_shape_and_structure(tmp_path):
    tree = _mixed_tree()
    save_checkpoint(str(tmp_path), 1, tree)
    bad = tree_map(lambda x: torch.empty((7,) + tuple(x.shape),
                                         dtype=x.dtype), tree)
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(str(tmp_path), 1, bad)
    with pytest.raises(KeyError, match="missing leaf"):
        restore_checkpoint(str(tmp_path), 1,
                           {"other": _like(tree["counters"])})


def test_no_temp_debris_after_saves(tmp_path):
    for step in (1, 2, 3):
        save_checkpoint(str(tmp_path), step, _mixed_tree())
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_valid_steps_and_latest_step_ordering(tmp_path):
    tree = {"x": torch.zeros(2)}
    for step in (3, 10, 2):          # written out of order
        save_checkpoint(str(tmp_path), step, tree)
    assert valid_steps(str(tmp_path)) == [2, 3, 10]
    assert latest_step(str(tmp_path)) == 10
    assert valid_steps(str(tmp_path / "nope")) == []
    assert latest_step(str(tmp_path / "nope")) is None


def test_npz_without_commit_marker_is_invisible(tmp_path):
    tree = {"x": torch.arange(3.0)}
    save_checkpoint(str(tmp_path), 1, tree)
    save_checkpoint(str(tmp_path), 2, tree)
    os.remove(tmp_path / "ckpt_00000002.json")     # the torn pair
    assert valid_steps(str(tmp_path)) == [1]
    step, out, _ = restore_latest(str(tmp_path), _like(tree))
    assert step == 1 and _tree_equal(tree, out)


def test_restore_latest_falls_back_past_truncated_npz(tmp_path):
    tree = {"x": torch.arange(8.0),
            "y": {"z": torch.ones((2, 2), dtype=torch.int32)}}
    save_checkpoint(str(tmp_path), 1, tree)
    save_checkpoint(str(tmp_path), 2, tree)
    npz2 = tmp_path / "ckpt_00000002.npz"
    npz2.write_bytes(npz2.read_bytes()[:40])       # truncate mid-zip
    with pytest.warns(RuntimeWarning, match="unreadable"):
        step, out, meta = restore_latest(str(tmp_path), _like(tree))
    assert step == 1 and meta["step"] == 1
    assert _tree_equal(tree, out)


def test_restore_latest_falls_back_past_corrupt_metadata(tmp_path):
    tree = {"x": torch.arange(4.0)}
    save_checkpoint(str(tmp_path), 1, tree)
    save_checkpoint(str(tmp_path), 2, tree)
    (tmp_path / "ckpt_00000002.json").write_text("{not json")
    with pytest.warns(RuntimeWarning, match="unreadable"):
        step, out, _ = restore_latest(str(tmp_path), _like(tree))
    assert step == 1 and _tree_equal(tree, out)


def test_restore_latest_returns_none_when_nothing_readable(tmp_path):
    like = {"x": torch.empty(2)}
    assert restore_latest(str(tmp_path / "empty"), like) is None
    save_checkpoint(str(tmp_path), 1, {"x": torch.zeros(2)})
    (tmp_path / "ckpt_00000001.npz").write_bytes(b"garbage")
    with pytest.warns(RuntimeWarning, match="unreadable"):
        assert restore_latest(str(tmp_path), like) is None


def test_atomic_write_json_roundtrip_and_replace(tmp_path):
    path = str(tmp_path / "doc.json")
    atomic_write_json(path, {"a": 1})
    atomic_write_json(path, {"a": 2, "b": [1, 2, 3]}, indent=2)
    with open(path) as f:
        assert json.load(f) == {"a": 2, "b": [1, 2, 3]}
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_atomic_write_json_failure_preserves_old_contents(tmp_path):
    path = str(tmp_path / "doc.json")
    atomic_write_json(path, {"good": True})

    class Unserializable:
        pass

    with pytest.raises(TypeError):
        atomic_write_json(path, {"bad": Unserializable()})
    with open(path) as f:
        assert json.load(f) == {"good": True}
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_restore_puts_leaves_on_the_templates_dtype(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"x": np.arange(4, dtype=np.float64)})
    out = restore_checkpoint(str(tmp_path), 1, {"x": torch.empty(4)})
    assert out["x"].dtype == torch.float32
    assert torch.equal(out["x"], torch.arange(4.0))


# --------------------------------------------------------- loader cursors

def test_loader_seek_and_one_batch_match_reference():
    rng = np.random.default_rng(0)
    x, y = rng.normal(size=(37, 3)), rng.integers(0, 4, 37)
    ours, ref = ClientLoader(x, y, 8, 5), JLoader(x, y, 8, 5)
    for loader in (ours, ref):
        list(loader.epoch())
        loader.seek(4)
    assert ours.epochs_drawn == ref.epochs_drawn == 4
    a, b = ours.one_batch(), ref.one_batch()
    np.testing.assert_array_equal(a["x"], b["x"])
    assert ours.epochs_drawn == 5
    with pytest.raises(ValueError, match="empty"):
        ClientLoader(x[:0], y[:0], 8, 0).one_batch()


# ---------------------------------------------------- engine fingerprint

@pytest.mark.parametrize("fl", [
    dict(), dict(executor="fleet"), dict(planner="jax"),
    dict(executor="fleet", planner="jax"), dict(engine="host"),
    dict(engine="fleet"), dict(engine="auto"),
    dict(executor="sharded", num_clients=8, num_models=8)])
def test_describe_matches_reference(fl):
    assert engine_fingerprint(FLConfig(**fl)) == j_fingerprint(JConfig(**fl))


@pytest.mark.parametrize("mode", ["host", "fleet"])
@pytest.mark.parametrize("planner", ["host", "jax"])
def test_engine_spec_describe_matches_reference(mode, planner):
    assert (EngineSpec(mode=mode, planner=planner).describe()
            == JEngineSpec(mode=mode, planner=planner).describe())


def test_config_guard_matches_reference():
    assert _CONFIG_GUARD == J_GUARD
    assert all(hasattr(FLConfig(), k) for k in _CONFIG_GUARD)


# --------------------------------------------------- run-level kill/resume

def _spec(executor: str, strategy: str = "feddif", **fl_overrides
          ) -> ExperimentSpec:
    kwargs = dict(strategy=strategy, num_clients=4, num_models=4,
                  rounds=ROUNDS, topology_seed=7, executor=executor,
                  checkpoint_every=1, batch_size=8)
    kwargs.update(fl_overrides)
    return ExperimentSpec(task="logistic", num_samples=400,
                          fl=FLConfig(**kwargs))


def _run(spec, ckpt_dir):
    return run_experiment(spec, device="cpu", checkpoint_dir=ckpt_dir)


def _assert_results_identical(clean, resumed):
    assert clean.accuracy == resumed.accuracy
    assert clean.loss == resumed.loss
    assert clean.ledger == resumed.ledger
    assert clean.diffusion_rounds == resumed.diffusion_rounds
    assert clean.iid_distance == resumed.iid_distance
    assert len(resumed.round_wall_s) == ROUNDS
    assert _tree_equal(clean.final_params, resumed.final_params)


def _killed(spec, ckpt_dir, kill_round, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(RoundCheckpointer, "fail_after_save", kill_round)
        with pytest.raises(Preempted):
            _run(spec, ckpt_dir)


def _killed_then_resumed(spec, ckpt_dir, kill_round, monkeypatch):
    _killed(spec, ckpt_dir, kill_round, monkeypatch)
    return _run(spec, ckpt_dir)


@pytest.mark.parametrize("executor", ["host", "fleet"])
@pytest.mark.parametrize("strategy", ["feddif", "gossip"])
def test_kill_resume_bit_identical(executor, strategy, tmp_path,
                                   monkeypatch):
    spec = _spec(executor, strategy)
    clean = _run(spec, str(tmp_path / "clean"))
    resumed = _killed_then_resumed(spec, str(tmp_path / "killed"), 2,
                                   monkeypatch)
    _assert_results_identical(clean, resumed)
    meta = load_metadata(str(tmp_path / "killed"), 2)
    assert meta["has_slots"] == (strategy == "gossip")
    assert meta["engine"] == f"{executor}/planner=host/overlap=auto" \
                             f"/transport=auto/mb=32/km=1"
    assert meta["extra"]["loader_epochs"] and meta["rng_state"]["state"]


@pytest.mark.parametrize("kill_round", range(1, ROUNDS))
def test_kill_resume_every_boundary(kill_round, tmp_path, monkeypatch):
    spec = _spec("host")
    clean = _run(spec, str(tmp_path / "clean"))
    resumed = _killed_then_resumed(spec, str(tmp_path / "killed"),
                                   kill_round, monkeypatch)
    _assert_results_identical(clean, resumed)


def test_double_kill_resume(tmp_path, monkeypatch):
    spec = _spec("fleet", "gossip")
    clean = _run(spec, str(tmp_path / "clean"))
    d = str(tmp_path / "killed")
    for k in (1, 3):
        _killed(spec, d, k, monkeypatch)
    _assert_results_identical(clean, _run(spec, d))


def test_kill_resume_with_stateful_model_rng(tmp_path, monkeypatch):
    """With ``topology_seed=None`` the control plane draws from the model
    seed's generator; the resume restores its bit-generator position."""
    spec = _spec("host", topology_seed=None)
    clean = _run(spec, str(tmp_path / "clean"))
    resumed = _killed_then_resumed(spec, str(tmp_path / "killed"), 2,
                                   monkeypatch)
    _assert_results_identical(clean, resumed)


def test_corrupt_latest_checkpoint_falls_back_one_boundary(tmp_path,
                                                           monkeypatch):
    spec = _spec("fleet", "gossip")
    clean = _run(spec, str(tmp_path / "clean"))
    d = tmp_path / "killed"
    _killed(spec, str(d), 3, monkeypatch)
    assert valid_steps(str(d)) == [2, 3]          # keep=2 pruned step 1
    npz = d / "ckpt_00000003.npz"
    npz.write_bytes(npz.read_bytes()[:64])
    with pytest.warns(RuntimeWarning, match="round checkpoint 3"):
        resumed = _run(spec, str(d))
    _assert_results_identical(clean, resumed)


def test_resume_refuses_mismatched_config(tmp_path, monkeypatch):
    spec = _spec("host")
    d = str(tmp_path / "ckpt")
    _killed(spec, d, 2, monkeypatch)
    other = dataclasses.replace(
        spec, fl=dataclasses.replace(spec.fl, gamma_min=2.5))
    with pytest.raises(ValueError, match="different config"):
        _run(other, d)
    fleet = dataclasses.replace(
        spec, fl=dataclasses.replace(spec.fl, engine="fleet"))
    with pytest.raises(ValueError, match="engine"):
        _run(fleet, d)


def test_async_checkpoints_are_refused(tmp_path, monkeypatch):
    """A checkpoint of the async plane (its curves and pending buffer in the
    reference's keys) resumes only on the async engine that wrote it: a
    sync run refuses it by the engine fingerprint."""
    spec = _spec("host")
    eng = EngineSpec(mode="async", data_plane="host", buffered=AsyncSpec(
        buffer_k=2, delay_scale=0.01, delay_sigma=1.0))
    aspec = dataclasses.replace(spec, fl=dataclasses.replace(spec.fl,
                                                             engine=eng))
    d = str(tmp_path / "ckpt")
    _killed(aspec, d, 2, monkeypatch)
    meta = load_metadata(d, 2)
    assert set(meta["async_hist"]) == {"virtual_s", "arrivals",
                                       "staleness", "parked_hops"}
    assert meta["buffer"]["count"] == len(meta["buffer"]["seq"]) > 0
    with np.load(os.path.join(d, "ckpt_00000002.npz")) as z:
        assert any(k.startswith("abuf/") for k in z.files)
    with pytest.raises(ValueError, match="engine"):
        _run(spec, d)


def test_slot_capture_hooks_round_trip():
    cfg = FLConfig()
    params = {"w": torch.randn(3, 2), "b": torch.randn(2)}
    host = HostExecutor(None, [], cfg, torch.device("cpu"))
    slots = [tree_map(lambda x: x + i, params) for i in range(3)]
    saved = host.capture_slots(slots)
    assert host.num_slots_of(saved) == 3 and host.capture_slots(None) is None
    like = host.slots_like(params, 3)
    assert [tuple(x.shape) for x in tree_leaves(like)] == [(2,), (3, 2)] * 3
    assert _tree_equal(host.adopt_slots(saved), slots)
    fleet = FleetExecutor(lambda p, b: p["b"].sum(), [], cfg,
                          torch.device("cpu"))
    stacked = tree_map(lambda x: torch.stack([x, x + 1]), params)
    saved = fleet.capture_slots(stacked)
    assert fleet.num_slots_of(saved) == 2
    assert [tuple(x.shape) for x in tree_leaves(
        fleet.slots_like(params, 2))] == [(2, 2), (2, 3, 2)]
    strided = tree_map(lambda x: torch.stack([x, x], dim=-1)[..., 0], saved)
    assert not all(x.is_contiguous() for x in tree_leaves(strided))
    adopted = fleet.adopt_slots(strided)
    assert all(x.is_contiguous() for x in tree_leaves(adopted))
    assert _tree_equal(adopted, stacked)


# ------------------------------------------------ the reference's files

@pytest.mark.parametrize("executor,strategy", [("host", "gossip"),
                                               ("fleet", "feddif")])
def test_port_resumes_a_reference_checkpoint(executor, strategy, tmp_path,
                                             monkeypatch):
    """The reference writes round checkpoints up to round 2 and is killed;
    the port finishes the run from its files."""
    kw = dict(strategy=strategy, num_clients=4, num_models=4, rounds=ROUNDS,
              topology_seed=7, executor=executor, checkpoint_every=1,
              batch_size=8)
    data = dict(task="fcn", num_samples=400)
    clean = j_run(JSpec(fl=JConfig(**kw), **data))
    d = str(tmp_path / "ref")
    with monkeypatch.context() as m:
        m.setattr(JCheckpointer, "fail_after_save", 2)
        with pytest.raises(JPreempted):
            j_run(JSpec(fl=JConfig(**kw), **data), checkpoint_dir=d)
    resumed = run_experiment(ExperimentSpec(fl=FLConfig(**kw), **data),
                             device="cpu", checkpoint_dir=d)
    assert resumed.ledger.as_dict() == clean.ledger.as_dict()
    assert resumed.diffusion_rounds == clean.diffusion_rounds
    assert resumed.accuracy[:2] == clean.accuracy[:2]      # restored
    np.testing.assert_allclose(resumed.accuracy, clean.accuracy, atol=2e-3)
    ref = jax.tree.leaves(clean.final_params)
    got = jax.tree.leaves(params_to_numpy(resumed.final_params))
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b, np.asarray(a), atol=2e-4, rtol=2e-3)


# ----------------------------------------------------------- the manifest

SAMPLES = 400


def _durable_sweep(out, state, **kw):
    return run_sweep("fig3_alpha", seeds=(0, 1), out_dir=out,
                     state_dir=state, num_samples=SAMPLES, device="cpu", **kw)


def _same(a, b) -> bool:
    """Equal artifacts after ``strip_volatile``, the state directory's
    manifest path aside."""
    a, b = strip_volatile(a), strip_volatile(b)
    a.pop("manifest", None), b.pop("manifest", None)
    return (json.dumps(a, sort_keys=True, default=str)
            == json.dumps(b, sort_keys=True, default=str))


def test_cell_slug_and_default_state_dir(monkeypatch):
    assert cell_slug("alpha=0.1/feddif") == "alpha-0.1__feddif"
    monkeypatch.delenv("REPRO_BENCH_DIR", raising=False)
    assert default_state_dir("fig3_alpha") == os.path.join(
        "benchmarks", "results", "torch", "sweeps", "fig3_alpha")


def test_sweep_kill_resume_artifact_parity(tmp_path, monkeypatch):
    clean = _durable_sweep(str(tmp_path / "o1"), str(tmp_path / "s1"),
                           checkpoint_every=1)
    assert all(c["engine"] == "loop" for c in clean["cells"])
    with monkeypatch.context() as m:
        m.setattr(RoundCheckpointer, "fail_after_save", 1)
        with pytest.raises(Preempted):
            _durable_sweep(str(tmp_path / "o2"), str(tmp_path / "s2"),
                           checkpoint_every=1)
    resumed = _durable_sweep(str(tmp_path / "o2"), str(tmp_path / "s2"),
                             resume=True)
    assert _same(clean, resumed) and resumed["failed_cells"] == []
    man = SweepManifest.load(str(tmp_path / "s2"))
    assert all(c["status"] == "done" for c in man.data["cells"].values())
    assert resumed["manifest"] == man.path
    assert os.path.exists(tmp_path / "s2" / "plan_cache.json")


def test_sweep_failure_isolation_and_retry(tmp_path, monkeypatch):
    real_loop = orchestrator.run_replicates_loop
    clean = _durable_sweep(str(tmp_path / "o1"), str(tmp_path / "s1"),
                           checkpoint_every=1)
    poisoned = clean["cells"][0]

    def flaky(spec, seeds, plan_cache=None, **kw):
        if (spec.fl.strategy == poisoned["strategy"]
                and spec.alpha == poisoned["value"]):
            raise RuntimeError("injected cell crash")
        return real_loop(spec, seeds, plan_cache=plan_cache, **kw)

    with monkeypatch.context() as m:
        m.setattr(orchestrator, "run_replicates_loop", flaky)
        broken = _durable_sweep(str(tmp_path / "o2"), str(tmp_path / "s2"),
                                checkpoint_every=1)
    assert [f["label"] for f in broken["failed_cells"]] == [poisoned["label"]]
    assert "injected cell crash" in broken["failed_cells"][0]["error"]
    assert len(broken["cells"]) == len(clean["cells"]) - 1
    healed = _durable_sweep(str(tmp_path / "o2"), str(tmp_path / "s2"),
                            resume=True)
    assert healed["failed_cells"] == [] and _same(clean, healed)


def test_fresh_sweep_refuses_existing_state_dir(tmp_path):
    _durable_sweep(str(tmp_path / "o"), str(tmp_path / "s"),
                   checkpoint_every=1)
    with pytest.raises(FileExistsError, match="resume"):
        _durable_sweep(str(tmp_path / "o"), str(tmp_path / "s"),
                       checkpoint_every=1)


def test_resume_refuses_mismatched_sweep_config(tmp_path):
    _durable_sweep(str(tmp_path / "o"), str(tmp_path / "s"),
                   checkpoint_every=1)
    with pytest.raises(ValueError, match="different configuration"):
        run_sweep("fig3_alpha", seeds=(0, 1, 2), out_dir=str(tmp_path / "o"),
                  state_dir=str(tmp_path / "s"), num_samples=SAMPLES,
                  resume=True, device="cpu")


def test_resume_refuses_another_device(tmp_path, monkeypatch):
    """A sweep started on the card is not resumed on the CPU: its plan
    cache and round checkpoints were made on the other device.  The state
    directory is written here on the CPU and its manifest relabelled as
    the card's, as a sweep killed there would have left it."""
    with monkeypatch.context() as m:
        m.setattr(RoundCheckpointer, "fail_after_save", 1)
        with pytest.raises(Preempted):
            _durable_sweep(str(tmp_path / "o"), str(tmp_path / "s"),
                           checkpoint_every=1)
    man = SweepManifest.load(str(tmp_path / "s"))
    assert man.data["config"]["device"] == "cpu"
    man.data["config"]["device"] = "cuda"
    man.flush()
    with pytest.raises(ValueError, match="'device': \\('cuda', 'cpu'\\)"):
        _durable_sweep(str(tmp_path / "o"), str(tmp_path / "s"), resume=True)


def test_resume_replays_the_stored_plan_cache(tmp_path, monkeypatch):
    """A device-planned durable sweep killed in its second cell: the
    resumed run restores plan_cache.json and pre-plans nothing."""
    kw = dict(seeds=(0,), num_samples=SAMPLES, device="cpu", planner="jax",
              executor="fleet", state_dir=str(tmp_path / "s"),
              out_dir=str(tmp_path / "o"))
    clean = run_sweep("fig5_gamma_min", out_dir=None, seeds=(0,),
                      num_samples=SAMPLES, device="cpu", planner="jax",
                      executor="fleet")
    first = clean["cells"][0]["label"]
    seen = []

    def kill_in_second_cell(self, *a, **k):
        seen.append(self.directory)
        if cell_slug(first) not in self.directory:
            raise Preempted("killed in the second cell")

    with monkeypatch.context() as m:
        m.setattr(RoundCheckpointer, "save", kill_in_second_cell)
        with pytest.raises(Preempted):
            run_sweep("fig5_gamma_min", checkpoint_every=1, **kw)
    man = SweepManifest.load(str(tmp_path / "s"))
    assert man.status(first) == "done"
    lines = []
    pre = []
    real = orchestrator.prepopulate_plan_cache

    def spy(cells, cache, device=None):
        out = real(cells, cache, device=device)
        pre.append(out)
        return out

    monkeypatch.setattr(orchestrator, "prepopulate_plan_cache", spy)
    resumed = run_sweep("fig5_gamma_min", resume=True, log=lines.append,
                        **kw)
    assert pre[0]["planned"] == 0
    assert pre[0]["planner_stats"].get("loop_iterations", 0) == 0
    assert any("plan_cache,restored=" in line for line in lines)
    assert any(f"{first},resumed=done" in line for line in lines)
    assert all(c["plan_cache"]["misses"] == 0 for c in resumed["cells"])
    assert _same(clean, resumed)


# ------------------------------------------------------ SIGTERM the CLI

@pytest.mark.skipif(not hasattr(signal, "SIGTERM") or os.name != "posix",
                    reason="POSIX signals required")
def test_sigterm_kill_resume_cli(tmp_path):
    """SIGTERM a durable CLI sweep once a round checkpoint is committed,
    resume it with --resume, and diff the artifact against a clean run."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    state, out = str(tmp_path / "state"), str(tmp_path / "out")
    args = [sys.executable, "-m", "repro_torch.launch.sweep",
            "--sweep", "fig3_alpha", "--smoke", "--seeds", "2",
            "--checkpoint-every", "1", "--num-samples", str(SAMPLES),
            "--state-dir", state, "--out-dir", out, "--device", "cpu"]

    def committed():
        for _, _, files in os.walk(os.path.join(state, "cells")):
            if any(f.startswith("ckpt_") and f.endswith(".json")
                   for f in files):
                return True
        return False

    proc = subprocess.Popen(args, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    try:
        deadline = time.time() + 120
        while (time.time() < deadline and proc.poll() is None
               and not committed()):
            time.sleep(0.05)
        assert committed(), "no checkpoint ever committed"
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    r = subprocess.run(args + ["--resume"], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "# manifest" in r.stdout
    clean = _durable_sweep(str(tmp_path / "out-clean"),
                           str(tmp_path / "state-clean"), checkpoint_every=1)
    with open(os.path.join(out, "BENCH_feddif_fig3_alpha.json")) as f:
        resumed = json.load(f)
    assert resumed["failed_cells"] == [] and _same(clean, resumed)
