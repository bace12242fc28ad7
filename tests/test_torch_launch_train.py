"""The port's training launchers against the JAX package's, on the CPU.

* ``python -m repro_torch.launch.train --smoke`` (2 rounds, 4 clients, 4
  steps a round) through :func:`run_train` with the reference's initial
  params (``init_fn``) against ``python -m repro.launch.train`` with the
  same flags: the model line, every round's ``dif_rounds`` and the ledger
  (sub-frames, models, bits) bit for bit, eval losses within 2e-3 (bf16
  compute, the configs' own; the zoo's losses agree to ≈ 1e-3,
  ``tests/test_torch_zoo.py``; measured ≤ 1e-4 here), and ``--ckpt-dir``
  writing the reference's checkpoint.
* ``run_spmd_feddif(clients=4, rounds=2)`` from the reference's init
  against ``repro.launch.fl_spmd.run_spmd_feddif``: each round's diffusion
  rounds, final IID distance and ledger sub-frames bit for bit, the mean
  client losses within 2e-3 (bf16 compute; measured ≤ 1.1e-4); the same
  at zamba2-smoke, its ``mamba2`` layers through ``ssd_scan``'s gradient
  (measured ≤ 8.8e-5).
* Without a GPU the entry points raise unless given ``device="cpu"``; the
  client-sharded mesh raises naming A12.
"""
import sys

import jax
import numpy as np
import pytest
import torch

import repro.launch.fl_spmd as j_spmd
import repro.launch.train as j_train
from repro.configs import get_smoke_config as j_get_smoke
from repro.models.zoo import build_model as j_build
from repro_torch.launch import fl_spmd, train
from repro_torch.models.zoo import params_from_numpy
from repro_torch.train import load_metadata, restore_checkpoint

FLAGS = ["--arch", "smollm_360m", "--smoke", "--rounds", "2", "--clients",
         "4", "--steps-per-round", "4"]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _reference_init(seed=0, arch="smollm_360m"):
    params = j_build(j_get_smoke(arch)).init(jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, params)


def _fields(line):
    """``key=value`` pairs of one output line, time stripped."""
    return dict(tok.split("=", 1) for tok in line.split()
                if "=" in tok and not tok.startswith("("))


def test_launch_train_matches_reference(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(sys, "argv", ["train", *FLAGS, "--ckpt-dir",
                                      str(tmp_path / "ref")])
    j_train.main()
    want = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    init = _reference_init()
    lines = []
    result = train.run_train(
        "smollm_360m", smoke=True, rounds=2, clients=4, steps_per_round=4,
        ckpt_dir=str(tmp_path / "port"), device="cpu",
        init_fn=lambda gen: params_from_numpy(init), log=lines.append)
    assert len(lines) == len(want)
    assert lines[0] == want[0]                        # the model line
    for got, ref in zip(lines[1:3], want[1:3]):       # the round lines
        g, r = _fields(got), _fields(ref)
        assert g["dif_rounds"] == r["dif_rounds"]
        assert abs(float(g["eval_loss"]) - float(r["eval_loss"])) <= 2e-3
    g, r = _fields(lines[3]), _fields(want[3])        # the ledger line
    assert (g["subframes"], g["models"], g["bits"]) == (
        r["subframes"], r["models"], r["bits"])
    assert lines[4].startswith("global model checkpointed")
    assert result.ledger.subframes == int(r["subframes"])
    # The port's checkpoint is the reference's format: it restores onto the
    # reference's template.
    meta = load_metadata(str(tmp_path / "port"), 2)
    assert meta["arch"] == "smollm-smoke" and len(meta["loss_history"]) == 2
    restored = restore_checkpoint(str(tmp_path / "ref"), 2,
                                  result.final_params)
    for a, b in zip(jax.tree.leaves(restored, is_leaf=torch.is_tensor),
                    jax.tree.leaves(result.final_params,
                                    is_leaf=torch.is_tensor)):
        assert a.shape == b.shape


def test_launch_train_cli_on_the_cpu(capsys):
    train.main([*FLAGS[:3], "--rounds", "1", "--clients", "2",
                "--steps-per-round", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "round 1: eval_loss=" in out and "ledger: subframes=" in out


def _spmd_matches_reference(arch):
    want_lines, got_lines = [], []
    _, want_hist = j_spmd.run_spmd_feddif(arch, clients=4, rounds=2,
                                          log=want_lines.append)
    init = _reference_init(arch=arch)
    state, hist, ledger = fl_spmd.run_spmd_feddif(
        arch, clients=4, rounds=2, log=got_lines.append, device="cpu",
        init_fn=lambda gen: params_from_numpy(init))
    assert len(got_lines) == len(want_lines) == 2
    for got, ref in zip(got_lines, want_lines):
        g, r = _fields(got), _fields(ref)
        for key in ("diffusion_rounds", "final_iid", "subframes"):
            assert g[key] == r[key]
    assert ledger.subframes == int(_fields(want_lines[-1])["subframes"])
    np.testing.assert_allclose(hist, want_hist, atol=2e-3)
    assert all(bool(torch.isfinite(x).all())
               for x in jax.tree.leaves(state.params,
                                        is_leaf=torch.is_tensor))


def test_fl_spmd_matches_reference():
    _spmd_matches_reference("smollm_360m")


def test_fl_spmd_zamba2_matches_reference():
    _spmd_matches_reference("zamba2_2_7b")


def test_entry_points_refuse_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.run_train(smoke=True, rounds=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fl_spmd.run_spmd_feddif(rounds=1)
    with pytest.raises(NotImplementedError, match="A12"):
        fl_spmd.run_spmd_feddif(rounds=1, shard_clients=True, device="cpu")
