"""The ``lm`` task and the adapter hop plane of the port against the JAX
package's, on the CPU (plain kernel versions).

* data: ``lm_corpus``, ``class_labels_for_lm`` and
  ``load_experiment_data(task="lm")`` give the reference's arrays, DSIs and
  loader batches bit for bit;
* the model, from the reference's own params: logits within atol 1e-5
  (fp32 products of width ≤ 128 in another order), loss and next-token
  accuracy within 1e-5; ``split``/``merge`` round-trip;
* ``spec_model_bits`` / ``spec_adapter_bits`` equal the reference's;
* the slice as a whole: FedDif on ``lm`` with int8 adapter hops (the
  reference's ``tests/test_adapter_hops.py`` cell), the port from the
  reference's init against ``executor="fleet"``: equal ledgers and
  diffusion rounds, a bit-identical frozen base, adapters within the
  reference's own cross-executor tolerance (atol 5e-4, rtol 5e-3);
* full-params tasks: ``adapter_hops`` changes nothing, and ``fcn`` with
  int8 hops matches the reference's fleet run (atol 2e-4, rtol 2e-3).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.data.synthetic import class_labels_for_lm as j_labels
from repro.data.synthetic import lm_corpus as j_corpus
from repro.fl import ExperimentSpec as JSpec
from repro.fl import FLConfig as JConfig
from repro.fl import run_experiment as j_run
from repro.fl.adapters import make_adapter_view as j_view
from repro.fl.experiment import load_experiment_data as j_load
from repro.fl.experiment import spec_adapter_bits as j_adapter_bits
from repro.fl.experiment import spec_model_bits as j_model_bits
from repro.fl.models import build_task_model as j_build
from repro_torch.data.synthetic import class_labels_for_lm, lm_corpus
from repro_torch.fl import (ExperimentSpec, FLConfig, build_task_model,
                            load_experiment_data, make_adapter_view,
                            packed_bits, params_from_numpy, params_to_numpy,
                            run_experiment, spec_adapter_bits,
                            spec_model_bits)
from repro_torch.tree import tree_leaves


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _specs(task="lm", hop_quant="int8", adapter_hops=True, clients=4,
           rounds=2):
    """The reference's ``tests/test_adapter_hops.py`` cell, both packages."""
    fl = dict(strategy="feddif", rounds=rounds, num_clients=clients,
              num_models=clients, seed=0, topology_seed=1,
              max_diffusion_rounds=3, hop_quant=hop_quant)
    data = dict(task=task, alpha=0.5, dim=16 if task == "lm" else 64,
                num_samples=640, adapter_hops=adapter_hops)
    return (JSpec(fl=JConfig(engine="fleet", **fl), **data),
            ExperimentSpec(fl=FLConfig(executor="fleet", **fl), **data))


def _ref_init(task="lm"):
    return jax.tree.map(np.asarray, j_build(task).init(jax.random.PRNGKey(0)))


# ---------------------------------------------------------------------- data

@pytest.mark.parametrize("n,vocab,seed", [(5000, 128, 0), (777, 64, 3)])
def test_lm_corpus_and_labels_are_identical(n, vocab, seed):
    tokens = lm_corpus(n, vocab=vocab, seed=seed)
    np.testing.assert_array_equal(tokens, j_corpus(n, vocab=vocab,
                                                   seed=seed))
    assert tokens.dtype == np.int32
    for classes, seq in ((10, 16), (4, 32)):
        np.testing.assert_array_equal(
            class_labels_for_lm(tokens, classes, seq),
            j_labels(tokens, classes, seq))


def test_lm_experiment_data_is_identical():
    j_spec, t_spec = _specs(clients=5)
    j_train, j_test, j_part, j_loaders = j_load(j_spec)
    t_train, t_test, t_part, t_loaders = load_experiment_data(t_spec)
    for a, b in ((j_train, t_train), (j_test, t_test)):
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.y, b.y)
        assert b.x.dtype == np.int32 and b.x.shape[1] == t_spec.dim
    np.testing.assert_array_equal(j_part.dsi, t_part.dsi)
    np.testing.assert_array_equal(j_part.data_sizes, t_part.data_sizes)
    for jl, tl in zip(j_loaders, t_loaders):
        for _ in range(2):
            jb, tb = list(jl.epoch()), list(tl.epoch())
            assert len(jb) == len(tb)
            for a, b in zip(jb, tb):
                np.testing.assert_array_equal(a["x"], b["x"])


# --------------------------------------------------------------------- model

def test_lm_model_matches_reference_from_its_params():
    init = _ref_init()
    j_model, t_model = j_build("lm"), build_task_model("lm")
    params = params_from_numpy(init)
    tokens = np.random.default_rng(0).integers(0, 128, size=(6, 16)).astype(
        np.int32)
    want = np.asarray(j_model.logits(init, tokens[:, :-1]))
    got = t_model.logits(params, torch.from_numpy(tokens[:, :-1])).numpy()
    assert got.shape == want.shape == (6, 15, 128)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    batch = {"x": tokens, "y": np.zeros(6, np.int64)}
    t_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    np.testing.assert_allclose(float(t_model.loss(params, t_batch)),
                               float(j_model.loss(init, batch)), atol=1e-5)
    np.testing.assert_allclose(
        float(t_model.accuracy(params, t_batch["x"], t_batch["y"])),
        float(j_model.accuracy(init, tokens, batch["y"])), atol=1e-5)


def test_lm_split_merge_and_own_init():
    """split/merge round-trip; the port's own init has the reference's
    leaf order and shapes, LoRA ``b`` zero (an exact zero delta)."""
    model = build_task_model("lm")
    params = model.init(torch.Generator().manual_seed(0))
    base, lora = model.split(params)
    merged = model.merge(base, lora)
    for a, b in zip(tree_leaves(merged), tree_leaves(params)):
        assert a is b
    ref = jax.tree.leaves(_ref_init())
    ours = tree_leaves(params)
    assert [x.shape for x in ref] == [tuple(x.shape) for x in ours]
    for layer in lora:
        for proj in layer.values():
            assert not proj["b"].any() and proj["a"].std() > 0


def test_spec_bits_match_reference():
    variants = [_specs(), _specs(hop_quant="none"),
                _specs(hop_quant="none", adapter_hops=False),
                _specs(task="fcn", hop_quant="none"),
                _specs(task="fcn", hop_quant="int8")]
    t_spec = variants[0][1]
    for j, t in variants:
        assert spec_model_bits(t) == j_model_bits(j)
        assert spec_adapter_bits(t) == j_adapter_bits(j)
    b_int8, b_f32, b_full = (spec_adapter_bits(t) for _, t in variants[:3])
    assert b_int8 < b_f32 < b_full == spec_model_bits(t_spec)
    assert b_full / b_int8 >= 50.0
    model = build_task_model("lm")
    _, adapter = model.split(model.init(torch.Generator()))
    assert b_int8 == packed_bits(adapter)
    # 3584 adapter values: exactly 7 row-blocks of 512.
    assert sum(x.numel() for x in tree_leaves(adapter)) == 7 * 512
    fcn = variants[3][1]
    assert spec_adapter_bits(fcn) == spec_model_bits(fcn)


# --------------------------------------------------------- the whole slice

def test_lm_int8_hops_match_reference_fleet():
    j_spec, t_spec = _specs()
    ref = j_run(j_spec)
    init = _ref_init()
    port = run_experiment(t_spec, device="cpu",
                          init_fn=lambda gen: params_from_numpy(init))
    assert port.ledger.as_dict() == ref.ledger.as_dict()
    assert port.diffusion_rounds == ref.diffusion_rounds
    assert sum(port.diffusion_rounds) > 0
    # The hop payload is the adapter; the frozen base never moves.
    model = build_task_model("lm")
    view = make_adapter_view(model, t_spec.fl,
                             init_fn=lambda gen: params_from_numpy(init))
    base_f, adapter_f = model.split(view.merge_fn(port.final_params))
    for a, b, c in zip(tree_leaves(base_f), tree_leaves(view.base),
                       jax.tree.leaves(init["base"])):
        np.testing.assert_array_equal(a.numpy(), c)
        np.testing.assert_array_equal(b.numpy(), c)
    j_base = j_view(j_build("lm"), j_spec.fl).base
    for a, b in zip(tree_leaves(base_f), jax.tree.leaves(j_base)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ref_leaves = jax.tree.leaves(ref.final_params)
    port_leaves = jax.tree.leaves(params_to_numpy(adapter_f))
    assert len(ref_leaves) == len(port_leaves) == 24
    for a, b in zip(ref_leaves, port_leaves):
        np.testing.assert_allclose(b, np.asarray(a, np.float32), atol=5e-4,
                                   rtol=5e-3)
    assert any(not np.array_equal(b, a) for a, b in
               zip(jax.tree.leaves(init["lora"]), port_leaves))
    np.testing.assert_allclose(port.accuracy, ref.accuracy, atol=0.02)
    np.testing.assert_allclose(port.loss, ref.loss, atol=1e-3)
    # One round-0 base downlink on top of one downlink per round.
    assert port.ledger.as_dict()["downlink_models"] == t_spec.fl.rounds + 1


def test_lm_ledger_decomposes_into_adapter_bits():
    """transmitted_bits = uplinks·(fp32 adapter) + D2D hops·(int8 adapter)
    (``benchmarks/run.py``'s lm_hops decomposition), on the port alone."""
    _, spec = _specs()
    res = run_experiment(spec, device="cpu")
    led = res.ledger.as_dict()
    hop = spec_adapter_bits(spec)
    f32 = spec_adapter_bits(dataclasses.replace(
        spec, fl=dataclasses.replace(spec.fl, hop_quant="none")))
    d2d = led["transmitted_models"] - led["uplink_models"]
    assert d2d > 0
    np.testing.assert_allclose(led["transmitted_bits"],
                               led["uplink_models"] * f32 + d2d * hop,
                               rtol=1e-9)
    for x in tree_leaves(res.final_params):
        assert torch.isfinite(x).all()


def test_full_params_tasks_unaffected_by_adapter_flag():
    """No-split tasks get the identity view: ``adapter_hops`` on or off is
    the same program, bit for bit."""
    runs = [run_experiment(_specs(task="fcn", hop_quant="none",
                                  adapter_hops=flag)[1], device="cpu")
            for flag in (True, False)]
    assert runs[0].ledger.as_dict() == runs[1].ledger.as_dict()
    assert runs[0].ledger.as_dict()["downlink_models"] == 2
    for a, b in zip(tree_leaves(runs[0].final_params),
                    tree_leaves(runs[1].final_params)):
        assert torch.equal(a, b)


def test_fcn_int8_hops_match_reference_fleet():
    j_spec, t_spec = _specs(task="fcn")
    ref = j_run(j_spec)
    init = _ref_init("fcn")
    port = run_experiment(t_spec, device="cpu",
                          init_fn=lambda gen: params_from_numpy(init))
    assert port.ledger.as_dict() == ref.ledger.as_dict()
    assert port.diffusion_rounds == ref.diffusion_rounds
    for a, b in zip(jax.tree.leaves(ref.final_params),
                    jax.tree.leaves(params_to_numpy(port.final_params))):
        np.testing.assert_allclose(b, np.asarray(a, np.float32), atol=2e-4,
                                   rtol=2e-3)
