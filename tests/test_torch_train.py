"""The port's training pieces against the JAX package's, on the CPU.

* ``train/optimizer.py``: SGD (heavy-ball, Nesterov, weight decay) and
  AdamW over 3 steps, the global-norm clip and the three LR schedules
  against ``repro.train.optimizer`` on the same numpy trees, within fp32
  tolerance (atol 1e-6, rtol 1e-5: one fp32 op per term, ``pow`` and
  ``cos`` from other libraries).
* ``data/pipeline.py::lm_batches`` bit for bit.
* ``train/trainstep.py``: ``init_train_state``; one ``make_train_step``
  with SGD and one with AdamW under ``warmup_cosine_lr`` against the
  reference's, from its init (smollm-smoke, fp32 compute): loss within
  2e-5, grad norm within 1e-4 relative, and after each of two steps SGD's
  params within atol 2e-5 (measured ≤ 3.0e-6: the gradients agree to 3e-4
  of their scale).  AdamW scales each element's step to about lr whatever
  its gradient's size, so an element whose gradient is within rounding of
  0 may move anywhere in ±lr: its params are held within lr (1e-3) per
  element and 1e-6 in the mean |Δ| (measured 3.8e-4 and 6.7e-9);
  ``accum_steps=2`` against one step on the whole batch
  (``tests/test_train_substrate.py``'s bar); the step under ``vmap``
  against a loop over clients.
  The vmapped step also at zamba2-smoke (its ``mamba2`` layers through
  ``ssd_scan``), port only, against the loop over clients.
* The refusals without a GPU: the backward CUDA wrappers take CUDA tensors
  only.  ``ops.ssd_scan``'s card route, forced on the CPU with the plain
  twins in its ``Function``, runs the forward and the backward through it
  and gives autograd's gradient.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from repro.configs import get_smoke_config as j_get_smoke
from repro.data.pipeline import lm_batches as j_lm_batches
from repro.data.synthetic import lm_corpus as j_lm_corpus
from repro.models.zoo import build_model as j_build
from repro.train import optimizer as jopt
from repro.train import trainstep as jts
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import lm_batches
from repro_torch.data.synthetic import lm_corpus
from repro_torch.kernels import ops
from repro_torch.models.zoo import build_model, params_from_numpy
from repro_torch.train import optimizer as topt
from repro_torch.train import trainstep as tts
from repro_torch.tree import tree_leaves, tree_map
from test_torch_zoo import HEAD_DIM_CUTS


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": [rng.standard_normal((5,)).astype(np.float32),
                  rng.standard_normal((2, 2, 2)).astype(np.float32)]}


def _assert_trees_close(got, want, atol=1e-6, rtol=1e-5):
    got_leaves = tree_leaves(got)
    want_leaves = jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g.detach().float().numpy(),
                                   np.asarray(w, np.float32),
                                   atol=atol, rtol=rtol)


# ------------------------------------------------------------- optimizers

OPTIMIZERS = [
    ("sgd", dict(momentum=0.9)),
    ("sgd", dict(momentum=0.9, nesterov=True)),
    ("sgd", dict(momentum=0.8, nesterov=True, weight_decay=0.01)),
    ("sgd", dict(momentum=0.0, weight_decay=0.1)),
    ("adamw", dict()),
    ("adamw", dict(b1=0.8, b2=0.99, eps=1e-6, weight_decay=0.0)),
]


@pytest.mark.parametrize("name,kw", OPTIMIZERS)
def test_optimizer_three_steps_match_reference(name, kw):
    jo = getattr(jopt, name)(**kw)
    to = getattr(topt, name)(**kw)
    params = _tree(0)
    jp = jax.tree.map(jnp.asarray, params)
    tp = params_from_numpy(params)
    js, ts = jo.init(jp), to.init(tp)
    for i in range(3):
        grads = _tree(10 + i)
        lr = 0.05 * (i + 1)
        ju, js = jo.update(jax.tree.map(jnp.asarray, grads), js, jp, lr)
        tu, ts = to.update(params_from_numpy(grads), ts, tp, lr)
        jp = jopt.apply_updates(jp, ju)
        tp = topt.apply_updates(tp, tu)
        _assert_trees_close(tu, ju)
        _assert_trees_close(tp, jp)
    if name == "adamw":
        assert ts["count"].dtype == torch.int32 and int(ts["count"]) == 3
        _assert_trees_close(ts["m"], js["m"])
        _assert_trees_close(ts["v"], js["v"])
    else:
        _assert_trees_close(ts["mu"], js["mu"])


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    grads = _tree(3)
    jc, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, grads),
                                      max_norm)
    tc, tn = topt.clip_by_global_norm(params_from_numpy(grads), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    _assert_trees_close(tc, jc)


SCHEDULES = [
    ("constant_lr", (0.01,)),
    ("cosine_lr", (0.1, 50, 0.01)),
    ("cosine_lr", (0.1, 0)),
    ("warmup_cosine_lr", (0.3, 5, 40)),
    ("warmup_cosine_lr", (0.3, 0, 10, 0.05)),
]


@pytest.mark.parametrize("name,args", SCHEDULES)
def test_schedules_match_reference(name, args):
    jfn = getattr(jopt, name)(*args)
    tfn = getattr(topt, name)(*args)
    for step in (0, 1, 4, 5, 6, 25, 39, 40, 41, 60):
        want = float(jfn(jnp.asarray(step, jnp.int32)))
        got = tfn(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-9)


def test_lm_batches_bit_for_bit():
    tokens = lm_corpus(20_000, vocab=300, seed=4)
    np.testing.assert_array_equal(tokens, j_lm_corpus(20_000, vocab=300,
                                                      seed=4))
    mine, ref = lm_batches(tokens, 3, 33, seed=9), j_lm_batches(tokens, 3,
                                                               33, seed=9)
    for _ in range(4):
        a, b = next(mine), next(ref)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])


# ------------------------------------------------------------- train step

ARCH = "smollm_360m"


def _cfgs():
    return (dataclasses.replace(j_get_smoke(ARCH), compute_dtype="float32"),
            dataclasses.replace(get_smoke_config(ARCH),
                                compute_dtype="float32"))


def _lm_batch(vocab, b=4, s=16, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (b, s)).astype(np.int32)
    return {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}


@functools.lru_cache(maxsize=None)
def _reference_step(opt_name):
    jcfg, _ = _cfgs()
    model = j_build(jcfg)
    opt, lr_fn = _opt(jopt, opt_name)
    state = jts.init_train_state(model, jax.random.PRNGKey(0), opt)
    batch = {k: jnp.asarray(v) for k, v in _lm_batch(jcfg.vocab_size).items()}
    step = jts.make_train_step(model, opt, lr_fn, clip_norm=1.0, remat=True)
    # Two steps, so AdamW's warmup gives a non-zero rate on the second.
    state1, _ = step(state, batch)
    state2, metrics = step(state1, batch)
    to_np = functools.partial(jax.tree.map, np.asarray)
    return (to_np(state1.params), to_np(state1.opt_state), int(state1.step),
            to_np(state2.params), {k: float(v) for k, v in metrics.items()})


def _opt(lib, name):
    if name == "sgd":
        return lib.sgd(momentum=0.9, nesterov=True), lib.constant_lr(0.05)
    return lib.adamw(), lib.warmup_cosine_lr(1e-3, 1, 10)


def _assert_params_close(opt_name, got, want):
    if opt_name == "sgd":
        _assert_trees_close(got, want, atol=2e-5, rtol=0)
        return
    diffs = [np.abs(g.numpy() - np.asarray(w)) for g, w in zip(
        tree_leaves(got), jax.tree.leaves(want))]
    assert max(float(d.max()) for d in diffs) <= 1e-3
    assert (sum(float(d.sum()) for d in diffs)
            <= 1e-6 * sum(d.size for d in diffs))


@pytest.mark.parametrize("opt_name", ["sgd", "adamw"])
def test_train_step_matches_reference(opt_name):
    params1, opt_state1, step1, params2, metrics = _reference_step(opt_name)
    _, cfg = _cfgs()
    model = build_model(cfg)
    opt, lr_fn = _opt(topt, opt_name)
    jcfg, _ = _cfgs()
    init = j_build(jcfg).init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, init))
    state = tts.TrainState(params=params, opt_state=opt.init(params),
                           step=torch.zeros((), dtype=torch.int32))
    batch = {k: torch.from_numpy(v) for k, v in
             _lm_batch(cfg.vocab_size).items()}
    step = tts.make_train_step(model, opt, lr_fn, clip_norm=1.0, remat=True)
    state, _ = step(state, batch)
    assert int(state.step) == step1 == 1 and state.step.dtype == torch.int32
    _assert_params_close(opt_name, state.params, params1)
    state, got = step(state, batch)
    _assert_params_close(opt_name, state.params, params2)
    assert float(got["loss"]) == pytest.approx(metrics["loss"], abs=2e-5)
    assert float(got["grad_norm"]) == pytest.approx(metrics["grad_norm"],
                                                    rel=1e-4)
    assert float(got["lr"]) == pytest.approx(metrics["lr"], rel=1e-6)
    assert float(got["lr"]) > 0.0


def test_init_train_state():
    _, cfg = _cfgs()
    model = build_model(cfg)
    state = tts.init_train_state(model, torch.Generator().manual_seed(0),
                                 topt.adamw())
    assert int(state.step) == 0 and state.step.dtype == torch.int32
    assert int(state.opt_state["count"]) == 0
    for p, m in zip(tree_leaves(state.params),
                    tree_leaves(state.opt_state["m"])):
        assert m.shape == p.shape and m.dtype == torch.float32
        assert float(m.abs().max()) == 0.0


def test_accum_steps_two_matches_one():
    _, cfg = _cfgs()
    model = build_model(cfg)
    opt = topt.sgd(momentum=0.0)
    params = model.init(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v)
             for k, v in _lm_batch(cfg.vocab_size).items()}
    s1 = tts.TrainState(params, opt.init(params), torch.zeros((),
                                                               dtype=torch.int32))
    one = tts.make_train_step(model, opt, remat=False, clip_norm=None)
    two = tts.make_train_step(model, opt, remat=False, clip_norm=None,
                              accum_steps=2)
    a, ma = one(s1, batch)
    b, mb = two(s1, {k: v.reshape(2, 2, *v.shape[1:])
                     for k, v in batch.items()})
    assert float(ma["loss"]) == pytest.approx(float(mb["loss"]), rel=1e-4)
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-4,
                                   rtol=1e-3)
    with pytest.raises(ValueError, match="accum_steps"):
        two(s1, batch)


@pytest.mark.parametrize("arch", [ARCH, "zamba2_2_7b", "mixtral_8x22b"])
def test_train_step_vmaps_over_clients(arch):
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    model = build_model(cfg)
    opt = topt.adamw()
    params = model.init(torch.Generator().manual_seed(1))
    step = tts.make_train_step(model, opt, topt.warmup_cosine_lr(1e-2, 2, 8))
    states, batches = [], []
    for c in range(3):
        p = tree_map(lambda x: x * (1.0 + 0.1 * c), params)
        states.append(tts.TrainState(p, opt.init(p),
                                     torch.tensor(c, dtype=torch.int32)))
        batches.append({k: torch.from_numpy(v) for k, v in
                        _lm_batch(cfg.vocab_size, seed=c).items()})
    stacked = torch.utils._pytree.tree_map(lambda *x: torch.stack(x),
                                           states[0], *states[1:])
    sbatch = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    fleet, metrics = vmap(step)(stacked, sbatch)
    assert metrics["loss"].shape == (3,)
    for c in range(3):
        want, wm = step(states[c], batches[c])
        assert float(metrics["lr"][c]) == pytest.approx(float(wm["lr"]))
        for x, y in zip(tree_leaves(fleet.params), tree_leaves(want.params)):
            np.testing.assert_allclose(x[c].numpy(), y.numpy(), atol=1e-6,
                                       rtol=1e-5)


# ---------------------------------------------------------------- refusals

def test_backward_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    from repro_torch.kernels.launch import LAUNCHES
    from repro_torch.kernels.ssd_scan import BWD_LAUNCHES, ssd_scan_bwd_cuda
    from repro_torch.kernels.ssm_scan import ssm_scan_bwd_cuda
    x = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd_cuda(x, x, x, x, x)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd_cuda(*(x.to(torch.bfloat16),) * 5)
    with pytest.raises(ValueError, match="CUDA"):
        ssm_scan_bwd_cuda(x, x, x)
    a, bm = torch.zeros((1, 8, 2)), torch.zeros((1, 8, 4))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_bwd_cuda(x, a, bm, bm, x, states=torch.zeros(
            (1, 1, 2, 16, 16)), acum=torch.zeros((1, 1, 2, 16)), chunk=8)
    assert {"flash_attention_bwd", "ssm_scan_bwd", *BWD_LAUNCHES} <= set(
        LAUNCHES)


def test_ssd_scan_card_route_runs_the_function(monkeypatch):
    """With the route forced to ``cuda`` and ``SsdScan`` built on the plain
    twins, ``ops.ssd_scan`` returns y alone, its forward and backward run
    through the ``Function`` once each, and the gradient is autograd's of
    the plain forward (the CPU route)."""
    from repro_torch.kernels import autograd as kag
    from repro_torch.kernels import ref as tref
    seen = []

    def fwd(*t, **kw):
        seen.append("fwd")
        return tref.ssd_scan_ref(*t, kw["chunk"],
                                 return_state=kw["return_state"])

    def bwd(*t, **kw):
        seen.append("bwd")
        return tref.ssd_scan_bwd_ref(*t, **kw)

    rng = np.random.default_rng(9)
    xh, w = (torch.from_numpy(rng.standard_normal((2, 20, 3, 4)).astype(
        np.float32)) for _ in range(2))
    a = torch.from_numpy((-0.5 * rng.uniform(size=(2, 20, 3))).astype(
        np.float32))
    bm, cm = (torch.from_numpy(rng.standard_normal((2, 20, 5)).astype(
        np.float32)) for _ in range(2))

    def loss(*t):
        return (ops.ssd_scan(*t, chunk=8) * w).sum()

    want = torch.func.grad(loss, argnums=(0, 1, 2, 3))(xh, a, bm, cm)
    monkeypatch.setattr(ops, "_route", lambda t: "cuda")
    monkeypatch.setattr(ops, "SsdScan", kag.ssd_function(fwd, bwd))
    y = ops.ssd_scan(xh, a, bm, cm, chunk=8)
    assert isinstance(y, torch.Tensor) and y.shape == xh.shape
    seen.clear()
    got = torch.func.grad(loss, argnums=(0, 1, 2, 3))(xh, a, bm, cm)
    assert seen == ["fwd", "bwd"]
    for x, y_ in zip(got, want):
        np.testing.assert_allclose(x.numpy(), y_.numpy(), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("arch", ["gemma3_4b", "pixtral_12b"])
def test_one_step_of_the_local_global_and_vision_families(arch):
    """One fp32 SGD step (clip 1.0, remat on) at gemma3-smoke (a ``swa``
    and an ``attn`` layer, tied and scaled embeddings) and pixtral-smoke
    (16 patch embeddings ahead of the text, the loss over the text) from
    the reference's init: params within 2e-5 of the reference's step,
    loss within 2e-5, the gradient's norm within rel 1e-4."""
    jcfg = dataclasses.replace(j_get_smoke(arch), compute_dtype="float32")
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    batch = _lm_batch(cfg.vocab_size)
    if cfg.frontend == "vision":
        batch["patch_embeddings"] = np.random.default_rng(5).normal(size=(
            4, cfg.num_frontend_tokens, cfg.d_model)).astype(np.float32)
    jmodel = j_build(jcfg)
    jopt_, jlr = _opt(jopt, "sgd")
    jstate = jts.init_train_state(jmodel, jax.random.PRNGKey(0), jopt_)
    jstate1, jmetrics = jts.make_train_step(
        jmodel, jopt_, jlr, clip_norm=1.0, remat=True)(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    model = build_model(cfg)
    opt, lr_fn = _opt(topt, "sgd")
    params = params_from_numpy(jax.tree.map(np.asarray, jstate.params))
    state = tts.TrainState(params=params, opt_state=opt.init(params),
                           step=torch.zeros((), dtype=torch.int32))
    state, metrics = tts.make_train_step(model, opt, lr_fn, clip_norm=1.0,
                                         remat=True)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    _assert_trees_close(state.params, jstate1.params, atol=2e-5, rtol=0)
    assert float(metrics["loss"]) == pytest.approx(float(jmetrics["loss"]),
                                                   abs=2e-5)
    assert float(metrics["grad_norm"]) == pytest.approx(
        float(jmetrics["grad_norm"]), rel=1e-4)


@pytest.mark.parametrize("cut,opt_name", [("gemma3_4b@256", "adamw"),
                                          ("pixtral_12b@160", "sgd")])
def test_one_step_at_the_head_dim_cuts(cut, opt_name):
    """One fp32 step (clip 1.0, remat on) at the head-dim cuts of
    ``tests/test_torch_zoo.py`` (gemma3 at head dim 256 with a 16-key
    window, pixtral at 160 with its 16 patch embeddings), the head dims
    whose backward the card runs on its ``wgmma`` instances: AdamW at a
    constant 1e-3 at the gemma3 cut (its first step moves every param),
    SGD with Nesterov momentum at the pixtral cut, from the reference's
    init.  The bars of ``test_one_step_of_the_local_global_and_vision_
    families``: loss within 2e-5, the gradient's norm within rel 1e-4,
    params within 2e-5 of the reference's step.  AdamW's first step moves
    an entry by ≈ lr · g / (|g| + eps), lr whatever |g|: where the
    reference's gradient is within fp32 noise of 0 its sign, and so the
    entry's direction, is noise (measured: 11–62 entries a leaf of ~10^5,
    at |g| ≤ 4.8e-7 against a leaf's largest 3.6e-3–2.0e-2, moved up to
    1.6e-3 apart; in the tied table, whose gradient carries the bf16
    readout's, entries below 1e-4 of its largest moved up to 7.5e-5).  So
    there the 2e-5 bar holds where |g| ≥ 1e-3 of its leaf's largest (g
    from the reference's first moment, (1 − b1) g; measured ≤ 7.5e-7
    apart), which must be ≥ 90 % of each leaf (measured ≥ 90.7 %, the
    table); every entry within 2 lr + 2e-5; the mean within
    ``_assert_params_close``'s AdamW bar."""
    arch, change = HEAD_DIM_CUTS[cut]
    jcfg = dataclasses.replace(j_get_smoke(arch), compute_dtype="float32",
                               **change)
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32",
                              **change)
    batch = _lm_batch(cfg.vocab_size)
    if cfg.frontend == "vision":
        batch["patch_embeddings"] = np.random.default_rng(5).normal(size=(
            4, cfg.num_frontend_tokens, cfg.d_model)).astype(np.float32)

    def make(lib):
        if opt_name == "adamw":
            return lib.adamw(), lib.constant_lr(1e-3)
        return _opt(lib, "sgd")

    jmodel = j_build(jcfg)
    jopt_, jlr = make(jopt)
    jstate = jts.init_train_state(jmodel, jax.random.PRNGKey(0), jopt_)
    jstate1, jmetrics = jts.make_train_step(
        jmodel, jopt_, jlr, clip_norm=1.0, remat=True)(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    model = build_model(cfg)
    opt, lr_fn = make(topt)
    params = params_from_numpy(jax.tree.map(np.asarray, jstate.params))
    state = tts.TrainState(params=params, opt_state=opt.init(params),
                           step=torch.zeros((), dtype=torch.int32))
    state, metrics = tts.make_train_step(model, opt, lr_fn, clip_norm=1.0,
                                         remat=True)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    if opt_name == "sgd":
        _assert_trees_close(state.params, jstate1.params, atol=2e-5, rtol=0)
    else:
        total, count = 0.0, 0
        for got, want, m in zip(tree_leaves(state.params),
                                jax.tree.leaves(jstate1.params),
                                jax.tree.leaves(jstate1.opt_state["m"])):
            d = np.abs(got.numpy() - np.asarray(want))
            m = np.abs(np.asarray(m))
            clear = m >= 1e-3 * m.max()
            assert clear.mean() >= 0.9
            assert d[clear].max(initial=0.0) <= 2e-5
            assert d.max() <= 2 * 1e-3 + 2e-5
            total += float(d.sum())
            count += d.size
        assert total <= 1e-6 * count
    assert float(metrics["loss"]) == pytest.approx(float(jmetrics["loss"]),
                                                   abs=2e-5)
    assert float(metrics["grad_norm"]) == pytest.approx(
        float(jmetrics["grad_norm"]), rel=1e-4)
