"""The port's audio family (whisper's encoder–decoder) against the JAX
package's, on the CPU.

At whisper-smoke (2 + 2 layers, d_model 128, 4 heads of D = 32, 32
frames) and at ``CUT`` (the same at 2 heads of D = 64, the head dim whose
attention the card runs on its ``wgmma<64>`` instances, over 200 frames:
a key length that is no whole number of 64- or 128-key tiles), from the
reference's init carried across with ``params_from_numpy``:

* the building blocks: the tanh GELU bit for bit against ``jax.nn.gelu``
  in bf16 (and its gradient against ``jax.vjp``'s), in fp32 within 4
  ulps of |x|; ``layernorm`` (bit for bit in bf16) and
  ``sinusoidal_positions`` (bit for bit);
* the init's tree: the reference's paths, shapes and dtypes;
* ``encode``, ``_decode_hidden`` and ``encdec_loss`` (remat on and off),
  fp32 and bf16;
* decode: teacher-forced steps against the port's own forward
  (``tests/test_encdec_vlm.py``'s contract, atol = rtol = 2e-4), and
  against the reference's ``encdec_decode_step``: the logits at every
  step and the final cache, fp32 and bf16, at a scalar and a per-row
  position;
* the encoder is bidirectional and the cross-attention sees the audio
  (``tests/test_encdec_vlm.py``'s contracts), and the spec's masks: the
  encoder and cross-attention non-causal, the decoder causal;
* one SGD and one AdamW step of ``make_train_step`` (clip 1.0, remat on)
  against the reference's, the encoder's leaves included.

Tolerances, measured on this CPU and stated per test: fp32 agrees to
sum-order noise (encoder and decoder states ≤ 1.5e-6, loss ≤ 5e-7,
decode logits and caches ≤ 4.6e-7·(1 + max|·|)), inside the zoo's fp32
bars (hidden states 5e-5, loss 2e-5; ``tests/test_torch_zoo.py``) and the
decode tests' (4e-6·(1 + max|·|); ``tests/test_torch_decode.py``).  bf16
within the zoo's bf16 bars (loss 3e-3, measured ≤ 4.7e-4; states 0.1·max|h|
at an element and 0.05·mean|h| on average, measured ≤ 0.014 and ≤ 0.006;
decode logits 0.06·max|·| and caches 0.08·max|·|, measured ≤ 0.011 and ≤
0.010): XLA keeps fp32 inside its fused bf16 chains, torch rounds per op.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad

from repro.configs import get_smoke_config as j_get_smoke
from repro.models import encdec as jed
from repro.models import layers as jlayers
from repro.models.zoo import build_model as j_build
from repro.train import optimizer as jopt
from repro.train import trainstep as jts
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import encdec as ed
from repro_torch.models import layers as L
from repro_torch.models.zoo import (build_model, cache_from_numpy,
                                    params_from_numpy)
from repro_torch.train import optimizer as topt
from repro_torch.train import trainstep as tts
from repro_torch.tree import tree_leaves

ARCH = "whisper_base"
# whisper-smoke at the published head dim 64 over a ragged key length.
CUT = dict(name="whisper-hd64", num_heads=2, num_kv_heads=2,
           num_frontend_tokens=200)
CUTS = {"smoke": {}, "hd64": CUT}
DTYPES = ["float32", "bfloat16"]
BATCH, SEQ = 2, 24


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _configs(cut, dtype):
    """(reference config, port config) of a CUTS entry in ``dtype``."""
    change = CUTS[cut]
    return (dataclasses.replace(j_get_smoke(ARCH), compute_dtype=dtype,
                                **change),
            dataclasses.replace(get_smoke_config(ARCH), compute_dtype=dtype,
                                **change))


def _batch(cfg, seed=7):
    """frames (B, T, d_model) N(0, 1), tokens, labels and a mask; numpy."""
    rng = np.random.default_rng(seed)
    return {"frames": rng.normal(size=(BATCH, cfg.num_frontend_tokens,
                                       cfg.d_model)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size,
                                   (BATCH, SEQ)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size,
                                   (BATCH, SEQ)).astype(np.int32),
            "mask": (rng.uniform(size=(BATCH, SEQ)) < 0.8).astype(
                np.float32)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _reference(cut, dtype):
    """The reference's params, encoder states, decoder hidden states and
    losses (remat off and on) on the shared batch."""
    jcfg, _ = _configs(cut, dtype)
    model = j_build(jcfg)
    params = model.init(jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v) for k, v in _batch(jcfg).items()}
    enc = jed.encode(params, jcfg, batch["frames"], remat=False)
    hid = jed._decode_hidden(params, jcfg, batch["tokens"], enc, remat=False)
    losses = [float(model.loss(params, batch, remat=r)) for r in (False,
                                                                  True)]
    return _np(params), _f32(enc), _f32(hid), losses


def _close_bf16(got, want):
    err = np.abs(got - want)
    assert err.max() <= 0.1 * np.abs(want).max(), err.max()
    assert err.mean() <= 0.05 * np.abs(want).mean(), err.mean()


# ------------------------------------------------------------ the blocks

def test_gelu_bf16_bits_and_gradient_match_reference():
    """200,000 N(0, 9) values rounded to bf16: the port's GELU bit for bit
    against ``jax.jit(jax.nn.gelu)``, and its gradient bit for bit against
    ``jax.vjp``'s with an N(0, 1) cotangent; ``F.gelu(approximate="tanh")``
    is not (it rounds once: 42.7 % of these inputs differ)."""
    rng = np.random.default_rng(0)
    x = (3.0 * rng.normal(size=200_000)).astype(np.float32)
    g = rng.normal(size=200_000).astype(np.float32)
    xj, gj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, g))
    want = _f32(jax.jit(jax.nn.gelu)(xj))
    want_g = _f32(jax.jit(lambda x, g: jax.vjp(jax.nn.gelu, x)[1](g)[0])(
        xj, gj))
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    y = L.gelu(xt)
    assert y.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(y.detach()), want)
    (got_g,) = torch.autograd.grad(y, xt, torch.from_numpy(g).to(
        torch.bfloat16))
    np.testing.assert_array_equal(_f32(got_g), want_g)
    one_rounding = torch.nn.functional.gelu(xt.detach(), approximate="tanh")
    assert (_f32(one_rounding) != want).mean() > 0.2


def test_gelu_fp32_and_its_gradient_match_reference():
    """fp32: within 4 ulps of |x| (torch's and XLA's fp32 tanh round apart
    on a third of the inputs; measured ≤ 2 ulps of |x|), the gradient
    within 8e-6 (measured 3.8e-6 at max|g| 1.13: XLA contracts the jitted
    chain into fused multiply-adds); the gradient under vmap equal to
    it."""
    rng = np.random.default_rng(1)
    x = (3.0 * rng.normal(size=50_000)).astype(np.float32)
    want = np.asarray(jax.jit(jax.nn.gelu)(jnp.asarray(x)))
    want_g = np.asarray(jax.jit(jax.grad(
        lambda x: jnp.sum(jax.nn.gelu(x))))(jnp.asarray(x)))
    xt = torch.from_numpy(x)
    ulp = np.spacing(np.abs(x))
    assert (np.abs(L.gelu(xt).numpy() - want) <= 4 * ulp).all()
    got_g = grad(lambda x: L.gelu(x).sum())(xt).numpy()
    np.testing.assert_allclose(got_g, want_g, rtol=0, atol=8e-6)
    rows = xt[:1000].reshape(10, 100)
    vm = torch.func.vmap(grad(lambda r: L.gelu(r).sum()))(rows)
    np.testing.assert_array_equal(vm.numpy(), got_g[:1000].reshape(10, 100))


@pytest.mark.parametrize("dtype", DTYPES)
def test_layernorm_matches_reference(dtype):
    """fp32 statistics, the result in x's dtype: bf16 bit for bit; fp32
    within 1e-6·(1 + max|y|) (sums in another order; measured 7.2e-7 at
    max|y| ≈ 10)."""
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(4, 7, 128)) * 3 + 1).astype(np.float32)
    scale = rng.normal(size=128).astype(np.float32)
    bias = rng.normal(size=128).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = _f32(jlayers.layernorm({"scale": jnp.asarray(scale),
                                   "bias": jnp.asarray(bias)},
                                  jnp.asarray(x).astype(jd), 1e-5))
    got = L.layernorm({"scale": torch.from_numpy(scale),
                       "bias": torch.from_numpy(bias)},
                      torch.from_numpy(x).to(td), 1e-5)
    assert got.dtype == td
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_f32(got), want)
    else:
        np.testing.assert_allclose(_f32(got), want, rtol=0,
                                   atol=1e-6 * (1 + np.abs(want).max()))
    init = L.init_layernorm(128, (3,))
    assert init["scale"].shape == init["bias"].shape == (3, 128)
    assert float(init["scale"].min()) == 1.0 and float(
        init["bias"].abs().max()) == 0.0


@pytest.mark.parametrize("seq,d", [(1500, 512), (448, 512), (200, 128),
                                   (7, 6)])
def test_sinusoidal_positions_match_reference(seq, d):
    """Bit for bit: numpy float64, rounded once to fp32."""
    want = np.asarray(jlayers.sinusoidal_positions(seq, d))
    got = L.sinusoidal_positions(seq, d)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ the model

@pytest.mark.parametrize("cut", list(CUTS))
def test_init_draws_the_reference_layout(cut):
    """The port's init (a torch.Generator) gives the reference's tree: the
    same paths, shapes and dtypes, every leaf finite."""
    jcfg, cfg = _configs(cut, "float32")
    want = jax.eval_shape(lambda: j_build(jcfg).init(jax.random.PRNGKey(0)))
    got = build_model(cfg).init(torch.Generator().manual_seed(0))
    want_paths = [(jax.tree_util.keystr(k), v.shape) for k, v in
                  jax.tree_util.tree_leaves_with_path(want)]
    got_paths = [(jax.tree_util.keystr(k), tuple(v.shape)) for k, v in
                 jax.tree_util.tree_leaves_with_path(
                     got, is_leaf=lambda t: isinstance(t, torch.Tensor))]
    assert got_paths == want_paths
    assert "['enc_layers']['attn']['wq']['w']" in dict(got_paths)
    for leaf in tree_leaves(got):
        assert leaf.dtype == torch.float32 and bool(torch.isfinite(leaf).all())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cut", list(CUTS))
def test_encode_decode_hidden_and_loss_match_reference(cut, dtype):
    """The encoder's states, the decoder's final hidden states (from the
    reference's encoder states, so each half is held alone) and the loss
    with remat off and on."""
    params_np, enc, hid, losses = _reference(cut, dtype)
    _, cfg = _configs(cut, dtype)
    model = build_model(cfg)
    params = params_from_numpy(params_np)
    batch = _tbatch(_batch(cfg))
    td = getattr(torch, dtype)
    got_enc = ed.encode(params, cfg, batch["frames"], remat=False)
    assert got_enc.dtype == td and got_enc.shape == enc.shape
    ref_enc = torch.from_numpy(enc.copy()).to(td)
    got_hid = ed._decode_hidden(params, cfg, batch["tokens"], ref_enc,
                                remat=False)
    assert got_hid.dtype == td
    got_losses = [float(model.loss(params, batch, remat=r))
                  for r in (False, True)]
    assert got_losses[0] == got_losses[1]
    if dtype == "float32":
        np.testing.assert_allclose(_f32(got_enc), enc, rtol=0, atol=5e-5)
        np.testing.assert_allclose(_f32(got_hid), hid, rtol=0, atol=5e-5)
        loss_tol = 2e-5
    else:
        _close_bf16(_f32(got_enc), enc)
        _close_bf16(_f32(got_hid), hid)
        loss_tol = 3e-3
    for got, want in zip(got_losses, losses):
        assert abs(got - want) <= loss_tol, (got, want)


def test_encoder_is_bidirectional_and_the_masks():
    """Replacing the second half of the frames changes the first frame's
    encoder state (no causal mask); the encoder's spec and the
    cross-attention's are non-causal, the decoder's causal: a later token
    leaves earlier decoder states alone."""
    _, cfg = _configs("smoke", "float32")
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    assert not ed.enc_spec(cfg).causal and ed.dec_spec(cfg).causal
    assert not ed.enc_spec(cfg).use_rope and not ed.dec_spec(cfg).use_rope
    t = cfg.num_frontend_tokens
    gen = torch.Generator().manual_seed(1)
    frames = torch.randn((1, t, cfg.d_model), generator=gen)
    other = torch.randn((1, t, cfg.d_model), generator=gen)
    frames2 = frames.clone()
    frames2[:, t // 2:] = other[:, t // 2:]
    enc1 = ed.encode(params, cfg, frames, remat=False)
    enc2 = ed.encode(params, cfg, frames2, remat=False)
    assert float((enc1[:, 0] - enc2[:, 0]).abs().max()) > 1e-5
    toks = torch.randint(0, cfg.vocab_size, (1, 10), generator=gen)
    toks2 = toks.clone()
    toks2[:, -1] = (toks[:, -1] + 1) % cfg.vocab_size
    h1 = ed._decode_hidden(params, cfg, toks, enc1, remat=False)
    h2 = ed._decode_hidden(params, cfg, toks2, enc1, remat=False)
    assert torch.equal(h1[:, :-1], h2[:, :-1])
    assert not torch.equal(h1[:, -1], h2[:, -1])


def test_cross_attention_sees_audio():
    """The same tokens over two draws of frames give two losses."""
    _, cfg = _configs("smoke", "float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.ones((1, 4), dtype=torch.long)
    gen = torch.Generator().manual_seed(3)
    losses = [float(model.loss(params, {
        "frames": torch.randn((1, cfg.num_frontend_tokens, cfg.d_model),
                              generator=gen),
        "tokens": toks, "labels": toks}, remat=False)) for _ in range(2)]
    assert abs(losses[0] - losses[1]) > 1e-6


# ------------------------------------------------------------ decode

@pytest.mark.parametrize("cut", list(CUTS))
def test_decode_matches_teacher_forcing(cut):
    """Teacher-forced decode logits against the port's own forward's
    (``_decode_hidden`` over ``encode``, the tied readout in fp32), fp32,
    B = 2, S = 12, at the reference's own bar (atol = rtol = 2e-4)."""
    _, cfg = _configs(cut, "float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    b, s = 2, 12
    frames = torch.randn((b, cfg.num_frontend_tokens, cfg.d_model),
                         generator=gen)
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen)
    enc = ed.encode(params, cfg, frames, remat=False)
    hid = ed._decode_hidden(params, cfg, toks, enc, remat=False)
    want = L.unembed_logits(params["embed"], hid, torch.float32)
    cache = model.init_cache(params, frames, b, s)
    got = torch.cat([model.decode_step(params, toks[:, t:t + 1], cache,
                                       torch.tensor(t))[0]
                     for t in range(s)], dim=1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4,
                               rtol=2e-4)


@functools.lru_cache(maxsize=None)
def _reference_decode(cut, dtype, steps=12):
    """The reference's params, frames, tokens, cache right after
    ``init_cache``, per-step logits and final cache of a teacher-forced
    decode."""
    jcfg, _ = _configs(cut, dtype)
    model = j_build(jcfg)
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    frames = rng.normal(size=(BATCH, jcfg.num_frontend_tokens,
                              jcfg.d_model)).astype(np.float32)
    toks = rng.integers(0, jcfg.vocab_size, (BATCH, steps)).astype(np.int32)
    cache = model.init_cache(params, jnp.asarray(frames), BATCH, steps)
    first = _np(cache)
    step = jax.jit(model.decode_step)
    logits = []
    for t in range(steps):
        lg, cache = step(params, jnp.asarray(toks[:, t:t + 1]), cache,
                         jnp.int32(t))
        logits.append(np.asarray(lg))
    return _np(params), frames, toks, first, logits, _np(cache)


def _close(got, want, dtype, fp32_atol=4e-6, bf16_rel=0.06):
    got, want = _f32(got), np.asarray(want, np.float32)
    assert got.shape == want.shape
    top = float(np.abs(want).max())
    tol = fp32_atol * (1 + top) if dtype == "float32" else bf16_rel * top
    assert float(np.abs(got - want).max()) <= tol


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "rows"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cut", list(CUTS))
def test_decode_step_matches_reference(cut, dtype, per_row):
    """The cache's tree and its cross half right after ``init_cache``,
    then 12 teacher-forced steps at a scalar position (or the same as a
    per-row vector): fp32 logits and caches within 4e-6·(1 + max|·|);
    bf16 logits within 0.06·max|·| and caches within
    0.08·max|·| (the decode tests' bars)."""
    params_np, frames, toks, first, want_logits, want_cache = (
        _reference_decode(cut, dtype))
    _, cfg = _configs(cut, dtype)
    model = build_model(cfg)
    params = params_from_numpy(params_np)
    cache = model.init_cache(params, torch.from_numpy(frames), BATCH,
                             toks.shape[1])
    want_first = cache_from_numpy(first)
    assert sorted(cache) == ["cross", "self"]
    for got, want in zip(tree_leaves(cache), tree_leaves(want_first)):
        assert got.shape == want.shape and got.dtype == want.dtype
    for got, want in zip(tree_leaves(cache["cross"]),
                         tree_leaves(want_first["cross"])):
        _close(got, want.float().numpy(), dtype, bf16_rel=0.08)
    assert all(float(a.abs().max()) == 0.0 for a in
               tree_leaves(cache["self"]))
    for t in range(toks.shape[1]):
        pos = torch.full((BATCH,), t) if per_row else t
        lg, cache = model.decode_step(params, torch.from_numpy(
            toks[:, t:t + 1]), cache, pos)
        assert lg.dtype == torch.float32 and lg.shape == (
            BATCH, 1, cfg.vocab_size)
        _close(lg, want_logits[t], dtype)
    for got, want in zip(tree_leaves(cache), jax.tree.leaves(want_cache)):
        _close(got, want, dtype, bf16_rel=0.08)


# ------------------------------------------------------------ training

def _sgd_or_adamw(lib, name):
    if name == "sgd":
        return lib.sgd(), lib.constant_lr(0.05)
    return lib.adamw(), lib.constant_lr(1e-3)


@pytest.mark.parametrize("opt_name", ["sgd", "adamw"])
@pytest.mark.parametrize("cut", list(CUTS))
def test_one_train_step_matches_reference(cut, opt_name):
    """One fp32 step of ``make_train_step`` (clip 1.0, remat on) from the
    reference's init: loss within 2e-5, the gradient's norm within rel
    1e-4 (measured ≤ 5e-7 and ≤ 1e-6).  SGD: every param within 1e-5 of
    the reference's step (measured ≤ 1.6e-6).  AdamW moves an entry by ≈
    lr whatever |g|, so where the reference's gradient is fp32 noise its
    sign is too (``tests/test_torch_train.py``,
    ``test_one_step_at_the_head_dim_cuts``): the 1e-5 bar holds where the
    reference's first moment is ≥ 1e-3 of its leaf's largest, which must
    be ≥ 90 % of each leaf (measured ≤ 3e-7 there, over ≥ 90.4 % of each
    leaf); every entry within 2 lr + 1e-5.  Every encoder leaf moves: its
    gradient comes back through the cross-attention under remat."""
    jcfg, cfg = _configs(cut, "float32")
    batch = _batch(cfg, seed=5)
    jmodel = j_build(jcfg)
    jo, jlr = _sgd_or_adamw(jopt, opt_name)
    jstate = jts.init_train_state(jmodel, jax.random.PRNGKey(0), jo)
    jstate1, jm = jts.make_train_step(jmodel, jo, jlr, clip_norm=1.0,
                                      remat=True)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    model = build_model(cfg)
    opt, lr_fn = _sgd_or_adamw(topt, opt_name)
    params = params_from_numpy(_np(jstate.params))
    state = tts.TrainState(params=params, opt_state=opt.init(params),
                           step=torch.zeros((), dtype=torch.int32))
    state1, m = tts.make_train_step(model, opt, lr_fn, clip_norm=1.0,
                                    remat=True)(state, _tbatch(batch))
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 2e-5
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=1e-4)
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_leaves_with_path(jstate1.params)]
    moments = (jax.tree.leaves(jstate1.opt_state["m"])
               if opt_name == "adamw" else [None] * len(paths))
    for path, old, got, want, mom in zip(
            paths, tree_leaves(params), tree_leaves(state1.params),
            jax.tree.leaves(jstate1.params), moments):
        d = np.abs(got.numpy() - np.asarray(want))
        if path.startswith("['enc_layers']"):
            assert not torch.equal(got, old), path
        if mom is None:
            assert d.max() <= 1e-5, (path, d.max())
            continue
        mom = np.abs(np.asarray(mom))
        clear = mom >= 1e-3 * mom.max()
        assert clear.mean() >= 0.9, path
        assert d[clear].max(initial=0.0) <= 1e-5, (path, d[clear].max())
        assert d.max() <= 2 * 1e-3 + 1e-5, (path, d.max())


# ------------------------------------------------------------ entry points

def test_published_config_builds():
    """whisper_base builds at its published size (no params drawn)."""
    cfg = get_config(ARCH)
    assert build_model(cfg).cfg == cfg
