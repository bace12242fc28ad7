"""The port's LM zoo forward against the JAX package's, on the CPU.

For the dense (qwen3-smoke: GQA 4/2, qk-norm, tied; smollm-smoke: GQA 3/1),
hybrid (zamba2-smoke: mamba2 + the shared attention block), ssm
(falcon-mamba-smoke: mamba1), MoE (mixtral-smoke: ``swa`` layers,
window 32 < S; qwen3-moe-smoke: qk-norm; moonshot-smoke: a shared expert),
local/global (gemma3-smoke: one ``swa`` and one ``attn`` layer, tied and
scaled embeddings), vision (pixtral-smoke: 16 patch embeddings ahead of
the text) and audio (whisper-smoke: the encoder–decoder over 32 frame
embeddings) smoke configs, and three narrow 2-layer cuts at the real head
dims (``HEAD_DIM_CUTS``: gemma3 at 256 with a 16-key window, pixtral at
160, whisper at 64 over 200 frames), the reference's
``build_model(cfg).init(PRNGKey(0))`` is carried into the port with
``params_from_numpy``; then ``make_prefill_step``, ``make_eval_step`` and
``forward_hidden`` of both packages see the same numpy tokens (and patch
or frame embeddings; for the audio family the hidden states are the
decoder's over the encoder's, ``encode`` then ``_decode_hidden``).
S = 40 is no multiple of zamba2-smoke's SSD chunk (16).
The scaled embeddings are held bit for bit, at the smoke widths here and
at gemma3's d_model 2560 in ``test_embed_scale_matches_reference``; the
rope tables at pixtral's θ = 1e9 and D = 160 within one ulp of a cos.

Tolerances, measured on this CPU and stated here:
* ``compute_dtype="float32"``: loss within 2e-5 and hidden states within
  5e-5 (measured ≤ 4e-6 and ≤ 1.5e-5: fp32 sums in another order, the
  scans unchunked; the loss's readout is bf16 in both packages);
* ``compute_dtype="bfloat16"`` (the configs' own): loss within 3e-3
  (measured ≤ 1.2e-3) and hidden states within 0.1·max|h| at any element
  and 0.05·mean|h| on average (measured ≤ 0.023 and ≤ 0.019).  XLA keeps
  fp32 inside fused bf16 elementwise chains and rounds scores to bf16;
  torch rounds per op and the attention's scores stay fp32;
* the MoE's summed aux loss within ``AUX_TOL``.  In bf16 the MoE configs'
  routers take the reference's experts where two probabilities nearly tie
  (``tests/test_torch_moe.py``: a near-tie token routed elsewhere differs
  by the size of its output, 1.67 of max|h| 3.69 in mixtral-smoke);
  elsewhere, and in fp32, each router's own choice.
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke
from repro.models import encdec as jed
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.models.layers import _rope_table as j_rope_table
from repro.models.zoo import build_model as j_build
from repro.train import trainstep as jts
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_smoke_config
from repro_torch.models import encdec as ted
from repro_torch.models import layers as L
from repro_torch.models import transformer as ttf
from repro_torch.models.zoo import build_model, params_from_numpy
from repro_torch.train import trainstep as tts
from repro_torch.train.optimizer import sgd
from test_torch_moe import capture_reference_routing, follow_reference_routing

PORTED = ["qwen3_0_6b", "smollm_360m", "zamba2_2_7b", "falcon_mamba_7b",
          "mixtral_8x22b", "qwen3_moe_235b_a22b", "moonshot_v1_16b_a3b",
          "gemma3_4b", "pixtral_12b", "whisper_base"]
# Narrow 2-layer cuts at the published head dims, as changes to the smoke
# configs: gemma3's 256 (one swa layer with a window shorter than S, one
# global layer; d_model 384, so the bf16 embedding scale rounds),
# pixtral's 5120 / 32 = 160 (d_model 320 over 2 heads) and whisper's 512 /
# 8 = 64 (d_model 128 over 2 heads) over 200 frames, a key length that is
# no whole number of 64- or 128-key tiles.
HEAD_DIM_CUTS = {
    "gemma3_4b@256": ("gemma3_4b", dict(
        name="gemma3-hd256", d_model=384, num_heads=2, num_kv_heads=1,
        head_dim=256, d_ff=256, sliding_window=16, local_global_ratio=1)),
    "pixtral_12b@160": ("pixtral_12b", dict(
        name="pixtral-hd160", d_model=320, num_heads=2, num_kv_heads=1,
        d_ff=256)),
    "whisper_base@64": ("whisper_base", dict(
        name="whisper-hd64", num_heads=2, num_kv_heads=2,
        num_frontend_tokens=200)),
}
BATCH, SEQ = 2, 40
# The MoE configs' summed load-balance loss (≈ 0.04 at the smoke
# configs): fp32 sums in another order, and in bf16 the router reads
# hidden states rounded by other kernels.
AUX_TOL = {"float32": 1e-6, "bfloat16": 1e-4}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_configs_equal_reference(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
        j_get_config(arch))
    assert dataclasses.asdict(get_smoke_config(arch)) == dataclasses.asdict(
        j_get_smoke(arch))
    assert get_config(arch).param_count() == j_get_config(arch).param_count()


def test_arch_ids_and_shapes_equal_reference():
    assert ARCH_IDS == J_ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}


def _configs(arch, dtype):
    """(reference config, port config): an arch's smoke config, or a
    HEAD_DIM_CUTS entry, in ``dtype``."""
    base, change = HEAD_DIM_CUTS.get(arch, (arch, {}))
    return (dataclasses.replace(j_get_smoke(base), compute_dtype=dtype,
                                **change),
            dataclasses.replace(get_smoke_config(base), compute_dtype=dtype,
                                **change))


def _batch(cfg):
    """tokens, labels, mask and the batch's other inputs: a vision
    config's patch embeddings (B, P, d_model), an audio config's frame
    embeddings (B, T, d_model), fp32 numpy."""
    rng = np.random.default_rng(7)
    vocab = cfg.vocab_size
    tokens = rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32)
    labels = rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32)
    mask = (rng.uniform(size=(BATCH, SEQ)) < 0.8).astype(np.float32)
    extra = {}
    if cfg.frontend is not None:
        key = {"vision": "patch_embeddings", "audio": "frames"}[cfg.frontend]
        extra[key] = rng.normal(size=(
            BATCH, cfg.num_frontend_tokens, cfg.d_model)).astype(np.float32)
    return tokens, labels, mask, extra


def _follows_routing(arch, dtype):
    """bf16 MoE: the port takes the reference's experts (near ties only;
    tests/test_torch_moe.py)."""
    return dtype == "bfloat16" and _configs(arch, dtype)[1].moe is not None


@functools.lru_cache(maxsize=None)
def _reference(arch, dtype):
    """The reference's params (numpy), prefill / eval losses, final hidden
    states and aux loss on the shared batch, and the experts its MoE layers
    chose in each of the three runs (empty lists without MoE)."""
    jcfg, _ = _configs(arch, dtype)
    model = j_build(jcfg)
    params = model.init(jax.random.PRNGKey(0))
    tokens, labels, mask, extra = _batch(jcfg)
    tokens, labels, mask = (jnp.asarray(x) for x in (tokens, labels, mask))
    extra = {k: jnp.asarray(v) for k, v in extra.items()}
    prefill, r_prefill = capture_reference_routing(
        lambda: float(jts.make_prefill_step(model)(
            params, {"tokens": tokens, **extra})))
    evaluate, r_eval = capture_reference_routing(
        lambda: float(jts.make_eval_step(model)(
            params, {"tokens": tokens, "labels": labels, "mask": mask,
                     **extra})))
    if jcfg.family == "audio":
        # The decoder's input and its final hidden states over the
        # encoder's.
        cd = jnp.dtype(dtype)
        x = (jlayers.embed(params["embed"], tokens, cd)
             + jlayers.sinusoidal_positions(SEQ, jcfg.d_model).astype(cd))
        enc = jed.encode(params, jcfg, extra["frames"], remat=False)
        hidden, aux = jed._decode_hidden(params, jcfg, tokens, enc,
                                         remat=False), 0.0
        r_hidden = []
    else:
        x = jtf._embed_inputs(params, jcfg, {"tokens": tokens, **extra})
        s = x.shape[1]
        pos = jnp.broadcast_to(jnp.arange(s)[None], (BATCH, s))
        (hidden, aux), r_hidden = capture_reference_routing(
            lambda: jtf.forward_hidden(params, jcfg, x, pos, remat=False))
    return (jax.tree.map(np.asarray, params), prefill, evaluate,
            np.asarray(x.astype(jnp.float32)),
            np.asarray(hidden.astype(jnp.float32)), float(aux),
            (r_prefill, r_eval, r_hidden))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", PORTED + list(HEAD_DIM_CUTS))
def test_prefill_eval_and_hidden_match_reference(arch, dtype):
    (params_np, prefill, evaluate, x, hidden, want_aux,
     routings) = _reference(arch, dtype)
    _, cfg = _configs(arch, dtype)
    model = build_model(cfg)
    params = params_from_numpy(params_np)
    tokens, labels, mask, extra = _batch(cfg)
    tokens, labels, mask = (torch.from_numpy(a)
                            for a in (tokens, labels, mask))
    extra = {k: torch.from_numpy(v) for k, v in extra.items()}
    follow = _follows_routing(arch, dtype)
    flips = []

    def routed(i):
        if not follow:
            return contextlib.nullcontext([])
        return follow_reference_routing(routings[i])

    with routed(0) as f:
        got_prefill = float(tts.make_prefill_step(model)(
            params, {"tokens": tokens, **extra}))
    flips += f
    with routed(1) as f:
        got_eval = float(tts.make_eval_step(model)(
            params, {"tokens": tokens, "labels": labels, "mask": mask,
                     **extra}))
    flips += f
    td = getattr(torch, dtype)
    if cfg.family == "audio":
        got_x = (L.embed(params["embed"], tokens, td)
                 + L.sinusoidal_positions(SEQ, cfg.d_model).to(td))
        enc = ted.encode(params, cfg, extra["frames"])
        got_h = ted._decode_hidden(params, cfg, tokens, enc)
        aux = torch.zeros(())
    else:
        got_x = ttf._embed_inputs(params, cfg, {"tokens": tokens, **extra})
    assert got_x.dtype == td
    # The embeddings (patches ahead of the text, the scale; the decoder's
    # positions) bit for bit.
    np.testing.assert_array_equal(got_x.float().numpy(), x)
    s = got_x.shape[1]
    assert s == SEQ + cfg.num_frontend_tokens * (cfg.frontend == "vision")
    pos = torch.arange(s)[None].expand(BATCH, s)
    if cfg.family != "audio":
        with routed(2) as f:
            got_h, aux = ttf.forward_hidden(params, cfg, got_x, pos)
        flips += f
    # Near ties are rare: at most 10 % of a call's tokens.
    assert max(flips, default=0) <= 0.1 * BATCH * SEQ, flips
    assert got_h.dtype == td and aux.dtype == torch.float32
    if cfg.moe is None:
        assert float(aux) == 0.0 == want_aux
    else:
        assert abs(float(aux) - want_aux) <= AUX_TOL[dtype], (aux, want_aux)
    got_h = got_h.float().numpy()
    err = np.abs(got_h - hidden)
    if dtype == "float32":
        # The head-dim cuts' loss within ZOO_BARS' fp32 1e-4 (chip_smoke.py):
        # the bf16 readout rounds the hidden states, and pixtral@160's
        # 7.3e-6 of fp32 noise in them flips enough roundings to move its
        # loss 2.4e-5 (the reference's hidden states through the port's
        # readout give the reference's loss bit for bit).
        loss_tol = 1e-4 if arch in HEAD_DIM_CUTS else 2e-5
        assert err.max() <= 5e-5, err.max()
    else:
        loss_tol = 3e-3
        assert err.max() <= 0.1 * np.abs(hidden).max(), err.max()
        assert err.mean() <= 0.05 * np.abs(hidden).mean(), err.mean()
    assert abs(got_prefill - prefill) <= loss_tol, (got_prefill, prefill)
    assert abs(got_eval - evaluate) <= loss_tol, (got_eval, evaluate)


@pytest.mark.parametrize("arch", PORTED)
def test_init_draws_the_reference_layout(arch):
    """The port's own init (a torch.Generator) gives the reference's tree:
    the same leaves, shapes and dtypes."""
    cfg = get_smoke_config(arch)
    jcfg = j_get_smoke(arch)
    want = jax.eval_shape(lambda: j_build(jcfg).init(jax.random.PRNGKey(0)))
    got = build_model(cfg).init(torch.Generator().manual_seed(0))
    want_leaves, want_def = jax.tree.flatten(want)
    got_leaves, got_def = jax.tree.flatten(
        jax.tree.map(lambda t: np.zeros(0), got,
                     is_leaf=lambda t: isinstance(t, torch.Tensor)))
    assert str(got_def) == str(want_def)
    got_tensors = jax.tree.leaves(got, is_leaf=lambda t: isinstance(
        t, torch.Tensor))
    for w, g in zip(want_leaves, got_tensors):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        assert bool(torch.isfinite(g).all())


@pytest.mark.parametrize("d_model", [2560, 128, 384, 5120])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_scale_matches_reference(d_model, dtype):
    """gemma's embedding scale, ``jnp.asarray(d_model, cd) ** 0.5`` in the
    reference: bit for bit, as the scalar and as the scaled embeddings of
    a (64, d_model) batch (in bf16 50.5 at 2560, not √2560 = 50.596)."""
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = jnp.asarray(d_model, jd) ** 0.5
    got = L.embed_scale(d_model, td)
    assert got == float(want)
    if (d_model, dtype) == (2560, "bfloat16"):
        assert got == 50.5
    x = np.random.default_rng(d_model).normal(size=(64, d_model)).astype(
        np.float32)
    np.testing.assert_array_equal(
        (torch.from_numpy(x).to(td) * got).float().numpy(),
        np.asarray((jnp.asarray(x).astype(jd) * want).astype(jnp.float32)))


@pytest.mark.parametrize("theta,head_dim", [(1e9, 160), (1e6, 256),
                                            (1e6, 128), (1e4, 80)])
def test_rope_tables_match_reference(theta, head_dim):
    """The rope tables against the reference's ``_rope_table`` at positions
    0 … 32,767: within one ulp of a cos or sin (torch's cos and XLA's
    round apart); their frequencies are the reference's bits, so the
    angles are equal at every position."""
    pos = np.arange(32768, dtype=np.int32)[None]
    want = j_rope_table(head_dim, float(theta), jnp.asarray(pos))
    got = L.rope_freqs(head_dim, theta, torch.from_numpy(pos))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=6e-8,
                                   rtol=0)


def test_every_family_is_ported():
    """Every architecture of the reference's zoo builds in the port, the
    audio family through the encoder–decoder (``init_cache`` takes its
    frames)."""
    assert sorted(PORTED) == sorted(J_ARCH_IDS)
    whisper = build_model(get_smoke_config("whisper_base"))
    params = whisper.init(torch.Generator().manual_seed(0))
    cfg = whisper.cfg
    frames = torch.zeros((1, cfg.num_frontend_tokens, cfg.d_model))
    cache = whisper.init_cache(params, frames, 1, 4)
    assert sorted(cache) == ["cross", "self"]
    logits, cache2 = whisper.decode_step(
        params, torch.zeros((1, 1), dtype=torch.long), cache, 0)
    assert logits.shape == (1, 1, cfg.vocab_size) and cache2 is cache


@pytest.mark.parametrize("arch", PORTED)
def test_published_configs_build(arch):
    """Each ported family builds at its published size (no params drawn);
    a Mamba-1 config's head dim (d_model / heads, no attention layer) is
    not held to the attention kernels'."""
    assert build_model(get_config(arch)).cfg == get_config(arch)


def test_decode_and_training_raise():
    """Decode through the zoo is ported (ROADMAP A13b): ``init_cache`` and
    ``decode_step`` return; so is training (A13c, and zamba2's through
    ``ssd_scan``'s backward, A13c-2): ``make_train_step`` builds a step.
    ``ssd_scan``'s card route under a gradient is held by
    ``tests/test_torch_train.py``."""
    model = build_model(get_smoke_config("qwen3_0_6b"))
    params = model.init(torch.Generator().manual_seed(0))
    cache = model.init_cache(params, 1, 16)
    logits, cache2 = model.decode_step(params, torch.zeros((1, 1),
                                                           dtype=torch.long),
                                       cache, 0)
    assert logits.shape == (1, 1, model.cfg.vocab_size)
    assert logits.dtype == torch.float32 and cache2 is cache
    assert callable(tts.make_serve_step(model))
    assert callable(tts.make_train_step(model, sgd()))
