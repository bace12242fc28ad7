"""The port's single-token decode against the JAX package's, on the CPU.

* ``attn_decode``: linear and ring mode, a scalar and a per-row (B,)
  position, with and without a window, fp32 and bf16 compute, on a cache
  filled with random entries (so the masks decide): the output and both
  cache leaves;
* ``mamba1_decode`` / ``mamba2_decode`` from random conv histories and
  states: the output and the new cache;
* ``init_cache``: the tree (paths, shapes, dtypes) of the qwen3, smollm,
  zamba2, falcon-mamba, mixtral (``swa`` rings), qwen3-moe, moonshot,
  gemma3 (a ring and a linear cache in one body) and pixtral smoke
  configs;
* ``decode_step`` teacher-forced for 20 steps from the same params (the
  reference's init, carried with ``params_from_numpy``) and the same cache,
  fp32 and bf16: logits at every step and the final cache; mixtral-smoke
  and gemma3-smoke also for 300 steps, past their rings' 256 positions
  (pixtral decodes text alone, as the reference's);
* the port's decode against its own prefill forward, as
  ``tests/test_models_consistency.py::test_prefill_equals_decode`` holds
  the reference (atol = rtol = 2e-4, fp32).

The port writes caches in place; every comparison keeps the reference's
functional caches apart and clones what it reuses.

Tolerances, measured on this CPU and stated per test as a share of
``1 + max|reference|`` (fp32) or of ``max|reference|`` (bf16): fp32
agrees to sum-order noise (≤ 2e-7 for one attention or Mamba step, ≤
1.2e-6 for 20 decode steps, logits and caches); bf16 within a few bf16
ulps (attention bit-equal, one Mamba step ≤ 0.011, 20 decode steps ≤
0.035: XLA keeps fp32 inside fused bf16 chains, torch rounds per op).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke
from repro.models import attention as jattn
from repro.models import ssm as jssm
from repro.models.zoo import build_model as j_build
from repro_torch.configs import get_smoke_config
from repro_torch.models import attention as tattn
from repro_torch.models import layers as L
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf
from repro_torch.models.zoo import (build_model, cache_from_numpy,
                                    params_from_numpy)
from repro_torch.tree import tree_flatten, tree_leaves, tree_map

PORTED = ["qwen3_0_6b", "smollm_360m", "zamba2_2_7b", "falcon_mamba_7b",
          "mixtral_8x22b", "qwen3_moe_235b_a22b", "moonshot_v1_16b_a3b",
          "gemma3_4b", "pixtral_12b"]
DTYPES = ["float32", "bfloat16"]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype, fp32_atol=2e-6, bf16_rel=0.02):
    """fp32: within ``fp32_atol`` of ``1 + max|want|`` per element; bf16:
    within ``bf16_rel`` of ``max|want|`` per element (a few bf16 ulps at
    the largest entries)."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) if got.size else 0.0
    scale = float(np.abs(want).max()) if want.size else 0.0
    bar = fp32_atol * (1.0 + scale) if dtype == "float32" else (
        bf16_rel * max(scale, 1e-6))
    assert err <= bar, (err, bar)


# ------------------------------------------------------------ attention

def _attn_specs(dtype, window):
    kw = dict(d_model=32, num_heads=4, num_kv_heads=2, head_dim=8,
              qk_norm=True, rope_theta=10000.0, window=window)
    return (jattn.AttnSpec(**kw, compute_dtype=jnp.dtype(dtype)),
            tattn.AttnSpec(**kw, compute_dtype=getattr(torch, dtype)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("pos", ["scalar", "rows"])
def test_attn_decode_matches_reference(pos, ring, window, dtype):
    jspec, tspec = _attn_specs(dtype, window)
    jp = jattn.init_attention(jax.random.PRNGKey(0), jspec)
    tp = params_from_numpy(_np(jp))
    b, length = 3, 12
    rng = np.random.default_rng(1)
    x = rng.standard_normal((b, 1, 32)).astype(np.float32)
    cache_np = {k: rng.standard_normal((b, length, 2, 8)).astype(np.float32)
                for k in ("k", "v")}
    if pos == "scalar":
        p = 29 if ring else 7
    else:
        p = np.array([3, 14, 29] if ring else [0, 7, 11], np.int32)
    jcache = {k: jnp.asarray(v, jnp.dtype(dtype))
              for k, v in cache_np.items()}
    tcache = cache_from_numpy(_np(jcache))
    jy, jc = jattn.attn_decode(jp, jspec, jnp.asarray(x, jnp.dtype(dtype)),
                               jcache, jnp.asarray(p, jnp.int32), ring=ring)
    ty, tc = tattn.attn_decode(tp, tspec,
                               torch.from_numpy(x).to(tspec.compute_dtype),
                               tcache, torch.from_numpy(np.asarray(p)),
                               ring=ring)
    assert tc is tcache and ty.dtype == tspec.compute_dtype
    _close(ty, jy, dtype, fp32_atol=2e-6)
    for k in ("k", "v"):
        assert tc[k].dtype == tspec.compute_dtype
        _close(tc[k], jc[k], dtype, fp32_atol=2e-6)
        # Only the written positions moved.
        moved = np.any(_f32(tc[k]) != _f32(jcache[k]), axis=(2, 3))
        assert moved.sum() <= b


def test_attn_decode_scalar_and_int_positions_agree():
    _, tspec = _attn_specs("float32", None)
    tp = params_from_numpy(_np(jattn.init_attention(
        jax.random.PRNGKey(0), _attn_specs("float32", None)[0])))
    x = torch.randn(2, 1, 32, generator=torch.Generator().manual_seed(0))
    outs = []
    for p in (4, torch.tensor(4), torch.tensor([4, 4])):
        cache = tattn.init_kv_cache(tspec, 2, 8, device="cpu")
        outs.append(tattn.attn_decode(tp, tspec, x, cache, p)[0])
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


# ------------------------------------------------------------------ SSM

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("version", [1, 2])
def test_mamba_decode_matches_reference(version, dtype):
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    if version == 1:
        kw = dict(d_model=16, d_state=4, d_conv=4, expand=2, dt_rank=0)
        jspec = jssm.Mamba1Spec(**kw, compute_dtype=jd)
        tspec = tssm.Mamba1Spec(**kw, compute_dtype=td)
        jp = jssm.init_mamba1(jax.random.PRNGKey(2), jspec)
        jcache = jssm.init_mamba1_cache(jspec, 3)
        jdec, tdec = jssm.mamba1_decode, tssm.mamba1_decode
        tinit = tssm.init_mamba1_cache
    else:
        kw = dict(d_model=16, d_state=8, d_conv=4, expand=2, head_dim=8,
                  chunk=16)
        jspec = jssm.Mamba2Spec(**kw, compute_dtype=jd)
        tspec = tssm.Mamba2Spec(**kw, compute_dtype=td)
        jp = jssm.init_mamba2(jax.random.PRNGKey(2), jspec)
        jcache = jssm.init_mamba2_cache(jspec, 3)
        jdec, tdec = jssm.mamba2_decode, tssm.mamba2_decode
        tinit = tssm.init_mamba2_cache
    # The port's empty cache has the reference's tree, fp32.
    empty = tinit(tspec, 3)
    assert [tuple(a.shape) for a in tree_leaves(empty)] == [
        a.shape for a in jax.tree.leaves(jcache)]
    assert all(a.dtype == torch.float32 for a in tree_leaves(empty))
    rng = np.random.default_rng(3)
    jcache = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), jnp.float32),
        jcache)
    tcache = params_from_numpy(_np(jcache))
    tp = params_from_numpy(_np(jp))
    for _ in range(3):
        x = rng.standard_normal((3, 1, 16)).astype(np.float32)
        jy, jcache = jdec(jp, jspec, jnp.asarray(x, jd), jcache)
        ty, tcache = tdec(tp, tspec, torch.from_numpy(x).to(td), tcache)
        _close(ty, jy, dtype, fp32_atol=2e-6)
        for a, b in zip(tree_leaves(tcache), jax.tree.leaves(jcache)):
            assert a.dtype == torch.float32
            _close(a, b, dtype, fp32_atol=2e-6)


# ------------------------------------------------------------ the stack

def _configs(arch, dtype):
    return (dataclasses.replace(j_get_smoke(arch), compute_dtype=dtype),
            dataclasses.replace(get_smoke_config(arch), compute_dtype=dtype))


def _paths(tree):
    out = []

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], prefix + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, prefix + (i,))
        else:
            out.append((prefix, tuple(node.shape), str(node.dtype)))
    walk(tree, ())
    return out


_DT = {"float32": "float32", "bfloat16": "bfloat16",
       "torch.float32": "float32", "torch.bfloat16": "bfloat16"}


@pytest.mark.parametrize("arch", PORTED)
def test_init_cache_tree_matches_reference(arch):
    jcfg, cfg = _configs(arch, "bfloat16")
    want = jax.eval_shape(lambda: j_build(jcfg).init_cache(None, 3, 24))
    want_paths = _paths(want)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    got = model.init_cache(params, 3, 24)
    got_paths = _paths(got)
    assert [(p, s, _DT[d]) for p, s, d in got_paths] == [
        (p, s, _DT[d]) for p, s, d in want_paths]
    assert all(float(a.abs().max()) == 0.0 for a in tree_leaves(got))


@functools.lru_cache(maxsize=None)
def _reference_decode(arch, dtype, steps=20, b=2):
    """The reference's params, tokens, per-step logits and final cache of
    a teacher-forced decode from an empty cache."""
    jcfg, _ = _configs(arch, dtype)
    model = j_build(jcfg)
    params = model.init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(11).integers(
        0, jcfg.vocab_size, (b, steps)).astype(np.int32)
    cache = model.init_cache(params, b, steps)
    step = jax.jit(model.decode_step)
    logits = []
    for t in range(steps):
        lg, cache = step(params, jnp.asarray(toks[:, t:t + 1]), cache,
                         jnp.int32(t))
        logits.append(np.asarray(lg))
    return _np(params), toks, logits, _np(cache)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", PORTED)
def test_decode_step_matches_reference(arch, dtype):
    """20 teacher-forced steps; fp32: logits and the cache within
    4e-6·(1 + max|·|) (measured ≤ 1.0e-6 and ≤ 1.2e-6); bf16: logits
    within 0.06·max|·| and the cache within 0.08·max|·| per leaf
    (measured ≤ 0.032 and ≤ 0.035)."""
    params_np, toks, want_logits, want_cache = _reference_decode(arch, dtype)
    _, cfg = _configs(arch, dtype)
    model = build_model(cfg)
    params = params_from_numpy(params_np)
    cache = model.init_cache(params, toks.shape[0], toks.shape[1])
    for t in range(toks.shape[1]):
        lg, cache = model.decode_step(params, torch.from_numpy(
            toks[:, t:t + 1]), cache, t)
        assert lg.dtype == torch.float32 and lg.shape == (
            toks.shape[0], 1, cfg.vocab_size)
        _close(lg, want_logits[t], dtype, fp32_atol=4e-6, bf16_rel=0.06)
    got, _ = tree_flatten(cache)
    for a, b in zip(got, jax.tree.leaves(want_cache)):
        _close(a, b, dtype, fp32_atol=4e-6, bf16_rel=0.08)


def test_swa_decode_past_its_ring_matches_reference():
    """mixtral-smoke (``swa`` layers, window 32, MoE) teacher-forced for
    300 steps at max_seq 300: each ring holds 256 positions
    (``ceil(33 / 256)·256``), so from step 256 on every write lands on a
    slot that held an older position.  fp32: logits at every step and the
    final cache (the rings) within 4e-6·(1 + max|·|), as the 20-step test;
    the rings are 256 long in both trees."""
    arch, steps = "mixtral_8x22b", 300
    params_np, toks, want_logits, want_cache = _reference_decode(
        arch, "float32", steps=steps)
    _, cfg = _configs(arch, "float32")
    model = build_model(cfg)
    params = params_from_numpy(params_np)
    cache = model.init_cache(params, toks.shape[0], steps)
    rings = [a.shape[2] for a in tree_leaves(cache)]
    assert rings == [256] * len(rings) == [
        a.shape[2] for a in jax.tree.leaves(want_cache)]
    for t in range(steps):
        lg, cache = model.decode_step(params, torch.from_numpy(
            toks[:, t:t + 1]), cache, t)
        _close(lg, want_logits[t], "float32", fp32_atol=4e-6)
    for a, b in zip(tree_leaves(cache), jax.tree.leaves(want_cache)):
        _close(a, b, "float32", fp32_atol=4e-6)


def test_local_global_decode_past_its_ring_matches_reference():
    """gemma3-smoke (one ``swa`` layer, window 32, and one global ``attn``
    layer; scaled embeddings) teacher-forced for 300 steps at max_seq 300:
    its ring holds 256 positions and wraps from step 256 on, while the
    global layer's linear cache holds all 300.  fp32: logits at every step
    and both caches within 4e-6·(1 + max|·|), as the 20-step test."""
    arch, steps = "gemma3_4b", 300
    params_np, toks, want_logits, want_cache = _reference_decode(
        arch, "float32", steps=steps)
    _, cfg = _configs(arch, "float32")
    model = build_model(cfg)
    params = params_from_numpy(params_np)
    cache = model.init_cache(params, toks.shape[0], steps)
    assert [a.shape[2] for a in tree_leaves(cache)] == [256, 256, 300, 300]
    for t in range(steps):
        lg, cache = model.decode_step(params, torch.from_numpy(
            toks[:, t:t + 1]), cache, t)
        _close(lg, want_logits[t], "float32", fp32_atol=4e-6)
    for a, b in zip(tree_leaves(cache), jax.tree.leaves(want_cache)):
        assert a.shape == b.shape
        _close(a, b, "float32", fp32_atol=4e-6)


@pytest.mark.parametrize("arch", PORTED)
def test_prefill_equals_decode(arch):
    """The port's teacher-forced decode logits against its own prefill
    forward's, fp32, B = 2, S = 20, at the reference's own bar."""
    _, cfg = _configs(arch, "float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(1))
    b, s = 2, 20
    toks = torch.randint(0, cfg.vocab_size, (b, s),
                         generator=torch.Generator().manual_seed(2))
    x = ttf._embed_inputs(params, cfg, {"tokens": toks})
    pos = torch.arange(s)[None].expand(b, s)
    hid, _ = ttf.forward_hidden(params, cfg, x, pos)
    want = (L.unembed_logits(params["embed"], hid, torch.float32)
            if cfg.tie_embeddings
            else L.dense(params["lm_head"], hid, torch.float32))
    cache = model.init_cache(params, b, s)
    got = torch.cat([model.decode_step(params, toks[:, t:t + 1], cache, t)[0]
                     for t in range(s)], dim=1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4,
                               rtol=2e-4)


def test_decode_cache_is_updated_in_place():
    _, cfg = _configs("zamba2_2_7b", "float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    cache = model.init_cache(params, 2, 8)
    before = tree_map(lambda a: a.clone(), cache)
    ids = [id(a) for a in tree_leaves(cache)]
    _, out = model.decode_step(params, torch.ones((2, 1), dtype=torch.long),
                               cache, 0)
    assert out is cache and [id(a) for a in tree_leaves(out)] == ids
    changed = [not torch.equal(a, b) for a, b in zip(tree_leaves(cache),
                                                     tree_leaves(before))]
    assert all(changed)
