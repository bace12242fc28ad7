"""The port's serving stack against the JAX package's, on the CPU.

* ``core.threefry``'s tensor draws — ``split_t``, ``uniform_t``,
  ``gumbel_t``, ``categorical_t`` — bit for bit against ``jax.random`` at
  seeds 0–4;
* ``serving.sample`` against ``repro.serving.sample`` on the same key and
  logits: greedy, temperature, top-k, top-p and top-k with top-p give the
  same tokens at seeds 0–4 over vocabularies of 16 to 19,000 (top-p's
  softmax and cumulative sum bit for bit as well);
* every contract of ``tests/test_serving.py`` on the port;
* the port's ``ServingEngine`` against the reference's, token for token
  from the reference's params: qwen3, smollm and the MoE configs
  (mixtral's ``swa`` rings) greedy and sampled; the Mamba families on the
  requests that reuse no slot;
* the reference's slot-reuse defect pinned: on falcon-mamba-smoke and
  zamba2-smoke its engine's request 2, the first to take a used slot,
  diverges from that request decoded alone; the port's engine, which zeroes
  the slot's recurrent state on admission, equals unbatched greedy decode
  for every family;
* the engine's refusal of the audio family (its cache needs each
  request's frames);
* ``python -m repro_torch.launch.serve`` with ``--smoke --device cpu``,
  fresh (qwen3, the MoE configs and whisper's encoder–decoder) and
  restoring a checkpoint the reference wrote, and the refusals without a
  GPU.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke
from repro.models import build_model as j_build
from repro.serving import Request as JRequest
from repro.serving import SamplerConfig as JSamplerConfig
from repro.serving import ServingEngine as JServingEngine
from repro.serving import sample as j_sample
from repro.train import save_checkpoint as j_save_checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.core import threefry as tf
from repro_torch.core.dol import xla_cumsum_t
from repro_torch.launch import serve
from repro_torch.models.zoo import build_model, params_from_numpy
from repro_torch.serving import Request, SamplerConfig, ServingEngine, sample
from repro_torch.serving.sampler import _softmax

SEEDS = range(5)
PORTED = ["qwen3_0_6b", "smollm_360m", "zamba2_2_7b", "falcon_mamba_7b",
          "mixtral_8x22b", "qwen3_moe_235b_a22b", "moonshot_v1_16b_a3b",
          "gemma3_4b", "pixtral_12b"]
SAMPLERS = [dict(temperature=0.0), dict(temperature=0.8),
            dict(temperature=1.0, top_k=40), dict(temperature=0.7, top_p=0.9),
            dict(temperature=0.8, top_k=40, top_p=0.9),
            dict(temperature=1.0, top_p=0.5)]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _keys():
    for seed in SEEDS:
        jk = jax.random.PRNGKey(seed)
        yield jk, torch.from_numpy(np.asarray(jk).astype(np.int64))


def _bits_equal(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    return np.array_equal(got.astype(np.float32).view(np.uint32),
                          want.astype(np.float32).view(np.uint32))


# ------------------------------------------------------ jax.random draws

def test_split_matches_jax():
    for jk, tk in _keys():
        for num in (2, 3, 5):
            assert np.array_equal(tf.split_t(tk, num).numpy(),
                                  np.asarray(jax.random.split(jk, num)))
        k, sub = tf.split_t(tk)
        jkey, jsub = jax.random.split(jk)
        assert np.array_equal(tf.split_t(k).numpy(),
                              np.asarray(jax.random.split(jkey)))


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 300), (2, 4096)])
def test_uniform_and_gumbel_match_jax(shape):
    for jk, tk in _keys():
        assert _bits_equal(tf.uniform_t(tk, shape),
                           jax.random.uniform(jk, shape))
        assert _bits_equal(tf.uniform_t(tk, shape, -2.0, 3.5),
                           jax.random.uniform(jk, shape, minval=-2.0,
                                              maxval=3.5))
        assert _bits_equal(tf.gumbel_t(tk, shape),
                           jax.random.gumbel(jk, shape))


def test_many_gumbel_draws_match_jax():
    jk, tk = jax.random.PRNGKey(2026), torch.tensor([0, 2026])
    assert _bits_equal(tf.gumbel_t(tk, (1 << 18,)),
                       jax.random.gumbel(jk, (1 << 18,)))


@pytest.mark.parametrize("v", [2, 256, 1000])
def test_categorical_matches_jax(v):
    rng = np.random.default_rng(v)
    for jk, tk in _keys():
        logits = (rng.standard_normal((4, v)) * 3).astype(np.float32)
        logits[0, : v // 2] = -np.inf
        want = np.asarray(jax.random.categorical(jk, jnp.asarray(logits)))
        got = tf.categorical_t(tk, torch.from_numpy(logits))
        assert np.array_equal(got.numpy(), want)


# ------------------------------------------------------------- sampler

@pytest.mark.parametrize("v", [16, 256, 1000, 4096, 18992])
def test_sample_matches_reference(v):
    rng = np.random.default_rng(v)
    for jk, tk in _keys():
        logits = (rng.standard_normal((4, v)) * 3).astype(np.float32)
        for kw in SAMPLERS:
            want = np.asarray(j_sample(jk, jnp.asarray(logits),
                                       JSamplerConfig(**kw)))
            got = sample(tk, torch.from_numpy(logits), SamplerConfig(**kw))
            assert got.dtype == torch.int32
            assert np.array_equal(got.numpy(), want), (kw, got, want)


@pytest.mark.parametrize("v", [16, 33, 1000, 18992])
def test_top_p_softmax_and_cumsum_bits(v):
    """The top-p mask's softmax over the sorted logits (``exp`` and the
    windowed sum of XLA-CPU) and its cumulative sum (XLA's chunked form),
    bit for bit."""
    rng = np.random.default_rng(v)
    x = -np.sort(-(rng.standard_normal((4, v)) * 3).astype(np.float32))
    x[1, v // 3:] = -np.inf
    want = np.asarray(jax.nn.softmax(jnp.asarray(x), axis=-1))
    got = _softmax(torch.from_numpy(x))
    assert _bits_equal(got, want)
    assert _bits_equal(xla_cumsum_t(got), jnp.cumsum(jnp.asarray(want),
                                                     axis=-1))


def test_sampler_greedy():
    logits = torch.tensor([[0.0, 5.0, 1.0], [3.0, 0.0, -1.0]])
    out = sample(torch.tensor([0, 0]), logits, SamplerConfig(temperature=0.0))
    assert out.tolist() == [1, 0]


def test_sampler_top_k_restricts_support():
    logits = torch.tensor([[0.0, 10.0, 9.0, -5.0]])
    cfg = SamplerConfig(temperature=1.0, top_k=2)
    draws = {int(sample(torch.tensor([0, s]), logits, cfg)[0])
             for s in range(50)}
    assert draws <= {1, 2}


def test_sampler_top_p_restricts_support():
    logits = torch.tensor([[10.0, 9.5, -10.0, -10.0]])
    cfg = SamplerConfig(temperature=1.0, top_p=0.9)
    draws = {int(sample(torch.tensor([0, s]), logits, cfg)[0])
             for s in range(50)}
    assert draws <= {0, 1}


# ------------------------------------------------------- ragged decode

def test_vector_position_decode_matches_scalar():
    cfg = dataclasses.replace(get_smoke_config("qwen3_0_6b"),
                              compute_dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(1))
    b, s = 3, 10
    toks = torch.randint(0, cfg.vocab_size, (b, s),
                         generator=torch.Generator().manual_seed(2))
    cache = model.init_cache(params, b, s)
    ref = torch.stack([model.decode_step(params, toks[:, t:t + 1], cache,
                                         t)[0][:, 0] for t in range(s)], 1)
    offsets = np.array([0, 1, 4])
    cache2 = model.init_cache(params, b, s)
    out = torch.zeros_like(ref)
    for gt in range(s + offsets.max()):
        pos = np.maximum(gt - offsets, 0)
        idx = np.minimum(pos, s - 1)
        xin = torch.stack([toks[r, idx[r]] for r in range(b)])[:, None]
        lg, cache2 = model.decode_step(params, xin, cache2,
                                       torch.from_numpy(pos))
        for r in range(b):
            p = gt - offsets[r]
            if 0 <= p < s:
                out[r, p] = lg[r, 0]
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-4)


# -------------------------------------------------------------- engine

def _engine(num_slots=2, max_seq=32):
    cfg = get_smoke_config("smollm_360m")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    return cfg, model, params, ServingEngine(
        model, params, num_slots=num_slots, max_seq=max_seq,
        sampler=SamplerConfig(temperature=0.0))


def test_engine_completes_more_requests_than_slots():
    cfg, model, params, eng = _engine(num_slots=2)
    rng = np.random.default_rng(0)
    for uid in range(5):
        eng.submit(Request(uid=uid,
                           prompt=rng.integers(0, cfg.vocab_size,
                                               size=4 + uid).astype(np.int32),
                           max_new_tokens=3))
    done = eng.run()
    assert sorted(r.uid for r in done) == [0, 1, 2, 3, 4]
    assert all(len(r.output) == 3 and r.done for r in done)


def test_engine_rejects_oversized_request():
    cfg, model, params, eng = _engine(max_seq=16)
    with pytest.raises(ValueError):
        eng.submit(Request(uid=0, prompt=np.zeros(20, np.int32),
                           max_new_tokens=4))


def _unbatched_greedy(model, params, prompt, new, max_seq):
    cache = model.init_cache(params, 1, max_seq)
    out = []
    for t in range(len(prompt) + new - 1):
        x = torch.tensor([[prompt[t] if t < len(prompt) else out[-1]]])
        lg, cache = model.decode_step(params, x, cache, t)
        if t >= len(prompt) - 1:
            out.append(int(torch.argmax(lg[0, -1])))
    return out


def _prompts(vocab):
    rng = np.random.default_rng(1)
    return [rng.integers(0, vocab, size=n).astype(np.int32)
            for n in (5, 7, 3)]


@functools.lru_cache(maxsize=None)
def _reference_engine(arch, sampler_kw):
    """The reference's params and its engine's outputs (fp32, 2 slots,
    max_seq 24, prompts of 5, 7 and 3 tokens, 4 new tokens each)."""
    jcfg = dataclasses.replace(j_get_smoke(arch), compute_dtype="float32")
    model = j_build(jcfg)
    params = model.init(jax.random.PRNGKey(0))
    eng = JServingEngine(model, params, num_slots=2, max_seq=24,
                         sampler=JSamplerConfig(**dict(sampler_kw)), seed=3)
    for uid, pr in enumerate(_prompts(jcfg.vocab_size)):
        eng.submit(JRequest(uid=uid, prompt=pr, max_new_tokens=4))
    done = {r.uid: r.output for r in eng.run()}
    return jax.tree.map(np.asarray, params), done, eng.steps


def _port_engine(arch, sampler_kw):
    params_np, _, _ = _reference_engine(arch, sampler_kw)
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    model = build_model(cfg)
    params = params_from_numpy(params_np)
    eng = ServingEngine(model, params, num_slots=2, max_seq=24,
                        sampler=SamplerConfig(**dict(sampler_kw)), seed=3)
    for uid, pr in enumerate(_prompts(cfg.vocab_size)):
        eng.submit(Request(uid=uid, prompt=pr, max_new_tokens=4))
    return model, params, {r.uid: r.output for r in eng.run()}, eng.steps


_GREEDY = (("temperature", 0.0),)
_SAMPLED = (("temperature", 0.8), ("top_k", 40))


@pytest.mark.parametrize("sampler_kw", [_GREEDY, _SAMPLED],
                         ids=["greedy", "sampled"])
@pytest.mark.parametrize("arch", PORTED)
def test_engine_matches_reference_engine(arch, sampler_kw):
    """Token for token; for the Mamba families only on requests 0 and 1,
    which take fresh slots (request 2 reuses one: see the next test)."""
    _, want, want_steps = _reference_engine(arch, sampler_kw)
    _, _, got, steps = _port_engine(arch, sampler_kw)
    assert steps == want_steps
    uids = ((0, 1) if arch in ("falcon_mamba_7b", "zamba2_2_7b")
            else (0, 1, 2))
    assert {u: got[u] for u in uids} == {u: want[u] for u in uids}


@pytest.mark.parametrize("arch", PORTED)
def test_engine_matches_unbatched_greedy_decode(arch):
    """Slot reuse must not leak state: the port's engine equals each
    request decoded alone, for every family; the reference's engine does
    not for the Mamba families (its request 2 keeps the previous request's
    conv and SSM state)."""
    model, params, got, _ = _port_engine(arch, _GREEDY)
    _, want_ref, _ = _reference_engine(arch, _GREEDY)
    alone = {uid: _unbatched_greedy(model, params, pr, 4, 24)
             for uid, pr in enumerate(_prompts(model.cfg.vocab_size))}
    assert got == alone
    if arch in ("falcon_mamba_7b", "zamba2_2_7b"):
        assert want_ref[2] != alone[2]
        assert {u: want_ref[u] for u in (0, 1)} == {u: alone[u]
                                                    for u in (0, 1)}
    else:
        assert want_ref == alone


def test_reference_defect_figures():
    """The reference engine's request 2 on falcon-mamba-smoke, against the
    request decoded alone (the figures ROADMAP records)."""
    _, want_ref, _ = _reference_engine("falcon_mamba_7b", _GREEDY)
    model, params, got, _ = _port_engine("falcon_mamba_7b", _GREEDY)
    assert want_ref[2] == [222, 42, 107, 169]
    assert got[2] == [59, 100, 228, 134]


# ----------------------------------------------------------------- CLI

def _cli_expected_ids(cfg, params, batch, context, new, seed):
    """Greedy ids of the CLI's run from ``params``: its prompts are the
    generator's draws after the init."""
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(seed)
    model.init(gen)
    prompt = torch.randint(0, cfg.vocab_size, (batch, context), generator=gen)
    cache = model.init_cache(params, batch, context + new)
    for t in range(context):
        lg, cache = model.decode_step(params, prompt[:, t:t + 1], cache, t)
    tok = torch.argmax(lg[:, -1], dim=-1, keepdim=True)
    ids = [int(tok[0])]
    for t in range(context, context + new - 1):
        lg, cache = model.decode_step(params, tok, cache, t)
        tok = torch.argmax(lg[:, -1], dim=-1, keepdim=True)
        ids.append(int(tok[0]))
    return ids[:16]


def _sample_ids(out: str) -> list:
    line = next(x for x in out.splitlines()
                if x.startswith("sample token ids:"))
    return eval(line.split(":", 1)[1])                  # noqa: S307


def test_serve_cli_fresh_on_cpu(capsys):
    serve.main(["--smoke", "--device", "cpu", "--batch", "2", "--context",
                "8", "--new-tokens", "6", "--temperature", "0"])
    out = capsys.readouterr().out
    assert "arch=qwen3-smoke batch=2 context=8" in out
    assert "tok/s/seq" in out and "tok/s aggregate (6 new tokens/seq)" in out
    cfg = get_smoke_config("qwen3_0_6b")
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    assert _sample_ids(out) == _cli_expected_ids(cfg, params, 2, 8, 6, 0)


@pytest.mark.parametrize("arch", ["mixtral_8x22b", "qwen3_moe_235b_a22b",
                                  "moonshot_v1_16b_a3b"])
def test_serve_cli_moe_smoke_on_cpu(arch, capsys):
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                "--context", "8", "--new-tokens", "6", "--temperature", "0"])
    out = capsys.readouterr().out
    cfg = get_smoke_config(arch)
    assert f"arch={cfg.name} batch=2 context=8" in out
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    assert _sample_ids(out) == _cli_expected_ids(cfg, params, 2, 8, 6, 0)


def test_serve_cli_gemma3_smoke_on_cpu(capsys):
    """gemma3 (local/global, scaled embeddings) through the serve CLI: its
    ids are the teacher-forced then greedy decode's."""
    serve.main(["--arch", "gemma3_4b", "--smoke", "--device", "cpu",
                "--batch", "2", "--context", "40", "--new-tokens", "6",
                "--temperature", "0"])
    out = capsys.readouterr().out
    cfg = get_smoke_config("gemma3_4b")
    assert f"arch={cfg.name} batch=2 context=40" in out
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    assert _sample_ids(out) == _cli_expected_ids(cfg, params, 2, 40, 6, 0)


def test_serve_cli_refuses_the_vision_family():
    """pixtral decodes text through the engine, but the serve CLI drives
    text decoders alone, as the reference's refuses it."""
    with pytest.raises(SystemExit, match="serve.py drives text decoders"):
        serve.main(["--arch", "pixtral_12b", "--smoke", "--device", "cpu"])


def test_serve_cli_restores_reference_checkpoint(tmp_path, capsys):
    jcfg = j_get_smoke("zamba2_2_7b")
    jparams = j_build(jcfg).init(jax.random.PRNGKey(5))
    j_save_checkpoint(str(tmp_path), 7, jparams)
    serve.main(["--arch", "zamba2_2_7b", "--smoke", "--device", "cpu",
                "--batch", "2", "--context", "6", "--new-tokens", "5",
                "--temperature", "0", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "restored checkpoint step 7" in out
    cfg = get_smoke_config("zamba2_2_7b")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams))
    assert _sample_ids(out) == _cli_expected_ids(cfg, params, 2, 6, 5, 0)


def test_serve_cli_samples_with_temperature(capsys):
    serve.main(["--smoke", "--device", "cpu", "--batch", "2", "--context",
                "4", "--new-tokens", "6", "--seed", "3"])
    ids = _sample_ids(capsys.readouterr().out)
    assert len(ids) == 6 and all(0 <= i < 256 for i in ids)


def test_serve_refusals_without_gpu(capsys):
    """Without a GPU the default device is refused, and whisper (the audio
    family) serves on the CPU when asked; the vision family is refused, as
    the reference refuses it."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke", "--batch", "1", "--context", "2",
                    "--new-tokens", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "whisper_base", "--smoke", "--batch", "1",
                    "--context", "2", "--new-tokens", "2"])
    capsys.readouterr()
    serve.main(["--arch", "whisper_base", "--smoke", "--device", "cpu",
                "--batch", "2", "--context", "4", "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "arch=whisper-smoke batch=2 context=4" in out
    assert "tok/s/seq" in out and "tok/s aggregate (3 new tokens/seq)" in out
    ids = _sample_ids(out)
    assert len(ids) == 3 and all(0 <= i < 256 for i in ids)
    with pytest.raises(SystemExit):
        serve.main(["--arch", "pixtral_12b", "--smoke", "--device", "cpu"])


def test_serve_cli_whisper_smoke_on_cpu(capsys):
    """whisper through the serve CLI: frames drawn from the seeded
    generator after the params, the cache built from them, then the ids of
    the teacher-forced then greedy decode."""
    serve.main(["--arch", "whisper_base", "--smoke", "--device", "cpu",
                "--batch", "2", "--context", "8", "--new-tokens", "6",
                "--temperature", "0"])
    out = capsys.readouterr().out
    cfg = get_smoke_config("whisper_base")
    assert f"arch={cfg.name} batch=2 context=8" in out
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen)
    frames = torch.randn((2, cfg.num_frontend_tokens, cfg.d_model),
                         generator=gen).to(torch.bfloat16)
    prompt = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen)
    cache = model.init_cache(params, frames, 2, 14)
    ids = []
    with torch.no_grad():
        for t in range(13):
            tok = prompt[:, t:t + 1] if t < 8 else tok
            lg, cache = model.decode_step(params, tok, cache, t)
            if t >= 7:
                tok = torch.argmax(lg[:, -1], dim=-1, keepdim=True)
                ids.append(int(tok[0]))
    assert _sample_ids(out) == ids


def test_engine_refuses_the_audio_family():
    """The engine takes decoder-only models: an encoder-decoder's cache is
    built from each request's audio frames, which a Request does not
    carry, so whisper is refused at construction with a clear error."""
    model = build_model(get_smoke_config("whisper_base"))
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="decoder-only"):
        ServingEngine(model, params, num_slots=2, max_seq=16)
