"""Gradients through the port's LM zoo against the JAX package's, on the CPU.

* ``torch.func.grad`` of the port's ``lm_loss`` (remat on) against
  ``jax.grad`` of the reference's ``model.loss`` at qwen3-smoke,
  smollm-smoke, falcon-mamba-smoke, zamba2-smoke (its ``mamba2`` layers
  through ``ssd_scan``), the MoE smoke configs (mixtral's ``swa``
  layers; each body's running aux loss carried through remat's
  checkpoint; in bf16 the reference's experts at near ties,
  ``tests/test_torch_moe.py``), gemma3-smoke (local/global, scaled tied
  embeddings), pixtral-smoke (patch embeddings ahead of the text) and
  whisper-smoke (the encoder–decoder: its encoder's gradient comes back
  through the cross-attention), and at ``tests/test_torch_zoo.py``'s
  ``HEAD_DIM_CUTS`` (gemma3 at head dim 256 with a 16-key window, pixtral
  at 160: the head dims whose backward the card runs on the ``wgmma``
  instances past D = 128; whisper at 64 over 200 frames), from
  the reference's init carried across with ``params_from_numpy``.  Per leaf, max|Δg| / max|g| and ‖Δg‖ / ‖g‖.
  ``compute_dtype="float32"``: within 2e-3 and 5e-4 (measured ≤ 4.4e-4,
  whisper-smoke's, and ≤ 9.1e-5; the readout is bf16 in both packages,
  its rounding lands on other sums).  ``"bfloat16"``: within 0.1 and
  0.05, every family.  Measured: qwen3 ≤ 0.022 / 0.022, smollm ≤ 0.019 /
  0.018, falcon ≤ 0.014 / 0.012, whisper ≤ 0.018 / 0.018 (0.020 / 0.020
  at D = 64; its GELU takes the reference's per-op bf16 rounding), zamba2
  ≤ 0.049 / 0.050 (0.087 / 0.081 before the port's SiLU took the
  reference's rounding: σ = 1 / (1 + exp(−x)) with each op rounded, and
  ``lax.logistic``'s gradient rule; a zamba2 layer's forward is then
  bit-equal to the reference's).  What is left is where XLA sums a
  bf16 gradient over the batch and sequence (the per-channel leaves: the
  convs' weights and biases, ``a_log``, ``dt_bias``, ``d_skip``, the norm
  scales), in an order and precision no eager torch op takes.
* ``remat=True`` against ``remat=False``: equal gradients, under ``grad``,
  ``vmap`` over a client axis and plain autograd, and the layer bodies run
  twice (the backward's recompute).
* The backward twins ``ref.flash_attention_bwd_ref`` and
  ``ref.ssm_scan_bwd_ref`` (``ref.ssd_scan_bwd_ref``'s are in
  ``tests/test_torch_ssd.py``) against ``jax.vjp`` of ``repro.kernels.ref``'s
  forwards (causal, windowed, Sq < Sk, non-causal, GQA-repeated heads, a
  fully masked row, and causal, windowed and Sq < Sk at gemma3's D = 256
  and pixtral's 160; within 2e-5 · (1 + max|g|): fp32 sums in another
  order) and against torch autograd of the forward twins (1e-5).
* The ``Function``s of ``kernels/autograd.py`` built on the plain twins
  (the seam the CUDA route uses; ``ssd_function`` with
  ``ref.ssd_scan_ref`` / ``ref.ssd_scan_bwd_ref``): ``grad``,
  ``grad_and_value`` and ``vmap`` over a client axis with an unbatched
  operand (attention's also at D = 160 and 256), against autograd of the
  plain forwards; the port's SiLU against
  ``jax.nn.sigmoid``'s rounding and gradient; and ``ops.flash_attention``'s card route (forced
  on the CPU) widening bf16 at a head dim the tensor-core kernel does not
  take to the fp32 kernels.
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, grad_and_value, vmap

from repro.configs import get_smoke_config as j_get_smoke
from repro.kernels import ref as jref
from repro.models.zoo import build_model as j_build
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import autograd as kag
from repro_torch.kernels import ref as tref
from repro_torch.models import transformer as ttf
from repro_torch.models.zoo import build_model, params_from_numpy
from repro_torch.tree import tree_leaves, tree_map
from test_torch_moe import capture_reference_routing, follow_reference_routing
from test_torch_zoo import HEAD_DIM_CUTS

ARCHS = ["qwen3_0_6b", "smollm_360m", "falcon_mamba_7b", "zamba2_2_7b",
         "mixtral_8x22b", "qwen3_moe_235b_a22b", "moonshot_v1_16b_a3b",
         "gemma3_4b", "pixtral_12b", "whisper_base", *HEAD_DIM_CUTS]
BATCH, SEQ = 2, 24
GRAD_BARS = {"float32": (2e-3, 5e-4), "bfloat16": (0.1, 0.05)}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _batch(cfg):
    """The shared batch; a vision config's also carries its patch
    embeddings (B, P, d_model) ahead of the text, an audio config its
    frame embeddings (B, T, d_model)."""
    rng = np.random.default_rng(3)
    vocab = cfg.vocab_size
    tokens = rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32)
    labels = rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32)
    mask = (rng.uniform(size=(BATCH, SEQ)) < 0.8).astype(np.float32)
    batch = {"tokens": tokens, "labels": labels, "mask": mask}
    if cfg.frontend is not None:
        key = {"vision": "patch_embeddings", "audio": "frames"}[cfg.frontend]
        batch[key] = rng.normal(size=(
            BATCH, cfg.num_frontend_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _cut(arch):
    """(smoke config name, its changes): an arch's smoke config, or a
    HEAD_DIM_CUTS entry."""
    return HEAD_DIM_CUTS.get(arch, (arch, {}))


@functools.lru_cache(maxsize=None)
def _reference(arch, dtype):
    """The reference's params, loss and gradients (numpy), and the experts
    its MoE layers chose (an empty list without MoE)."""
    base, change = _cut(arch)
    jcfg = dataclasses.replace(j_get_smoke(base), compute_dtype=dtype,
                               **change)
    model = j_build(jcfg)
    params = model.init(jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v) for k, v in _batch(jcfg).items()}
    (loss, grads), routings = capture_reference_routing(
        lambda: jax.value_and_grad(
            lambda p: model.loss(p, batch, remat=False))(params))
    to_np = functools.partial(jax.tree.map, lambda x: np.asarray(x))
    return to_np(params), float(loss), to_np(grads), routings


def _port(arch, dtype):
    base, change = _cut(arch)
    cfg = dataclasses.replace(get_smoke_config(base), compute_dtype=dtype,
                              **change)
    return build_model(cfg), cfg


def _tbatch(cfg):
    return {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_grad_matches_reference(arch, dtype):
    params_np, want_loss, want_grads, routings = _reference(arch, dtype)
    model, cfg = _port(arch, dtype)
    batch = _tbatch(cfg)
    # bf16 MoE: the reference's experts where the router nearly ties
    # (tests/test_torch_moe.py); the forward and remat's recompute alike.
    follow = dtype == "bfloat16" and cfg.moe is not None
    with (follow_reference_routing(routings) if follow
          else contextlib.nullcontext([])) as flips:
        grads, loss = grad_and_value(
            lambda p: model.loss(p, batch, remat=True))(
                params_from_numpy(params_np))
    # Near ties are rare: at most 10 % of a call's tokens (measured: 2 of
    # 48 in qwen3-moe-smoke's second layer, in the forward and its
    # recompute).
    assert max(flips, default=0) <= 0.1 * BATCH * SEQ, flips
    # fp32: 2e-5, and 1e-4 with pixtral's patch embeddings (N(0, 1) rows
    # ahead of the text: its fp32 hidden-state noise flips more of the bf16
    # readout's roundings; measured 2.6e-5).
    loss_tol = ((1e-4 if cfg.frontend == "vision" else 2e-5)
                if dtype == "float32" else 3e-3)
    assert abs(float(loss) - want_loss) <= loss_tol
    max_bar, l2_bar = GRAD_BARS[dtype]
    if cfg.frontend == "vision" and dtype == "float32":
        # One bf16 ulp of a leaf's largest entry (≤ 2^-7 of it): the
        # readout's gradient (lm_head) is a bf16 product in both packages,
        # and the patch rows' noise flips one of its roundings at max|g|
        # (measured 4.1e-3; every other leaf ≤ 1.5e-4, every leaf's l2 ≤
        # 2.8e-4).
        max_bar = 2.0 ** -7
    # At a head-dim cut in fp32 the leaf that carries the readout's
    # gradient (gemma3's tied table) is held to one bf16 ulp of its largest
    # entry, as pixtral's leaves above, for the same reason (measured at
    # gemma3's cut: 2.2e-3 of max|g|, one rounding flipped; every other
    # leaf ≤ 5.3e-4 and every leaf's l2 ≤ 1.1e-4).
    readout = "['embed']" if cfg.tie_embeddings else "['lm_head']"
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_leaves_with_path(want_grads)]
    want_leaves = jax.tree.leaves(want_grads)
    got_leaves = tree_leaves(grads)
    assert len(got_leaves) == len(want_leaves) == len(paths)
    for path, w, g in zip(paths, want_leaves, got_leaves):
        w = np.asarray(w, np.float32)
        g = g.float().numpy()
        assert g.shape == w.shape and np.isfinite(g).all()
        err = np.abs(g - w)
        bar = (max(max_bar, 2.0 ** -7)
               if arch in HEAD_DIM_CUTS and dtype == "float32"
               and path.startswith(readout) else max_bar)
        assert err.max() <= bar * np.abs(w).max() + 1e-12, (path,
                                                           err.max())
        assert (np.linalg.norm(g - w)
                <= l2_bar * np.linalg.norm(w) + 1e-12)


# ------------------------------------------------------------------ remat

@pytest.mark.parametrize("arch", ["qwen3_0_6b", "falcon_mamba_7b"])
def test_remat_equals_no_remat_and_recomputes(arch, monkeypatch):
    model, cfg = _port(arch, "float32")
    params = model.init(torch.Generator().manual_seed(0))
    batch = _tbatch(cfg)
    calls = []
    apply_layer = ttf._apply_layer

    def counted(*args, **kw):
        calls.append(1)
        return apply_layer(*args, **kw)

    monkeypatch.setattr(ttf, "_apply_layer", counted)

    def grads(remat):
        calls.clear()
        g = grad(lambda p: model.loss(p, batch, remat=remat))(params)
        return g, len(calls)

    g_on, n_on = grads(True)
    g_off, n_off = grads(False)
    assert n_off == cfg.num_layers and n_on == 2 * cfg.num_layers
    for a, b in zip(tree_leaves(g_on), tree_leaves(g_off)):
        assert torch.equal(a, b)
    # Plain autograd takes the same checkpoints.
    leaves = tree_map(lambda x: x.clone().requires_grad_(True), params)
    model.loss(leaves, batch, remat=True).backward()
    for a, b in zip(tree_leaves(leaves), tree_leaves(g_off)):
        assert torch.equal(a.grad, b)
    # Under vmap over a client axis of two perturbed copies.
    stacked = tree_map(lambda x: torch.stack([x, x * 1.01]), params)
    sbatch = tree_map(lambda x: torch.stack([x, x.flip(0)]), batch)

    def fleet(remat):
        return vmap(grad(lambda p, b: model.loss(p, b, remat=remat)))(
            stacked, sbatch)

    for a, b in zip(tree_leaves(fleet(True)), tree_leaves(fleet(False))):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- twins

ATTN_CASES = [
    # (B, Sq, Sk, KH, G, D, causal, window)
    (2, 24, 24, 2, 1, 16, True, None),        # causal
    (1, 40, 40, 2, 1, 8, True, 7),            # sliding window
    (1, 12, 30, 2, 1, 16, True, None),        # Sq < Sk, right-aligned
    (2, 20, 20, 1, 1, 12, False, None),       # non-causal
    (1, 16, 16, 2, 3, 8, True, None),         # GQA: heads repeated 3×
    (1, 10, 6, 1, 1, 8, True, None),          # Sq > Sk: rows 0-3 see none
    (1, 20, 20, 2, 1, 256, True, None),       # gemma3's head dim: causal
    (1, 36, 36, 1, 2, 256, True, 9),          # ... a window shorter than S
    (1, 12, 28, 1, 1, 256, True, None),       # ... Sq < Sk
    (1, 20, 20, 2, 1, 160, True, None),       # pixtral's head dim: causal
    (1, 36, 36, 2, 1, 160, True, 9),          # ... a window shorter than S
    (1, 12, 28, 1, 2, 160, True, None),       # ... Sq < Sk, GQA
]


def _attn_inputs(b, sq, sk, kh, g, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, kh * g, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, kh, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, kh, d)).astype(np.float32)
    do = rng.standard_normal((b, sq, kh * g, d)).astype(np.float32)
    # heads pre-repeated for GQA, h = kh·G + g
    return q, np.repeat(k, g, axis=2), np.repeat(v, g, axis=2), do


def _close(got, want, rel=2e-5):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert np.abs(got - want).max() <= rel * (1.0 + np.abs(want).max())


@pytest.mark.parametrize("use_lse", [False, True], ids=["softmax", "lse"])
@pytest.mark.parametrize("b,sq,sk,kh,g,d,causal,window", ATTN_CASES)
def test_flash_attention_bwd_ref_matches_reference_vjp(b, sq, sk, kh, g, d,
                                                       causal, window,
                                                       use_lse):
    """``use_lse``: P from the forward's lse, as the kernels form it."""
    q, k, v, do = _attn_inputs(b, sq, sk, kh, g, d)
    kw = dict(causal=causal, window=window)
    out, pull = jax.vjp(lambda q, k, v: jref.flash_attention_ref(
        q, k, v, **kw), *(jnp.asarray(x) for x in (q, k, v)))
    want = pull(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = tref.flash_attention_ref(tq, tk, tv, return_lse=True, **kw)
    _close(o.numpy(), out, 3e-6)
    got = tref.flash_attention_bwd_ref(tq, tk, tv, o, tdo,
                                       lse=lse if use_lse else None, **kw)
    for x, w in zip(got, want):
        _close(x.numpy(), w)
    # ... and against torch autograd of the forward twin.
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    tref.flash_attention_ref(*leaves, **kw).backward(tdo)
    for x, t in zip(got, leaves):
        _close(x.numpy(), t.grad.numpy(), 1e-5)
    if sq > sk and causal:
        # Rows that see no key output 0 and send no gradient.
        assert float(o[:, :sq - sk].abs().max()) == 0.0
        assert float(got[0][:, :sq - sk].abs().max()) == 0.0


def _masked_scores64(q, k, causal, window):
    """float64 scaled scores, -inf where the mask hides a key."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) / d ** 0.5
    q_pos = torch.arange(q.shape[1])[:, None] + (k.shape[1] - q.shape[1])
    k_pos = torch.arange(k.shape[1])[None, :]
    hide = (k_pos > q_pos) if causal else torch.zeros_like(k_pos > q_pos)
    if window is not None:
        hide |= k_pos <= q_pos - window
    return s.masked_fill(hide, float("-inf"))


@pytest.mark.parametrize("b,sq,sk,kh,g,d,causal,window", ATTN_CASES)
def test_flash_attention_ref_lse_matches_float64(b, sq, sk, kh, g, d, causal,
                                                  window):
    """The plain lse against float64 ``torch.logsumexp`` of the masked
    scores (fp32 scores and exp: within 2e-6·(1 + |lse|)); +inf exactly
    where a row sees no key; (B, H, Sq) fp32."""
    q, k, v, _ = (torch.from_numpy(x) for x in _attn_inputs(b, sq, sk, kh,
                                                            g, d, seed=3))
    _, lse = tref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                      return_lse=True)
    want = torch.logsumexp(_masked_scores64(q, k, causal, window), dim=-1)
    assert lse.dtype == torch.float32 and lse.shape == (b, kh * g, sq)
    none = torch.isneginf(want)
    assert torch.equal(torch.isposinf(lse), none)
    assert bool(none.any()) == (sq > sk and causal)
    seen = ~none
    err = (lse.double() - want)[seen].abs()
    assert float((err / (1.0 + want[seen].abs())).max()) <= 2e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,kh,g,d,causal,window", ATTN_CASES)
def test_flash_attention_ref_output_same_bits_with_lse(b, sq, sk, kh, g, d,
                                                       causal, window, dtype):
    """``o`` is bit-equal with and without ``return_lse``."""
    q, k, v, _ = (torch.from_numpy(x).to(dtype)
                  for x in _attn_inputs(b, sq, sk, kh, g, d, seed=4))
    kw = dict(causal=causal, window=window)
    o, _ = tref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    assert torch.equal(o, tref.flash_attention_ref(q, k, v, **kw))


def test_flash_attention_bwd_ref_keeps_bf16():
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _attn_inputs(1, 16, 16, 2, 1, 16))
    o = tref.flash_attention_ref(q, k, v)
    grads = tref.flash_attention_bwd_ref(q, k, v, o, do)
    assert all(x.dtype == torch.bfloat16 for x in grads)
    want = tref.flash_attention_bwd_ref(*(t.float() for t in (q, k, v)),
                                        o.float(), do.float())
    for x, w in zip(grads, want):
        _close(x.float().numpy(), w.numpy(), 1e-2)


@pytest.mark.parametrize("shape", [(2, 17, 3, 4), (1, 40, 8, 2)])
def test_ssm_scan_bwd_ref_matches_reference_vjp(shape):
    rng = np.random.default_rng(5)
    da = np.exp(-rng.uniform(size=shape)).astype(np.float32)
    dbx = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    dhs = rng.standard_normal(shape).astype(np.float32)
    _, pull = jax.vjp(jref.ssm_scan_ref, jnp.asarray(da), jnp.asarray(dbx))
    want = pull(jnp.asarray(dhs))
    tda, tdbx, tdhs = (torch.from_numpy(x) for x in (da, dbx, dhs))
    hs = tref.ssm_scan_ref(tda, tdbx)
    got = tref.ssm_scan_bwd_ref(tda, hs, tdhs)
    for x, w in zip(got, want):
        _close(x.numpy(), w, 1e-5)
    leaves = [t.clone().requires_grad_(True) for t in (tda, tdbx)]
    tref.ssm_scan_ref(*leaves).backward(tdhs)
    for x, t in zip(got, leaves):
        _close(x.numpy(), t.grad.numpy(), 1e-6)
    # The first step's decay meets h_{-1} = 0.
    assert float(got[0][:, 0].abs().max()) == 0.0


# --------------------------------------------------------- the Functions

PlainAttention = kag.attention_function(tref.flash_attention_ref,
                                        tref.flash_attention_bwd_ref)
PlainScan = kag.scan_function(tref.ssm_scan_ref, tref.ssm_scan_bwd_ref)
PlainSsd = kag.ssd_function(tref.ssd_scan_ref, tref.ssd_scan_bwd_ref)


def _attn_loss(fn, w, causal, window):
    def loss(q, k, v):
        return (fn(q, k, v, causal, window) * w).sum()
    return loss


def _through_function(q, k, v, causal, window):
    o, _ = PlainAttention.apply(q, k, v, causal, window, None)
    return o


def _through_plain(q, k, v, causal, window):
    return tref.flash_attention_ref(q, k, v, causal=causal, window=window)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 5),
                                           (False, None)])
def test_attention_function_grad_and_vmap(causal, window):
    q, k, v, do = (torch.from_numpy(x)
                   for x in _attn_inputs(2, 12, 12, 2, 1, 8, seed=1))
    args = (0, 1, 2)
    got = grad(_attn_loss(_through_function, do, causal, window),
               argnums=args)(q, k, v)
    want = grad(_attn_loss(_through_plain, do, causal, window),
                argnums=args)(q, k, v)
    for x, w in zip(got, want):
        _close(x.numpy(), w.numpy(), 1e-5)
    want_q = want[0]
    (g_q, _), value = grad_and_value(
        _attn_loss(_through_function, do, causal, window),
        argnums=(0, 1))(q, k, v)
    _close(value.numpy(), _attn_loss(_through_plain, do, causal,
                                     window)(q, k, v).numpy(), 1e-6)
    # A client axis of 3 on q and v; k unbatched (expanded in the rule).
    qs, vs = q[None] * torch.tensor([1.0, 0.5, -1.0])[:, None, None, None,
                                                      None], v[None].repeat(
        3, 1, 1, 1, 1)
    got = vmap(grad(_attn_loss(_through_function, do, causal, window),
                    argnums=args), in_dims=(0, None, 0))(qs, k, vs)
    want = vmap(grad(_attn_loss(_through_plain, do, causal, window),
                     argnums=args), in_dims=(0, None, 0))(qs, k, vs)
    for x, w in zip(got, want):
        assert x.shape[0] == 3
        _close(x.numpy(), w.numpy(), 1e-5)
    # The lse output: the plain twin's, under grad_and_value (as an aux
    # output) and vmap (the client axis folded and unfolded), and no
    # gradient flows through it.
    kw = dict(causal=causal, window=window)

    def with_lse(q, k, v):
        o, lse = PlainAttention.apply(q, k, v, causal, window, None)
        return (o * do).sum(), lse

    (g_q, _), (_, lse) = grad_and_value(with_lse, argnums=(0, 1),
                                        has_aux=True)(q, k, v)
    assert torch.equal(lse, tref.flash_attention_ref(
        q, k, v, return_lse=True, **kw)[1])
    _close(g_q.numpy(), want_q.numpy(), 1e-5)
    lses = vmap(lambda q, v: PlainAttention.apply(q, k, v, causal, window,
                                                  None)[1],
                in_dims=(0, 0))(qs, vs)
    assert lses.shape == (3,) + lse.shape
    for c in range(3):
        assert torch.equal(lses[c], tref.flash_attention_ref(
            qs[c], k, vs[c], return_lse=True, **kw)[1])
    _, lse_alone = PlainAttention.apply(q.clone().requires_grad_(True), k, v,
                                        causal, window, None)
    assert not lse_alone.requires_grad


@pytest.mark.parametrize("d", [160, 256])
def test_attention_function_vmaps_at_the_wide_head_dims(d):
    """The ``Function``'s ``vmap`` rule folds a client axis into B at
    pixtral's and gemma3's head dims too (a window at 256): gradients
    within 1e-5 of vmapped autograd of the plain forward."""
    q, k, v, do = (torch.from_numpy(x)
                   for x in _attn_inputs(1, 10, 10, 2, 1, d, seed=2))
    window = 4 if d == 256 else None
    qs = q[None] * torch.tensor([1.0, -0.5])[:, None, None, None, None]
    vs = v[None].repeat(2, 1, 1, 1, 1)
    got = vmap(grad(_attn_loss(_through_function, do, True, window),
                    argnums=(0, 1, 2)), in_dims=(0, None, 0))(qs, k, vs)
    want = vmap(grad(_attn_loss(_through_plain, do, True, window),
                     argnums=(0, 1, 2)), in_dims=(0, None, 0))(qs, k, vs)
    for x, w in zip(got, want):
        assert x.shape[0] == 2 and x.shape[-1] == d
        _close(x.numpy(), w.numpy(), 1e-5)


def test_scan_function_grad_and_vmap():
    rng = np.random.default_rng(2)
    da = torch.from_numpy(np.exp(-rng.uniform(size=(2, 9, 3, 2))).astype(
        np.float32))
    dbx = torch.from_numpy(rng.standard_normal((2, 9, 3, 2)).astype(
        np.float32))
    w = torch.from_numpy(rng.standard_normal((2, 9, 3, 2)).astype(
        np.float32))

    def through(fn):
        return lambda a, b: (fn(a, b) * w).sum()

    got = grad(through(PlainScan.apply), argnums=(0, 1))(da, dbx)
    want = grad(through(tref.ssm_scan_ref), argnums=(0, 1))(da, dbx)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    _, value = grad_and_value(through(PlainScan.apply))(da, dbx)
    assert torch.equal(value, through(tref.ssm_scan_ref)(da, dbx))
    das = torch.stack([da, da * 0.5, da.flip(1)])
    got = vmap(grad(through(PlainScan.apply), argnums=(0, 1)),
               in_dims=(0, None))(das, dbx)
    want = vmap(grad(through(tref.ssm_scan_ref), argnums=(0, 1)),
                in_dims=(0, None))(das, dbx)
    for x, y in zip(got, want):
        assert x.shape[0] == 3 and torch.equal(x, y)


def test_ssd_function_grad_and_vmap():
    rng = np.random.default_rng(4)
    b, s, h, p, n, chunk = 2, 21, 3, 4, 5, 8
    xh, w = (torch.from_numpy(rng.standard_normal((b, s, h, p)).astype(
        np.float32)) for _ in range(2))
    bm, cm = (torch.from_numpy(rng.standard_normal((b, s, n)).astype(
        np.float32)) for _ in range(2))
    a = torch.from_numpy((-0.5 * rng.uniform(size=(b, s, h))).astype(
        np.float32))
    args = (0, 1, 2, 3)

    def through(fn):
        return lambda *t: (fn(*t) * w).sum()

    fun = through(lambda *t: PlainSsd.apply(*t, chunk)[0])
    plain = through(lambda *t: tref.ssd_scan_ref(*t, chunk))
    got = grad(fun, argnums=args)(xh, a, bm, cm)
    want = grad(plain, argnums=args)(xh, a, bm, cm)
    for x, y in zip(got, want):
        _close(x.numpy(), y.numpy())
    (g_x, g_a), value = grad_and_value(fun, argnums=(0, 1))(xh, a, bm, cm)
    assert torch.equal(value, plain(xh, a, bm, cm))
    _close(g_a.numpy(), want[1].numpy())
    # A client axis of 3 on xh and cm; a and bm unbatched (expanded in
    # the rule).
    xs = xh[None] * torch.tensor([1.0, 0.5, -1.0])[:, None, None, None, None]
    cs = torch.stack([cm, cm.flip(1), 2.0 * cm])
    dims = (0, None, None, 0)
    got = vmap(grad(fun, argnums=args), in_dims=dims)(xs, a, bm, cs)
    want = vmap(grad(plain, argnums=args), in_dims=dims)(xs, a, bm, cs)
    for x, y in zip(got, want):
        assert x.shape[0] == 3
        _close(x.numpy(), y.numpy())
    # The saved state takes no gradient, and is the plain twin's.
    y, states, acum = PlainSsd.apply(xh.clone().requires_grad_(True), a, bm,
                                     cm, chunk)
    assert y.requires_grad and not states.requires_grad
    assert not acum.requires_grad
    _, want_states, want_acum = tref.ssd_scan_ref(xh, a, bm, cm, chunk,
                                                  return_state=True)
    assert torch.equal(states, want_states) and torch.equal(acum, want_acum)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_silu_takes_the_reference_rounding(dtype):
    """``layers.silu`` and its gradient against ``x * jax.nn.sigmoid(x)``
    and ``jax.vjp`` of it, bit for bit in bf16 (each op rounded in both
    packages), in fp32 within 1e-6 of the largest value (XLA contracts
    the fp32 chain into FMAs, and the gradient's two terms cancel near
    its zeros); and the same under ``vmap``."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL
    rng = np.random.default_rng(6)
    x = (3.0 * rng.standard_normal((4, 257))).astype(np.float32)
    g = rng.standard_normal((4, 257)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    want, pull = jax.vjp(JL.silu, jnp.asarray(x).astype(jdt))
    (want_dx,) = pull(jnp.asarray(g).astype(jdt))
    tx, tg = (torch.from_numpy(v).to(tdt) for v in (x, g))
    got, tpull = torch.func.vjp(torch.vmap(lambda r: TL.silu(r)), tx)
    (got_dx,) = tpull(tg)
    for a_, w_ in ((got, want), (got_dx, want_dx)):
        assert a_.dtype == tdt
        a_, w_ = a_.float().numpy(), np.asarray(w_.astype(jnp.float32))
        if dtype == "bfloat16":
            np.testing.assert_array_equal(a_, w_)
        else:
            np.testing.assert_allclose(a_, w_, rtol=1e-6,
                                       atol=1e-6 * np.abs(w_).max())


def test_card_route_widens_bf16_at_other_head_dims(monkeypatch):
    """On the card, bf16 attention at a head dim the tensor-core kernel
    does not take (the smoke configs' 32) runs the fp32 kernel and its
    backward on operands widened to fp32, the output rounded to bf16; at
    the zoo's head dims, pixtral's 160 and gemma3's 256 among them, it
    stays bf16.  Checked through the seam with the
    plain twins and the route forced to ``cuda``."""
    from repro_torch.kernels import ops
    seen = []

    def fwd(q, k, v, **kw):
        seen.append(("fwd", q.dtype))
        return tref.flash_attention_ref(q, k, v, **kw)

    def bwd(q, k, v, o, do, **kw):
        seen.append(("bwd", q.dtype))
        return tref.flash_attention_bwd_ref(q, k, v, o, do, **kw)

    monkeypatch.setattr(ops, "_route", lambda t: "cuda")
    monkeypatch.setattr(ops, "FlashAttention",
                        kag.attention_function(fwd, bwd))
    for d, inner in ((32, torch.float32), (64, torch.bfloat16),
                     (160, torch.bfloat16), (256, torch.bfloat16)):
        q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                       for x in _attn_inputs(1, 8, 8, 2, 1, d, seed=d))
        seen.clear()
        dq = grad(lambda q: (ops.flash_attention(q, k, v).float()
                             * do.float()).sum())(q)
        assert seen == [("fwd", inner), ("bwd", inner)]
        assert dq.dtype == torch.bfloat16
        out = ops.flash_attention(q, k, v)
        assert out.dtype == torch.bfloat16
        want = tref.flash_attention_ref(q.to(inner), k.to(inner),
                                        v.to(inner)).to(torch.bfloat16)
        assert torch.equal(out, want)
