"""The port's MoE layer against the JAX package's, on the CPU.

``repro_torch.models.moe`` against ``repro.models.moe`` from the
reference's init carried across with ``params_from_numpy`` and the same
numpy inputs (B = 2, S = 24, D = 32, E = 4, top-2, F = 16), dropless and
capacity-bounded (capacity factor 0.5: pairs are dropped), without and
with shared experts (2), fp32 and bf16 compute:

* the top-k experts and the dropped pairs bit for bit (the reference's
  dispatch written out below with its own jnp steps);
* the output within 2e-6·(1 + max|out|) in fp32 (sum order; measured ≤
  2.1e-7) and 2^-7·max|out| in bf16 (measured bit-equal), the aux loss
  within 1e-7 (fp32 router in both; measured ≤ 1.9e-9);
* the gradients of ``Σ out·w + aux`` with respect to every param leaf and
  the input against ``jax.grad``, fp32: max|Δg| ≤ 1e-5·(1 + max|g|)
  (measured ≤ 3.1e-7);
* ports of ``tests/test_models_consistency.py``'s routing conservation
  and capacity drops, the init's tree, the capacity rule, the same bits
  twice under deterministic mode, and ``vmap`` over a client axis against
  each client alone (fp32, 1e-5·(1 + max|g|)).

Also the helpers that hand the reference's routing to the port
(:func:`capture_reference_routing`, :func:`follow_reference_routing`), which
the bf16 zoo tests use: in bf16 the router's discrete top-k turns a
one-ulp difference of its input into another expert where two router
probabilities nearly tie, and a token routed elsewhere differs by the
size of its output.  The helpers let those tests hold everything else to
the zoo's bars, and fail where the port routes a token differently from
the reference without a near tie (a top-k gap above ``NEAR_TIE``).
"""
import contextlib
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jL
from repro.models import moe as jmoe
from repro_torch.models import moe as tmoe
from repro_torch.tree import params_from_numpy, tree_leaves, tree_map

B, S, D = 2, 24, 32
# The largest gap log(p_k / p_{k+1}) between the port's k-th and (k+1)-th
# router probabilities at which it may route a token differently from the
# reference in bf16: one bf16 ulp of a smoke config's layer input moves its
# router logits by ~1e-3 (the zoo tests' flips measured at gaps of 2.6e-4
# to 2.6e-3).
NEAR_TIE = 1e-2


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _specs(dtype, dropless, shared, **kw):
    kw = dict(d_model=D, num_experts=4, top_k=2, d_ff_expert=16,
              num_shared_experts=shared, dropless=dropless, **kw)
    if not dropless:
        kw.setdefault("capacity_factor", 0.5)
    return (jmoe.MoESpec(**kw, compute_dtype=jnp.dtype(dtype)),
            tmoe.MoESpec(**kw, compute_dtype=getattr(torch, dtype)))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _reference_dispatch(p, spec, x):
    """The reference's router and capacity assignment (``moe_forward``'s own
    steps): top-k experts (T, k) and the kept pairs, back in pair order."""
    t = x.shape[0] * x.shape[1]
    xt = x.reshape(t, -1)
    logits = jL.dense(p["router"], xt, jnp.float32)
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    _, top_e = jax.lax.top_k(probs, spec.top_k)
    flat_e = top_e.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = jnp.bincount(sorted_e, length=spec.num_experts)
    starts = jnp.cumsum(counts) - counts
    keep = jnp.arange(flat_e.shape[0]) - starts[sorted_e] < spec.capacity(t)
    keep = jnp.zeros_like(keep).at[order].set(keep)
    return np.asarray(top_e), np.asarray(keep).reshape(top_e.shape)


def _case(dtype, dropless, shared, seed=0):
    jspec, tspec = _specs(dtype, dropless, shared)
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jspec)
    x = np.random.default_rng(seed).standard_normal((B, S, D)).astype(
        np.float32)
    return jspec, tspec, jp, params_from_numpy(_np(jp)), x


MODES = [True, False]
MODE_IDS = ["dropless", "capacity"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shared", [0, 2])
@pytest.mark.parametrize("dropless", MODES, ids=MODE_IDS)
def test_moe_forward_matches_reference(dropless, shared, dtype):
    jspec, tspec, jp, tp, x = _case(dtype, dropless, shared)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(tspec.compute_dtype)
    want_e, want_keep = _reference_dispatch(jp, jspec, jx)
    _, got_e, _ = tmoe.route(tp, tspec, tx.reshape(B * S, D))
    got_slot, got_keep = tmoe.dispatch(got_e, tspec.num_experts,
                                       tspec.capacity(B * S))
    np.testing.assert_array_equal(got_e.numpy(), want_e)
    np.testing.assert_array_equal(got_keep.numpy(), want_keep)
    assert bool(got_keep.all()) == dropless          # capacity drops pairs
    assert int(got_slot.max()) <= tspec.num_experts * tspec.capacity(B * S)
    jy, jaux = jmoe.moe_forward(jp, jspec, jx)
    ty, taux = tmoe.moe_forward(tp, tspec, tx)
    assert ty.dtype == tspec.compute_dtype and ty.shape == (B, S, D)
    assert taux.dtype == torch.float32 and taux.shape == ()
    want = _f32(jy)
    err = np.abs(_f32(ty) - want).max()
    scale = np.abs(want).max()
    bar = 2e-6 * (1 + scale) if dtype == "float32" else 2 ** -7 * scale
    assert err <= bar, (err, bar)
    assert abs(float(taux) - float(jaux)) <= 1e-7


@pytest.mark.parametrize("shared", [0, 2])
@pytest.mark.parametrize("dropless", MODES, ids=MODE_IDS)
def test_moe_grad_matches_reference(dropless, shared):
    jspec, tspec, jp, tp, x = _case("float32", dropless, shared, seed=1)
    w = np.random.default_rng(5).standard_normal((B, S, D)).astype(
        np.float32)

    def jloss(p, x):
        y, aux = jmoe.moe_forward(p, jspec, x)
        return jnp.sum(y * w) + aux

    want_p, want_x = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))

    def tloss(p, x):
        y, aux = tmoe.moe_forward(p, tspec, x)
        return torch.sum(y * torch.from_numpy(w)) + aux

    got_p, got_x = torch.func.grad(tloss, argnums=(0, 1))(
        tp, torch.from_numpy(x))
    pairs = list(zip(tree_leaves(got_p), jax.tree.leaves(want_p)))
    pairs.append((got_x, want_x))
    assert len(pairs) == len(jax.tree.leaves(jp)) + 1
    for g, want in pairs:
        g, want = _f32(g), _f32(want)
        assert g.shape == want.shape
        bar = 1e-5 * (1 + np.abs(want).max())
        assert np.abs(g - want).max() <= bar, (np.abs(g - want).max(), bar)


def test_moe_routing_conservation():
    """Every kept token's output is the prob-weighted sum of its experts'
    outputs (capacity factor 2: all kept), as the reference's test."""
    gen = torch.Generator().manual_seed(0)
    spec = tmoe.MoESpec(d_model=16, num_experts=4, top_k=2, d_ff_expert=32,
                        capacity_factor=2.0, compute_dtype=torch.float32)
    p = tmoe.init_moe(gen, spec)
    x = torch.randn((2, 8, 16), generator=gen)
    out, aux = tmoe.moe_forward(p, spec, x)
    assert out.shape == x.shape
    assert bool(torch.isfinite(out).all()) and float(aux) > 0
    xt = x.reshape(16, 16)
    probs = torch.softmax(xt @ p["router"]["w"], -1)
    top_p, top_e = torch.topk(probs, 2)
    top_p = top_p / top_p.sum(-1, keepdim=True)

    def expert(e, h):
        g = h @ p["w_gate"][e]
        u = h @ p["w_up"][e]
        return (torch.nn.functional.silu(g) * u) @ p["w_down"][e]

    want = torch.stack([sum(top_p[t, j] * expert(int(top_e[t, j]), xt[t])
                            for j in range(2)) for t in range(16)])
    np.testing.assert_allclose(out.reshape(16, 16).numpy(), want.numpy(),
                               atol=1e-4, rtol=1e-3)


def test_moe_capacity_drops_overflow():
    gen = torch.Generator().manual_seed(0)
    spec = tmoe.MoESpec(d_model=8, num_experts=2, top_k=1, d_ff_expert=16,
                        capacity_factor=0.5, compute_dtype=torch.float32)
    p = tmoe.init_moe(gen, spec)
    x = torch.randn((1, 16, 8), generator=gen)
    out, _ = tmoe.moe_forward(p, spec, x)
    norms = torch.linalg.vector_norm(out.reshape(16, 8), dim=-1)
    assert int((norms == 0.0).sum()) >= 1


@pytest.mark.parametrize("t", [1, 7, 8, 24, 100, 4096])
@pytest.mark.parametrize("dropless", MODES, ids=MODE_IDS)
def test_moe_capacity_rule_equals_reference(dropless, t):
    jspec, tspec = _specs("float32", dropless, 0, capacity_factor=1.25)
    assert tspec.capacity(t) == jspec.capacity(t)


@pytest.mark.parametrize("shared", [0, 2])
def test_init_moe_draws_the_reference_layout(shared):
    jspec, tspec = _specs("float32", True, shared)
    want = jax.eval_shape(lambda: jmoe.init_moe(jax.random.PRNGKey(0),
                                                jspec))
    for stack in ((), (3,)):
        got = tmoe.init_moe(torch.Generator().manual_seed(0), tspec, stack)
        want_leaves = jax.tree.leaves(want)
        got_leaves = tree_leaves(got)
        assert len(got_leaves) == len(want_leaves)
        for g, w in zip(got_leaves, want_leaves):
            assert tuple(g.shape) == stack + w.shape
            assert g.dtype == torch.float32


def test_moe_forward_same_bits_twice_in_deterministic_mode():
    """The same bits twice, under ``torch.use_deterministic_algorithms``
    (which raises on an op with no deterministic kernel)."""
    _, tspec, _, tp, x = _case("float32", True, 2)
    tx = torch.from_numpy(x)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        a, aux_a = tmoe.moe_forward(tp, tspec, tx)
        b, aux_b = tmoe.moe_forward(tp, tspec, tx)
    finally:
        torch.use_deterministic_algorithms(prev)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


# ------------------------------------------- the reference's routing, handed

def capture_reference_routing(fn):
    """``fn()`` with the reference's ``moe_forward`` reporting each call's
    top-k experts (its own router steps, inside whatever jit or scan runs
    it): returns ``(fn's result, [top_e (T, k) per call, in order])``."""
    calls = []
    real = jmoe.moe_forward

    def wrapped(p, spec, x):
        t = x.shape[0] * x.shape[1]
        logits = jL.dense(p["router"], x.reshape(t, -1), jnp.float32)
        probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
        _, top_e = jax.lax.top_k(probs, spec.top_k)
        jax.debug.callback(lambda e: calls.append(np.asarray(e)), top_e,
                           ordered=True)
        return real(p, spec, x)

    with mock.patch.object(jmoe, "moe_forward", wrapped):
        out = fn()
        jax.effects_barrier()
    return out, calls


@contextlib.contextmanager
def follow_reference_routing(routings, near_tie=NEAR_TIE):
    """Within the block the port's router takes the reference's experts
    from ``routings`` (:func:`capture_reference_routing`'s list): each call
    takes the recorded routing its own top-k agrees with most (a layer's,
    whichever order the layers run in, remat's recompute included), with
    the weights gathered from its own probabilities.  A token the port
    would route differently must be a near tie (log(p_k / p_{k+1}) of its
    own probabilities within ``near_tie``), else an AssertionError.  Yields
    a list that receives the number of such tokens per call."""
    real = tmoe._top_k
    flips = []

    def forced(probs, k):
        own = torch.sort(real(probs, k)[1], dim=-1).values
        agree = [(torch.from_numpy(np.sort(r, -1)) == own).all(-1)
                 for r in routings]
        best = max(range(len(agree)), key=lambda i: int(agree[i].sum()))
        moved = ~agree[best]
        srt = torch.sort(probs, dim=-1, descending=True).values
        gaps = torch.log(srt[:, k - 1] / srt[:, k])[moved]
        assert bool((gaps <= near_tie).all()), (gaps.tolist(), near_tie)
        flips.append(int(moved.sum()))
        e = torch.from_numpy(routings[best].astype(np.int64))
        return torch.gather(probs, -1, e), e

    with mock.patch.object(tmoe, "_top_k", forced):
        yield flips


def test_follow_reference_routing_rejects_a_wrong_router():
    """The helper itself: it hands the recorded experts over where they
    agree or nearly tie, and fails where the port's routing differs
    without a near tie (a router whose top-k was exchanged with the
    next)."""
    jspec, tspec, jp, tp, x = _case("float32", True, 0)
    (want, _), routings = capture_reference_routing(
        lambda: jax.jit(lambda p, x: jmoe.moe_forward(p, jspec, x))(
            jp, jnp.asarray(x)))
    assert len(routings) == 1 and routings[0].shape == (B * S, 2)
    with follow_reference_routing(routings) as flips:
        got, _ = tmoe.moe_forward(tp, tspec, torch.from_numpy(x))
    assert flips == [0]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-6, rtol=0)
    wrong = [(r + 1) % tspec.num_experts for r in routings]
    with pytest.raises(AssertionError):
        with follow_reference_routing(wrong):
            tmoe.moe_forward(tp, tspec, torch.from_numpy(x))


def test_dataclass_fields_equal_reference():
    jf = [(f.name, f.default) for f in dataclasses.fields(jmoe.MoESpec)
          if f.name != "compute_dtype"]
    tf_ = [(f.name, f.default) for f in dataclasses.fields(tmoe.MoESpec)
           if f.name != "compute_dtype"]
    assert jf == tf_


def test_moe_under_vmap_equals_each_client():
    """``torch.func.vmap`` over a client axis (each client its own params
    and tokens, as the fleet steps stack them) gives each client's own
    forward and gradients, fp32, to sum-order noise."""
    tspec = _specs("float32", True, 2)[1]
    clients = 3
    gen = torch.Generator().manual_seed(4)
    params = [tmoe.init_moe(gen, tspec) for _ in range(clients)]
    xs = torch.randn((clients, B, S, D), generator=gen)
    stacked = tree_map(lambda *a: torch.stack(a), *params)

    def loss(p, x):
        y, aux = tmoe.moe_forward(p, tspec, x)
        return torch.sum(y * y) + aux

    got = torch.func.vmap(torch.func.grad_and_value(loss))(stacked, xs)
    for c in range(clients):
        want = torch.func.grad_and_value(loss)(params[c], xs[c])
        np.testing.assert_allclose(float(got[1][c]), float(want[1]),
                                   rtol=1e-6)
        for g, w in zip(tree_leaves(got[0]), tree_leaves(want[0])):
            np.testing.assert_allclose(g[c].numpy(), w.numpy(), rtol=0,
                                       atol=1e-5 * (1 + float(w.abs().max())))
