"""The SSD scan's state-passing form (the stages the CUDA kernels compute)
against the JAX package, on the CPU.

``repro_torch.kernels.ref``'s ``ssd_chunk_states_ref``,
``ssd_state_pass_ref`` and ``ssd_chunk_output_ref`` compose to the SSD
scan: held to ``repro.kernels.ssd_scan.ssd_scan_ref`` (the sequential
oracle), ``repro.models.ssm._ssd_chunk_scan`` (the model layer's chunked
form) and ``ssd_scan_pallas`` in interpret mode, within atol 5e-5 / rtol
1e-4 (the reference's bars for its SSD kernel), on the existing four shapes,
a near-unit decay (a ≈ −1e-3: the state grows over many chunks) and
zamba2's width at S = 256.

The CUDA kernels run every product in 3×TF32: each fp32 operand x is split
into hi = tf32(x) and lo = tf32(x − hi), both cut from the bits toward zero
(the 13 low mantissa bits cleared; x − hi is exact in fp32), and lo·hi +
hi·lo + hi·hi accumulate in fp32.  An emulation (the same bit operations; a
product of two TF32 values is exact in fp32) shows that this keeps the
stages inside the card's bar, 5e-5·(1 + max|y|) against ``ssd_scan_ref``,
at zamba2's width, where a single TF32 pass does not.

The backward's twin ``ref.ssd_scan_bwd_ref`` (the stages
``ssd_bwd_local_ref``, ``ssd_bwd_pass_ref``, ``ssd_bwd_intra_ref``,
``ssd_bwd_state_ref``, as ``csrc/ssd_scan_bwd.cu`` computes them) against
``jax.vjp`` of ``_ssd_chunk_scan`` from h0 = 0 (its y) and against torch
autograd of ``ssd_scan_ref``, on the same shapes, within 2e-5·(1 +
max|g|), the other backward twins' bar (fp32 sums in another order); fed
the forward's saved states and decays, or recomputing them.  Its stages
emulated in 3×TF32 stay within the card's backward bar SSD_BWD_BAR (the
forward's, 5e-5·(1 + max|plain|)) at zamba2's width, one TF32 pass does
not, and the planted fault of ``chip_smoke.py``'s phase 8a (each chunk
handed the gradient of the chunk after it, G one chunk late) fails it.  The
wide path of ``csrc/ssd_scan_bwd.cu`` (chunk 128, P = N = 64) is emulated
as it orders its sums: every product by k-steps of 8, lo·hi, hi·lo and
hi·hi into one fp32 accumulator, dX's two terms in one accumulator with
dk folded into B before the split, and ⟨G, h_out⟩ formed from
exp(acum_L)·⟨G, h⟩ and the row dots it already has; it holds the bar, one
TF32 pass does not, and that form of ⟨G, h_out⟩ agrees with the saved
state.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.ssd_scan import ssd_scan_ref as j_ssd_seq
from repro.models.ssm import _ssd_chunk_scan
from repro_torch.kernels import ref as tref
from repro_torch.kernels.launch import LAUNCHES
from repro_torch.kernels.ssd_scan import (BWD_DACUM_SLOTS, BWD_LAUNCHES,
                                          BWD_PART_SLOTS)

ZAMBA2 = (1, 256, 80, 64, 64, 128)      # (B, S, H, P, N, chunk), S cut
BAR = 5e-5                              # chip_smoke.py's ssd_scan bar


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(shape, kind: str, seed: int):
    """numpy fp32 (xh, a, b, c).  "plain": the reference tests' inputs;
    "model": the zoo's streams (Δ = softplus, a = −Δ·A with A in [1, 16]
    by head, x scaled by Δ, b and c through SiLU); "unit": a ≈ −1e-3."""
    b, s, h, p, n, _ = shape
    rng = np.random.default_rng(seed)
    xh = rng.normal(size=(b, s, h, p))
    bm = rng.normal(size=(b, s, n))
    cm = rng.normal(size=(b, s, n))
    if kind == "plain":
        a = -rng.uniform(size=(b, s, h)) * 0.5
    elif kind == "unit":
        a = -1e-3 * rng.uniform(0.5, 1.5, size=(b, s, h))
    else:
        z = 0.5 * rng.normal(size=(b, s, h)) - 1.0
        dt = np.logaddexp(0.0, z)
        a = -dt * np.exp(np.linspace(0.0, np.log(16.0), h))
        xh = xh * dt[..., None]
        bm, cm = (v / (1.0 + np.exp(-v)) for v in (bm, cm))
    return [x.astype(np.float32) for x in (xh, a, bm, cm)]


CASES = [
    ((1, 64, 4, 16, 8, 16), "plain"),
    ((2, 100, 6, 8, 4, 32), "plain"),     # S not a multiple of the chunk
    ((1, 33, 2, 20, 8, 8), "plain"),      # ragged chunk, P not a multiple of 16
    ((1, 40, 3, 16, 16, 128), "plain"),   # one chunk longer than S
    ((1, 300, 3, 16, 8, 16), "unit"),     # 19 chunks at near-unit decay
    (ZAMBA2, "model"),
]


@pytest.mark.parametrize("shape,kind", CASES, ids=str)
def test_ssd_stages_match_reference(shape, kind):
    b, s, h, p, n, chunk = shape
    inputs = _inputs(shape, kind, seed=sum(shape))
    t_in = [torch.from_numpy(x) for x in inputs]
    j_in = [jnp.asarray(x) for x in inputs]
    got = tref.ssd_scan_stages_ref(*t_in, chunk=chunk)
    assert got.shape == (b, s, h, p) and got.dtype == torch.float32
    seq = j_ssd_seq(*j_in)
    chunked, _ = _ssd_chunk_scan(*j_in, jnp.zeros((b, h, p, n), jnp.float32),
                                 chunk)
    pallas = jops.ssd_scan(*j_in, implementation="pallas_interpret")
    for other in (seq, chunked, pallas):
        np.testing.assert_allclose(got.numpy(), np.asarray(other), atol=5e-5,
                                   rtol=1e-4)
    # The stages and the one-piece plain version compute one function.
    torch.testing.assert_close(got, tref.ssd_scan_ref(*t_in, chunk),
                               atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("shape,kind", [((1, 96, 3, 16, 8, 16), "plain"),
                                        ((2, 128, 2, 8, 16, 32), "unit")],
                         ids=str)
def test_ssd_state_pass_carries_the_final_state(shape, kind):
    """The state entering each chunk, carried once more, is the model
    layer's final state ``h_last``; the first chunk enters at zero."""
    b, s, h, p, n, chunk = shape
    inputs = _inputs(shape, kind, seed=7)
    t_in = [torch.from_numpy(x) for x in inputs]
    acum, states = tref.ssd_chunk_states_ref(t_in[0], t_in[1], t_in[2], chunk)
    assert acum.shape == (b, s // chunk, h, chunk)
    assert states.shape == (b, s // chunk, h, p, n)
    entering = tref.ssd_state_pass_ref(states, acum)
    assert float(entering[:, 0].abs().max()) == 0.0
    last = (torch.exp(acum[:, -1, :, -1])[..., None, None] * entering[:, -1]
            + states[:, -1])
    _, h_last = _ssd_chunk_scan(*(jnp.asarray(x) for x in inputs),
                                jnp.zeros((b, h, p, n), jnp.float32), chunk)
    np.testing.assert_allclose(last.numpy(), np.asarray(h_last), atol=5e-5,
                               rtol=1e-4)


# ------------------------------------------------------------ TF32 emulation

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 → TF32 as the kernels cut it: the 13 low mantissa bits
    cleared (toward zero)."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mm_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(_tf32(a), _tf32(b))


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return (torch.matmul(a_lo, b_hi) + torch.matmul(a_hi, b_lo)
            + torch.matmul(a_hi, b_hi))


def test_tf32_split_cuts_toward_zero():
    ulp = 2.0 ** -10                       # TF32's at 1
    x = torch.tensor([1.0 + ulp * 0.75, -(1.0 + ulp * 0.75), 1.0 + ulp, 3.0,
                      0.0], dtype=torch.float32)
    assert _tf32(x).tolist() == [1.0, -1.0, 1.0 + ulp, 3.0, 0.0]
    # hi keeps 11 significant bits, hi + lo ~21: the error of the split
    # operand is at most 2^-20 relative.
    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.normal(size=4096).astype(np.float32))
    hi = _tf32(v)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert float(((v - hi).abs() / v.abs()).max()) < 2.0 ** -10
    two = hi + _tf32(v - hi)
    assert float(((v - two).abs() / v.abs()).max()) < 2.0 ** -20


@pytest.mark.parametrize("kind", ["model", "unit"])
def test_3xtf32_holds_the_bar_and_1xtf32_does_not(kind):
    """The stages with every product emulated in 3×TF32 stay inside the
    card's bar against the plain version at zamba2's width; one TF32 pass
    does not."""
    chunk = ZAMBA2[-1]
    t_in = [torch.from_numpy(x) for x in _inputs(ZAMBA2, kind, seed=11)]
    plain = tref.ssd_scan_ref(*t_in, chunk)
    tol = BAR * (1.0 + float(plain.abs().max()))
    err3 = float((tref.ssd_scan_stages_ref(*t_in, chunk, mm=_mm_3xtf32)
                  - plain).abs().max())
    err1 = float((tref.ssd_scan_stages_ref(*t_in, chunk, mm=_mm_1xtf32)
                  - plain).abs().max())
    assert err3 <= tol / 10, (err3, tol)
    assert err1 > tol, (err1, tol)


def test_state_one_chunk_late_fails_the_bar():
    """The planted fault of chip_smoke.py's near-unit-decay row: the state
    entering each chunk applied one chunk late must fail the bar."""
    shape = (1, 512, 4, 16, 16, 128)
    b, s, h, p, n, chunk = shape
    xh, a, bm, cm = (torch.from_numpy(x) for x in _inputs(shape, "unit", 3))
    plain = tref.ssd_scan_ref(xh, a, bm, cm, chunk)
    acum, states = tref.ssd_chunk_states_ref(xh, a, bm, chunk)
    entering = tref.ssd_state_pass_ref(states, acum)
    late = torch.cat([torch.zeros_like(entering[:, :1]), entering[:, :-1]],
                     dim=1)
    tol = BAR * (1.0 + float(plain.abs().max()))
    good = tref.ssd_chunk_output_ref(xh, acum, bm, cm, entering, chunk)
    bad = tref.ssd_chunk_output_ref(xh, acum, bm, cm, late, chunk)
    assert float((good - plain).abs().max()) <= tol
    assert float((bad - plain).abs().max()) > 100 * tol


# ------------------------------------------------------------ the backward

BWD_BAR = 2e-5       # the backward twins' bar against jax.vjp and autograd


def _close(got, want, rel=BWD_BAR):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    assert err <= rel * (1.0 + np.abs(want).max()), (err, np.abs(want).max())


@pytest.mark.parametrize("saved", [False, True], ids=["recomputed", "saved"])
@pytest.mark.parametrize("shape,kind", CASES, ids=str)
def test_ssd_scan_bwd_ref_matches_reference_vjp(shape, kind, saved):
    b, s, h, p, n, chunk = shape
    inputs = _inputs(shape, kind, seed=sum(shape) + 1)
    dy = np.random.default_rng(sum(shape)).normal(
        size=(b, s, h, p)).astype(np.float32)
    h0 = jnp.zeros((b, h, p, n), jnp.float32)
    _, pull = jax.vjp(lambda *t: _ssd_chunk_scan(*t, h0, chunk)[0],
                      *(jnp.asarray(x) for x in inputs))
    want = pull(jnp.asarray(dy))
    t_in = [torch.from_numpy(x) for x in inputs]
    tdy = torch.from_numpy(dy)
    kw = {}
    if saved:
        _, states, acum = tref.ssd_scan_ref(*t_in, chunk, return_state=True)
        kw = dict(states=states, acum=acum)
    got = tref.ssd_scan_bwd_ref(*t_in, tdy, chunk, **kw)
    for x, w, t_ in zip(got, want, t_in):
        assert x.shape == t_.shape and x.dtype == torch.float32
        _close(x.numpy(), w)
    # ... and against torch autograd of the forward twin.
    leaves = [t_.clone().requires_grad_(True) for t_ in t_in]
    tref.ssd_scan_ref(*leaves, chunk).backward(tdy)
    for x, t_ in zip(got, leaves):
        _close(x.numpy(), t_.grad.numpy())


def test_ssd_scan_ref_returns_the_saved_state():
    """``return_state``: y unchanged, the entering states and decays the
    stages compute."""
    shape = (2, 100, 3, 8, 4, 32)
    t_in = [torch.from_numpy(x) for x in _inputs(shape, "plain", seed=4)]
    y, states, acum = tref.ssd_scan_ref(*t_in, 32, return_state=True)
    assert torch.equal(y, tref.ssd_scan_ref(*t_in, 32))
    want_acum, own = tref.ssd_chunk_states_ref(t_in[0], t_in[1], t_in[2], 32)
    assert acum.shape == (2, 4, 3, 32) and states.shape == (2, 4, 3, 8, 4)
    torch.testing.assert_close(acum, want_acum, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(states, tref.ssd_state_pass_ref(own, acum),
                               atol=5e-5, rtol=1e-4)


def _bwd_err(grads, want) -> float:
    """The worst of the four gradients' max error over its bar's scale,
    1 + max|plain|."""
    return max(float((g - w).abs().max()) / (1.0 + float(w.abs().max()))
               for g, w in zip(grads, want))


def _zamba2_bwd(kind, seed):
    t_in = [torch.from_numpy(x) for x in _inputs(ZAMBA2, kind, seed=seed)]
    dy = torch.from_numpy(np.random.default_rng(seed).normal(
        size=ZAMBA2[:4]).astype(np.float32))
    return t_in, dy


@pytest.mark.parametrize("kind", ["model", "unit"])
def test_bwd_3xtf32_holds_the_bar_and_1xtf32_does_not(kind):
    """The backward's stages with every product emulated in 3×TF32 stay
    inside the card's bar against the plain twin at zamba2's width; one
    TF32 pass does not."""
    chunk = ZAMBA2[-1]
    t_in, dy = _zamba2_bwd(kind, 12)
    plain = tref.ssd_scan_bwd_ref(*t_in, dy, chunk)
    err3 = _bwd_err(tref.ssd_scan_bwd_ref(*t_in, dy, chunk, mm=_mm_3xtf32),
                    plain)
    err1 = _bwd_err(tref.ssd_scan_bwd_ref(*t_in, dy, chunk, mm=_mm_1xtf32),
                    plain)
    assert err3 <= BAR / 10, err3
    assert err1 > BAR, err1


def test_gradient_one_chunk_late_fails_the_bar():
    """The planted fault of chip_smoke.py's phase 8a: every chunk handed
    the state gradient of the chunk after it must fail the bar by 10x."""
    chunk = ZAMBA2[-1]
    t_in, dy = _zamba2_bwd("unit", 13)
    xh, a, bm, cm = t_in
    plain = tref.ssd_scan_bwd_ref(xh, a, bm, cm, dy, chunk)
    acum, own = tref.ssd_chunk_states_ref(xh, a, bm, chunk)
    states = tref.ssd_state_pass_ref(own, acum)
    grads = tref.ssd_bwd_pass_ref(tref.ssd_bwd_local_ref(dy, acum, cm, chunk),
                                  acum)
    late = torch.cat([grads[:, 1:], torch.zeros_like(grads[:, :1])], dim=1)
    good = tref.ssd_bwd_chunks_ref(xh, acum, bm, cm, dy, states, grads, chunk)
    bad = tref.ssd_bwd_chunks_ref(xh, acum, bm, cm, dy, states, late, chunk)
    assert _bwd_err(good, plain) <= BAR
    assert _bwd_err(bad, plain) > 10 * BAR


# ---------------------------------------------- the wide path's sum order

def _mm_ksteps(split: bool):
    """A product as TF32 wgmma (or mma.sync) issues it: per k-step of 8,
    lo·hi, hi·lo, then hi·hi (``split``; else hi·hi alone) added in turn to
    one fp32 accumulator."""
    def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a_hi, b_hi = _tf32(a), _tf32(b)
        a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
        acc = None
        for k0 in range(0, a.shape[-1], 8):
            ks = slice(k0, k0 + 8)
            terms = [a_hi[..., ks] @ b_hi[..., ks, :]]
            if split:
                terms = [a_lo[..., ks] @ b_hi[..., ks, :],
                         a_hi[..., ks] @ b_lo[..., ks, :]] + terms
            for t in terms:
                acc = t if acc is None else acc + t
        return acc
    return mm


def _wide_bwd(xh, a, bm, cm, dy, chunk, mm, state_tail=False):
    """The backward as the wide path forms it, every product through
    ``mm``: dX = [diag(dk) B | Wᵀ]·[Gᵀ ; dY] in one accumulator (B·Gᵀ's
    k-steps first), dW, E and its products, the state terms, and dacum's
    last row from exp(acum_L)·⟨G, h⟩ + Σ dk∘rowsum((X·G)∘B).  With
    ``state_tail`` it returns that tail and ⟨G, h_out⟩ from the saved
    states instead."""
    b, s, h, p = xh.shape
    acum, own = tref.ssd_chunk_states_ref(xh, a, bm, chunk)
    states = tref.ssd_state_pass_ref(own, acum)
    grads = tref.ssd_bwd_pass_ref(
        tref.ssd_bwd_local_ref(dy, acum, cm, chunk, mm=mm), acum)
    x_c = tref._ssd_chunks(xh, chunk).transpose(2, 3)     # (B,nc,H,L,P)
    dy_c = tref._ssd_chunks(dy, chunk).transpose(2, 3)
    b_c = tref._ssd_chunks(bm, chunk)                     # (B,nc,L,N)
    c_c = tref._ssd_chunks(cm, chunk)
    dec = tref._ssd_decay(acum)                           # (B,nc,H,L,L)
    w = mm(c_c, b_c.transpose(-1, -2))[:, :, None] * dec
    dk = torch.exp(acum[..., -1:] - acum)                 # (B,nc,H,L)
    lhs = torch.cat([dk[..., None] * b_c[:, :, None].expand(
        *dk.shape, b_c.shape[-1]), w.transpose(-1, -2)], -1)
    dx = mm(lhs, torch.cat([grads.transpose(-1, -2), dy_c], -2))
    dw = mm(dy_c, x_c.transpose(-1, -2))
    dww = dw * w
    e = (dw * dec).sum(2)
    dcs = torch.exp(acum)[..., None] * mm(dy_c, states)
    dbs = dk[..., None] * mm(x_c, grads)
    rb = (dbs * b_c[:, :, None]).sum(-1)                  # (B,nc,H,L)
    tail = (torch.exp(acum[..., -1]) * (grads * states).sum((-1, -2))
            + rb.sum(-1))
    if state_tail:
        h_out = torch.cat([states[:, 1:], torch.zeros_like(states[:, :1])],
                          1)
        return tail, (grads * h_out).sum((-1, -2))
    dacum = (dww.sum(-1) - dww.sum(-2) + (dcs * c_c[:, :, None]).sum(-1)
             - rb)
    dacum[..., -1] += tail
    da = torch.flip(torch.cumsum(torch.flip(dacum, (-1,)), -1), (-1,))
    return (dx.transpose(2, 3).reshape(b, -1, h, p)[:, :s],
            da.transpose(2, 3).reshape(b, -1, h)[:, :s],
            (mm(e.transpose(-1, -2), c_c) + dbs.sum(2)).reshape(
                b, -1, bm.shape[-1])[:, :s],
            (mm(e, b_c) + dcs.sum(2)).reshape(b, -1, cm.shape[-1])[:, :s])


@pytest.mark.parametrize("kind", ["model", "unit"])
def test_bwd_wide_path_order_holds_the_bar_and_1xtf32_does_not(kind):
    """The wide path's arithmetic (its split points and its order of sums)
    stays inside the card's bar against the plain twin at zamba2's width;
    the same order with one TF32 pass does not."""
    chunk = ZAMBA2[-1]
    t_in, dy = _zamba2_bwd(kind, 14)
    plain = tref.ssd_scan_bwd_ref(*t_in, dy, chunk)
    err3 = _bwd_err(_wide_bwd(*t_in, dy, chunk, _mm_ksteps(True)), plain)
    err1 = _bwd_err(_wide_bwd(*t_in, dy, chunk, _mm_ksteps(False)), plain)
    assert err3 <= BAR / 10, err3
    assert err1 > BAR, err1


@pytest.mark.parametrize("shape,kind", [((1, 96, 3, 16, 8, 32), "model"),
                                        ((2, 100, 4, 8, 16, 32), "plain"),
                                        ((1, 300, 3, 16, 8, 16), "unit")],
                         ids=str)
def test_state_tail_equals_g_dot_h_out(shape, kind):
    """⟨G, h_out⟩ as the wide path forms it, exp(acum_L)·⟨G, h⟩ plus the
    sum of dk∘rowsum((X·G)∘B), against the dot with the next chunk's
    saved state (zero at the last chunk, whose G is zero)."""
    chunk = shape[-1]
    t_in = [torch.from_numpy(x) for x in _inputs(shape, kind, seed=15)]
    dy = torch.from_numpy(np.random.default_rng(15).normal(
        size=shape[:4]).astype(np.float32))
    tail, want = _wide_bwd(*t_in, dy, chunk, torch.matmul, state_tail=True)
    scale = 1.0 + float(want.abs().max())
    assert float((tail - want).abs().max()) <= 2e-5 * scale
    assert float(want[:, -1].abs().max()) == 0.0


def test_bwd_launch_names_and_scratch_slots_match_the_source():
    """The wrapper counts the four launches and sizes its scratch with the
    slot counts the CUDA source uses."""
    src = (Path(tref.__file__).parent / "csrc" / "ssd_scan_bwd.cu").read_text()
    slots = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (kDacumSlots|kPartSlots) = (\d+);", src)}
    assert slots == {"kDacumSlots": BWD_DACUM_SLOTS,
                     "kPartSlots": BWD_PART_SLOTS}
    assert BWD_LAUNCHES == ("ssd_scan_bwd_local", "ssd_scan_bwd_pass",
                            "ssd_scan_bwd_main", "ssd_scan_bwd")
    assert set(BWD_LAUNCHES) <= set(LAUNCHES)
    assert not {"ssd_scan_bwd_intra", "ssd_scan_bwd_state"} & set(LAUNCHES)
