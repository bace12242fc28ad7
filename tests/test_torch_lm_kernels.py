"""The LM zoo's kernel modules against the JAX package's, on the CPU.

Plain PyTorch versions (``repro_torch.kernels.ref``) and the CPU dispatch
(``repro_torch.kernels.ops``) of ``flash_attention``, ``ssm_scan`` and
``ssd_scan`` are held to ``repro.kernels.ref`` / ``ssd_scan_ref``, the
model layer's chunked SSD form and the Pallas bodies run in interpret mode,
on the same numpy inputs.  The CUDA kernels are held to these plain versions
on the card by ``chip_smoke.py``.

Attention runs at the zoo's head dims, 64 to pixtral's 160 and gemma3's
256.  Tolerances: fp32 attention within 3e-6 (the reference's own bar for its
kernel against its oracle; both sides are fp32 softmaxes summed in another
order); bf16 attention within one bf16 ulp of the output's scale (2e-2,
the reference's bar: both round an fp32 result to bf16).  The scans within
atol 1e-5 / rtol 1e-5 (Mamba-1) and atol 5e-5 / rtol 1e-4 (SSD), the
reference's bars for its kernels.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan_ref as j_ssd_seq
from repro.models.ssm import _ssd_chunk_scan
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return np.asarray(x.to(torch.float32) if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


# ------------------------------------------------------------ attention

@pytest.mark.parametrize("b,sq,sk,h,d,causal,window,dtype", [
    (2, 64, 64, 4, 64, True, None, "float32"),       # causal
    (1, 100, 100, 2, 80, True, None, "float32"),     # zamba2's D = 80
    (1, 96, 96, 2, 128, True, None, "float32"),      # qwen3's D = 128
    (1, 130, 130, 3, 32, True, 32, "float32"),       # sliding window
    (1, 32, 128, 2, 64, True, None, "float32"),      # Sq < Sk, right-aligned
    (1, 48, 160, 2, 80, True, 40, "float32"),        # Sq < Sk with a window
    (2, 64, 64, 1, 64, False, None, "float32"),      # non-causal
    (2, 64, 64, 4, 64, True, None, "bfloat16"),
    (1, 40, 72, 2, 80, True, 24, "bfloat16"),
    (1, 72, 72, 2, 160, True, None, "float32"),     # pixtral's D = 160
    (1, 72, 72, 2, 256, True, None, "float32"),     # gemma3's D = 256
    (1, 96, 96, 2, 256, True, 32, "float32"),       # gemma3's window < S
    (1, 24, 88, 2, 160, True, None, "float32"),     # Sq < Sk at D = 160
    (1, 40, 104, 1, 256, True, 48, "float32"),      # Sq < Sk, windowed
    (1, 72, 72, 2, 160, True, None, "bfloat16"),
    (1, 96, 96, 2, 256, True, 32, "bfloat16"),
    (1, 40, 104, 2, 256, True, 48, "bfloat16"),
    (1, 24, 88, 2, 160, True, 20, "bfloat16"),
], ids=str)
def test_flash_attention_plain_matches_reference(b, sq, sk, h, d, causal,
                                                 window, dtype):
    rng = np.random.default_rng(b * sq + sk + d)
    q, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32)
               for s in (sq, sk, sk))
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(x).astype(jd) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x).to(td) for x in (q, k, v))
    got = tref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == td and got.shape == (b, sq, h, d)
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    pallas = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                  implementation="pallas_interpret")
    atol = 3e-6 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=atol, rtol=0)
    # The CPU dispatch takes the plain version.
    assert torch.equal(tops.flash_attention(tq, tk, tv, causal=causal,
                                            window=window), got)


def test_flash_attention_fully_masked_rows_are_zero():
    """A query right-aligned before every key (Sq > Sk, causal) sees no key:
    its row is 0, as the reference's."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(1, 12, 2, 16)).astype(np.float32)
    kv = rng.normal(size=(1, 8, 2, 16)).astype(np.float32)
    got = tops.flash_attention(*(torch.from_numpy(x) for x in (q, kv, kv)))
    want = jref.flash_attention_ref(*(jnp.asarray(x) for x in (q, kv, kv)))
    assert float(got[:, :4].abs().max()) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-6)


def test_gqa_head_order_is_repeat_interleave():
    """The zoo's q head h = kh·G + g reads kv head kh: repeating kv with
    repeat_interleave matches per-group attention, tile does not."""
    rng = np.random.default_rng(2)
    b, s, kh, g, d = 1, 24, 2, 3, 16
    q = torch.from_numpy(rng.normal(size=(b, s, kh, g, d)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(b, s, kh, d)).astype(np.float32))
            for _ in range(2))
    got = tops.flash_attention(q.reshape(b, s, kh * g, d),
                               k.repeat_interleave(g, dim=2),
                               v.repeat_interleave(g, dim=2))
    for hk in range(kh):
        for gi in range(g):
            one = tref.flash_attention_ref(q[:, :, hk, gi:gi + 1],
                                           k[:, :, hk:hk + 1],
                                           v[:, :, hk:hk + 1])
            torch.testing.assert_close(got[:, :, hk * g + gi], one[:, :, 0])
    tiled = tops.flash_attention(q.reshape(b, s, kh * g, d),
                                 k.tile(1, 1, g, 1), v.tile(1, 1, g, 1))
    assert not torch.allclose(tiled, got)


# ------------------------------------------------------------ Mamba-1 scan

@pytest.mark.parametrize("shape", [(2, 100, 64, 16), (1, 257, 40, 8),
                                   (3, 33, 12, 4)], ids=str)
def test_ssm_scan_plain_matches_reference(shape):
    rng = np.random.default_rng(sum(shape))
    da = np.exp(-rng.uniform(size=shape)).astype(np.float32)
    dbx = rng.normal(size=shape).astype(np.float32)
    got = tref.ssm_scan_ref(torch.from_numpy(da), torch.from_numpy(dbx))
    want = jref.ssm_scan_ref(jnp.asarray(da), jnp.asarray(dbx))
    # block_d 32 does not divide D = 40 or 12: ragged channel blocks.
    pallas = jops.ssm_scan(jnp.asarray(da), jnp.asarray(dbx),
                           implementation="pallas_interpret")
    for other in (want, pallas):
        np.testing.assert_allclose(got.numpy(), np.asarray(other),
                                   atol=1e-5, rtol=1e-5)
    assert torch.equal(tops.ssm_scan(torch.from_numpy(da),
                                     torch.from_numpy(dbx)), got)


def test_ssm_scan_with_unit_decay_is_a_prefix_sum():
    rng = np.random.default_rng(3)
    dbx = torch.from_numpy(rng.normal(size=(1, 32, 8, 4)).astype(np.float32))
    got = tref.ssm_scan_ref(torch.ones_like(dbx), dbx)
    torch.testing.assert_close(got, torch.cumsum(dbx, dim=1), atol=1e-5,
                               rtol=1e-5)


# ------------------------------------------------------------ Mamba-2 SSD

@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 64, 4, 16, 8, 16),
    (2, 100, 6, 8, 4, 32),       # S not a multiple of the chunk
    (1, 33, 2, 20, 8, 8),        # ragged chunk, P not a multiple of 16
    (1, 40, 3, 16, 16, 128),     # one chunk longer than S
], ids=str)
def test_ssd_scan_plain_matches_reference(b, s, h, p, n, chunk):
    rng = np.random.default_rng(b * s + h * p + n)
    xh = rng.normal(size=(b, s, h, p)).astype(np.float32)
    a = (-rng.uniform(size=(b, s, h)) * 0.5).astype(np.float32)
    bm = rng.normal(size=(b, s, n)).astype(np.float32)
    cm = rng.normal(size=(b, s, n)).astype(np.float32)
    j_in = [jnp.asarray(x) for x in (xh, a, bm, cm)]
    t_in = [torch.from_numpy(x) for x in (xh, a, bm, cm)]
    got = tref.ssd_scan_ref(*t_in, chunk=chunk)
    assert got.shape == (b, s, h, p)
    seq = j_ssd_seq(*j_in)
    chunked, _ = _ssd_chunk_scan(*j_in, jnp.zeros((b, h, p, n), jnp.float32),
                                 chunk)
    pallas = jops.ssd_scan(*j_in, implementation="pallas_interpret")
    for other in (seq, chunked, pallas):
        np.testing.assert_allclose(got.numpy(), np.asarray(other), atol=5e-5,
                                   rtol=1e-4)
    assert torch.equal(tops.ssd_scan(*t_in, chunk=chunk), got)


def test_cuda_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers take CUDA tensors only (the CPU dispatch never
    reaches them); each kernel has its launch counter."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.launch import LAUNCHES
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda
    from repro_torch.kernels.ssm_scan import ssm_scan_cuda
    x = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(x, x, x)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(*(x.to(torch.bfloat16),) * 3)
    with pytest.raises(ValueError, match="CUDA"):
        ssm_scan_cuda(x, x)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_cuda(x, torch.zeros((1, 8, 2)), torch.zeros((1, 8, 4)),
                      torch.zeros((1, 8, 4)))
    assert set(LAUNCHES) >= {"flash_attention", "ssm_scan", "ssd_scan_state",
                             "ssd_scan_pass", "ssd_scan"}
