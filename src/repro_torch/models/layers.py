"""Shared building blocks of the LM zoo, as pure functions of a params tree.

Counterpart of ``repro.models.layers``.  Parameters are plain nested dicts of
tensors in the reference's layout; every function takes ``(params, inputs)``.
Compute runs in ``compute_dtype`` (bf16 by default) with fp32 master params
and fp32 norm / softmax accumulation.  The reference's ``REPRO_PERF_OPTS``
toggles are fixed at their default (``all``): the cross-entropy chunks over
the sequence with the batch intact, and ``embed_dshard`` (an opt-in sharding
hint) does not exist here.
"""
from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch

from repro_torch.models.remat import checkpoint

Params = Any

__all__ = ["silu", "gelu", "init_dense", "dense", "init_rmsnorm", "rmsnorm",
           "init_layernorm", "layernorm", "init_embedding", "embed",
           "embed_scale", "unembed_logits", "rope_freqs", "apply_rope",
           "sinusoidal_positions", "init_swiglu", "swiglu",
           "chunked_cross_entropy", "torch_dtype", "init_normal"]


def torch_dtype(name: str | torch.dtype) -> torch.dtype:
    """``"bfloat16"`` / ``"float32"`` (a config's dtype names) → torch."""
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


def init_normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device).mul_(scale)


class _Silu(torch.autograd.Function):
    """``x·σ(x)`` as the reference's ``x * jax.nn.sigmoid(x)`` rounds it:
    σ = 1 / (1 + exp(−x)), ``lax.logistic``'s expansion, each op rounded in
    x's dtype, and the gradient by its JVP rule, ``g·σ + (g·x)·(σ·(1 −
    σ))``.  In bf16 ``torch.sigmoid`` and autograd's own gradient round at
    other places, which alone sent zamba2's bf16 gradients 0.06 (rel-L2)
    from the reference's (``tests/test_torch_zoo_grad.py``).  Returns
    ``(y, σ)``; σ takes no gradient."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        s = 1.0 / (1.0 + torch.exp(-x))
        return x * s, s

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output[1])
        ctx.save_for_backward(inputs[0], output[1])

    @staticmethod
    def backward(ctx, g, _gs):
        x, s = ctx.saved_tensors
        return g * s + (g * x) * (s * (1.0 - s))


def silu(x: torch.Tensor) -> torch.Tensor:
    return _Silu.apply(x)[0]


@functools.lru_cache(maxsize=None)
def _gelu_constants(dtype: torch.dtype) -> tuple[float, float]:
    """√(2/π) and 0.044715 rounded to ``dtype``, as the reference's
    ``np.sqrt(2 / np.pi).astype(x.dtype)`` and its weakly typed literal
    are; returned as Python floats holding those values exactly."""
    return tuple(float(torch.tensor(v, dtype=dtype))
                 for v in (float(np.sqrt(2.0 / np.pi)), 0.044715))


class _Gelu(torch.autograd.Function):
    """The tanh GELU as the reference's ``jax.nn.gelu`` (approximate, its
    default) rounds it: ``x·(0.5·(1 + tanh(c·(x + k·x³))))`` with every op
    rounded in x's dtype and tanh taken in fp32 and rounded once (bit for
    bit in bf16; ``F.gelu(approximate="tanh")`` differs on 42.7 % of
    ``tests/test_torch_encdec.py``'s bf16 inputs).  The gradient is JAX's
    transpose of that expression, op by op: ``(g·cdf + s̄) +
    (s̄·k)·(3·x²)`` with ``s̄ = c·(t̄ + t̄·th)`` and ``t̄ =
    ((g·x)·0.5)·(1 − th)``.  Returns ``(y, th)``; th takes no gradient."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        c, k = _gelu_constants(x.dtype)
        a = c * (x + k * (x * x * x))
        th = torch.tanh(a.to(torch.float32)).to(x.dtype)
        return x * (0.5 * (1.0 + th)), th

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output[1])
        ctx.save_for_backward(inputs[0], output[1])

    @staticmethod
    def backward(ctx, g, _gth):
        x, th = ctx.saved_tensors
        c, k = _gelu_constants(x.dtype)
        t = ((g * x) * 0.5) * (1.0 - th)
        s = (t + t * th) * c
        return (g * (0.5 * (1.0 + th)) + s) + (s * k) * (3.0 * (x * x))


def gelu(x: torch.Tensor) -> torch.Tensor:
    return _Gelu.apply(x)[0]


# ---------------------------------------------------------------- dense

def init_dense(gen: torch.Generator, d_in: int, d_out: int,
               scale: float | None = None, stack: tuple = ()) -> Params:
    """``{"w": (d_in, d_out)}`` ~ N(0, 1/d_in); ``stack`` prepends layer
    axes (a segment's stacked layers)."""
    scale = scale if scale is not None else 1.0 / d_in ** 0.5
    return {"w": init_normal(gen, (*stack, d_in, d_out), scale)}


def dense(p: Params, x: torch.Tensor,
          compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return x.to(compute_dtype) @ p["w"].to(compute_dtype)


# ---------------------------------------------------------------- norms

def init_rmsnorm(d: int, stack: tuple = (),
                 device: torch.device | str = "cpu") -> Params:
    return {"scale": torch.ones((*stack, d), device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p["scale"]
    return y.to(x.dtype)


def init_layernorm(d: int, stack: tuple = (),
                   device: torch.device | str = "cpu") -> Params:
    return {"scale": torch.ones((*stack, d), device=device),
            "bias": torch.zeros((*stack, d), device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Statistics in fp32, the result in x's dtype, as the reference's."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y.to(x.dtype)


# ---------------------------------------------------------------- embedding

def init_embedding(gen: torch.Generator, vocab: int, d: int) -> Params:
    return {"table": init_normal(gen, (vocab, d), 0.02)}


def embed(p: Params, tokens: torch.Tensor,
          compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    # Gather, then cast: the same values as the reference's cast-then-gather
    # without a bf16 copy of the whole table.
    return p["table"][tokens].to(compute_dtype)


@functools.lru_cache(maxsize=None)
def embed_scale(d_model: int, compute_dtype: torch.dtype) -> float:
    """The scale of gemma's embeddings as the reference computes it,
    ``jnp.asarray(d_model, cd) ** 0.5``: a pow in the compute dtype, so in
    bf16 50.5 at d_model 2560 (√2560 = 50.596… rounded to bf16) and
    11.3125 at 128.  Returned as a Python float holding that value
    exactly: a tensor in ``compute_dtype`` times it rounds as the
    reference's product of two ``compute_dtype`` operands."""
    return float(torch.tensor(float(d_model), dtype=compute_dtype) ** 0.5)


def unembed_logits(p: Params, x: torch.Tensor,
                   compute_dtype: torch.dtype = torch.bfloat16
                   ) -> torch.Tensor:
    """Tied-embedding readout: x @ tableᵀ."""
    return x.to(compute_dtype) @ p["table"].to(compute_dtype).T


# ---------------------------------------------------------------- RoPE

@functools.lru_cache(maxsize=None)
def _rope_inv_freqs(head_dim: int, theta: float,
                    device: torch.device) -> torch.Tensor:
    """``θ^(−i/half)``, i < half, fp32, in the bits of the reference's
    ``_rope_table`` on the CPU: XLA turns the division by ``half`` into a
    product with its float32 reciprocal, and its pow is glibc's ``powf``
    (:func:`~repro_torch.core.threefry.xla_powf_t`).  ``torch.pow`` and a
    true division differ from it by an ulp at some i (pixtral's θ = 1e9 at
    D = 160, qwen3's 1e6 at 128), which position 32,767 turns into 5e-4 of
    a cos.  Made once per (head_dim, θ, device) on the CPU and copied
    over, so a CUDA graph captured after the first call reads the cached
    tensor and copies nothing."""
    from repro_torch.core.threefry import xla_powf_t
    half = head_dim // 2
    with torch.inference_mode(False), torch.no_grad():
        f32 = torch.float32
        recip = torch.tensor(1.0, dtype=f32) / torch.tensor(float(half),
                                                            dtype=f32)
        exps = -torch.arange(0, half, dtype=f32) * recip
        return xla_powf_t(float(theta), exps).to(device)


def rope_freqs(head_dim: int, theta: float, positions: torch.Tensor):
    """cos / sin tables (..., S, head_dim/2) of the reference's
    ``_rope_table``: ``freqs = θ^(−i/half)`` in fp32 (its bits:
    :func:`_rope_inv_freqs`)."""
    freqs = _rope_inv_freqs(head_dim, float(theta), positions.device)
    ang = positions.to(torch.float32)[..., None] * freqs    # (..., S, half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, Dh); cos/sin: (..., S, Dh/2) broadcast over heads.
    Half-split rotation, as the reference."""
    xf = x.to(torch.float32)
    x1, x2 = torch.chunk(xf, 2, dim=-1)
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _sinusoid_table(seq: int, d: int, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False), torch.no_grad():
        pos = np.arange(seq)[:, None]
        dim = np.arange(d // 2)[None, :]
        ang = pos / np.power(10000.0, 2 * dim / d)
        out = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
        return torch.from_numpy(out.astype(np.float32)).to(device)


def sinusoidal_positions(seq: int, d: int,
                         device: torch.device | str = "cpu") -> torch.Tensor:
    """(seq, d) fp32: sin then cos of ``pos / 10000^(2i/d)``, i < d/2,
    taken in float64 with numpy and rounded once, as the reference's.
    Made once per (seq, d, device) and shared: callers do not write to
    it."""
    return _sinusoid_table(seq, d, torch.device(device))


# ---------------------------------------------------------------- SwiGLU

def init_swiglu(gen: torch.Generator, d: int, d_ff: int,
                stack: tuple = ()) -> Params:
    return {"w_gate": init_dense(gen, d, d_ff, stack=stack),
            "w_up": init_dense(gen, d, d_ff, stack=stack),
            "w_down": init_dense(gen, d_ff, d, stack=stack)}


def swiglu(p: Params, x: torch.Tensor,
           compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    g = dense(p["w_gate"], x, compute_dtype)
    u = dense(p["w_up"], x, compute_dtype)
    return dense(p["w_down"], silu(g) * u, compute_dtype)


# ---------------------------------------------------------------- loss

def _ce_chunk(h: torch.Tensor, w: torch.Tensor, y: torch.Tensor,
              msk: torch.Tensor) -> torch.Tensor:
    """One chunk's masked CE sum: (B, c, D) hidden against the (D, V)
    readout, fp32 logits."""
    logits = (h.to(w.dtype) @ w).to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y[..., None])[..., 0]
    return torch.sum((logz - gold) * msk)


def chunked_cross_entropy(emb_or_head: Params, hidden: torch.Tensor,
                          labels: torch.Tensor, *, tie: bool,
                          chunk: int = 512,
                          compute_dtype: torch.dtype = torch.bfloat16,
                          mask: torch.Tensor | None = None,
                          remat: bool = True) -> torch.Tensor:
    """Mean next-token cross-entropy without materializing (B, S, V) logits.

    ``hidden``: (B, S, D); ``labels``: (B, S) int.  The loop runs over
    sequence chunks with the batch intact, as the reference's default; one
    chunk's (B, chunk, V) fp32 logits is the largest live tensor.  With
    ``remat`` (the reference's, which checkpoints every chunk) each chunk
    is a :func:`~repro_torch.models.remat.checkpoint`, so the backward
    recomputes its logits instead of keeping all of them."""
    b, s, _ = hidden.shape
    m = (torch.ones((b, s), dtype=torch.float32, device=hidden.device)
         if mask is None else mask.to(torch.float32))
    if tie:
        w = emb_or_head["table"].to(compute_dtype).T          # (D, V)
    else:
        w = emb_or_head["w"].to(compute_dtype)                # (D, V)
    chunk = min(chunk, s)
    loss_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for s0 in range(0, s, chunk):
        args = (hidden[:, s0:s0 + chunk], w,
                labels[:, s0:s0 + chunk].long(), m[:, s0:s0 + chunk])
        loss_sum = loss_sum + (checkpoint(_ce_chunk, *args) if remat
                               else _ce_chunk(*args))
        count = count + torch.sum(args[3])
    return loss_sum / torch.clamp(count, min=1.0)
