"""Attention of the LM zoo: GQA/MHA with RoPE and qk-norm, full-context
(prefill) forward.

Counterpart of ``repro.models.attention``.  The reference computes the
self-attention inline in XLA (``chunked_attention``, a two-level chunked
online softmax) and names the Pallas ``flash_attention`` kernel as its TPU
form; here the self-attention branch calls
:func:`repro_torch.kernels.ops.flash_attention`, which is the hand-written
Hopper kernel on the card and its plain version on the CPU.  q is projected
as (B, S, KH, G, Dh) with head ``h = kh·G + g``; the kernel takes k/v
already repeated to H heads, so they are repeated over G in that order.

Not ported yet: cross-attention (the audio family) and single-token decode
with a KV cache (``attn_decode``; ROADMAP A13b).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers as L

Params = Any

__all__ = ["AttnSpec", "init_attention", "attn_forward"]


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    use_rope: bool = True
    rope_theta: float = 10000.0
    causal: bool = True
    window: Optional[int] = None        # sliding-window width in tokens
    norm_eps: float = 1e-6
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def q_groups(self) -> int:
        assert self.num_heads % self.num_kv_heads == 0
        return self.num_heads // self.num_kv_heads


def init_attention(gen: torch.Generator, spec: AttnSpec,
                   stack: tuple = ()) -> Params:
    d, hd = spec.d_model, spec.head_dim
    p = {"wq": L.init_dense(gen, d, spec.num_heads * hd, stack=stack),
         "wk": L.init_dense(gen, d, spec.num_kv_heads * hd, stack=stack),
         "wv": L.init_dense(gen, d, spec.num_kv_heads * hd, stack=stack),
         "wo": L.init_dense(gen, spec.num_heads * hd, d, stack=stack)}
    if spec.qk_norm:
        p["q_norm"] = L.init_rmsnorm(hd, stack, gen.device)
        p["k_norm"] = L.init_rmsnorm(hd, stack, gen.device)
    return p


def _project_qkv(p: Params, spec: AttnSpec, x: torch.Tensor,
                 positions: torch.Tensor | None):
    """Returns q (B,S,KH,G,Dh), k (B,S,KH,Dh), v (B,S,KH,Dh)."""
    b, s, _ = x.shape
    cd = spec.compute_dtype
    q = L.dense(p["wq"], x, cd).reshape(b, s, spec.num_heads, spec.head_dim)
    k = L.dense(p["wk"], x, cd).reshape(b, s, spec.num_kv_heads,
                                        spec.head_dim)
    v = L.dense(p["wv"], x, cd).reshape(b, s, spec.num_kv_heads,
                                        spec.head_dim)
    if spec.qk_norm:
        q = L.rmsnorm(p["q_norm"], q, spec.norm_eps)
        k = L.rmsnorm(p["k_norm"], k, spec.norm_eps)
    if spec.use_rope:
        if positions is None:
            positions = torch.arange(s, device=x.device)[None, :]
        cos, sin = L.rope_freqs(spec.head_dim, spec.rope_theta, positions)
        q = L.apply_rope(q, cos, sin)
        k = L.apply_rope(k, cos, sin)
    q = q.reshape(b, s, spec.num_kv_heads, spec.q_groups, spec.head_dim)
    return q, k, v


def attn_forward(p: Params, spec: AttnSpec, x: torch.Tensor,
                 positions: torch.Tensor | None = None,
                 context: torch.Tensor | None = None) -> torch.Tensor:
    """Self-attention over the whole context: x (B, S, D) → (B, S, D)."""
    if context is not None:
        raise NotImplementedError(
            "cross-attention (the audio family) is queued as ROADMAP item "
            "A13d")
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, spec, x, positions)
    g = spec.q_groups
    out = ops.flash_attention(
        q.reshape(b, s, spec.num_heads, spec.head_dim),
        k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2),
        causal=spec.causal, window=spec.window)
    out = out.to(spec.compute_dtype).reshape(b, s,
                                             spec.num_heads * spec.head_dim)
    return L.dense(p["wo"], out, spec.compute_dtype)
