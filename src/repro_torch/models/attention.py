"""Attention of the LM zoo: GQA/MHA with RoPE and qk-norm, full-context
(prefill) forward, self- and cross-attention.

Counterpart of ``repro.models.attention``.  The reference computes the
self-attention inline in XLA (``chunked_attention``, a two-level chunked
online softmax) and names the Pallas ``flash_attention`` kernel as its TPU
form; here self- and cross-attention call
:func:`repro_torch.kernels.ops.flash_attention`, which is the hand-written
Hopper kernel on the card and its plain version on the CPU.  q is projected
as (B, S, KH, G, Dh) with head ``h = kh·G + g``; the kernel takes k/v
already repeated to H heads, so they are repeated over G in that order.

Single-token decode (:func:`attn_decode`) attends one query against the
whole masked cache, as the reference's einsum does, with no kernel: the
products are cuBLAS batched GEMMs over each row's cache, read in place.
Unlike the reference's functional update, the new K/V are written into the
cache in place.

Cross-attention (the audio family's decoder, :mod:`repro_torch.models.encdec`)
takes q from x and k/v from the encoder's states, with no rope, under the
spec's mask (``causal=False`` for the encoder's spec): :func:`attn_forward`
with ``context``.  Its decode projects the encoder's states once
(:func:`precompute_cross_kv`) and attends one query against that static
cache with no mask (:func:`cross_attn_decode`), per-row GEMMs as above.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers as L

Params = Any

__all__ = ["AttnSpec", "init_attention", "attn_forward", "init_kv_cache",
           "attn_decode", "precompute_cross_kv", "cross_attn_decode",
           "NEG_INF"]

NEG_INF = -1e30


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
    """Self-attention over the whole context (``context`` None) or
    cross-attention to ``context`` (B, Sc, D): x (B, S, D) → (B, S, D)."""
    b, s, _ = x.shape
    if context is None:
        q, k, v = _project_qkv(p, spec, x, positions)
    else:
        q = _project_q(p, spec, x)
        k, v = _project_kv(p, spec, context)
    g = spec.q_groups
    out = ops.flash_attention(
        q.reshape(b, s, spec.num_heads, spec.head_dim),
        k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2),
        causal=spec.causal, window=spec.window)
    out = out.to(spec.compute_dtype).reshape(b, s,
                                             spec.num_heads * spec.head_dim)
    return L.dense(p["wo"], out, spec.compute_dtype)


def _project_q(p: Params, spec: AttnSpec, x: torch.Tensor) -> torch.Tensor:
    """Cross-attention's q (B, S, KH, G, Dh): qk-norm where the spec has
    it, no rope."""
    b, s, _ = x.shape
    q = L.dense(p["wq"], x, spec.compute_dtype).reshape(
        b, s, spec.num_heads, spec.head_dim)
    if spec.qk_norm:
        q = L.rmsnorm(p["q_norm"], q, spec.norm_eps)
    return q.reshape(b, s, spec.num_kv_heads, spec.q_groups, spec.head_dim)


def _project_kv(p: Params, spec: AttnSpec, context: torch.Tensor):
    """Cross-attention's k, v (B, Sc, KH, Dh) from the context."""
    b, sc, _ = context.shape
    cd = spec.compute_dtype
    k = L.dense(p["wk"], context, cd).reshape(b, sc, spec.num_kv_heads,
                                              spec.head_dim)
    v = L.dense(p["wv"], context, cd).reshape(b, sc, spec.num_kv_heads,
                                              spec.head_dim)
    if spec.qk_norm:
        k = L.rmsnorm(p["k_norm"], k, spec.norm_eps)
    return k, v


# ---------------------------------------------------------------- decode

def init_kv_cache(spec: AttnSpec, batch: int, max_seq: int, dtype=None,
                  device: torch.device | str = "cpu") -> Params:
    """``{"k", "v"}``: zeros (B, max_seq, KH, Dh) in ``compute_dtype``."""
    dtype = spec.compute_dtype if dtype is None else dtype
    shape = (batch, max_seq, spec.num_kv_heads, spec.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_decode(p: Params, spec: AttnSpec, x: torch.Tensor, cache: Params,
                pos, ring: bool = False) -> tuple[torch.Tensor, Params]:
    """One-token decode. x: (B, 1, D); pos: an int or 0-d tensor (the
    current length) or a per-row (B,) vector, as the serving engine's
    slots decode at their own positions.

    Linear mode writes the new K/V at ``pos`` and attends to
    ``cache[:pos+1]`` through the mask.  Ring mode treats the cache as a
    ring of length L: slot ``pos % L`` is overwritten and slot ``ri`` holds
    absolute position ``pos − ((pos − ri) mod L)``.  ``spec.window`` masks
    keys at or before ``pos − window`` in both modes.

    The write is in place: ``cache["k"]`` / ``cache["v"]`` are updated and
    returned (the reference returns new arrays), so a caller that needs the
    old cache clones it first.  The scores and the weighted sum read each
    row's cache in place, (KH, S, Dh) batched over the KV heads.
    """
    b = x.shape[0]
    cd = spec.compute_dtype
    dev = x.device
    pos_vec = torch.as_tensor(pos, dtype=torch.int64, device=dev
                              ).reshape(-1).expand(b)
    q, k_new, v_new = _project_qkv(p, spec, x, pos_vec[:, None])
    s_max = cache["k"].shape[1]
    # A linear write past the cache lands on its last slot, as the
    # reference's dynamic_update_slice clamps its start.
    write_pos = (torch.remainder(pos_vec, s_max) if ring
                 else torch.clamp(pos_vec, 0, s_max - 1))
    rows = torch.arange(b, device=dev)
    cache["k"][rows, write_pos] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][rows, write_pos] = v_new[:, 0].to(cache["v"].dtype)
    kpos = torch.arange(s_max, device=dev)
    pv = pos_vec[:, None]
    if ring:
        abs_pos = pv - torch.remainder(pv - kpos[None, :], s_max)  # (B, S)
        mask = abs_pos >= 0
        if spec.window is not None:
            mask &= abs_pos > pv - spec.window
    else:
        mask = kpos[None, :] <= pv
        if spec.window is not None:
            mask &= kpos[None, :] > pv - spec.window
    scale = 1.0 / (spec.head_dim ** 0.5)
    q = q[:, 0]                                               # (B,KH,G,Dh)
    # Per row: (KH, G, Dh) @ (KH, Dh, S) and (KH, G, S) @ (KH, S, Dh), the
    # cache's (S, KH, Dh) rows read as strided batches with no copy.
    scores = torch.stack([
        torch.matmul(q[i], cache["k"][i].to(cd).permute(1, 2, 0))
        for i in range(b)]).to(torch.float32) * scale         # (B,KH,G,S)
    scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(cd)
    out = torch.stack([torch.matmul(probs[i], cache["v"][i].to(cd)
                                    .transpose(0, 1))
                       for i in range(b)])                    # (B,KH,G,Dh)
    out = out.reshape(b, 1, spec.num_heads * spec.head_dim)
    return L.dense(p["wo"], out, cd), cache


def precompute_cross_kv(p: Params, spec: AttnSpec,
                        context: torch.Tensor) -> Params:
    """The static cross-attention cache ``{"k", "v"}`` (B, Sc, KH, Dh) in
    ``compute_dtype``: the context projected once, as the reference's
    (which applies no qk-norm here)."""
    k, v = _project_kv(p, dataclasses.replace(spec, qk_norm=False), context)
    return {"k": k, "v": v}


def cross_attn_decode(p: Params, spec: AttnSpec, x: torch.Tensor,
                      context_cache: Params) -> torch.Tensor:
    """One-token cross-attention of x (B, 1, D) against the static cache
    (:func:`precompute_cross_kv`), every key visible: fp32 scores, the
    softmax's weights in ``compute_dtype``, each row's cache read in place
    as :func:`attn_decode` reads it."""
    b = x.shape[0]
    cd = spec.compute_dtype
    kc = context_cache["k"].to(cd)
    vc = context_cache["v"].to(cd)
    q = L.dense(p["wq"], x, cd).reshape(b, spec.num_kv_heads, spec.q_groups,
                                        spec.head_dim)
    scale = 1.0 / (spec.head_dim ** 0.5)
    scores = torch.stack([torch.matmul(q[i], kc[i].permute(1, 2, 0))
                          for i in range(b)]).to(torch.float32) * scale
    probs = torch.softmax(scores, dim=-1).to(cd)              # (B,KH,G,Sc)
    out = torch.stack([torch.matmul(probs[i], vc[i].transpose(0, 1))
                       for i in range(b)])                    # (B,KH,G,Dh)
    return L.dense(p["wo"], out.reshape(b, 1, -1), cd)
