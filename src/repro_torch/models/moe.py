"""Mixture-of-Experts layer: top-k router, capacity-bounded gather dispatch,
batched SwiGLU experts and a prob-weighted combine.

Counterpart of ``repro.models.moe``.  Tokens are gathered into per-expert
buffers of static capacity ``C`` (``MoESpec.capacity``) through a stable
sort of the routing assignment; the experts run as three batched products
over the expert axis (``torch.bmm`` in ``compute_dtype``); each routed
pair's output comes back weighted by its router probability.  Overflowing
pairs are dropped (Switch semantics) unless ``dropless``, where every
buffer holds all T tokens.

Every shape is static and nothing reads a value back to the host (no
``bincount``, ``nonzero``, boolean indexing or ``.item()``), so the layer
runs inside the serving engine's captured CUDA graph.  The combine is
deterministic: the reference scatter-adds the pairs in expert order
(``.at[sorted_tok].add``); here each token's k pair outputs are gathered
back through the inverse of the sort and summed left to right from zero in
ascending expert order, the same additions in the same order, with no
float atomics.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.kernels.ref import _top_k
from repro_torch.models import layers as L

Params = Any

__all__ = ["MoESpec", "init_moe", "moe_forward"]


@dataclasses.dataclass(frozen=True)
class MoESpec:
    d_model: int
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    num_shared_experts: int = 0
    compute_dtype: torch.dtype = torch.bfloat16
    # Buffers sized to the worst case (every token on one expert): no pair
    # is ever dropped, so a token routes alike at prefill and at decode.
    # The price is E·T dispatch rows against T·k·cf (E/k times the active
    # expert FLOPs when every buffer is full width).
    dropless: bool = False

    def capacity(self, num_tokens: int) -> int:
        if self.dropless:
            c = num_tokens
        else:
            c = int(num_tokens * self.top_k * self.capacity_factor
                    / self.num_experts)
        return max(8, -(-c // 8) * 8)


def init_moe(gen: torch.Generator, spec: MoESpec, stack: tuple = ()
             ) -> Params:
    """The router, the stacked experts' SwiGLU weights (E, D, F) / (E, F,
    D) and, with shared experts, one SwiGLU of width F·n_shared; ``stack``
    prepends layer axes."""
    e, d, f = spec.num_experts, spec.d_model, spec.d_ff_expert
    p = {"router": L.init_dense(gen, d, e, scale=0.02, stack=stack),
         "w_gate": L.init_normal(gen, (*stack, e, d, f), 1.0 / d ** 0.5),
         "w_up": L.init_normal(gen, (*stack, e, d, f), 1.0 / d ** 0.5),
         "w_down": L.init_normal(gen, (*stack, e, f, d), 1.0 / f ** 0.5)}
    if spec.num_shared_experts:
        p["shared"] = L.init_swiglu(gen, d, f * spec.num_shared_experts,
                                    stack)
    return p


def route(p: Params, spec: MoESpec, xt: torch.Tensor):
    """The fp32 router on (T, D) tokens: ``(top_p, top_e, aux)``, the
    renormalised top-k probabilities and experts (T, k) under
    ``lax.top_k``'s tie rule, and the Switch load-balance loss."""
    e = spec.num_experts
    probs = torch.softmax(L.dense(p["router"], xt, torch.float32), dim=-1)
    top_p, top_e = _top_k(probs, spec.top_k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(0)
    hits = top_e[..., None] == torch.arange(e, device=xt.device)
    ce = hits.to(torch.float32).sum(1).mean(0)
    aux = spec.router_aux_coef * e * torch.sum(me * ce)
    return top_p, top_e, aux


def dispatch(top_e: torch.Tensor, num_experts: int, cap: int):
    """Capacity slots of the (T, k) routed pairs, in the reference's order:
    the pairs stably sorted by expert, each placed at its rank within its
    expert.  Returns ``(slot, keep)`` (T, k) in the pairs' own order:
    ``slot = expert·cap + rank`` where ``keep`` (rank < cap), else the
    trash slot ``E·cap``."""
    t, k = top_e.shape
    flat_e = top_e.reshape(t * k)
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    # Each expert's first index in the sorted pairs: the exclusive scan of
    # the per-expert counts (a one-hot sum: bincount's length is the data's).
    counts = (flat_e[:, None] == torch.arange(num_experts,
                                              device=top_e.device)).sum(0)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(t * k, device=top_e.device) - starts[sorted_e]
    keep = rank < cap
    slot = torch.where(keep, sorted_e * cap + rank, num_experts * cap)
    # Back to the pairs' own order (the inverse of the sort).
    slot = torch.empty_like(slot).scatter(0, order, slot)
    keep = torch.empty_like(keep).scatter(0, order, keep)
    return slot.reshape(t, k), keep.reshape(t, k)


def moe_forward(p: Params, spec: MoESpec, x: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D), aux loss, a 0-d fp32 tensor)."""
    b, s, d = x.shape
    cd = spec.compute_dtype
    t = b * s
    e, k = spec.num_experts, spec.top_k
    cap = spec.capacity(t)
    xt = x.reshape(t, d)
    top_p, top_e, aux = route(p, spec, xt)
    slot, keep = dispatch(top_e, e, cap)

    # Gather the tokens into (E, cap, D) buffers; empty slots stay zero.
    # Kept slots are distinct, and every dropped pair writes the trash slot.
    dev = x.device
    tok = torch.arange(t, device=dev)[:, None].expand(t, k).reshape(-1)
    buf_tok = torch.zeros(e * cap + 1, dtype=torch.long, device=dev
                          ).scatter(0, slot.reshape(-1), tok)
    buf_valid = torch.zeros(e * cap + 1, dtype=torch.bool, device=dev
                            ).scatter(0, slot.reshape(-1), keep.reshape(-1))
    gathered = torch.where(buf_valid[:e * cap, None],
                           xt[buf_tok[:e * cap]], 0.0)
    ex_in = gathered.reshape(e, cap, d).to(cd)

    # The experts: batched SwiGLU over the expert axis.
    g = torch.bmm(ex_in, p["w_gate"].to(cd))
    u = torch.bmm(ex_in, p["w_up"].to(cd))
    ex_out = torch.bmm(L.silu(g) * u, p["w_down"].to(cd)).reshape(e * cap, d)

    # Combine: each token's pairs in ascending expert order (the order of
    # the reference's scatter-add), weighted by their probabilities, summed
    # left to right from zero.
    by_expert = torch.sort(top_e, dim=-1).indices
    slot = torch.gather(slot, 1, by_expert)
    keep = torch.gather(keep, 1, by_expert)
    weight = torch.gather(top_p, 1, by_expert)
    pair = ex_out[torch.clamp(slot, max=e * cap - 1)]           # (T, k, D)
    pair = torch.where(keep[..., None], pair, 0.0).to(torch.float32)
    contrib = pair * weight[..., None]
    out = torch.zeros((t, d), dtype=torch.float32, device=dev)
    for j in range(k):
        out = out + contrib[:, j]
    if spec.num_shared_experts:
        out = out + L.swiglu(p["shared"], xt, cd).to(torch.float32)
    return out.reshape(b, s, d).to(x.dtype), aux
