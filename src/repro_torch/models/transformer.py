"""Decoder-only stack of the LM zoo, built as *segments* of stacked layers:
the full-context (prefill) forward and the loss.

Counterpart of ``repro.models.transformer``.  A segment is
``(kinds, count)``: a tuple of layer kinds forming one body, repeated
``count`` times with stacked parameters (leading axis ``count``), in the
reference's params layout.  The reference scans a body with ``lax.scan``;
here a Python loop walks the stacked layers, in the forward and in
single-token decode (:func:`init_cache`, :func:`decode_step`) alike.  With
``remat`` each body is one :func:`~repro_torch.models.remat.checkpoint`
(the reference's ``jax.checkpoint`` of its scan body): the backward
recomputes the body's activations instead of keeping them.

Layer kinds ported: ``attn`` (full-causal GQA attention + SwiGLU),
``mamba1``, ``mamba2`` and ``shared`` (the hybrid's one attention + MLP
block, ``params["shared_block"]``, reused at every occurrence).  The MoE
MLP, ``swa`` (sliding window) and the local/global pattern raise
:class:`NotImplementedError` naming ROADMAP item A13d.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.attention import (AttnSpec, attn_decode,
                                          attn_forward, init_attention,
                                          init_kv_cache)
from repro_torch.models.remat import checkpoint
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

Params = Any

__all__ = ["Segment", "build_plan", "specs_for", "init_lm", "forward_hidden",
           "lm_loss", "check_supported", "init_cache", "decode_step"]

Segment = tuple[tuple[str, ...], int]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the families and layer kinds this slice does not port."""
    what = None
    if cfg.family in ("audio", "vlm") or cfg.frontend is not None:
        what = f"the {cfg.family} family ({cfg.frontend} frontend)"
    elif cfg.moe is not None:
        what = "the MoE family"
    elif cfg.sliding_window or cfg.local_global_ratio:
        what = "sliding-window and local/global attention (swa)"
    if what is not None:
        raise NotImplementedError(
            f"{cfg.name}: {what} is queued as ROADMAP item A13d")


def build_plan(cfg: ModelConfig) -> list[Segment]:
    n = cfg.num_layers
    if cfg.family == "ssm":
        return [(("mamba1",), n)]
    if cfg.family == "hybrid":
        period = cfg.attn_period or 6
        groups, rem = divmod(n, period)
        plan: list[Segment] = []
        if groups:
            plan.append((("mamba2",) * period + ("shared",), groups))
        if rem:
            plan.append((("mamba2",) * rem, 1))
        return plan
    if cfg.local_global_ratio > 0:
        r = cfg.local_global_ratio
        groups, rem = divmod(n, r + 1)
        plan = []
        if groups:
            plan.append((("swa",) * r + ("attn",), groups))
        if rem:
            plan.append((("swa",) * rem, 1))
        return plan
    kind = "swa" if cfg.sliding_window else "attn"
    return [((kind,), n)]


def specs_for(cfg: ModelConfig):
    """Attention and SSM specs of a ModelConfig: ``(attn, m1, m2)`` (the
    reference's windowed ``swa`` spec and MoE spec are A13d)."""
    cd = L.torch_dtype(cfg.compute_dtype)
    attn = AttnSpec(
        d_model=cfg.d_model, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
        qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta,
        use_rope=cfg.family != "audio", causal=True, window=None,
        norm_eps=cfg.norm_eps, compute_dtype=cd)
    m1 = m2 = None
    if cfg.ssm is not None:
        if cfg.ssm.version == 1:
            m1 = ssm_lib.Mamba1Spec(
                d_model=cfg.d_model, d_state=cfg.ssm.d_state,
                d_conv=cfg.ssm.d_conv, expand=cfg.ssm.expand,
                dt_rank=cfg.ssm.dt_rank, compute_dtype=cd)
        else:
            m2 = ssm_lib.Mamba2Spec(
                d_model=cfg.d_model, d_state=cfg.ssm.d_state,
                d_conv=cfg.ssm.d_conv, expand=cfg.ssm.expand,
                head_dim=cfg.ssm.head_dim, chunk=cfg.ssm.chunk,
                compute_dtype=cd)
    return attn, m1, m2


# ------------------------------------------------------------------ init

def _init_layer(gen: torch.Generator, kind: str, cfg: ModelConfig,
                stack: tuple = ()) -> Params:
    attn, m1, m2 = specs_for(cfg)
    dev = gen.device
    if kind in ("attn", "shared"):
        return {"ln1": L.init_rmsnorm(cfg.d_model, stack, dev),
                "attn": init_attention(gen, attn, stack),
                "ln2": L.init_rmsnorm(cfg.d_model, stack, dev),
                "mlp": L.init_swiglu(gen, cfg.d_model,
                                     cfg.d_ff or 4 * cfg.d_model, stack)}
    if kind == "mamba1":
        return {"ln": L.init_rmsnorm(cfg.d_model, stack, dev),
                "mamba": ssm_lib.init_mamba1(gen, m1, stack)}
    if kind == "mamba2":
        return {"ln": L.init_rmsnorm(cfg.d_model, stack, dev),
                "mamba": ssm_lib.init_mamba2(gen, m2, stack)}
    raise ValueError(kind)


def init_lm(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random params in the reference's layout, drawn from ``gen`` on its
    device: ``embed``, ``segments`` (a list of {``"{i}_{kind}"``: stacked
    layer params}), ``shared_block`` (hybrid), ``final_norm`` and
    ``lm_head`` (untied).  The values differ from the reference's
    ``jax.random`` draws; parity tests inject those instead."""
    check_supported(cfg)
    params: Params = {"embed": L.init_embedding(gen, cfg.vocab_size,
                                                cfg.d_model)}
    plan = build_plan(cfg)
    params["segments"] = [
        {f"{pi}_{kind}": _init_layer(gen, kind, cfg, (count,))
         for pi, kind in enumerate(kinds) if kind != "shared"}
        for kinds, count in plan]
    if any("shared" in kinds for kinds, _ in plan):
        params["shared_block"] = _init_layer(gen, "shared", cfg)
    params["final_norm"] = L.init_rmsnorm(cfg.d_model, device=gen.device)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.init_dense(gen, cfg.d_model, cfg.vocab_size,
                                         scale=0.02)
    return params


# ------------------------------------------------------------------ forward

def _apply_layer(p: Params, kind: str, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor | None) -> torch.Tensor:
    attn, m1, m2 = specs_for(cfg)
    if kind in ("attn", "shared"):
        x = x + attn_forward(p["attn"], attn,
                             L.rmsnorm(p["ln1"], x, cfg.norm_eps), positions)
        h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
        return x + L.swiglu(p["mlp"], h, attn.compute_dtype)
    if kind == "mamba1":
        return x + ssm_lib.mamba1_forward(
            p["mamba"], m1, L.rmsnorm(p["ln"], x, cfg.norm_eps))
    if kind == "mamba2":
        return x + ssm_lib.mamba2_forward(
            p["mamba"], m2, L.rmsnorm(p["ln"], x, cfg.norm_eps))
    raise ValueError(kind)


def _layer(stacked: Params, i: int) -> Params:
    """Layer ``i`` of a segment's stacked params (views, no copies)."""
    if isinstance(stacked, dict):
        return {k: _layer(v, i) for k, v in stacked.items()}
    return stacked[i]


def _unstack(stacked: Params, count: int) -> list[Params]:
    """A segment's stacked params as ``count`` per-layer trees of views
    (one ``unbind`` per leaf, so the gradients stack back in one copy)."""
    leaves, treedef = tree_flatten(stacked)
    cols = [leaf.unbind(0) for leaf in leaves]
    return [tree_unflatten(treedef, [c[i] for c in cols])
            for i in range(count)]


def _body(cfg: ModelConfig, kinds: tuple, layer: Params, shared: Params,
          x: torch.Tensor, positions: torch.Tensor | None) -> torch.Tensor:
    """One repeat of a segment's kinds."""
    for pi, kind in enumerate(kinds):
        p = shared if kind == "shared" else layer[f"{pi}_{kind}"]
        x = _apply_layer(p, kind, cfg, x, positions)
    return x


def _remat_body(cfg: ModelConfig, kinds: tuple, layer: Params,
                shared: Params, x: torch.Tensor,
                positions: torch.Tensor | None) -> torch.Tensor:
    """:func:`_body` as one checkpoint: its inputs are x, the positions and
    the body's params, nothing captured."""
    leaves, treedef = tree_flatten((layer, shared))
    has_pos = positions is not None

    def fn(x, *rest):
        pos = rest[0] if has_pos else None
        layer_, shared_ = tree_unflatten(treedef, list(rest[has_pos:]))
        return _body(cfg, kinds, layer_, shared_, x, pos)

    return checkpoint(fn, x, *((positions,) if has_pos else ()), *leaves)


def forward_hidden(params: Params, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor | None = None, *,
                   remat: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Embedded inputs (B,S,D) -> final hidden (B,S,D), aux loss (0: no
    MoE).  ``remat`` checkpoints each layer body: the backward recomputes
    its activations (under ``torch.func`` transforms and ``vmap`` too)."""
    check_supported(cfg)
    for seg_p, (kinds, count) in zip(params["segments"], build_plan(cfg)):
        shared = params["shared_block"] if "shared" in kinds else {}
        body = _remat_body if remat else _body
        for layer in _unstack(seg_p, count):
            x = body(cfg, kinds, layer, shared, x, positions)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def _embed_inputs(params: Params, cfg: ModelConfig,
                  batch: dict) -> torch.Tensor:
    # No ported family scales its embeddings (gemma3's scale is A13d).
    return L.embed(params["embed"], batch["tokens"],
                   L.torch_dtype(cfg.compute_dtype))


def lm_loss(params: Params, cfg: ModelConfig, batch: dict, *,
            remat: bool = True) -> torch.Tensor:
    """Next-token CE loss.  batch: tokens (B,S), labels (B,S) [, mask]."""
    x = _embed_inputs(params, cfg, batch)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    hidden, aux = forward_hidden(params, cfg, x, positions, remat=remat)
    n_text = batch["tokens"].shape[1]
    hidden = hidden[:, -n_text:]
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    # The readout runs in bf16 whatever cfg.compute_dtype is, as in the
    # reference (its lm_loss leaves chunked_cross_entropy at the default).
    ce = L.chunked_cross_entropy(head, hidden, batch["labels"],
                                 tie=cfg.tie_embeddings,
                                 mask=batch.get("mask"), remat=remat)
    return ce + aux


# ------------------------------------------------------------------ decode

def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device: torch.device | str = "cpu") -> Params:
    """The decode cache in the reference's layout: ``{"segments": [...]}``,
    one dict per segment of ``{"{i}_{kind}": cache}`` with every leaf
    stacked on the segment's leading count axis.  An ``attn`` or
    ``shared`` layer holds a KV cache of ``max_seq`` positions in
    ``compute_dtype`` (a ``shared`` block one per occurrence); a Mamba
    layer its fp32 conv history and state."""
    check_supported(cfg)
    attn, m1, m2 = specs_for(cfg)
    segs = []
    for kinds, count in build_plan(cfg):
        seg: Params = {}
        for pi, kind in enumerate(kinds):
            if kind in ("attn", "shared"):
                one = init_kv_cache(attn, count * batch, max_seq,
                                    device=device)
            elif kind == "mamba1":
                one = ssm_lib.init_mamba1_cache(m1, count * batch, device)
            elif kind == "mamba2":
                one = ssm_lib.init_mamba2_cache(m2, count * batch, device)
            else:
                raise ValueError(kind)
            # Allocated once as count·batch rows, viewed per layer.
            seg[f"{pi}_{kind}"] = tree_map(
                lambda a: a.reshape(count, batch, *a.shape[1:]), one)
        segs.append(seg)
    return {"segments": segs}


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Params, pos) -> tuple[torch.Tensor, Params]:
    """One decode step.  tokens: (B, 1) int; pos: the current length, an
    int, a 0-d tensor or a per-row (B,) vector.

    Returns (logits (B, 1, V) fp32, cache).  The cache is updated in
    place (the reference returns a new one): each layer writes its new K/V
    or state into its slice of the stacked leaves."""
    check_supported(cfg)
    attn, m1, m2 = specs_for(cfg)
    cd = L.torch_dtype(cfg.compute_dtype)
    x = L.embed(params["embed"], tokens, cd)
    eps = cfg.norm_eps
    for seg_p, seg_c, (kinds, count) in zip(params["segments"],
                                            cache["segments"],
                                            build_plan(cfg)):
        for i in range(count):
            for pi, kind in enumerate(kinds):
                name = f"{pi}_{kind}"
                c = _layer(seg_c[name], i)
                if kind in ("attn", "shared"):
                    p = (params["shared_block"] if kind == "shared"
                         else _layer(seg_p[name], i))
                    y, _ = attn_decode(p["attn"], attn,
                                       L.rmsnorm(p["ln1"], x, eps), c, pos)
                    x = x + y
                    x = x + L.swiglu(p["mlp"], L.rmsnorm(p["ln2"], x, eps),
                                     cd)
                else:
                    p = _layer(seg_p[name], i)
                    step = (ssm_lib.mamba1_decode if kind == "mamba1"
                            else ssm_lib.mamba2_decode)
                    y, _ = step(p["mamba"], m1 if kind == "mamba1" else m2,
                                L.rmsnorm(p["ln"], x, eps), c)
                    x = x + y
    x = L.rmsnorm(params["final_norm"], x, eps)
    if cfg.tie_embeddings:
        logits = L.unembed_logits(params["embed"], x, cd)
    else:
        logits = L.dense(params["lm_head"], x, cd)
    return logits.to(torch.float32), cache
