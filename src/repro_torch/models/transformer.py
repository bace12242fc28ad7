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

Layer kinds ported: ``attn`` (full-causal GQA attention + MLP), ``swa``
(sliding-window GQA attention + MLP; its decode cache a ring), ``mamba1``,
``mamba2`` and ``shared`` (the hybrid's one attention + MLP block,
``params["shared_block"]``, reused at every occurrence).  The MLP of an
``attn`` or ``swa`` layer is the MoE (:mod:`repro_torch.models.moe`) when
the config has one, else SwiGLU; the MoE's load-balance loss is summed over
the layers and returned beside the hidden states.  The local/global
pattern (gemma3: bodies of ``swa`` layers and one ``attn``) is a plan of
these kinds; gemma's embeddings are scaled by √d_model rounded as the
reference rounds it (:func:`~repro_torch.models.layers.embed_scale`); the
vision family (pixtral) takes its patch embeddings ahead of the text, the
loss over the text alone.  The audio family is an encoder–decoder, not this
stack: :mod:`repro_torch.models.encdec`, which
:func:`repro_torch.models.zoo.build_model` routes it to.
"""
from __future__ import annotations

from typing import Any

import torch

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.attention import (AttnSpec, attn_decode,
                                          attn_forward, init_attention,
                                          init_kv_cache)
from repro_torch.models.remat import checkpoint
from repro_torch.tree import (tree_flatten, tree_map, tree_unflatten,
                              tree_unstack)

Params = Any

__all__ = ["Segment", "build_plan", "specs_for", "init_lm", "forward_hidden",
           "lm_loss", "init_cache", "decode_step"]

Segment = tuple[tuple[str, ...], int]


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
    """Attention / MoE / SSM specs of a ModelConfig: ``(attn, swa, moe, m1,
    m2)``; ``swa`` is ``attn`` with the window ``cfg.sliding_window or
    4096``, ``moe`` None without an MoE config."""
    cd = L.torch_dtype(cfg.compute_dtype)
    attn = AttnSpec(
        d_model=cfg.d_model, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
        qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta,
        use_rope=cfg.family != "audio", causal=True, window=None,
        norm_eps=cfg.norm_eps, compute_dtype=cd)
    swa = dataclasses.replace(attn, window=cfg.sliding_window or 4096)
    moe = None
    if cfg.moe is not None:
        moe = moe_lib.MoESpec(
            d_model=cfg.d_model, num_experts=cfg.moe.num_experts,
            top_k=cfg.moe.top_k, d_ff_expert=cfg.moe.d_ff_expert,
            capacity_factor=cfg.moe.capacity_factor,
            router_aux_coef=cfg.moe.router_aux_coef,
            num_shared_experts=cfg.moe.num_shared_experts,
            dropless=cfg.moe.dropless, compute_dtype=cd)
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
    return attn, swa, moe, m1, m2


# ------------------------------------------------------------------ init

def _init_layer(gen: torch.Generator, kind: str, cfg: ModelConfig,
                stack: tuple = ()) -> Params:
    attn, swa, moe, m1, m2 = specs_for(cfg)
    dev = gen.device
    if kind in ("attn", "swa", "shared"):
        p = {"ln1": L.init_rmsnorm(cfg.d_model, stack, dev),
             "attn": init_attention(gen, swa if kind == "swa" else attn,
                                    stack),
             "ln2": L.init_rmsnorm(cfg.d_model, stack, dev)}
        if moe is not None and kind != "shared":
            p["moe"] = moe_lib.init_moe(gen, moe, stack)
        else:
            p["mlp"] = L.init_swiglu(gen, cfg.d_model,
                                     cfg.d_ff or 4 * cfg.d_model, stack)
        return p
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
                 positions: torch.Tensor | None
                 ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One layer: ``(x, aux)``, aux the MoE's load-balance loss or None."""
    attn, swa, moe, m1, m2 = specs_for(cfg)
    if kind in ("attn", "swa", "shared"):
        spec = swa if kind == "swa" else attn
        x = x + attn_forward(p["attn"], spec,
                             L.rmsnorm(p["ln1"], x, cfg.norm_eps), positions)
        h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
        if "moe" in p:
            y, aux = moe_lib.moe_forward(p["moe"], moe, h)
            return x + y, aux
        return x + L.swiglu(p["mlp"], h, spec.compute_dtype), None
    if kind == "mamba1":
        return x + ssm_lib.mamba1_forward(
            p["mamba"], m1, L.rmsnorm(p["ln"], x, cfg.norm_eps)), None
    if kind == "mamba2":
        return x + ssm_lib.mamba2_forward(
            p["mamba"], m2, L.rmsnorm(p["ln"], x, cfg.norm_eps)), None
    raise ValueError(kind)


def _layer(stacked: Params, i: int) -> Params:
    """Layer ``i`` of a segment's stacked params (views, no copies)."""
    if isinstance(stacked, dict):
        return {k: _layer(v, i) for k, v in stacked.items()}
    return stacked[i]


def _body(cfg: ModelConfig, kinds: tuple, layer: Params, shared: Params,
          x: torch.Tensor, positions: torch.Tensor | None,
          aux: torch.Tensor | None = None):
    """One repeat of a segment's kinds: x, or ``(x, aux)`` when ``aux`` (the
    running MoE loss, carried as the reference's scan carries it) is
    given."""
    for pi, kind in enumerate(kinds):
        p = shared if kind == "shared" else layer[f"{pi}_{kind}"]
        x, a = _apply_layer(p, kind, cfg, x, positions)
        if a is not None:
            aux = aux + a
    return x if aux is None else (x, aux)


def _remat_body(cfg: ModelConfig, kinds: tuple, layer: Params,
                shared: Params, x: torch.Tensor,
                positions: torch.Tensor | None,
                aux: torch.Tensor | None = None):
    """:func:`_body` as one checkpoint: its inputs are x, the positions, the
    running aux and the body's params, nothing captured."""
    leaves, treedef = tree_flatten((layer, shared))
    extra = tuple(a for a in (positions, aux) if a is not None)
    has_pos, has_aux = positions is not None, aux is not None

    def fn(x, *rest):
        pos = rest[0] if has_pos else None
        a = rest[has_pos] if has_aux else None
        layer_, shared_ = tree_unflatten(treedef, list(rest[len(extra):]))
        return _body(cfg, kinds, layer_, shared_, x, pos, a)

    return checkpoint(fn, x, *extra, *leaves)


def forward_hidden(params: Params, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor | None = None, *,
                   remat: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Embedded inputs (B,S,D) -> final hidden (B,S,D), aux loss (the MoE
    layers' load-balance losses summed; 0 without MoE).  ``remat``
    checkpoints each layer body: the backward recomputes its activations
    (under ``torch.func`` transforms and ``vmap`` too)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    moe = cfg.moe is not None
    for seg_p, (kinds, count) in zip(params["segments"], build_plan(cfg)):
        shared = params["shared_block"] if "shared" in kinds else {}
        body = _remat_body if remat else _body
        for layer in tree_unstack(seg_p):
            if moe:
                x, aux = body(cfg, kinds, layer, shared, x, positions, aux)
            else:
                x = body(cfg, kinds, layer, shared, x, positions)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x, aux


def _embed_inputs(params: Params, cfg: ModelConfig,
                  batch: dict) -> torch.Tensor:
    """The token embeddings in the compute dtype; a vision config's
    ``patch_embeddings`` (B, P, D), when the batch has them, cast and put
    ahead of them; then the whole sequence scaled where the config scales
    its embeddings."""
    cd = L.torch_dtype(cfg.compute_dtype)
    x = L.embed(params["embed"], batch["tokens"], cd)
    if cfg.frontend == "vision" and "patch_embeddings" in batch:
        x = torch.cat([batch["patch_embeddings"].to(cd), x], dim=1)
    if cfg.scale_embeddings:
        x = x * L.embed_scale(cfg.d_model, cd)
    return x


def lm_loss(params: Params, cfg: ModelConfig, batch: dict, *,
            remat: bool = True) -> torch.Tensor:
    """Next-token CE loss.  batch: tokens (B,S), labels (B,S) [, mask,
    patch_embeddings (B,P,D)]; positions run over the patches and the text,
    the loss over the text alone."""
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
    ``compute_dtype`` (a ``shared`` block one per occurrence); an ``swa``
    layer a ring of ``min(ceil((window + 1) / 256)·256, max_seq)``
    positions (it only reads the last ``window``); a Mamba layer its fp32
    conv history and state."""
    attn, swa, _, m1, m2 = specs_for(cfg)
    segs = []
    for kinds, count in build_plan(cfg):
        seg: Params = {}
        for pi, kind in enumerate(kinds):
            if kind in ("attn", "shared"):
                one = init_kv_cache(attn, count * batch, max_seq,
                                    device=device)
            elif kind == "swa":
                ring = min(-(-(swa.window + 1) // 256) * 256, max_seq)
                one = init_kv_cache(swa, count * batch, ring, device=device)
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
    or state into its slice of the stacked leaves; an ``swa`` layer writes
    its ring at ``pos mod length``.  An MoE layer's aux loss is dropped."""
    attn, swa, moe, m1, m2 = specs_for(cfg)
    cd = L.torch_dtype(cfg.compute_dtype)
    x = L.embed(params["embed"], tokens, cd)
    if cfg.scale_embeddings:
        x = x * L.embed_scale(cfg.d_model, cd)
    eps = cfg.norm_eps
    for seg_p, seg_c, (kinds, count) in zip(params["segments"],
                                            cache["segments"],
                                            build_plan(cfg)):
        for i in range(count):
            for pi, kind in enumerate(kinds):
                name = f"{pi}_{kind}"
                c = _layer(seg_c[name], i)
                if kind in ("attn", "swa", "shared"):
                    p = (params["shared_block"] if kind == "shared"
                         else _layer(seg_p[name], i))
                    y, _ = attn_decode(p["attn"], swa if kind == "swa"
                                       else attn, L.rmsnorm(p["ln1"], x, eps),
                                       c, pos, ring=kind == "swa")
                    x = x + y
                    h = L.rmsnorm(p["ln2"], x, eps)
                    x = x + (moe_lib.moe_forward(p["moe"], moe, h)[0]
                             if "moe" in p else L.swiglu(p["mlp"], h, cd))
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
