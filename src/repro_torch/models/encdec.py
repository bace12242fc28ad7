"""Whisper-style encoder–decoder of the LM zoo (the audio family).

Counterpart of ``repro.models.encdec``.  The mel-spectrogram and conv
front end is a stub there too: the batch carries precomputed frame
embeddings ``frames`` (B, T, d_model), 1,500 for whisper-base's 30 s
window.  The encoder adds sinusoidal positions and runs pre-LayerNorm
blocks of bidirectional self-attention (``causal=False``) and a tanh-GELU
MLP; the decoder embeds the text, adds sinusoidal positions and runs
causal self-attention, cross-attention to the encoder's states and the
MLP; the readout is tied to the embedding table [arXiv:2212.04356].  Every
attention goes through :func:`repro_torch.kernels.ops.flash_attention`
(:mod:`repro_torch.models.attention`): the encoder's and the
cross-attention non-causal, the decoder's self-attention causal.

Params keep the reference's layout: ``embed``, ``enc_layers`` and
``dec_layers`` (each leaf stacked on a leading layer axis), ``enc_norm``
and ``dec_norm``; the decode cache is ``{"self": {k, v}, "cross": {k,
v}}``, stacked on the decoder's layer axis.  As in the decoder-only stack
(:mod:`repro_torch.models.transformer`) a Python loop walks the stacked
layers, and with ``remat`` each layer is one
:func:`~repro_torch.models.remat.checkpoint` whose inputs are its hidden
states, its params and, in the decoder, the encoder's states: nothing
captured, so the encoder's gradient flows back through every
cross-attention.  Decode writes the self-attention cache in place.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.attention import (AttnSpec, attn_decode, attn_forward,
                                          cross_attn_decode, init_attention,
                                          init_kv_cache, precompute_cross_kv)
from repro_torch.models.remat import checkpoint
from repro_torch.tree import tree_flatten, tree_unflatten, tree_unstack

Params = Any

__all__ = ["enc_spec", "dec_spec", "init_encdec", "encode", "encdec_loss",
           "init_encdec_cache", "encdec_decode_step"]


def _spec(cfg: ModelConfig, causal: bool) -> AttnSpec:
    return AttnSpec(d_model=cfg.d_model, num_heads=cfg.num_heads,
                    num_kv_heads=cfg.num_kv_heads,
                    head_dim=cfg.resolved_head_dim, use_rope=False,
                    causal=causal, norm_eps=cfg.norm_eps,
                    compute_dtype=L.torch_dtype(cfg.compute_dtype))


def enc_spec(cfg: ModelConfig) -> AttnSpec:
    """The encoder's self-attention and the decoder's cross-attention."""
    return _spec(cfg, causal=False)


def dec_spec(cfg: ModelConfig) -> AttnSpec:
    """The decoder's self-attention."""
    return _spec(cfg, causal=True)


def _init_mlp(gen: torch.Generator, d: int, d_ff: int,
              stack: tuple) -> Params:
    return {"w1": L.init_dense(gen, d, d_ff, stack=stack),
            "w2": L.init_dense(gen, d_ff, d, stack=stack)}


def _mlp(p: Params, x: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    return L.dense(p["w2"], L.gelu(L.dense(p["w1"], x, cd)), cd)


def init_encdec(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random params in the reference's layout, drawn from ``gen`` on its
    device (the values differ from the reference's ``jax.random`` draws;
    parity tests inject those)."""
    dev = gen.device
    d = cfg.d_model
    ne = (cfg.encoder_layers or cfg.num_layers,)
    nd = (cfg.num_layers,)
    enc = {"ln1": L.init_layernorm(d, ne, dev),
           "attn": init_attention(gen, enc_spec(cfg), ne),
           "ln2": L.init_layernorm(d, ne, dev),
           "mlp": _init_mlp(gen, d, cfg.d_ff, ne)}
    dec = {"ln1": L.init_layernorm(d, nd, dev),
           "self_attn": init_attention(gen, dec_spec(cfg), nd),
           "ln_x": L.init_layernorm(d, nd, dev),
           "cross_attn": init_attention(gen, enc_spec(cfg), nd),
           "ln2": L.init_layernorm(d, nd, dev),
           "mlp": _init_mlp(gen, d, cfg.d_ff, nd)}
    return {"embed": L.init_embedding(gen, cfg.vocab_size, d),
            "enc_layers": enc, "enc_norm": L.init_layernorm(d, device=dev),
            "dec_layers": dec, "dec_norm": L.init_layernorm(d, device=dev)}


def _enc_layer(cfg: ModelConfig, p: Params, h: torch.Tensor) -> torch.Tensor:
    eps = cfg.norm_eps
    h = h + attn_forward(p["attn"], enc_spec(cfg),
                         L.layernorm(p["ln1"], h, eps))
    return h + _mlp(p["mlp"], L.layernorm(p["ln2"], h, eps),
                    L.torch_dtype(cfg.compute_dtype))


def _dec_layer(cfg: ModelConfig, p: Params, h: torch.Tensor,
               enc_out: torch.Tensor) -> torch.Tensor:
    eps = cfg.norm_eps
    h = h + attn_forward(p["self_attn"], dec_spec(cfg),
                         L.layernorm(p["ln1"], h, eps))
    h = h + attn_forward(p["cross_attn"], enc_spec(cfg),
                         L.layernorm(p["ln_x"], h, eps), context=enc_out)
    return h + _mlp(p["mlp"], L.layernorm(p["ln2"], h, eps),
                    L.torch_dtype(cfg.compute_dtype))


def _run_layers(layer_fn, cfg: ModelConfig, stacked: Params,
                h: torch.Tensor, *extra: torch.Tensor,
                remat: bool) -> torch.Tensor:
    """``h`` through each stacked layer in turn; with ``remat`` each layer
    is one checkpoint over (h, ``extra``, its params)."""
    for p in tree_unstack(stacked):
        if not remat:
            h = layer_fn(cfg, p, h, *extra)
            continue
        leaves, treedef = tree_flatten(p)
        n = len(extra)

        def fn(h, *rest, treedef=treedef, n=n):
            return layer_fn(cfg, tree_unflatten(treedef, list(rest[n:])), h,
                            *rest[:n])

        h = checkpoint(fn, h, *extra, *leaves)
    return h


def encode(params: Params, cfg: ModelConfig, frames: torch.Tensor, *,
           remat: bool = True) -> torch.Tensor:
    """frames (B, T, d_model), the stubbed front end's output → the
    encoder's states (B, T, d_model) in the compute dtype: the frames cast
    to it before the positions are added."""
    cd = L.torch_dtype(cfg.compute_dtype)
    x = frames.to(cd) + L.sinusoidal_positions(
        frames.shape[1], cfg.d_model, frames.device).to(cd)
    x = _run_layers(_enc_layer, cfg, params["enc_layers"], x, remat=remat)
    return L.layernorm(params["enc_norm"], x, cfg.norm_eps)


def _decode_hidden(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   enc_out: torch.Tensor, *,
                   remat: bool = True) -> torch.Tensor:
    """tokens (B, S) and the encoder's states → the decoder's final hidden
    states (B, S, d_model)."""
    cd = L.torch_dtype(cfg.compute_dtype)
    x = L.embed(params["embed"], tokens, cd)
    x = x + L.sinusoidal_positions(tokens.shape[1], cfg.d_model,
                                   tokens.device).to(cd)
    x = _run_layers(_dec_layer, cfg, params["dec_layers"], x, enc_out,
                    remat=remat)
    return L.layernorm(params["dec_norm"], x, cfg.norm_eps)


def encdec_loss(params: Params, cfg: ModelConfig, batch: dict, *,
                remat: bool = True) -> torch.Tensor:
    """Next-token CE loss.  batch: frames (B, T, d_model), tokens (B, S),
    labels (B, S) [, mask].  The tied readout runs in bf16 whatever
    ``cfg.compute_dtype`` is, as the reference's (``chunked_cross_entropy``
    at its default)."""
    enc_out = encode(params, cfg, batch["frames"], remat=remat)
    hidden = _decode_hidden(params, cfg, batch["tokens"], enc_out,
                            remat=remat)
    return L.chunked_cross_entropy(params["embed"], hidden, batch["labels"],
                                   tie=True, mask=batch.get("mask"),
                                   remat=remat)


# ------------------------------------------------------------------ decode

def init_encdec_cache(params: Params, cfg: ModelConfig, frames: torch.Tensor,
                      batch: int, max_seq: int) -> Params:
    """Runs the encoder once over ``frames`` (on the params' device) and
    returns ``{"self": {k, v}, "cross": {k, v}}``: zeroed self-attention
    caches (L, batch, max_seq, KH, Dh) and the static cross caches (L, B,
    T, KH, Dh), both in the compute dtype."""
    sspec, xspec = dec_spec(cfg), enc_spec(cfg)
    nd = cfg.num_layers
    dev = params["embed"]["table"].device
    with torch.no_grad():
        enc_out = encode(params, cfg, frames.to(dev), remat=False)
        one = init_kv_cache(sspec, nd * batch, max_seq, device=dev)
        self_cache = {k: v.reshape(nd, batch, *v.shape[1:])
                      for k, v in one.items()}
        per_layer = [precompute_cross_kv(p["cross_attn"], xspec, enc_out)
                     for p in tree_unstack(params["dec_layers"])]
        cross = {k: torch.stack([c[k] for c in per_layer])
                 for k in ("k", "v")}
    return {"self": self_cache, "cross": cross}


def encdec_decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                       cache: Params, pos) -> tuple[torch.Tensor, Params]:
    """One decode step.  tokens (B, 1); pos: the current length, an int, a
    0-d tensor or a per-row (B,) vector.  The position embedding is row
    ``pos`` of the cache's ``max_seq``-row sinusoidal table.  Returns
    (logits (B, 1, V) fp32, cache), the self-attention cache updated in
    place."""
    cd = L.torch_dtype(cfg.compute_dtype)
    sspec, xspec = dec_spec(cfg), enc_spec(cfg)
    eps = cfg.norm_eps
    b = tokens.shape[0]
    dev = tokens.device
    x = L.embed(params["embed"], tokens, cd)
    pe = L.sinusoidal_positions(cache["self"]["k"].shape[2], cfg.d_model,
                                dev).to(cd)
    pos_vec = torch.as_tensor(pos, dtype=torch.int64, device=dev
                              ).reshape(-1).expand(b)
    x = x + pe[pos_vec][:, None, :]
    for i, p in enumerate(tree_unstack(params["dec_layers"])):
        sc = {k: v[i] for k, v in cache["self"].items()}
        xc = {k: v[i] for k, v in cache["cross"].items()}
        y, _ = attn_decode(p["self_attn"], sspec,
                           L.layernorm(p["ln1"], x, eps), sc, pos)
        x = x + y
        x = x + cross_attn_decode(p["cross_attn"], xspec,
                                  L.layernorm(p["ln_x"], x, eps), xc)
        x = x + _mlp(p["mlp"], L.layernorm(p["ln2"], x, eps), cd)
    x = L.layernorm(params["dec_norm"], x, eps)
    logits = L.unembed_logits(params["embed"], x, cd)
    return logits.to(torch.float32), cache
