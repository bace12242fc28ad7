"""State-space blocks of the LM zoo: Mamba-1 selective scan and Mamba-2 SSD,
full-context (prefill) forward.

Counterpart of ``repro.models.ssm``.  The reference runs both scans inline
in XLA (a chunked ``lax.scan``) and names the Pallas ``ssm_scan`` /
``ssd_scan`` kernels as their TPU form; here the scans call
:func:`repro_torch.kernels.ops.ssm_scan` and
:func:`repro_torch.kernels.ops.ssd_scan` — the hand-written Hopper kernels
on the card, their plain versions on the CPU.

* Mamba-1: ``hs = ssm_scan(da, dbx)`` over the whole sequence, then
  ``y = Σ_n hs·C``.  That is the function of the reference's default fused
  ``_chunked_scan_project``; the reference's chunk length (raised to 1024)
  only changes its blocking, so the port's spec has none and the two differ
  by fp32 rounding only.
* Mamba-2: ``ssd_scan(xh, a, b, c, chunk=spec.chunk)`` takes the place of
  ``_ssd_chunk_scan`` from a zero state.

Decode (:func:`mamba1_decode`, :func:`mamba2_decode`) is one recurrence
step on the carried state, as in the reference, with no kernel.  A layer's
cache is its conv history and its state, fp32 as the reference's; the
decode steps write the new ones into the cache in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers as L

Params = Any

__all__ = ["Mamba1Spec", "init_mamba1", "mamba1_forward", "init_mamba1_cache",
           "mamba1_decode", "Mamba2Spec", "init_mamba2", "mamba2_forward",
           "init_mamba2_cache", "mamba2_decode"]


# ===================================================================
# Mamba-1 (falcon-mamba-7b): per-channel selective scan, diagonal A.
# ===================================================================

@dataclasses.dataclass(frozen=True)
class Mamba1Spec:
    d_model: int
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def resolved_dt_rank(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)


def init_mamba1(gen: torch.Generator, spec: Mamba1Spec,
                stack: tuple = ()) -> Params:
    """Random init in the reference's layout and scales (``stack``
    prepends a segment's layer axis)."""
    d, di, n = spec.d_model, spec.d_inner, spec.d_state
    r = spec.resolved_dt_rank
    dev = gen.device
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.rand((*stack, di), generator=gen, device=dev) * (hi - lo) + lo
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device=dev))
    return {
        "in_proj": L.init_dense(gen, d, 2 * di, stack=stack),
        "conv_w": L.init_normal(gen, (*stack, spec.d_conv, di),
                            1.0 / spec.d_conv),
        "conv_b": torch.zeros((*stack, di), device=dev),
        "x_proj": L.init_dense(gen, di, r + 2 * n, stack=stack),
        "dt_proj": {"w": L.init_normal(gen, (*stack, r, di), r ** -0.5),
                    "b": torch.log(torch.expm1(torch.exp(u)))},
        # S4D-real init: A_log[c, n] = log(n+1)
        "a_log": a_log.expand(*stack, di, n).contiguous(),
        "d_skip": torch.ones((*stack, di), device=dev),
        "out_proj": L.init_dense(gen, di, d, stack=stack),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv1d.  x: (B,S,C), w: (K,C):
    ``y[t] = Σ_j w[j]·xp[t+j] + b`` over ``xp``, the history (the carried
    ``state`` of the K−1 previous inputs, or zeros) followed by x.  Returns
    ``(y, new_state)``, the new state the trailing K−1 inputs."""
    k, s = w.shape[0], x.shape[1]
    if state is None:
        xp = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = xp[:, 0:s, :] * w[0]
    for j in range(1, k):
        y = y + xp[:, j:j + s, :] * w[j]
    return y + b, (xp[:, -(k - 1):, :] if k > 1 else None)


def _ssm_params(p: Params, spec: Mamba1Spec, x_conv: torch.Tensor):
    """Input-dependent (Δ, B, C) → (da, dbx, C) for tokens x_conv (B,S,di)."""
    r, n = spec.resolved_dt_rank, spec.d_state
    proj = L.dense(p["x_proj"], x_conv, torch.float32)
    dt_low, bmat, cmat = torch.split(proj, [r, n, n], dim=-1)
    dt = dt_low @ p["dt_proj"]["w"] + p["dt_proj"]["b"]
    dt = torch.nn.functional.softplus(dt)                    # (B,S,di)
    a = -torch.exp(p["a_log"])                               # (di,N)
    # In place where a (B,S,di,N) temporary would be: 1 GB each at
    # falcon-mamba-7b's width per 2048 tokens.
    da = (dt[..., None] * a).exp_()                          # (B,S,di,N)
    dbx = (dt[..., None] * bmat[:, :, None, :]).mul_(
        x_conv.to(torch.float32)[..., None])                 # (B,S,di,N)
    return da, dbx, cmat


def mamba1_forward(p: Params, spec: Mamba1Spec,
                   x: torch.Tensor) -> torch.Tensor:
    """x: (B,S,D) -> (B,S,D)."""
    cd = spec.compute_dtype
    xz = L.dense(p["in_proj"], x, cd)
    xin, z = torch.chunk(xz, 2, dim=-1)
    x_conv = L.silu(_causal_conv(xin, p["conv_w"].to(cd),
                                 p["conv_b"].to(cd))[0])
    da, dbx, cmat = _ssm_params(p, spec, x_conv)
    hs = ops.ssm_scan(da, dbx)                               # (B,S,di,N)
    del da, dbx
    y = torch.einsum("bsdn,bsn->bsd", hs, cmat)              # (B,S,di)
    del hs
    y = y + p["d_skip"] * x_conv.to(torch.float32)
    y = y.to(cd) * L.silu(z)
    return L.dense(p["out_proj"], y, cd)


def init_mamba1_cache(spec: Mamba1Spec, batch: int,
                      device: torch.device | str = "cpu") -> Params:
    return {"conv": torch.zeros((batch, spec.d_conv - 1, spec.d_inner),
                                device=device),
            "h": torch.zeros((batch, spec.d_inner, spec.d_state),
                             device=device)}


def mamba1_decode(p: Params, spec: Mamba1Spec, x: torch.Tensor,
                  cache: Params) -> tuple[torch.Tensor, Params]:
    """One-token step. x: (B,1,D).  Writes the new conv history and state
    into ``cache`` in place and returns it."""
    cd = spec.compute_dtype
    xin, z = torch.chunk(L.dense(p["in_proj"], x, cd), 2, dim=-1)
    x_conv, conv_state = _causal_conv(xin, p["conv_w"].to(cd),
                                      p["conv_b"].to(cd), cache["conv"])
    x_conv = L.silu(x_conv)
    da, dbx, cmat = _ssm_params(p, spec, x_conv)
    h = da[:, 0] * cache["h"] + dbx[:, 0]                    # (B,di,N)
    y = torch.einsum("bdn,bn->bd", h, cmat[:, 0])
    y = y + p["d_skip"] * x_conv[:, 0].to(torch.float32)
    y = (y.to(cd) * L.silu(z[:, 0]))[:, None, :]
    out = L.dense(p["out_proj"], y, cd)
    cache["conv"].copy_(conv_state)
    cache["h"].copy_(h)
    return out, cache


# ===================================================================
# Mamba-2 / SSD (zamba2): scalar decay per head, chunked SSD algorithm.
# ===================================================================

@dataclasses.dataclass(frozen=True)
class Mamba2Spec:
    d_model: int
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def num_heads(self) -> int:
        return self.d_inner // self.head_dim


def init_mamba2(gen: torch.Generator, spec: Mamba2Spec,
                stack: tuple = ()) -> Params:
    d, di, n, nh = spec.d_model, spec.d_inner, spec.d_state, spec.num_heads
    dev = gen.device
    a_log = torch.log(torch.linspace(1.0, 16.0, nh, device=dev))
    return {
        "w_zx": L.init_dense(gen, d, 2 * di, stack=stack),
        "w_bc": L.init_dense(gen, d, 2 * n, stack=stack),
        "w_dt": L.init_dense(gen, d, nh, stack=stack),
        "conv_x": {"w": L.init_normal(gen, (*stack, spec.d_conv, di),
                                  1.0 / spec.d_conv),
                   "b": torch.zeros((*stack, di), device=dev)},
        "conv_bc": {"w": L.init_normal(gen, (*stack, spec.d_conv, 2 * n),
                                   1.0 / spec.d_conv),
                    "b": torch.zeros((*stack, 2 * n), device=dev)},
        "a_log": a_log.expand(*stack, nh).contiguous(),
        "dt_bias": torch.zeros((*stack, nh), device=dev),
        "d_skip": torch.ones((*stack, nh), device=dev),
        "out_norm": L.init_rmsnorm(di, stack, dev),
        "out_proj": L.init_dense(gen, di, d, stack=stack),
    }


def _mamba2_streams(p: Params, spec: Mamba2Spec, x: torch.Tensor,
                    conv_state: Params | None = None):
    """z, the dt-scaled value stream xh (B,S,H,P), the per-step log decay
    (B,S,H), the b / c projections (B,S,N) and the new conv histories
    ``{"x", "bc"}``, from the carried ``conv_state`` (or zeros)."""
    cd = spec.compute_dtype
    nh = spec.num_heads
    z, xin = torch.chunk(L.dense(p["w_zx"], x, cd), 2, dim=-1)
    bc = L.dense(p["w_bc"], x, cd)
    dt = L.dense(p["w_dt"], x, cd)
    cs = conv_state or {"x": None, "bc": None}
    xin, new_x = _causal_conv(xin, p["conv_x"]["w"].to(cd),
                              p["conv_x"]["b"].to(cd), cs["x"])
    bc, new_bc = _causal_conv(bc, p["conv_bc"]["w"].to(cd),
                              p["conv_bc"]["b"].to(cd), cs["bc"])
    xin = L.silu(xin)
    bmat, cmat = torch.chunk(L.silu(bc), 2, dim=-1)
    dt = torch.nn.functional.softplus(dt.to(torch.float32) + p["dt_bias"])
    a_step = dt * -torch.exp(p["a_log"])                     # (B,S,H)
    xh = xin.to(torch.float32).reshape(*xin.shape[:-1], nh, spec.head_dim)
    xh = xh * dt[..., None]
    return (z, xh, a_step, bmat.to(torch.float32), cmat.to(torch.float32),
            {"x": new_x, "bc": new_bc})


def mamba2_forward(p: Params, spec: Mamba2Spec,
                   x: torch.Tensor) -> torch.Tensor:
    cd = spec.compute_dtype
    b, s, _ = x.shape
    z, xh, a_step, bmat, cmat, _ = _mamba2_streams(p, spec, x)
    y = ops.ssd_scan(xh, a_step, bmat, cmat, chunk=spec.chunk)
    y = y + p["d_skip"][None, None, :, None] * xh
    y = y.reshape(b, s, spec.d_inner).to(cd)
    y = L.rmsnorm(p["out_norm"], y * L.silu(z))
    return L.dense(p["out_proj"], y, cd)


def init_mamba2_cache(spec: Mamba2Spec, batch: int,
                      device: torch.device | str = "cpu") -> Params:
    k = spec.d_conv - 1
    return {"conv": {"x": torch.zeros((batch, k, spec.d_inner),
                                      device=device),
                     "bc": torch.zeros((batch, k, 2 * spec.d_state),
                                       device=device)},
            "h": torch.zeros((batch, spec.num_heads, spec.head_dim,
                              spec.d_state), device=device)}


def mamba2_decode(p: Params, spec: Mamba2Spec, x: torch.Tensor,
                  cache: Params) -> tuple[torch.Tensor, Params]:
    """One-token step. x: (B,1,D).  Writes the new conv histories and
    state into ``cache`` in place and returns it."""
    cd = spec.compute_dtype
    b = x.shape[0]
    z, xh, a_step, bmat, cmat, conv_state = _mamba2_streams(
        p, spec, x, cache["conv"])
    da = torch.exp(a_step[:, 0])                             # (B,H)
    h = da[:, :, None, None] * cache["h"] + torch.einsum(
        "bn,bhp->bhpn", bmat[:, 0], xh[:, 0])
    y = torch.einsum("bn,bhpn->bhp", cmat[:, 0], h)
    y = y + p["d_skip"][None, :, None] * xh[:, 0]
    y = y.reshape(b, 1, spec.d_inner).to(cd)
    y = L.rmsnorm(p["out_norm"], y * L.silu(z[:, :1]))
    out = L.dense(p["out_proj"], y, cd)
    cache["conv"]["x"].copy_(conv_state["x"])
    cache["conv"]["bc"].copy_(conv_state["bc"])
    cache["h"].copy_(h)
    return out, cache
