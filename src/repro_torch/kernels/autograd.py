"""Gradients of the LM zoo's kernels: ``torch.autograd.Function``s around
``flash_attention``, ``ssm_scan`` and ``ssd_scan``.

The reference has no backward Pallas body: ``jax.grad`` differentiates its
inline XLA attention and scans.  The port's zoo runs its forward through
the hand-written kernels, so training needs their backward kernels
(``flash_attention_bwd_cuda``, ``ssm_scan_bwd_cuda``,
``ssd_scan_bwd_cuda``) wired in here.

:func:`attention_function`, :func:`scan_function` and
:func:`ssd_function` build a ``Function`` from a forward and a backward
callable: the seam through which the CPU tests run the very same
``Function`` with the plain twins (``ref.flash_attention_ref`` /
``ref.flash_attention_bwd_ref``, ``ref.ssm_scan_ref`` /
``ref.ssm_scan_bwd_ref``, ``ref.ssd_scan_ref`` / ``ref.ssd_scan_bwd_ref``).
:data:`FlashAttention`, :data:`SsmScan` and :data:`SsdScan` are built on
the CUDA kernels; ``kernels.ops`` routes a CUDA tensor through them.

Each ``Function`` is written in the ``forward`` / ``setup_context`` /
``backward`` form, so ``torch.func.grad`` and ``grad_and_value`` take it,
and has a ``vmap`` staticmethod that folds the vmapped dimension into the
kernel's batch axis B (an unbatched operand is expanded first), runs the
kernel once and unfolds the result: the fleet plane's vmapped train step
launches each kernel once per layer, not once per client.  The backward
itself is a second ``Function`` with the same ``vmap`` rule (it has no
backward of its own: no double differentiation).  ``flash_attention``
returns ``(o, lse)`` — the row log-sum-exp is an output, marked
non-differentiable, because ``torch.func`` takes only inputs and outputs
as saved tensors — and saves q, k, v, o and lse, so its backward
recomputes P from lse; ``ssm_scan`` saves ``da`` and its output ``hs``;
``ssd_scan`` returns ``(y, states, acum)`` — the state entering each chunk
and the chunks' cumulative decays, which the forward computes anyway, as
non-differentiable outputs — and saves its four inputs with them, so its
backward recomputes neither.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.autograd import Function

from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                 flash_attention_cuda)
from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda, ssd_scan_cuda
from repro_torch.kernels.ssm_scan import ssm_scan_bwd_cuda, ssm_scan_cuda

__all__ = ["attention_function", "scan_function", "ssd_function",
           "FlashAttention", "SsmScan", "SsdScan"]


def _fold(info, in_dims, tensors) -> list[torch.Tensor]:
    """Each tensor with its vmapped dimension (expanded where None) folded
    into its leading axis, contiguous."""
    out = []
    for t, d in zip(tensors, in_dims):
        t = (t.unsqueeze(0).expand(info.batch_size, *t.shape) if d is None
             else t.movedim(d, 0))
        out.append(t.reshape(-1, *t.shape[2:]).contiguous())
    return out


def _unfold(info, t: torch.Tensor) -> torch.Tensor:
    return t.reshape(info.batch_size, -1, *t.shape[1:])


def _no_double_backward(name: str):
    def backward(ctx, *grads):
        raise NotImplementedError(f"{name}'s backward has no backward of its "
                                  f"own (no double differentiation)")
    return staticmethod(backward)


def attention_function(fwd: Callable, bwd: Callable) -> type[Function]:
    """``Function.apply(q, k, v, causal, window, scale) -> (o, lse)``
    computing ``fwd(q, k, v, causal=, window=, scale=, return_lse=True)``,
    its gradients by ``bwd(q, k, v, o, do, lse=, causal=, window=, scale=)
    -> (dq, dk, dv)``; ``lse`` (B, H, Sq) takes no gradient."""

    class FlashAttentionBwd(Function):
        @staticmethod
        def forward(q, k, v, o, do, lse, causal, window, scale):
            return tuple(bwd(q, k, v, o, do, lse=lse, causal=causal,
                             window=window, scale=scale))

        @staticmethod
        def setup_context(ctx, inputs, output):
            pass

        backward = _no_double_backward("flash_attention")

        @staticmethod
        def vmap(info, in_dims, q, k, v, o, do, lse, causal, window, scale):
            folded = _fold(info, in_dims[:6], (q, k, v, o, do, lse))
            grads = FlashAttentionBwd.apply(*folded, causal, window, scale)
            return tuple(_unfold(info, g) for g in grads), (0, 0, 0)

    class FlashAttention(Function):
        @staticmethod
        def forward(q, k, v, causal, window, scale):
            return tuple(fwd(q, k, v, causal=causal, window=window,
                             scale=scale, return_lse=True))

        @staticmethod
        def setup_context(ctx, inputs, output):
            q, k, v, causal, window, scale = inputs
            o, lse = output
            ctx.mark_non_differentiable(lse)
            ctx.save_for_backward(q, k, v, o, lse)
            ctx.opts = (causal, window, scale)

        @staticmethod
        def backward(ctx, do, _dlse):
            q, k, v, o, lse = ctx.saved_tensors
            dq, dk, dv = FlashAttentionBwd.apply(
                q, k, v, o, do.to(q.dtype).contiguous(), lse, *ctx.opts)
            return dq, dk, dv, None, None, None

        @staticmethod
        def vmap(info, in_dims, q, k, v, causal, window, scale):
            q, k, v = _fold(info, in_dims[:3], (q, k, v))
            o, lse = FlashAttention.apply(q, k, v, causal, window, scale)
            return (_unfold(info, o), _unfold(info, lse)), (0, 0)

    return FlashAttention


def scan_function(fwd: Callable, bwd: Callable) -> type[Function]:
    """``Function.apply(da, dbx)`` computing ``fwd(da, dbx) -> hs``, its
    gradients by ``bwd(da, hs, dhs) -> (dda, ddbx)``."""

    class SsmScanBwd(Function):
        @staticmethod
        def forward(da, hs, dhs):
            return tuple(bwd(da, hs, dhs))

        @staticmethod
        def setup_context(ctx, inputs, output):
            pass

        backward = _no_double_backward("ssm_scan")

        @staticmethod
        def vmap(info, in_dims, da, hs, dhs):
            grads = SsmScanBwd.apply(*_fold(info, in_dims, (da, hs, dhs)))
            return tuple(_unfold(info, g) for g in grads), (0, 0)

    class SsmScan(Function):
        @staticmethod
        def forward(da, dbx):
            return fwd(da, dbx)

        @staticmethod
        def setup_context(ctx, inputs, output):
            ctx.save_for_backward(inputs[0], output)

        @staticmethod
        def backward(ctx, dhs):
            da, hs = ctx.saved_tensors
            return SsmScanBwd.apply(da, hs, dhs.to(hs.dtype).contiguous())

        @staticmethod
        def vmap(info, in_dims, da, dbx):
            out = SsmScan.apply(*_fold(info, in_dims, (da, dbx)))
            return _unfold(info, out), 0

    return SsmScan


def ssd_function(fwd: Callable, bwd: Callable) -> type[Function]:
    """``Function.apply(xh, a, bmat, cmat, chunk) -> (y, states, acum)``
    computing ``fwd(xh, a, bmat, cmat, chunk=, return_state=True)``, its
    gradients by ``bwd(xh, a, bmat, cmat, dy, chunk=, states=, acum=) ->
    (dxh, da, db, dc)``; ``states`` and ``acum`` take no gradient."""

    class SsdScanBwd(Function):
        @staticmethod
        def forward(xh, a, bmat, cmat, dy, states, acum, chunk):
            return tuple(bwd(xh, a, bmat, cmat, dy, chunk=chunk,
                             states=states, acum=acum))

        @staticmethod
        def setup_context(ctx, inputs, output):
            pass

        backward = _no_double_backward("ssd_scan")

        @staticmethod
        def vmap(info, in_dims, xh, a, bmat, cmat, dy, states, acum, chunk):
            folded = _fold(info, in_dims[:7],
                           (xh, a, bmat, cmat, dy, states, acum))
            grads = SsdScanBwd.apply(*folded, chunk)
            return tuple(_unfold(info, g) for g in grads), (0, 0, 0, 0)

    class SsdScan(Function):
        @staticmethod
        def forward(xh, a, bmat, cmat, chunk):
            return tuple(fwd(xh, a, bmat, cmat, chunk=chunk,
                             return_state=True))

        @staticmethod
        def setup_context(ctx, inputs, output):
            xh, a, bmat, cmat, chunk = inputs
            _, states, acum = output
            ctx.mark_non_differentiable(states, acum)
            ctx.save_for_backward(xh, a, bmat, cmat, states, acum)
            ctx.chunk = chunk

        @staticmethod
        def backward(ctx, dy, _dstates, _dacum):
            xh, a, bmat, cmat, states, acum = ctx.saved_tensors
            grads = SsdScanBwd.apply(xh, a, bmat, cmat,
                                     dy.to(xh.dtype).contiguous(), states,
                                     acum, ctx.chunk)
            return (*grads, None)

        @staticmethod
        def vmap(info, in_dims, xh, a, bmat, cmat, chunk):
            folded = _fold(info, in_dims[:4], (xh, a, bmat, cmat))
            out = SsdScan.apply(*folded, chunk)
            return tuple(_unfold(info, o) for o in out), (0, 0, 0)

    return SsdScan


#: The CUDA route of ``ops.flash_attention``.
FlashAttention = attention_function(flash_attention_cuda,
                                    flash_attention_bwd_cuda)
#: The CUDA route of ``ops.ssm_scan``.
SsmScan = scan_function(ssm_scan_cuda, ssm_scan_bwd_cuda)
#: The CUDA route of ``ops.ssd_scan``.
SsdScan = ssd_function(ssd_scan_cuda, ssd_scan_bwd_cuda)
