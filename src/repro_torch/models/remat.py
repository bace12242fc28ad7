"""Rematerialization that works inside ``torch.func`` transforms.

Counterpart of the reference's ``jax.checkpoint`` around each layer body
(``repro.models.transformer.forward_hidden``) and each cross-entropy chunk
(``repro.models.layers.chunked_cross_entropy``).  ``torch.utils.checkpoint``
cannot serve: ``torch.func.grad`` refuses its saved-tensor hooks, and the
port computes every gradient with ``torch.func`` (the FL client's step, the
fleet plane's vmapped step, ``make_train_step``).

:func:`checkpoint` runs ``fn(*args)`` as one ``torch.autograd.Function``
that saves only its inputs; its backward recomputes ``fn`` through
``torch.func.vjp`` and pulls the gradient back, outside the caller's
graph: ``torch.func.grad`` differentiates with ``create_graph=True``, and a
recompute recorded into that graph would keep every layer's activations
alive until the end, more than no remat at all.  The floating-point
arguments are differentiated, the others (token ids, positions) are
constants.  ``fn`` returns one tensor or a tuple of them (an MoE body
returns its hidden states and its running aux loss).
``generate_vmap_rule`` lets ``torch.func.vmap`` batch the whole thing, so a
checkpointed layer runs under the fleet plane's vmap and the kernels inside
it still see one folded batch.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch.autograd import Function

__all__ = ["checkpoint"]


class _Checkpoint(Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(fn, diff_at, *args):
        return fn(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        fn, diff_at, *args = inputs
        ctx.fn, ctx.diff_at, ctx.n_args = fn, diff_at, len(args)
        ctx.multi = isinstance(output, tuple)
        ctx.save_for_backward(*args)

    @staticmethod
    def backward(ctx, *grads):
        args = list(ctx.saved_tensors)

        def part(*diff):
            full = list(args)
            for i, x in zip(ctx.diff_at, diff):
                full[i] = x
            return ctx.fn(*full)

        # torch.func's grad runs the backward with create_graph=True; the
        # recompute outside the outer graph keeps that from holding every
        # recomputed activation (no double differentiation through here).
        with torch.no_grad():
            _, pull = torch.func.vjp(part, *(args[i] for i in ctx.diff_at))
            pulled = pull(grads if ctx.multi else grads[0])
        grads = [None] * ctx.n_args
        for i, g in zip(ctx.diff_at, pulled):
            grads[i] = g
        return (None, None, *grads)


def checkpoint(fn: Callable[..., Any], *args: torch.Tensor) -> Any:
    """``fn(*args)`` (a tensor or a tuple of tensors out), its
    intermediates recomputed in the backward instead of saved."""
    diff_at = tuple(i for i, a in enumerate(args)
                    if torch.is_floating_point(a))
    return _Checkpoint.apply(fn, diff_at, *args)
