"""The adapter hop plane: frozen-base / trainable-adapter views + int8 wire.

Counterpart of ``repro.fl.adapters``.  An :class:`AdapterView` splits a
task's parameters into a frozen base (broadcast once, charged on the round-0
downlink) and a trainable adapter tree (the LoRA factors of the ``lm``
task), which is the only state the executor trains, diffuses and
aggregates.  Tasks without a split (``TaskModel.split is None``) get the
identity view: the exact ``model.init``/``model.loss`` objects pass through
unwrapped, so full-params runs are the pre-adapter program.

With ``FLConfig.hop_quant == "int8"`` a hop payload is also packed to int8:
the flattened adapter is cut into ``QUANT_BLOCK``-element row-blocks, each
moving as int8 codes plus one fp32 absmax scale (``kernels.ops.quant_pack``
/ ``quant_unpack``: the ``quant`` kernels on the card).  :func:`packed_bits`
is the Eq.-15 payload size S of that format, 8·block + 32 bits per
row-block.  The executor applies exactly one pack→unpack roundtrip per
PermuteOp to every slot — what the receiving device decodes; per-row
packing commutes with the row gather that implements the move.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
import torch.nn.functional as F

from repro_torch.core.aggregation import model_bits
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.diffusion import stack_ravel, stack_unravel
from repro_torch.kernels.quant import QUANT_BLOCK
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

Params = Any

__all__ = ["AdapterView", "make_adapter_view", "packed_bits", "pack_rows",
           "unpack_rows", "quant_roundtrip_rows", "quant_roundtrip_tree",
           "quant_roundtrip_slot", "QUANT_BLOCK"]


def pack_rows(flat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(C, F) fp32 client-stacked flat params → ((C, Fp) int8 codes,
    (C, Fp/block) fp32 scales), Fp = F zero-padded up to a block multiple.
    Per client row the layout matches :func:`quant_roundtrip_slot`, so a
    packed row is the same wire bytes whichever executor sends it."""
    c, f = flat.shape
    fp = -(-f // QUANT_BLOCK) * QUANT_BLOCK
    flat = F.pad(flat.to(torch.float32), (0, fp - f))
    r = fp // QUANT_BLOCK
    q, s = kernel_ops.quant_pack(flat.reshape(c * r, QUANT_BLOCK))
    return q.reshape(c, fp), s.reshape(c, r)


def unpack_rows(q: torch.Tensor, scales: torch.Tensor, f: int
                ) -> torch.Tensor:
    """Inverse of :func:`pack_rows`; ``f`` is the unpadded feature count."""
    c, fp = q.shape
    r = scales.shape[1]
    x = kernel_ops.quant_unpack(q.reshape(c * r, fp // r),
                                scales.reshape(c * r))
    return x.reshape(c, fp)[:, :f]


def quant_roundtrip_rows(flat: torch.Tensor) -> torch.Tensor:
    """pack→unpack of a (C, F) block: what the hop destination decodes."""
    q, s = pack_rows(flat)
    return unpack_rows(q, s, flat.shape[1])


def quant_roundtrip_tree(params: Params) -> Params:
    """Roundtrip a client-stacked tree per client row (FleetExecutor)."""
    flat, spec = stack_ravel(params)
    return stack_unravel(quant_roundtrip_rows(flat), spec)


def quant_roundtrip_slot(params: Params) -> Params:
    """Roundtrip one unstacked slot tree (the host executor).
    Flattens in ``stack_ravel``'s leaf-concat order, so the row-block
    boundaries, and the decoded values, are the stacked executor's."""
    leaves, treedef = tree_flatten(params)
    flat = torch.cat([x.reshape(1, -1).to(torch.float32) for x in leaves],
                     dim=1)
    out = quant_roundtrip_rows(flat)[0]
    new, off = [], 0
    for x in leaves:
        n = x.numel()
        new.append(out[off:off + n].reshape(x.shape).to(x.dtype))
        off += n
    return tree_unflatten(treedef, new)


def packed_bits(template: Params) -> float:
    """S for one int8-packed hop (Eq. 15 numerator): 8 bits per padded
    element plus one fp32 scale per row-block, from the leaves' shapes."""
    f = sum(math.prod(x.shape) for x in tree_leaves(template))
    rows = -(-f // QUANT_BLOCK)
    return float(rows * (8 * QUANT_BLOCK + 32))


@dataclasses.dataclass(frozen=True)
class AdapterView:
    """What ``run_federated`` sees of a task: init/loss over the hop payload
    tree, a merge back to full params for eval, and the one-time base
    broadcast charge (0.0 when the view is the identity)."""
    init_fn: Callable[[torch.Generator], Params]
    loss_fn: Callable[[Params, dict], torch.Tensor]
    merge_fn: Callable[[Params], Params]
    base_bits: float
    base: Params | None


def make_adapter_view(model, fl_cfg, adapter_hops: bool = True,
                      init_fn: Callable | None = None,
                      device: str | torch.device = "cpu") -> AdapterView:
    """Build the view ``run_federated`` trains and hops over.

    Full-params tasks (``model.split is None``) or ``adapter_hops=False``
    return the identity view with the unwrapped ``init_fn`` (``model.init``
    by default) and ``model.loss``.  Otherwise the base is fixed from the
    run seed, ``split(init_fn(Generator(seed)))[0]`` on ``device`` (every
    client derives the same base from the round-0 broadcast), the hop
    payload is ``split(init_fn(gen))[1]``, and the loss closes over the
    frozen base.  As in the reference, base and adapter come from one init,
    so an ``init_fn`` that returns the reference's params gives both."""
    init_fn = init_fn or model.init
    if not adapter_hops or model.split is None:
        return AdapterView(init_fn, model.loss, lambda p: p, 0.0, None)
    base, _ = model.split(init_fn(torch.Generator().manual_seed(fl_cfg.seed)))
    base = tree_map(lambda x: x.to(device), base)

    def adapter_init(gen):
        return model.split(init_fn(gen))[1]

    def loss_fn(adapter, batch):
        return model.loss(model.merge(base, adapter), batch)

    def merge_fn(adapter):
        return model.merge(base, adapter)

    return AdapterView(adapter_init, loss_fn, merge_fn,
                       model_bits(base, fl_cfg.bits_per_param), base)
