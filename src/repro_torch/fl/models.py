"""The paper's evaluation models (Sec. VI-A): FCN, CNN, LSTM, SVM, logistic,
and the ``lm`` task: a small pre-norm transformer with LoRA adapters.

Counterpart of ``repro.fl.models``.  Each model is a pure function of a
params tree with the reference's nesting, leaf names and layouts — dense
``w`` as (in, out), CNN kernels as HWIO — so the fleet executor can
``torch.func.vmap`` it over a client-stacked tree and the tests can feed it
the reference's own weights (:func:`params_from_numpy`).

``init(gen)`` draws from an explicit ``torch.Generator`` on the CPU: the
reference's distributions, not its bits.

The ``lm`` transformer (tied embeddings, causal attention, next-token
cross-entropy over ``data/synthetic.lm_corpus`` rows) carries rank-``LM_RANK``
LoRA factors on its attention and MLP projections; ``split``/``merge``
expose the frozen-base / trainable-adapter view that the FL executors hop
instead of the full model (:mod:`repro_torch.fl.adapters`).  It is plain
tensor code, as the reference's is.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
import torch.nn.functional as F

from repro_torch.tree import params_from_numpy, params_to_numpy

Params = Any

__all__ = ["TaskModel", "build_task_model", "TASK_MODELS",
           "params_from_numpy", "params_to_numpy", "LM_VOCAB", "LM_WIDTH",
           "LM_FF", "LM_LAYERS", "LM_HEADS", "LM_RANK"]

TASK_MODELS = ("logistic", "svm", "fcn", "lstm", "cnn", "lm")

# The small-LM config of the reference: a 2-layer, 64-wide tied-embedding
# transformer with rank-2 LoRA adapters.
LM_VOCAB = 128
LM_WIDTH = 64
LM_FF = 128
LM_LAYERS = 2
LM_HEADS = 2
LM_RANK = 2


@dataclasses.dataclass(frozen=True)
class TaskModel:
    name: str
    init: Callable[[torch.Generator], Params]
    logits: Callable[[Params, torch.Tensor], torch.Tensor]
    loss: Callable[[Params, dict], torch.Tensor]
    # Frozen-base / trainable-adapter view (repro_torch.fl.adapters):
    # ``split`` maps params -> (base, adapter), ``merge`` inverts it.
    # ``None`` means full-params: the view is the identity.
    split: Callable[[Params], tuple[Params, Params]] | None = None
    merge: Callable[[Params, Params], Params] | None = None
    # Task-specific accuracy (next-token accuracy for "lm"); ``None`` means
    # argmax-class accuracy from ``logits``.
    accuracy_fn: Callable[[Params, torch.Tensor, torch.Tensor],
                          torch.Tensor] | None = None

    def predict(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return torch.argmax(self.logits(params, x), dim=-1)

    def accuracy(self, params: Params, x: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
        if self.accuracy_fn is not None:
            return self.accuracy_fn(params, x, y)
        return (self.predict(params, x) == y).to(torch.float32).mean()


def _xent(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y[:, None])[:, 0]
    return torch.mean(logz - gold)


def _hinge(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Multiclass (Crammer–Singer) hinge — the SVM task."""
    c = logits.shape[-1]
    gold = torch.gather(logits, -1, y[:, None])
    other = (torch.arange(c, device=logits.device) != y[:, None])
    margins = (logits - gold + 1.0) * other.to(logits.dtype)
    return torch.mean(torch.amax(margins, dim=-1))


def _dense_stack(gen: torch.Generator, dims) -> list:
    return [{"w": torch.randn((a, b), generator=gen) / math.sqrt(a),
             "b": torch.zeros((b,))}
            for a, b in zip(dims[:-1], dims[1:])]


def _mlp_apply(layers, x):
    for i, p in enumerate(layers):
        x = x @ p["w"] + p["b"]
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def build_task_model(name: str, dim: int = 64, num_classes: int = 10,
                     hidden: int = 128) -> TaskModel:
    if name in ("logistic", "svm"):
        def init(gen):
            return _dense_stack(gen, [dim, num_classes])

        def loss(p, b):
            if name == "logistic":
                return _xent(_mlp_apply(p, b["x"]), b["y"])
            return (_hinge(_mlp_apply(p, b["x"]), b["y"])
                    + 1e-4 * sum(torch.sum(q["w"] ** 2) for q in p))
        return TaskModel(name, init, _mlp_apply, loss)

    if name == "fcn":
        def init(gen):
            return _dense_stack(gen, [dim, hidden, hidden, num_classes])
        return TaskModel(name, init, _mlp_apply,
                         lambda p, b: _xent(_mlp_apply(p, b["x"]), b["y"]))

    if name == "cnn":
        side = int(dim ** 0.5)
        if side * side != dim:
            raise ValueError("cnn task needs a square feature dim")

        def init(gen):
            return {
                "c1": torch.randn((3, 3, 1, 16), generator=gen) * 0.2,
                "c2": torch.randn((3, 3, 16, 32), generator=gen) * 0.1,
                "head": _dense_stack(gen, [32 * (side // 4) ** 2, hidden,
                                           num_classes]),
            }

        def logits(p, x):
            b = x.shape[0]
            # NHWC with one channel has the memory layout of NCHW.
            h = x.reshape(b, 1, side, side)
            for k in ("c1", "c2"):
                # HWIO → OIHW; JAX's SAME padding of a 3x3 stride-1 conv
                # is one row/column on every side.
                h = F.conv2d(h, p[k].permute(3, 2, 0, 1), padding=1)
                h = F.max_pool2d(torch.relu(h), 2, 2)
            # Flatten in NHWC order, as the reference's head expects.
            return _mlp_apply(p["head"], h.permute(0, 2, 3, 1).reshape(b, -1))

        return TaskModel(name, init, logits,
                         lambda p, b: _xent(logits(p, b["x"]), b["y"]))

    if name == "lstm":
        steps = 8
        feat = dim // steps

        def init(gen):
            h = hidden
            return {
                "wx": torch.randn((feat, 4 * h), generator=gen)
                / math.sqrt(feat),
                "wh": torch.randn((h, 4 * h), generator=gen) / math.sqrt(h),
                "b": torch.zeros((4 * h,)),
                "head": _dense_stack(gen, [h, num_classes]),
            }

        def logits(p, x):
            b = x.shape[0]
            seq = x.reshape(b, steps, feat)
            h = x.new_zeros((b, hidden))
            c = x.new_zeros((b, hidden))
            for t in range(steps):
                z = seq[:, t] @ p["wx"] + h @ p["wh"] + p["b"]
                i, f, g, o = torch.split(z, hidden, dim=-1)
                c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
                h = torch.sigmoid(o) * torch.tanh(c)
            return _mlp_apply(p["head"], h)

        return TaskModel(name, init, logits,
                         lambda p, b: _xent(logits(p, b["x"]), b["y"]))

    if name == "lm":
        return _lm_task_model()
    raise ValueError(f"unknown task model {name!r}")


def _lm_task_model() -> TaskModel:
    """The ``lm`` task: reference ``repro.fl.models`` (``name == "lm"``)."""
    v, d, ff = LM_VOCAB, LM_WIDTH, LM_FF
    nl, nh, r = LM_LAYERS, LM_HEADS, LM_RANK
    hd = d // nh
    shapes = (("wq", (d, d)), ("wk", (d, d)), ("wv", (d, d)),
              ("wo", (d, d)), ("w1", (d, ff)), ("w2", (ff, d)))

    def init(gen):
        base = {"embed": torch.randn((v, d), generator=gen) * 0.02,
                "layers": [{n: torch.randn(s, generator=gen) / math.sqrt(s[0])
                            for n, s in shapes} for _ in range(nl)]}
        # b zero-init: the adapter starts as an exact zero delta.
        lora = [{n: {"a": torch.randn((s[0], r), generator=gen)
                     / math.sqrt(s[0]),
                     "b": torch.zeros((r, s[1]))}
                 for n, s in shapes} for _ in range(nl)]
        return {"base": base, "lora": lora}

    def _rms(h):
        return h * torch.rsqrt(torch.mean(h * h, dim=-1, keepdim=True) + 1e-6)

    def _proj(h, bl, lo, n):
        return h @ bl[n] + (h @ lo[n]["a"]) @ lo[n]["b"]

    def logits(p, x):
        base, lora = p["base"], p["lora"]
        tok = x.to(torch.int64)
        b, s = tok.shape
        h = F.embedding(tok, base["embed"])                      # (B, S, D)
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                     device=h.device))
        for bl, lo in zip(base["layers"], lora):
            hn = _rms(h)
            q = _proj(hn, bl, lo, "wq").reshape(b, s, nh, hd)
            k = _proj(hn, bl, lo, "wk").reshape(b, s, nh, hd)
            vv = _proj(hn, bl, lo, "wv").reshape(b, s, nh, hd)
            att = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
            att = torch.softmax(torch.where(mask, att, -torch.inf), dim=-1)
            o = torch.einsum("bhqk,bkhd->bqhd", att, vv).reshape(b, s, d)
            h = h + _proj(o, bl, lo, "wo")
            h = h + _proj(torch.relu(_proj(_rms(h), bl, lo, "w1")),
                          bl, lo, "w2")
        return _rms(h) @ base["embed"].T                         # tied head

    def loss(p, batch):
        tok = batch["x"].to(torch.int64)        # next-token CE; no "y"
        lg = logits(p, tok[:, :-1])
        logz = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, tok[:, 1:, None])[..., 0]
        return torch.mean(logz - gold)

    def accuracy_fn(p, x, y):
        tok = x.to(torch.int64)
        pred = torch.argmax(logits(p, tok[:, :-1]), dim=-1)
        return (pred == tok[:, 1:]).to(torch.float32).mean()

    return TaskModel("lm", init, logits, loss,
                     split=lambda p: (p["base"], p["lora"]),
                     merge=lambda base, lora: {"base": base, "lora": lora},
                     accuracy_fn=accuracy_fn)
