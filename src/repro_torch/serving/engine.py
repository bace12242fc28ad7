"""Continuous-batching serving engine (vLLM-lite) over the decode step.

Counterpart of ``repro.serving.engine``.  It keeps ``num_slots`` cache
slots and a request queue: finished or empty slots are refilled each step
(admission), every step decodes the whole batch once, and per-slot
positions drive the masks inside the model's ``decode_step``.  Prompts are
ingested teacher-forced through the same decode path, one token a step, as
in the reference.  The cache lives on the params' device with the slots on
its batch axis and is updated in place; the sampling key is the
reference's threefry key, ``PRNGKey(seed)`` split once per step on that
device (:func:`repro_torch.core.threefry.split_t`), so a sampled token
equals the reference's for the same logits.

On the card the decode step is captured once into a CUDA graph and
replayed every step after the first, as the reference jits it once: the
inputs go through static token and position buffers, the cache is the
graph's in place, and the logits come back in a static buffer.  A step is
a few thousand small launches at these widths, so without the graph the
host's dispatch, not the card, sets its time.

A departure from the reference: admission also zeroes the slot's
recurrent state (the conv history and the state ``h`` of every ``mamba1``
and ``mamba2`` layer).  The reference resets only the slot's position,
which masks a KV cache's old entries but lets a Mamba layer's state carry
over into the next request that takes the slot, so its output there is
not the request's own greedy decode.

The engine serves decoder-only models.  An encoder–decoder (the audio
family) builds its cache from each request's audio frames, which a
:class:`Request` does not carry, so the engine refuses it at construction
with a ``ValueError``; the reference's engine calls the three-argument
``init_cache`` there and fails with a ``TypeError``.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any

import numpy as np
import torch

from repro_torch.core.threefry import PRNGKey, split_t
from repro_torch.models.zoo import Model
from repro_torch.serving.sampler import SamplerConfig, sample
from repro_torch.tree import tree_leaves

__all__ = ["Request", "ServingEngine"]


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                 # (len,) int32
    max_new_tokens: int = 16
    output: list[int] = dataclasses.field(default_factory=list)
    done: bool = False

    @property
    def total_budget(self) -> int:
        return len(self.prompt) + self.max_new_tokens


def _recurrent_leaves(cache: Any) -> list[torch.Tensor]:
    """The Mamba layers' cache leaves, each (count, slots, ...)."""
    return [leaf for seg in cache["segments"] for name, c in seg.items()
            if name.endswith(("_mamba1", "_mamba2"))
            for leaf in tree_leaves(c)]


class ServingEngine:
    def __init__(self, model: Model, params, num_slots: int = 4,
                 max_seq: int = 256, sampler: SamplerConfig | None = None,
                 eos_id: int | None = None, seed: int = 0):
        if model.cfg.family == "audio":
            raise ValueError(
                f"{model.cfg.name}: the serving engine takes decoder-only "
                f"models; an encoder-decoder's cache needs each request's "
                f"audio frames (init_cache(params, frames, batch, max_seq)), "
                f"which a Request does not carry")
        self.model = model
        self.params = params
        self.num_slots = num_slots
        self.max_seq = max_seq
        self.sampler = sampler or SamplerConfig(temperature=0.0)
        self.eos_id = eos_id
        self.device = tree_leaves(params)[0].device
        self.key = torch.from_numpy(PRNGKey(seed).astype(np.int64)).to(
            self.device)
        self.queue: deque[Request] = deque()
        self.slots: list[Request | None] = [None] * num_slots
        self.pos = np.zeros(num_slots, np.int64)       # per-slot lengths
        self.cache = model.init_cache(params, num_slots, max_seq)
        self._recurrent = _recurrent_leaves(self.cache)
        self._graph = None       # (graph, tokens, positions, logits)
        self.steps = 0

    # ------------------------------------------------------------- API
    def submit(self, req: Request) -> None:
        if req.total_budget > self.max_seq:
            raise ValueError(f"request {req.uid} exceeds max_seq")
        self.queue.append(req)

    def run(self, max_steps: int = 10_000) -> list[Request]:
        finished: list[Request] = []
        while (self.queue or any(self.slots)) and self.steps < max_steps:
            finished.extend(self.step())
        return finished

    # ------------------------------------------------------------ core
    def _admit(self) -> None:
        for s in range(self.num_slots):
            if self.slots[s] is None and self.queue:
                self.slots[s] = self.queue.popleft()
                self.pos[s] = 0
                # Position masking resets the slot's KV entries; a Mamba
                # layer's state has no position, so it is zeroed.
                for leaf in self._recurrent:
                    leaf[:, s].zero_()

    def _next_inputs(self) -> np.ndarray:
        toks = np.zeros((self.num_slots, 1), np.int32)
        for s, req in enumerate(self.slots):
            if req is None:
                continue
            p = self.pos[s]
            if p < len(req.prompt):
                toks[s, 0] = req.prompt[p]          # prompt ingestion
            elif req.output:
                toks[s, 0] = req.output[-1]         # autoregressive
            else:
                toks[s, 0] = req.prompt[-1]
        return toks

    def _decode(self, toks: torch.Tensor, pos: torch.Tensor
                ) -> torch.Tensor:
        """One decode of every slot; returns logits (B, 1, V).  On the
        card the first call runs eagerly on a side stream (it warms cuBLAS
        up, as a capture requires) and the second captures the step."""
        if self.device.type != "cuda":
            return self.model.decode_step(self.params, toks, self.cache,
                                          pos)[0]
        if self._graph is None:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                logits = self.model.decode_step(self.params, toks,
                                                self.cache, pos)[0]
            torch.cuda.current_stream(self.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            self._graph = (graph, toks.clone(), pos.clone(), None)
            return logits
        graph, st_toks, st_pos, st_logits = self._graph
        st_toks.copy_(toks)
        st_pos.copy_(pos)
        if st_logits is None:
            with torch.cuda.graph(graph):
                st_logits = self.model.decode_step(self.params, st_toks,
                                                   self.cache, st_pos)[0]
            self._graph = (graph, st_toks, st_pos, st_logits)
        graph.replay()
        return st_logits

    def step(self) -> list[Request]:
        """One engine step: admit → one ragged decode → harvest.

        Every slot decodes at its own position (``decode_step`` takes a
        (B,) position vector); idle slots decode a dummy token, harmless
        since an admitted request rewrites its slot from position 0.
        """
        self._admit()
        if not any(self.slots):
            return []
        toks = torch.from_numpy(self._next_inputs()).to(self.device)
        pos_vec = torch.from_numpy(self.pos).to(self.device)
        with torch.no_grad():
            logits = self._decode(toks, pos_vec)
            self.key, sub = split_t(self.key)
            out_tok = sample(sub, logits[:, -1], self.sampler).cpu().numpy()
        finished: list[Request] = []
        for s, req in enumerate(self.slots):
            if req is None:
                continue
            self.pos[s] += 1
            if self.pos[s] >= len(req.prompt):
                req.output.append(int(out_tok[s]))
                if (len(req.output) >= req.max_new_tokens
                        or (self.eos_id is not None
                            and req.output[-1] == self.eos_id)
                        or self.pos[s] >= self.max_seq - 1):
                    req.done = True
                    finished.append(req)
                    self.slots[s] = None
        self.steps += 1
        return finished
