"""Batched serving engine: request queue -> fixed-slot batch -> decode loop.

Ported from ``repro.serve.engine`` (``Request``, ``ServeEngine`` with
``submit``, ``step``, ``run_until_drained`` and the pre-warmed decode and
worst-case prefill dispatch plans).  The adaptive re-planner, elastic
resizing, the obs/refit loop and ``verify`` are still to port (ROADMAP
Queue 1 item 7).

Static batch slots: requests are admitted into free slots and the whole
batch prefills together (each active slot re-presents its full history as
its prompt, right-aligned, so every slot's cache is exact after admission);
then the batch decodes one token per slot per step, and finished slots are
recycled.  Greedy sampling (argmax).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..core.cache import default_plan_cache
from ..models import serving
from ..models.lm import Model


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [T] int32
    max_new_tokens: int
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, model: Model, params, batch_slots: int = 4,
                 max_len: int = 256):
        self.model = model
        self.params = params
        self.B = batch_slots
        self.max_len = max_len
        self.slots: List[Optional[Request]] = [None] * batch_slots
        self.queue: List[Request] = []
        self.caches = None
        self.cur_len = 0
        self._next_tok = np.zeros((batch_slots, 1), np.int32)
        # MoE dispatch planning is hoisted out of the decode loop: the
        # decode plan (one token per slot) is built here and every decode
        # step hits it; prefill dispatch is planned once for the worst case
        # (B * max_len tokens) and pinned, so re-prefills at every history
        # length share one plan-cache entry.  The other families dispatch
        # nothing.
        self.plan_cache = default_plan_cache()
        self.moe_plan = self.moe_prefill_plan = None
        if model.cfg.family == "moe":
            self.moe_plan = serving.moe_plan_for_model(
                model, self.B, cache=self.plan_cache)
            self.moe_prefill_plan = serving.moe_plan_for_model(
                model, self.B * self.max_len, cache=self.plan_cache)

    def _prefill(self, params, inputs):
        return serving.prefill(self.model, params, inputs,
                               max_len=self.max_len,
                               moe_plan=self.moe_prefill_plan)

    def _decode(self, params, inputs, caches, cur_len):
        return serving.decode_step(self.model, params, inputs, caches,
                                   cur_len)

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> bool:
        """Admit queued requests into free slots and (re)prefill the batch."""
        free = [i for i, s in enumerate(self.slots) if s is None]
        if not free or not self.queue:
            return False
        while free and self.queue:
            self.slots[free.pop(0)] = self.queue.pop(0)
        self._prefill_slots()
        return True

    def _prefill_slots(self) -> None:
        """(Re)prefill the batch from the slots' host-side histories."""
        seqs = []
        for s in self.slots:
            if s is None:
                seqs.append(np.zeros((1,), np.int32))
            else:
                seqs.append(np.concatenate(
                    [s.prompt, np.asarray(s.generated, np.int32)]))
        T = max(len(x) for x in seqs)
        toks = np.zeros((self.B, T), np.int32)
        for i, x in enumerate(seqs):
            toks[i, T - len(x):] = x  # right-align so the last token is real
        logits, self.caches = self._prefill(
            self.params,
            {"tokens": torch.as_tensor(toks, device=self.model.device)})
        self.cur_len = T
        self._next_tok = torch.argmax(logits, dim=-1).to(
            torch.int32).cpu().numpy()[:, None]

    def step(self) -> List[Request]:
        """One engine step: admit if possible, then decode one token for the
        active batch.  Returns the requests completed this step."""
        finished: List[Request] = []
        if any(s is None for s in self.slots) and self.queue:
            self._admit()
        if self.caches is None:
            return finished
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return finished
        for i in active:
            self.slots[i].generated.append(int(self._next_tok[i, 0]))
        logits, self.caches = self._decode(
            self.params,
            {"tokens": torch.as_tensor(self._next_tok,
                                       device=self.model.device)},
            self.caches, self.cur_len)
        self.cur_len += 1
        self._next_tok = torch.argmax(logits, dim=-1).to(
            torch.int32).cpu().numpy()[:, None]
        for i in active:
            s = self.slots[i]
            if (len(s.generated) >= s.max_new_tokens
                    or self.cur_len >= self.max_len - 1):
                s.done = True
                finished.append(s)
                self.slots[i] = None
        return finished

    def run_until_drained(self, max_steps: int = 10_000) -> List[Request]:
        done: List[Request] = []
        for _ in range(max_steps):
            done.extend(self.step())
            if not self.queue and all(s is None for s in self.slots):
                break
        return done
