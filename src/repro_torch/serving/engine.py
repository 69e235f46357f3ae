"""Batched serving engine: request queue and continuous slot-based
batching, the counterpart of the reference's ``serving/engine.py``.

A fixed pool of B decode slots shares one ``serve_step``. Requests are
admitted into free slots and their prompts fed token by token through
the same step ("prefill as decode", which is how recurrent archs prefill
anyway); each loop iteration decodes one token for every active slot;
finished slots (eos or max_tokens) are freed and refilled from the
queue. Greedy sampling.

Slot reset differs from the reference on purpose. The reference zeroes
slot i on the first axis of each state field whose length equals the
slot count (``src/repro/serving/engine.py:91-105``). The transformer
cache ``k``/``v`` is (num_layers, B, size, KV, hd), the RWKV state
``wkv`` is (num_layers, B, H, hd, hd) and Zamba2's ``ssm``/``conv`` are
(num_layers, B, ...) and its ``k``/``v`` (sites, B, ...), so when the
slot count equals the number of layers (28 slots on qwen2-1.5b, 24 on
rwkv6-1.6b) or of sites (7 on zamba2-1.2b) the reference zeroes layer
or site i of every slot instead of slot i. This engine
resets each field along its known batch axis
(``registry.state_batch_axes``), which equals the reference for every
slot count that does not collide with another axis.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import registry as R


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_tokens: int = 16
    eos_id: Optional[int] = None
    # filled by the engine
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    submitted_at: float = 0.0
    finished_at: float = 0.0


@dataclasses.dataclass
class _Slot:
    request: Optional[Request] = None
    remaining_prompt: Deque[int] = dataclasses.field(default_factory=deque)

    @property
    def active(self) -> bool:
        return self.request is not None


class ServingEngine:
    """Continuous batching over a fixed decode-slot pool, on the device
    of ``params``."""

    def __init__(self, cfg: ModelConfig, params, batch_slots: int = 4,
                 max_len: int = 256, window: int = 0):
        self.cfg = cfg
        self.params = params
        self.b = batch_slots
        self.max_len = max_len
        self.window = window
        self.device = params["embed"].device
        self.state = R.init_serve_state(cfg, batch_slots, max_len,
                                        window=window, device=self.device)
        self._fresh = R.init_serve_state(cfg, 1, max_len, window=window,
                                         device=self.device)
        self._axes = R.state_batch_axes(cfg)
        self.slots = [_Slot() for _ in range(batch_slots)]
        self.queue: Deque[Request] = deque()
        self._uid = 0
        self.stats: Dict[str, float] = {"steps": 0, "tokens_out": 0}

    # -- public API -----------------------------------------------------------

    def submit(self, prompt: List[int], max_tokens: int = 16,
               eos_id: Optional[int] = None) -> Request:
        self._uid += 1
        req = Request(uid=self._uid, prompt=list(prompt),
                      max_tokens=max_tokens, eos_id=eos_id,
                      submitted_at=time.time())
        self.queue.append(req)
        return req

    def run(self, max_steps: int = 10_000) -> List[Request]:
        """Drive the loop until the queue and all slots drain."""
        finished: List[Request] = []
        for _ in range(max_steps):
            self._admit()
            if not any(s.active for s in self.slots):
                break
            finished.extend(self._decode_one())
        return finished

    # -- internals ------------------------------------------------------------

    def _reset_slot_state(self, i: int) -> None:
        """Slot i's lanes of every state field back to a fresh state's,
        along the field's batch axis (in place)."""
        for name, axis in self._axes.items():
            self.state[name].select(axis, i).copy_(
                self._fresh[name].select(axis, 0))

    def _admit(self) -> None:
        for i, slot in enumerate(self.slots):
            if slot.active or not self.queue:
                continue
            req = self.queue.popleft()
            slot.request = req
            slot.remaining_prompt = deque(req.prompt)
            self._reset_slot_state(i)

    def _next_tokens(self) -> np.ndarray:
        toks = np.zeros((self.b, 1), np.int32)
        for i, slot in enumerate(self.slots):
            if not slot.active:
                continue
            if slot.remaining_prompt:
                toks[i, 0] = slot.remaining_prompt[0]
            elif slot.request.output:
                toks[i, 0] = slot.request.output[-1]
            else:
                toks[i, 0] = slot.request.prompt[-1]
        return toks

    def _decode_one(self) -> List[Request]:
        toks = torch.as_tensor(self._next_tokens(), device=self.device)
        logits, self.state = R.serve_step(self.params, self.cfg, toks,
                                          self.state, window=self.window)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32).cpu()
        nxt = nxt.numpy()
        self.stats["steps"] += 1
        finished: List[Request] = []
        for i, slot in enumerate(self.slots):
            if not slot.active:
                continue
            req = slot.request
            if slot.remaining_prompt:
                slot.remaining_prompt.popleft()
                if slot.remaining_prompt:
                    continue            # still prefilling
            # prompt consumed: the model just produced a generation token
            req.output.append(int(nxt[i]))
            self.stats["tokens_out"] += 1
            if (len(req.output) >= req.max_tokens
                    or (req.eos_id is not None
                        and req.output[-1] == req.eos_id)):
                req.done = True
                req.finished_at = time.time()
                finished.append(req)
                slot.request = None
        return finished
