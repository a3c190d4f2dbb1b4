"""Request scheduler: admission queue, slot assignment, continuous batching
(port of repro/serving/scheduler.py, one priority class, no preemption).

Pure host-side policy.  Each tick the engine asks for one action:

  ("prefill", request, chunk_len)  — advance one request's prompt by one
                                     exact power-of-two chunk
  ("decode", [requests])           — one decode step for every slot in the
                                     DECODE phase
  None                             — nothing runnable

Prefill chunks and decode batches alternate, so a slot mid-prefill never
starves the decoding slots and vice versa.  Admission is FIFO and gated by
the engine's block-reservation check: a blocked head blocks everything
behind it.
"""

from __future__ import annotations

import dataclasses
import enum
from collections import deque
from typing import Callable, Deque, List, Optional, Tuple

import numpy as np

from repro_torch.serving.prefill import next_chunk
from repro_torch.serving.request import RequestSpec


class Phase(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    FINISHED = "finished"


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (L,) int32
    max_new: int
    eos_token: Optional[int] = None
    # -- filled in by the scheduler/engine --
    phase: Phase = Phase.QUEUED
    slot: int = -1
    prefilled: int = 0                 # prompt tokens already in the cache
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    submit_step: int = 0
    first_token_step: Optional[int] = None

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def length(self) -> int:
        """Tokens currently held in the slot's cache."""
        return self.prefilled + len(self.out_tokens)

    @property
    def done(self) -> bool:
        if len(self.out_tokens) >= self.max_new:
            return True
        return bool(self.out_tokens) and self.out_tokens[-1] == self.eos_token


class Scheduler:
    """Slot-based continuous batching with FIFO admission."""

    def __init__(self, slots: int, *, max_chunk: int = 32,
                 max_queue: Optional[int] = None):
        self.n_slots = slots
        self.max_chunk = max_chunk
        self.max_queue = max_queue
        self.queue: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * slots
        self._next_rid = 0
        self._prefer_prefill = True   # round-robin flip between phases
        self.rejected = 0

    # -- admission -----------------------------------------------------------

    def submit(self, spec: RequestSpec, *, step: int = 0) -> Optional[Request]:
        """Enqueue a request; None when the admission queue is full."""
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            self.rejected += 1
            return None
        req = Request(rid=self._next_rid, prompt=spec.prompt,
                      max_new=spec.max_new, eos_token=spec.eos_token,
                      submit_step=step)
        self._next_rid += 1
        self.queue.append(req)
        return req

    def admit(self, can_admit: Callable[[Request], bool]
              ) -> List[Tuple[int, Request]]:
        """Move queued requests into free slots while `can_admit` (the
        engine's block-reservation check) allows, in FIFO order."""
        admitted = []
        for slot in range(self.n_slots):
            if self.slots[slot] is not None:
                continue
            if not self.queue or not can_admit(self.queue[0]):
                break
            req = self.queue.popleft()
            req.slot, req.phase = slot, Phase.PREFILL
            self.slots[slot] = req
            admitted.append((slot, req))
        return admitted

    # -- tick policy ---------------------------------------------------------

    def prefilling(self) -> List[Request]:
        return [r for r in self.slots if r is not None and r.phase is Phase.PREFILL]

    def decoding(self) -> List[Request]:
        return [r for r in self.slots if r is not None and r.phase is Phase.DECODE]

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slots)

    def next_action(self):
        pre, dec = self.prefilling(), self.decoding()
        if pre and (self._prefer_prefill or not dec):
            self._prefer_prefill = False
            req = pre[0]
            chunk = next_chunk(req.prompt_len - req.prefilled, self.max_chunk)
            return ("prefill", req, chunk)
        self._prefer_prefill = True
        if dec:
            return ("decode", dec)
        return None

    # -- bookkeeping (engine callbacks) --------------------------------------

    def on_prefill(self, req: Request, chunk: int, step: int) -> None:
        req.prefilled += chunk
        if req.prefilled >= req.prompt_len:
            req.phase = Phase.DECODE

    def on_token(self, req: Request, token: int, step: int) -> None:
        if req.first_token_step is None:
            req.first_token_step = step
        req.out_tokens.append(int(token))
        if req.done:
            req.phase = Phase.FINISHED

    def release(self, req: Request) -> int:
        """Detach a finished request from its slot; returns the slot."""
        slot = req.slot
        assert self.slots[slot] is req
        self.slots[slot] = None
        req.slot = -1
        return slot
