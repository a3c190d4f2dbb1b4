"""Request scheduler: admission queues, slot assignment, continuous
batching (port of repro/serving/scheduler.py).

Pure host-side policy.  Each tick the engine asks for one action:

  ("prefill", request, chunk_len)  — advance one request's prompt by one
                                     exact power-of-two chunk
  ("decode", [requests])           — one decode step for every slot in the
                                     DECODE phase
  None                             — nothing runnable

Prefill chunks and decode batches alternate, so a slot mid-prefill never
starves the decoding slots and vice versa.  Admission is gated by the
engine's block-reservation check and is class-aware: one FIFO deque per
priority class (`request.PRIORITIES`, best first), drained strictly by
class rank.  A blocked head blocks everything behind it, lower classes
included, so freed blocks always go to the most urgent waiter.  `preempt`
returns a decoding victim to the front of its class queue with its
progress intact; the engine swaps its KV blocks to host memory and
restores them when the victim is admitted again (straight back to DECODE).
"""

from __future__ import annotations

import dataclasses
import enum
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.prefill import next_chunk
from repro_torch.serving.request import (GREEDY, PRIORITIES, RequestSpec,
                                         SamplingParams)


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
    cached_tokens: int = 0             # prompt tokens covered by a shared KV
                                       # prefix at admission
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    submit_step: int = 0
    first_token_step: Optional[int] = None
    finish_step: Optional[int] = None
    # -- speculative decoding accounting --
    spec_drafted: int = 0              # draft tokens proposed over its life
    spec_accepted: int = 0             # draft tokens verification accepted
    # -- from the RequestSpec --
    sampling: SamplingParams = GREEDY
    sample_seed: int = 0               # resolved: the spec's seed, else rid
    priority: str = PRIORITIES[0]
    tenant: str = "default"
    preemptions: int = 0               # times this request was swapped out
    swapped: bool = False              # queued with its KV parked on the host

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def remaining(self) -> int:
        """Tokens this request may still emit."""
        return self.max_new - len(self.out_tokens)

    @property
    def context(self) -> np.ndarray:
        """The committed token history (prompt + generated): what the
        self-speculative drafter matches n-grams over."""
        if not self.out_tokens:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.out_tokens, np.int32)])

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
    """Slot-based continuous batching with per-class FIFO admission."""

    def __init__(self, slots: int, *, max_chunk: int = 32,
                 max_queue: Optional[int] = None):
        self.n_slots = slots
        self.max_chunk = max_chunk
        self.max_queue = max_queue
        self.queues: Dict[str, Deque[Request]] = {p: deque() for p in PRIORITIES}
        self.slots: List[Optional[Request]] = [None] * slots
        self._next_rid = 0
        self._prefer_prefill = True   # round-robin flip between phases
        self.rejected = 0
        self.admitted_total = 0       # requests that ever reached a slot
        self.peak_queue_depth = 0     # admission-queue high-water mark
        self.preemptions = 0          # decode slots returned to the queue

    @property
    def queue(self) -> List[Request]:
        """Queued requests in admission order (class rank, then FIFO); a
        view, the storage is `queues`."""
        out: List[Request] = []
        for p in PRIORITIES:
            out.extend(self.queues[p])
        return out

    # -- admission -----------------------------------------------------------

    def submit(self, spec: RequestSpec, *, step: int = 0) -> Optional[Request]:
        """Enqueue a request; None when the admission queue is full."""
        depth = sum(len(q) for q in self.queues.values())
        if self.max_queue is not None and depth >= self.max_queue:
            self.rejected += 1
            return None
        rid = self._next_rid
        seed = spec.sampling.seed if spec.sampling.seed is not None else rid
        req = Request(rid=rid, prompt=spec.prompt, max_new=spec.max_new,
                      eos_token=spec.eos_token, submit_step=step,
                      sampling=spec.sampling, sample_seed=int(seed),
                      priority=spec.priority, tenant=spec.tenant)
        self._next_rid += 1
        self.queues[spec.priority].append(req)
        self.peak_queue_depth = max(self.peak_queue_depth, depth + 1)
        return req

    def next_queued(self) -> Optional[Request]:
        """The request the next free slot would admit (head of the best
        non-empty class queue), or None."""
        for p in PRIORITIES:
            if self.queues[p]:
                return self.queues[p][0]
        return None

    def admit(self, can_admit: Callable[[Request], bool]
              ) -> List[Tuple[int, Request]]:
        """Move queued requests into free slots while `can_admit` (the
        engine's block-reservation check) allows, best class first, FIFO
        within a class; a blocked head blocks every class behind it."""
        admitted = []
        for slot in range(self.n_slots):
            if self.slots[slot] is not None:
                continue
            head = self.next_queued()
            if head is None or not can_admit(head):
                break
            req = self.queues[head.priority].popleft()
            if req.swapped:
                # A preempted victim: the engine restores its cache, so it
                # resumes decoding with its progress.
                req.slot, req.phase = slot, Phase.DECODE
            else:
                # Prefill starts after a shared KV prefix the admission
                # check may have found (req.cached_tokens).
                req.slot, req.phase = slot, Phase.PREFILL
                req.prefilled = req.cached_tokens
                self.admitted_total += 1
            self.slots[slot] = req
            admitted.append((slot, req))
        return admitted

    def preempt(self, req: Request) -> int:
        """Evict a decoding request to the front of its class queue (the
        engine swaps its KV out); returns the freed slot."""
        slot = req.slot
        assert self.slots[slot] is req and req.phase is Phase.DECODE
        self.slots[slot] = None
        req.slot = -1
        req.phase = Phase.QUEUED
        req.preemptions += 1
        req.swapped = True
        self.queues[req.priority].appendleft(req)
        self.preemptions += 1
        return slot

    # -- tick policy ---------------------------------------------------------

    def prefilling(self) -> List[Request]:
        return [r for r in self.slots if r is not None and r.phase is Phase.PREFILL]

    def decoding(self) -> List[Request]:
        return [r for r in self.slots if r is not None and r.phase is Phase.DECODE]

    @property
    def has_work(self) -> bool:
        return (any(self.queues.values())
                or any(r is not None for r in self.slots))

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
            req.finish_step = step

    def on_spec(self, req: Request, drafted: int, accepted: int) -> None:
        """Account one speculative verification: `drafted` tokens were
        proposed, `accepted` of them survived (the committed tokens still
        go through on_token)."""
        req.spec_drafted += drafted
        req.spec_accepted += accepted

    def release(self, req: Request) -> int:
        """Detach a finished request from its slot; returns the slot."""
        slot = req.slot
        assert self.slots[slot] is req
        self.slots[slot] = None
        req.slot = -1
        return slot
