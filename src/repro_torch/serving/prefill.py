"""Chunked-prefill planning: power-of-two chunk schedules (copy of
repro/serving/prefill.py).

A prompt of length L is processed in chunks drawn from {C, C/2, ..., 1}
(C = the engine's max chunk), largest first, so every chunk is exact — no
padding tokens — and the set of chunk shapes the engine can ever run is
known before traffic (warmup runs each once).
"""

from __future__ import annotations

from typing import List


def _pow2_floor(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def chunk_buckets(max_chunk: int) -> List[int]:
    """Every chunk size the planner can emit, descending: C, C/2, ..., 1."""
    if max_chunk < 1:
        raise ValueError(f"max_chunk must be >= 1, got {max_chunk}")
    c = _pow2_floor(max_chunk)
    out = []
    while c >= 1:
        out.append(c)
        c //= 2
    return out


def plan_chunks(prompt_len: int, max_chunk: int) -> List[int]:
    """Chunk schedule for one prompt: greedy largest power-of-two <= remaining."""
    if prompt_len < 0:
        raise ValueError(f"prompt_len must be >= 0, got {prompt_len}")
    cap = _pow2_floor(max_chunk)
    plan, rest = [], prompt_len
    while rest:
        c = min(cap, _pow2_floor(rest))
        plan.append(c)
        rest -= c
    return plan


def next_chunk(remaining: int, max_chunk: int) -> int:
    """First entry of plan_chunks(remaining, max_chunk) (0 when done)."""
    if remaining <= 0:
        return 0
    return min(_pow2_floor(max_chunk), _pow2_floor(remaining))
