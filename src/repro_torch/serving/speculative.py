"""Self-speculative drafting: prompt-lookup / n-gram proposal (copy of
repro/serving/speculative.py).

Speculative decoding is the serving stack's answer to the paper's core
diagnosis — utilization, not peak compute, is what a decode loop loses.
Each decode tick runs every hot matmul as an M=slots GEMV; the drafter
proposes up to K likely next tokens per request, and one batched
``paged_verify_step`` scores all of them at M = slots * (K + 1) — K
sequential starved ticks folded into one well-fed GEMM (the
reference's README maps this onto the paper's output buffering / input
pre-fetching).

The drafter here is deliberately *model-free*: prompt lookup (n-gram
matching over the request's own token history).  No second model means no
extra weights, no extra compile, and a drafter cheap enough for the CPU CI
host — while still capturing the regime speculative decoding wins in
(repetitive continuations: code, structured text, copied spans).  Greedy
verification makes the output token-identical to non-speculative decoding
whatever the drafter proposes; a bad draft only costs the wasted columns of
one GEMM.

Verification contract under sampling (models/model.py
``paged_verify_sample_step``): the n-gram drafter is a deterministic
point-mass proposal, so stochastic rejection sampling reduces to accepting
draft token ``d_j`` with probability ``p̃(d_j)`` — the model's
temperature/top-k/top-p-adjusted probability of the drafted token — drawn
against a per-(seed, position) uniform.  On first rejection the replacement
token resamples from ``p̃`` with the rejected draft token masked out, which
makes every emitted position exactly ``p̃``-distributed: the same law a
non-speculative sampled decode of that request would produce (though not
the same draw, since the uniforms are consumed in a different pattern).
Greedy requests (``temperature <= 0``) degenerate to the argmax accept
rule above — token-identical to ``paged_verify_step``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative-decoding knobs.

    k           — max drafted tokens per request per tick (the verify GEMM
                  covers k + 1 positions worst-case).
    ngram_max   — longest history suffix the drafter tries to match.
    ngram_min   — shortest suffix worth matching; below this, proposals are
                  noise and every miss wastes a verify column.
    corpus_size — recently *committed* streams (prompt + generated tokens of
                  finished requests) the drafter may also match against, most
                  recent first; 0 keeps drafting strictly per-request.
                  Greedy decoding is deterministic, so repeat/templated
                  traffic — regeneration storms, shared templates, the same
                  workloads prefix caching targets — re-generates streams the
                  corpus already holds, and lookups there draft the *true*
                  continuation (acceptance ~1).
    """

    k: int = 4
    ngram_max: int = 3
    ngram_min: int = 2
    corpus_size: int = 8

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"speculative k must be >= 1, got {self.k}")
        if not 1 <= self.ngram_min <= self.ngram_max:
            raise ValueError(
                f"need 1 <= ngram_min <= ngram_max, got "
                f"{self.ngram_min}..{self.ngram_max}")
        if self.corpus_size < 0:
            raise ValueError(f"corpus_size must be >= 0, got {self.corpus_size}")


def coerce_spec(value: Union[None, bool, int, SpecConfig]) -> Optional[SpecConfig]:
    """Engine(speculative=...) sugar: False/None -> off, True -> defaults,
    int -> draft length K, SpecConfig -> itself."""
    if value is None or value is False:
        return None
    if value is True:
        return SpecConfig()
    if isinstance(value, int):
        return SpecConfig(k=value)
    if isinstance(value, SpecConfig):
        return value
    raise TypeError(f"speculative must be bool, int or SpecConfig, "
                    f"got {type(value).__name__}")


class NgramDrafter:
    """Prompt-lookup drafter: propose the continuation of the most recent
    earlier occurrence of the history's suffix n-gram — in the request's own
    token history first, then in the engine's recent-stream corpus.

    Pure host-side numpy over int32 token ids; deterministic — the same
    history and corpus always draft the same tokens, so speculative-on runs
    are reproducible (and whatever is drafted, greedy verification keeps the
    committed tokens exact).
    """

    def __init__(self, config: SpecConfig):
        self.config = config
        self._corpus: list = []            # most recent last
        # Lookup economics: how often drafting was attempted,
        # how often it proposed anything, and how many tokens it proposed.
        self.draft_calls = 0
        self.draft_hits = 0
        self.drafted_tokens = 0

    @property
    def hit_rate(self) -> float:
        """Fraction of draft() calls that proposed at least one token."""
        return self.draft_hits / self.draft_calls if self.draft_calls else 0.0

    def remember(self, stream: np.ndarray) -> None:
        """Retain a committed stream (prompt + generated tokens of a
        finished request) for cross-request lookup."""
        if self.config.corpus_size < 1:
            return
        self._corpus.append(np.asarray(stream, np.int32))
        if len(self._corpus) > self.config.corpus_size:
            del self._corpus[0]

    @staticmethod
    def _lookup(hay: np.ndarray, suffix: np.ndarray, k: int,
                exclude_tail: bool) -> Optional[np.ndarray]:
        """Continuation after the most recent occurrence of `suffix` in
        `hay` (None if absent).  ``exclude_tail`` drops the trivial
        self-match of a history against its own suffix by requiring at
        least one continuation token."""
        n = len(suffix)
        end = len(hay) - 1 if exclude_tail else len(hay)
        if end < n:
            return None
        windows = np.lib.stride_tricks.sliding_window_view(hay[:end], n)
        hits = np.nonzero((windows == suffix).all(axis=1))[0]
        if len(hits) == 0:
            return None
        start = int(hits[-1]) + n
        proposal = hay[start:start + k]
        return proposal if len(proposal) else None

    def draft(self, context: np.ndarray, k: Optional[int] = None) -> np.ndarray:
        """Propose up to k tokens following `context` (1-D int32 history:
        prompt + generated so far).  Returns a possibly-empty (d,) array,
        d <= k; empty means "no match — decode normally this tick".

        Longer suffix matches win over shorter; at equal length the
        request's own history wins over the corpus, and more recent corpus
        streams over older ones."""
        cfg = self.config
        k = cfg.k if k is None else min(k, cfg.k)
        context = np.asarray(context, np.int32)
        L = len(context)
        self.draft_calls += 1
        if k < 1 or L < 1:
            return np.empty((0,), np.int32)
        for n in range(min(cfg.ngram_max, L), cfg.ngram_min - 1, -1):
            suffix = context[L - n:]
            found = self._lookup(context, suffix, k, exclude_tail=True)
            if found is None:
                for stream in reversed(self._corpus):
                    found = self._lookup(stream, suffix, k, exclude_tail=False)
                    if found is not None:
                        break
            if found is not None:
                self.draft_hits += 1
                self.drafted_tokens += len(found)
                return np.asarray(found, np.int32)
        return np.empty((0,), np.int32)


def verify_buckets(k: int) -> list:
    """Verify-step token widths (S = drafts + 1) the engine pre-compiles:
    power-of-two draft lengths up to k, plus k itself — the same
    finite-bucket trick as prefill chunks, so every verify shape the server
    can ever dispatch is AOT-compiled during warmup."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    widths = set()
    d = 1
    while d < k:
        widths.add(d + 1)
        d *= 2
    widths.add(k + 1)
    return sorted(widths)


def bucket_for(draft_len: int, k: int) -> int:
    """Smallest pre-compiled verify width covering draft_len drafts."""
    for s in verify_buckets(k):
        if s >= draft_len + 1:
            return s
    raise ValueError(f"draft of {draft_len} exceeds k={k}")
