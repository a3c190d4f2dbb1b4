"""RequestSpec: the request-description type of every submit surface (port
of repro/serving/request.py): `Engine.submit`, `Scheduler.submit` and
`cluster.Router.submit`, with the legacy `(prompt, max_new)` form shimmed
through `as_spec`.

A frozen description, not state: progress lives on
`serving.scheduler.Request`.  `trace_id` carries an id minted outside the
engine (the cluster router's request id) into the request's flow chain.  The prompt is normalized to a read-only int32
ndarray at construction.  `SamplingParams` defaults to greedy, so a default
spec takes the greedy steps token for token; `seed=None` derives the
request's random stream from its id.  Priority classes are a fixed ordered
vocabulary (`PRIORITIES`, best first): the scheduler admits by class rank
and preemption evicts only strictly lower classes.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

import numpy as np

__all__ = ["GREEDY", "PRIORITIES", "RequestSpec", "SamplingParams", "as_spec",
           "priority_rank"]

# Admission order, best first: rank 0 preempts rank 1, never the reverse.
PRIORITIES: Tuple[str, ...] = ("interactive", "batch")
_RANK = {p: i for i, p in enumerate(PRIORITIES)}


def priority_rank(priority: str) -> int:
    """Smaller is more urgent.  Raises on an unknown class name."""
    try:
        return _RANK[priority]
    except KeyError:
        raise ValueError(
            f"unknown priority class {priority!r}; expected one of "
            f"{PRIORITIES}") from None


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Token-sampling knobs.  `temperature <= 0` selects greedy argmax;
    `top_k=0` / `top_p=1.0` disable the truncations.  `seed=None` derives
    the stream from the request id at submit time."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None

    def __post_init__(self):
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")

    @property
    def is_greedy(self) -> bool:
        return self.temperature <= 0.0


GREEDY = SamplingParams()


@dataclasses.dataclass(frozen=True, eq=False)
class RequestSpec:
    """Immutable description of one generation request."""

    prompt: np.ndarray
    max_new: int
    eos_token: Optional[int] = None
    sampling: SamplingParams = GREEDY
    priority: str = "interactive"
    tenant: str = "default"
    trace_id: Optional[int] = None

    def __post_init__(self):
        arr = np.ascontiguousarray(np.asarray(self.prompt, np.int32).ravel())
        arr.flags.writeable = False
        object.__setattr__(self, "prompt", arr)
        if arr.size == 0:
            raise ValueError("empty prompt")
        if self.max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {self.max_new}")
        priority_rank(self.priority)          # validate the class name
        if not isinstance(self.sampling, SamplingParams):
            raise TypeError("sampling must be a SamplingParams, got "
                            f"{type(self.sampling).__name__}")

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])


def as_spec(request, max_new: Optional[int] = None, *,
            eos_token: Optional[int] = None, trace_id: Optional[int] = None
            ) -> RequestSpec:
    """A submit argument as a `RequestSpec`.  A spec passes through (the
    keywords must not contradict it; a `trace_id` fills an unset one); a
    bare token array with `max_new` (and `eos_token`) builds a greedy spec
    and warns that the form is deprecated."""
    if isinstance(request, RequestSpec):
        if max_new is not None and max_new != request.max_new:
            raise TypeError("pass max_new inside the RequestSpec, not alongside it")
        if eos_token is not None and eos_token != request.eos_token:
            raise TypeError("pass eos_token inside the RequestSpec, not alongside it")
        if trace_id is not None and request.trace_id is None:
            return dataclasses.replace(request, trace_id=trace_id)
        return request
    if max_new is None:
        raise TypeError("legacy submit(prompt, max_new) form requires max_new")
    warnings.warn("submit(prompt, max_new, ...) is deprecated; pass a "
                  "repro_torch.serving.request.RequestSpec instead",
                  DeprecationWarning, stacklevel=3)
    return RequestSpec(prompt=request, max_new=int(max_new), eos_token=eos_token,
                       trace_id=trace_id)
