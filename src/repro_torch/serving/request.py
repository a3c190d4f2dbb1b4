"""RequestSpec: the request-description type of every submit surface (port
of repro/serving/request.py, greedy only).

A frozen description, not state: progress lives on
`serving.scheduler.Request`.  The prompt is normalized to a read-only int32
ndarray at construction.  Sampling and priority classes are not ported
yet, so every request is greedy and interactive.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["GREEDY", "RequestSpec", "SamplingParams"]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Token-sampling knobs; only greedy argmax (temperature 0) is ported."""

    temperature: float = 0.0

    def __post_init__(self):
        if self.temperature > 0.0:
            raise NotImplementedError("sampling slice")


GREEDY = SamplingParams()


@dataclasses.dataclass(frozen=True, eq=False)
class RequestSpec:
    """Immutable description of one generation request."""

    prompt: np.ndarray
    max_new: int
    eos_token: Optional[int] = None
    sampling: SamplingParams = GREEDY

    def __post_init__(self):
        arr = np.ascontiguousarray(np.asarray(self.prompt, np.int32).ravel())
        arr.flags.writeable = False
        object.__setattr__(self, "prompt", arr)
        if arr.size == 0:
            raise ValueError("empty prompt")
        if self.max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {self.max_new}")
        if not isinstance(self.sampling, SamplingParams):
            raise TypeError("sampling must be a SamplingParams, got "
                            f"{type(self.sampling).__name__}")

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])
