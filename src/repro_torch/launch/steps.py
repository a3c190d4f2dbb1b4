"""The unpaged serve step (port of repro/launch/steps.py::make_serve_step)
and its CUDA graph.

The reference jits `make_serve_step(cfg)`; the port's counterpart on the
card is one CUDA graph of the step over one `DecodeState`
(`GraphedServeStep`): the step writes the dense caches and the recurrent
states in place and advances the device-held index, so every replay reads
and writes the same addresses.  The cross caches are fixed per batch, so a
graph serves one (batch, max_seq) and one batch of encoder frames.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import launches
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig


def make_serve_step(cfg: ArchConfig):
    def serve_step(params, state: M.DecodeState, tokens):
        return M.decode_step(params, cfg, state, tokens)

    return serve_step


class GraphedServeStep:
    """`make_serve_step(cfg)` captured as a CUDA graph over `state` (CUDA
    tensors only).  Calling it copies tokens (B, 1) into the graph's input
    and replays it: it returns the graph's logits buffer (valid until the
    next replay) and `state`, which the replay advanced in place.

    Capture records the step without running it, so `state` is as it was;
    the step must have run once before on this device (the kernels' build
    and one-time attribute calls, the split-K scratch).  `launches` holds
    the hand-kernel launches of one replay.  Capture under the precision
    mode the replays should run in: it binds then."""

    def __init__(self, cfg: ArchConfig, params: dict, state: M.DecodeState, batch: int):
        if state.index.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA state, got {state.index.device}")
        self.params, self.state = params, state
        self.tokens = torch.zeros((batch, 1), dtype=torch.int64, device=state.index.device)
        step = make_serve_step(cfg)
        before = launches.counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), torch.cuda.graph(self.graph):
            self.logits, _ = step(params, state, self.tokens)
        after = launches.counts()
        self.launches: Dict[str, int] = {k: after[k] - v for k, v in before.items()
                                         if after[k] != v}

    def __call__(self, params: dict, state: M.DecodeState, tokens: torch.Tensor):
        if params is not self.params or state is not self.state:
            raise ValueError("the graph was captured over other params or another state")
        self.tokens.copy_(tokens)
        self.graph.replay()
        return self.logits, state
