"""Tensor parallelism over the model axis: Megatron's operators as autograd
Functions (the port's own module: the reference has none, since GSPMD
inserts these collectives from the models' `shard` annotations).

A head-parallel plan (`ParallelPlan.model_axis` with `attn_seq` False)
holds on each model rank its columns of wq / wk / wv / w_gate / w_up /
the untied head (and qwen2.5's q / k / v biases), its rows of wo / w_down
and its rows of the embedding table (`parallel/fsdp.py`).  The models call
the operators below at the reference's annotations; each is the identity
outside `use_model_axis`, so a model function computes as it did, bit for
bit:

  * `copy_to_model`: identity forward, all-reduce backward (before a
    column-parallel product: its input's gradient is summed over the
    ranks' columns);
  * `reduce_from_model`: all-reduce forward, identity backward (after a
    row-parallel product);
  * `vocab_embed`: the lookup of a vocab-parallel table: rows outside this
    rank's range give zeros, then the ranks' rows are summed;
  * `vocab_log_likelihood`: log p(label) from (B, chunk, V / M) f32 logits:
    the max and the sum of exponentials all-reduced (max, then sum), and
    the label's log-probability all-reduced from the rank that holds it;
    at a model axis of 1 it is `torch.log_softmax` and gather, values and
    gradient, bit for bit.

Every collective runs on the model axis's process group, even at a model
axis of size 1, and is counted (calls and bytes by kind) in the counters
the `ModelAxis` was given, `Layout.collectives` in a sharded step.  On the
"meta" device a collective is counted and not run, so
`launch.step_cost.analyze` traces one rank's step without a group.
Tensors reaching a hand kernel stay plain and contiguous.

The context is thread-local, as `logical.use_rules` is; a Function keeps
the axis it ran under for its backward (which the autograd engine may run
on another thread), and `bind` carries the context into a checkpointed
function's recompute (`models.model._checkpoint`).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

_state = threading.local()


@dataclasses.dataclass
class ModelAxis:
    """The running model axis: its size, this rank's index on it, its
    process group (None: the default group; unused on the meta device) and
    the counters its collectives add to."""

    size: int
    index: int
    group: Any = None
    collectives: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    collective_bytes: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """`t` reduced over the model axis, in place."""
        self.collectives["all_reduce"] += 1
        self.collective_bytes["all_reduce"] += t.numel() * t.element_size()
        if t.device.type != "meta":
            dist.all_reduce(t, op=op, group=self.group)
        return t


def current() -> Optional[ModelAxis]:
    return getattr(_state, "axis", None)


@contextlib.contextmanager
def use_model_axis(axis: Optional[ModelAxis]):
    """Run the operators over `axis` (None: as the identity)."""
    prev = current()
    _state.axis = axis
    try:
        yield
    finally:
        _state.axis = prev


def bind(fn: Callable) -> Callable:
    """`fn` run under the model axis current now, whatever thread calls it."""
    axis = current()
    if axis is None:
        return fn

    def run(*args, **kwargs):
        with use_model_axis(axis):
            return fn(*args, **kwargs)

    return run


def _summed(t: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    return axis.all_reduce(t.clone(memory_format=torch.contiguous_format))


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.axis), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _summed(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """The input of a column-parallel product (module docstring)."""
    axis = current()
    return x if axis is None else _CopyToModel.apply(x, axis)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The sum over the model ranks of a row-parallel product's partial
    outputs (module docstring)."""
    axis = current()
    return x if axis is None else _ReduceFromModel.apply(x, axis)


def _local(labels: torch.Tensor, rows: int, axis: ModelAxis):
    """Labels as rows of this rank's vocab range, 0 outside it, and where
    they fall outside."""
    local = labels - axis.index * rows
    outside = (local < 0) | (local >= rows)
    return torch.where(outside, torch.zeros_like(local), local), outside


def vocab_embed(tokens: torch.Tensor, table: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """`table` (V / M, d) is this rank's rows of the (V, d) embedding:
    table[tokens] summed over the ranks, each giving zeros for the tokens
    it does not hold (their gradient too)."""
    local, outside = _local(tokens, table.shape[0], axis)
    x = F.embedding(local, table).masked_fill(outside[..., None], 0)
    return _ReduceFromModel.apply(x, axis)


class _VocabLogLikelihood(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, axis):
        # log_softmax over this rank's columns, shifted by delta = the whole
        # row's logsumexp - this rank's: exactly 0 at one rank, so there the
        # values and the gradient are `torch.log_softmax`'s bit for bit.
        logp = torch.log_softmax(logits, dim=-1)
        m = torch.amax(logits, dim=-1)
        sumexp = torch.sum(torch.exp(logits - m[..., None]), dim=-1)
        top = axis.all_reduce(m.clone(), op=dist.ReduceOp.MAX)
        s = axis.all_reduce(sumexp * torch.exp(m - top))
        delta = (top + torch.log(s)) - (m + torch.log(sumexp))
        local, outside = _local(labels, logits.shape[-1], axis)
        ll = torch.gather(logp, -1, local[..., None])[..., 0] - delta
        ctx.save_for_backward(logp, delta, local, outside)
        return axis.all_reduce(ll.masked_fill(outside, 0.0))

    @staticmethod
    def backward(ctx, g):
        # d ll / d logits = (onehot(label) - softmax) g: in a row whose label
        # this rank holds, log_softmax's own backward of the row's log p
        # (this rank's less delta); in another row, - softmax g.
        logp, delta, local, outside = ctx.saved_tensors
        out = logp - delta[..., None]
        onehot = torch.zeros_like(logp).scatter_(
            -1, local[..., None], torch.where(outside, 0.0, g)[..., None])
        d = torch._log_softmax_backward_data(onehot, out, -1, logp.dtype)
        return torch.where(outside[..., None], -(torch.exp(out) * g[..., None]), d), None, None


def vocab_log_likelihood(logits: torch.Tensor, labels: torch.Tensor,
                         axis: ModelAxis) -> torch.Tensor:
    """log softmax(logits)[label] over the whole vocabulary from this
    rank's (B, chunk, V / M) f32 logits (vocab rows index * V / M onward),
    labels (B, chunk) int64: this rank's log_softmax less the difference of
    the row's logsumexp and this rank's, taken from the rank that holds
    the label.  The max and the sum of exponentials (rescaled to the
    row's max) are all-reduced, then the label's term."""
    return _VocabLogLikelihood.apply(logits, labels, axis)
