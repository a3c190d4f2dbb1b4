"""Tensor parallelism over the model axis: Megatron's operators as autograd
Functions (the port's own module: the reference has none, since GSPMD
inserts these collectives from the models' `shard` annotations).

A head-parallel plan (`ParallelPlan.model_axis` with `attn_seq` False)
holds on each model rank its columns of wq / wk / wv / w_gate / w_up /
the untied head (and qwen2.5's q / k / v biases), its rows of wo / w_down
and its rows of the embedding table (`parallel/fsdp.py`).  A
sequence-parallel plan (`attn_seq` True: Megatron's sequence parallelism)
holds the MLP, the embedding and the head the same way, and the attention
projections whole: the residual stream, the norms and attention run on
this rank's contiguous chunk of S / M positions (`ModelAxis.seq`).  The
models call the operators below at the reference's annotations; each is
the identity outside `use_model_axis`, so a model function computes as it
did, bit for bit:

  * `copy_to_model`: head-parallel, identity forward, all-reduce backward
    (before a column-parallel product: its input's gradient is summed over
    the ranks' columns); sequence-parallel, `gather_seq`;
  * `reduce_from_model`: head-parallel, all-reduce forward, identity
    backward (after a row-parallel product); sequence-parallel, the sum
    over the ranks reduce-scattered to this rank's chunk (reduce-scatter
    forward, all-gather backward);
  * `gather_seq`: the whole sequence from the ranks' chunks (all-gather on
    dim 1 forward, reduce-scatter backward): the input of the MLP's
    column-parallel products and of the head, and attention's K and V for
    this rank's chunk of queries (`seq_offset` gives the chunk's first
    position);
  * `vocab_embed`: the lookup of a vocab-parallel table: rows outside this
    rank's range give zeros, then the ranks' rows are summed (reduced to
    this rank's chunk under a sequence-parallel plan);
  * `vocab_log_likelihood`: log p(label) from (B, chunk, V / M) f32 logits:
    the max and the sum of exponentials all-reduced (max, then sum), and
    the label's log-probability all-reduced from the rank that holds it;
    at a model axis of 1 it is `torch.log_softmax` and gather, values and
    gradient, bit for bit.

Every collective runs on the model axis's process group, even at a model
axis of size 1, and is counted (calls and bytes by kind) in the counters
the `ModelAxis` was given, `Layout.collectives` in a sharded step.  On the
"meta" device a collective is counted and not run, so
`launch.step_cost.analyze` traces one rank's step without a group.  The
sequence operators take the 1-D form of all-gather and reduce-scatter
that both gloo and NCCL take, the (M, B, S / M, ...) pieces laid back as
(B, S, ...).  Tensors reaching a hand kernel stay plain and contiguous.

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
    seq: bool = False            # a sequence-parallel plan (module docstring)
    collectives: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    collective_bytes: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)

    def _count(self, kind: str, t: torch.Tensor) -> None:
        self.collectives[kind] += 1
        self.collective_bytes[kind] += t.numel() * t.element_size()

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """`t` reduced over the model axis, in place."""
        self._count("all_reduce", t)
        if t.device.type != "meta":
            dist.all_reduce(t, op=op, group=self.group)
        return t

    def all_gather_seq(self, x: torch.Tensor) -> torch.Tensor:
        """(B, M s, ...) from each rank's (B, s, ...), rank r's at positions
        r s .. r s + s - 1."""
        x = x.contiguous()
        out = torch.empty((self.size,) + tuple(x.shape), dtype=x.dtype, device=x.device)
        self._count("all_gather", out)
        if x.device.type != "meta":
            dist.all_gather_into_tensor(out.view(-1), x.view(-1), group=self.group)
        B, s = x.shape[:2]
        return out.movedim(0, 1).reshape((B, self.size * s) + tuple(x.shape[2:]))

    def reduce_scatter_seq(self, g: torch.Tensor) -> torch.Tensor:
        """This rank's chunk (B, S / M, ...) of `g` (B, S, ...) summed over
        the model axis."""
        B, S = g.shape[:2]
        if S % self.size:
            raise ValueError(f"a sequence of {S} over a model axis of {self.size}")
        stacked = g.reshape((B, self.size, S // self.size) + tuple(g.shape[2:])) \
            .movedim(1, 0).contiguous()
        out = torch.empty(stacked.shape[1:], dtype=g.dtype, device=g.device)
        self._count("reduce_scatter", stacked)
        if g.device.type != "meta":
            dist.reduce_scatter_tensor(out.view(-1), stacked.view(-1), group=self.group)
        return out


def current() -> Optional[ModelAxis]:
    return getattr(_state, "axis", None)


def sequence_parallel() -> bool:
    """Whether the running model axis is sequence-parallel."""
    axis = current()
    return axis is not None and axis.seq


def seq_offset(n: int) -> int:
    """The first position of this rank's chunk of `n` positions (0 outside
    a sequence-parallel axis)."""
    axis = current()
    return axis.index * n if axis is not None and axis.seq else 0


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


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis.all_gather_seq(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.reduce_scatter_seq(g), None


class _ReduceScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis.reduce_scatter_seq(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_gather_seq(g), None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """The input of a column-parallel product (module docstring)."""
    axis = current()
    if axis is None:
        return x
    return (_GatherSeq if axis.seq else _CopyToModel).apply(x, axis)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The sum over the model ranks of a row-parallel product's partial
    outputs (module docstring)."""
    axis = current()
    if axis is None:
        return x
    return (_ReduceScatterSeq if axis.seq else _ReduceFromModel).apply(x, axis)


def gather_seq(x: torch.Tensor) -> torch.Tensor:
    """The whole sequence (B, S, ...) from this rank's chunk (B, S / M,
    ...) under a sequence-parallel axis; `x` itself otherwise."""
    axis = current()
    return _GatherSeq.apply(x, axis) if axis is not None and axis.seq else x


def _local(labels: torch.Tensor, rows: int, axis: ModelAxis):
    """Labels as rows of this rank's vocab range, 0 outside it, and where
    they fall outside."""
    local = labels - axis.index * rows
    outside = (local < 0) | (local >= rows)
    return torch.where(outside, torch.zeros_like(local), local), outside


def vocab_embed(tokens: torch.Tensor, table: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """`table` (V / M, d) is this rank's rows of the (V, d) embedding:
    table[tokens] summed over the ranks, each giving zeros for the tokens
    it does not hold (their gradient too).  Under a sequence-parallel axis
    `tokens` (B, S) are the whole sequence and the sum is reduced to this
    rank's chunk (B, S / M, d)."""
    local, outside = _local(tokens, table.shape[0], axis)
    x = F.embedding(local, table).masked_fill(outside[..., None], 0)
    return (_ReduceScatterSeq if axis.seq else _ReduceFromModel).apply(x, axis)


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
