"""Data parallelism and ZeRO-3 over a process group: the placements of a
dp-mode `ParallelPlan`, carried out (the port's own module: the reference
has none, since GSPMD carries out the placements when it jits a step with
`in_shardings`).

The port's model is functions over a parameter tree, not `nn.Module`s, so
the gathers and reductions are written out here instead of wrapping the
model (`torch.distributed.fsdp.fully_shard` wraps modules).  Every tensor
that reaches a hand kernel is a plain contiguous one, as on one card.

`Layout` holds each parameter leaf's placement on this rank:
  * replicated: every rank holds the whole leaf;
  * sharded along one dimension into `world` equal pieces, piece `rank`
    here (the spec's entry names every mesh axis, row-major).
Without `plan.fsdp` every leaf is replicated (pure data parallelism).  With
it the leaves follow `param_sharding`'s specs (ZeRO-3: parameters and
moments sharded; the whole parameters gathered for the step, the
gradients reduce-scattered).  Under int8 moments a leaf is sharded only
where each piece is whole 128-element blocks of the leaf's flat order, so
the block quantization is the one a single card makes; the others stay
replicated.

Gradients are summed over the ranks: each rank's loss is its rows' sum
over the global mask count (`models.model.loss_fn(denominator=)`), so the
sum of the ranks' losses, and of their gradients, is the global batch's.
A batch that no batch axis divides is replicated (`data.rank_rows`): each
rank then counts every row, the global count is `world` times the batch's,
and the summed gradients are the average of the ranks' equal ones.

Collectives are counted per kind (calls and bytes) in `Layout.collectives`.
"""

from __future__ import annotations

import collections
import math
from typing import Any, List, Optional

import torch
import torch.distributed as dist

from repro_torch import tree as tree_lib
from repro_torch.launch.mesh import MeshShape, world
from repro_torch.optim.adamw import BlockQ, _BLOCK, _moments
from repro_torch.parallel.sharding import ParallelPlan, param_sharding, shard_index

A4B = "ROADMAP A.4b"


def check_plan(cfg, mesh, plan: ParallelPlan) -> None:
    """Raise for a plan the port does not execute: tensor / expert
    parallelism (a tp-mode plan), and an MoE arch whose batch is split
    over ranks: the reference routes all B x S tokens at once, capacity
    from the global token count, so earlier tokens win slots across the
    whole batch; routing each rank's rows alone would drop others."""
    mesh = MeshShape.of(mesh)
    if plan.model_axis is not None:
        raise NotImplementedError(
            f"{cfg.name}: a tp-mode plan (model axis {plan.model_axis!r} of "
            f"{mesh.shape.get(plan.model_axis)}): tensor and expert parallelism are not "
            f"ported ({A4B})")
    data = math.prod(mesh.shape[a] for a in plan.batch_axes)
    if cfg.moe is not None and data > 1:
        raise NotImplementedError(
            f"{cfg.name}: MoE over a data axis of {data}: the reference routes the whole "
            f"batch with capacity from the global token count; global routing comes with "
            f"expert parallelism ({A4B})")


class Layout:
    """Each parameter leaf's placement on this rank (module docstring),
    from the whole parameters' shapes (`params`: the tree or its meta
    struct) under `plan` over `mesh`; rank and world are the running
    process group's (0 and 1 without one)."""

    def __init__(self, params, mesh, plan: ParallelPlan, *, int8_moments: bool = False):
        self.rank, self.world = world()
        mesh = MeshShape.of(mesh)
        if mesh.size != self.world:
            raise ValueError(f"a mesh of {mesh.size} over a world of {self.world}")
        self.template = params
        self.int8_moments = int8_moments
        self.dims: List[Optional[int]] = []
        for ns, x in zip(tree_lib.leaves(param_sharding(params, mesh, plan)),
                         tree_lib.leaves(params)):
            sharded = [(d, e) for d, e in enumerate(ns.spec) if e is not None]
            dim = None
            if plan.fsdp and sharded:
                if len(sharded) > 1 or shard_index(sharded[0][1], mesh, 0)[1] != self.world:
                    raise NotImplementedError(
                        f"spec {ns.spec} over {mesh.shape}: only one dimension sharded "
                        f"over every mesh axis is carried out ({A4B})")
                dim = sharded[0][0]
                shape = tuple(x.shape)
                if int8_moments and not (math.prod(shape[:dim]) == 1 and
                                         math.prod(shape) // self.world % _BLOCK == 0):
                    dim = None          # its pieces would cut 128-element blocks
            self.dims.append(dim)
        self.collectives = collections.Counter()   # kind -> calls
        self.collective_bytes = collections.Counter()

    @property
    def sharded(self) -> int:
        """How many leaves are split into pieces."""
        return sum(d is not None for d in self.dims)

    # -- placing a whole tree ------------------------------------------------------

    def shard(self, params):
        """This rank's pieces of whole parameters (a replicated leaf is the
        leaf itself; a piece a copy of its own)."""
        return tree_lib.unflatten(params, [self.piece(x, d) for x, d in
                                           zip(tree_lib.leaves(params), self.dims)])

    def piece(self, x, dim: Optional[int]):
        if dim is None:
            return x
        n = x.shape[dim] // self.world
        return x.narrow(dim, self.rank * n, n).clone(memory_format=torch.contiguous_format)

    # -- collectives --------------------------------------------------------------

    def _count(self, kind: str, t: torch.Tensor) -> None:
        self.collectives[kind] += 1
        self.collective_bytes[kind] += t.numel() * t.element_size()

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """`t` summed over the ranks, in place."""
        self._count("all_reduce", t)
        dist.all_reduce(t)
        return t

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole leaf from each rank's piece along `dim`."""
        x = x.detach().contiguous()
        out = torch.empty(self.world * x.numel(), dtype=x.dtype, device=x.device)
        self._count("all_gather", out)
        # 1-D, the pieces concatenated: the form both gloo and NCCL take
        dist.all_gather_into_tensor(out, x.reshape(-1))
        shape = list(x.shape)
        shape[dim] *= self.world
        return out.reshape((self.world,) + tuple(x.shape)).movedim(0, dim).reshape(shape)

    def reduce_scatter(self, g: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's piece along `dim` of `g` summed over the ranks."""
        shape = list(g.shape)
        n = shape[dim] // self.world
        stacked = g.reshape(shape[:dim] + [self.world, n] + shape[dim + 1:]) \
            .movedim(dim, 0).contiguous()
        out = torch.empty(stacked.shape[1:], dtype=g.dtype, device=g.device)
        self._count("reduce_scatter", stacked)
        dist.reduce_scatter_tensor(out.view(-1), stacked.view(-1))
        return out

    def barrier(self) -> None:
        if dist.is_initialized():
            dist.barrier()

    # -- the step's pieces ----------------------------------------------------------

    def gather(self, leaves) -> list:
        """The whole parameters of this rank's pieces (leaf order), each
        requiring a gradient: a replicated leaf is marked in place, a
        sharded one gathered."""
        out = []
        for x, dim in zip(leaves, self.dims):
            if dim is None:
                if not x.requires_grad:
                    x.requires_grad_(True)
                out.append(x)
            else:
                out.append(self.all_gather(x, dim).requires_grad_(True))
        return out

    def reduce(self, grads) -> list:
        """Each whole gradient summed over the ranks: this rank's piece of a
        sharded leaf's, a replicated leaf's whole."""
        # A gradient may be a strided view into a buffer it shares with
        # others (the sLSTM's four recurrent gates): reduce a copy of it.
        return [self.all_reduce(g.contiguous()) if dim is None else self.reduce_scatter(g, dim)
                for g, dim in zip(grads, self.dims)]

    def norm_reduce(self, sq: torch.Tensor) -> torch.Tensor:
        """Per-leaf sums of squares of this rank's gradient pieces -> the
        whole leaves' (`adamw.global_norm`): a replicated leaf counts once,
        from rank 0."""
        own = torch.tensor([1.0 if d is not None or self.rank == 0 else 0.0
                            for d in self.dims], device=sq.device)
        return self.all_reduce(sq * own)

    # -- checkpoints --------------------------------------------------------------

    def state_dims(self, opt_state) -> dict:
        """Per leaf of a checkpoint's {"params", "opt", "step"} tree, the
        dimension its pieces split (None: whole on every rank); a BlockQ
        moment's q and scale split along their block axis."""
        def moment(m):
            flat = _moments(m, self.int8_moments)
            return tree_lib.unflatten(self.template, [
                BlockQ(0, 0) if isinstance(b, BlockQ) and d is not None else
                BlockQ(None, None) if isinstance(b, BlockQ) else d
                for b, d in zip(flat, self.dims)])

        params = tree_lib.unflatten(self.template, self.dims)
        return {"params": params, "step": None,
                "opt": {"m": moment(opt_state["m"]), "v": moment(opt_state["v"]),
                        "count": None}}

    def gather_to_host(self, tree, dims) -> Optional[Any]:
        """The whole tree on the host at rank 0 (None elsewhere): pieces
        gathered leaf by leaf; every rank takes part."""
        out = []
        for x, dim in zip(tree_lib.leaves(tree), tree_lib.leaves(dims)):
            if isinstance(x, torch.Tensor):
                x = x.detach() if dim is None else self.all_gather(x, dim)
                x = x.to("cpu", copy=True) if self.rank == 0 else None
            out.append(x)
        return tree_lib.unflatten(tree, out) if self.rank == 0 else None

    def pieces(self, dims) -> list:
        """Per leaf: None (whole) or (dim, index, count) of this rank's
        piece, for `checkpoint.restore_checkpoint`."""
        return [None if d is None else (d, self.rank, self.world)
                for d in tree_lib.leaves(dims)]
