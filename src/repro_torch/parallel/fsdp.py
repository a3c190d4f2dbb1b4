"""Data parallelism, ZeRO-3 and tensor parallelism (head-parallel, or
sequence-parallel attention) over a process group: the placements of a
`ParallelPlan`, carried out (the port's own module: the reference has
none, since GSPMD carries out the placements when it jits a step with
`in_shardings`).

The port's model is functions over a parameter tree, not `nn.Module`s, so
the gathers and reductions are written out here instead of wrapping the
model (`torch.distributed.fsdp.fully_shard` wraps modules).  Every tensor
that reaches a hand kernel is a plain contiguous one, as on one card.

`Layout` holds each parameter leaf's placement on this rank, from its spec
(`param_sharding`):
  * a dimension on the model axis (a tp-mode plan: w_gate / w_up / the
    head by columns, w_down / the embedding by rows; under head-parallel
    attention also wq / wk / wv and the q / k / v biases by columns and wo
    by rows, which a sequence-parallel plan holds whole) is held as this
    rank's piece for good; the models run on it through
    `parallel/tensor.py`'s operators;
  * a dimension on the data axes (the spec's FSDP entry, which names the
    plan's batch axes: every mesh axis in dp mode) is held as a piece only
    where `plan.fsdp` (ZeRO-3: parameters and moments sharded; the piece
    gathered over the data axes for the step, its gradient reduce-scattered
    after); without it the leaf is whole over the data axes.
Under int8 moments a leaf is sharded over the data axes only where each
piece is whole 128-element blocks of the leaf's flat order, so the block
quantization is the one a single card makes; the others stay replicated.

Gradients are summed over the batch axes: each rank's loss is its rows'
sum over the mask count of the batch axes' rows
(`models.model.loss_fn(denominator=)`), so the sum of the data ranks'
losses, and of their gradients, is the global batch's.  A batch that no
batch axis divides is replicated (`data.rank_rows`): each rank then counts
every row, the global count is the data ranks' number times the batch's,
and the summed gradients are the average of the ranks' equal ones.  The
model ranks of one data rank hold the same rows and the same loss.

The replicated leaves of a tp-mode plan (the model axis's rule):
  * head-parallel, a leaf on the replicated residual stream (the block
    norms, "final_norm") gets its whole gradient on every model rank,
    since `copy_to_model` sums the gradients entering the column-parallel
    products: it is summed over the batch axes only;
  * head-parallel, a leaf used only on model-sharded activations (qwen3's
    q_norm / k_norm, over a rank's own heads: `PARTIAL_OVER_MODEL`) gets
    this rank's heads' part of its gradient: it is summed over the model
    axis too;
  * sequence-parallel (`attn_seq`), every leaf the model axis replicates
    (the block norms, "final_norm", wq / wk / wv / wo, qwen2.5's biases,
    qwen3's q_norm / k_norm) is applied to this rank's chunk of the
    sequence only, so its gradient is this rank's part: it is summed over
    the model axis too (after the reduce-scatter over the data axes under
    ZeRO-3).

Collectives run on per-axis process groups (`dist.new_group` over the
ranks that share every other coordinate; the default group where that is
every rank) and are counted per kind (calls and bytes) in
`Layout.collectives`, the tensor-parallel operators' included.  A Layout
made for a `rank` of a mesh without a process group (`Layout(...,
rank=r)`) traces that rank's step on the "meta" device: its collectives
are counted, not run.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import re
from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import tree as tree_lib
from repro_torch.kernels import gemm
from repro_torch.launch.mesh import MeshShape, world
from repro_torch.optim.adamw import BlockQ, _BLOCK, _moments
from repro_torch.parallel import tensor
from repro_torch.parallel.logical import axes_of
from repro_torch.parallel.sharding import ParallelPlan, param_sharding, shard_index

A4C = "ROADMAP A.4c"
# Replicated leaves applied to model-sharded activations only under a
# head-parallel plan (module docstring); under a sequence-parallel one
# every replicated leaf is.
PARTIAL_OVER_MODEL = re.compile(r"(q_norm|k_norm)$")


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def check_plan(cfg, mesh, plan: ParallelPlan, seq_len: Optional[int] = None) -> None:
    """Raise for a plan the port does not execute, before any weight is
    made.  Under a model axis the port runs tensor parallelism of the dense
    decoders with the SwiGLU MLP whose d_ff and vocabulary the axis
    divides: head-parallel where the kv heads divide it too, else
    sequence-parallel attention (`attn_seq`), where the axis must divide
    the sequence length `seq_len` (the reference's GSPMD would pad it; the
    port raises); it refuses MoE (expert parallelism) and the other
    families.  Over a data axis > 1 it refuses MoE: the reference routes
    all B x S tokens at once, capacity from the global token count, so
    earlier tokens win slots across the whole batch; routing each rank's
    rows alone would drop others."""
    mesh = MeshShape.of(mesh)
    if plan.model_axis is not None:
        m = mesh.shape[plan.model_axis]
        where = f"{cfg.name} under a model axis of {m}"
        if cfg.moe is not None:
            raise NotImplementedError(
                f"{where}: MoE under a model axis is expert parallelism with global routing "
                f"({A4C})")
        if cfg.family != "dense":
            raise NotImplementedError(
                f"{where}: tensor parallelism of the {cfg.family!r} family is not ported; the "
                f"dense decoders' is ({A4C})")
        if cfg.mlp_variant != "swiglu":
            raise NotImplementedError(
                f"{where}: the {cfg.mlp_variant} MLP's output bias is split over the model "
                f"axis by the plan and added whole after the row-parallel product ({A4C})")
        split = [("d_ff", cfg.d_ff), ("vocab", cfg.vocab)]
        if not plan.attn_seq:        # head-parallel attention splits the kv heads too
            split.insert(0, ("kv heads", cfg.n_kv_heads))
        for what, n in split:
            if n % m:
                raise NotImplementedError(
                    f"{where}: its {n} {what} do not divide over the axis; the plan would "
                    f"replicate them ({A4C}; make_plan takes sequence-parallel attention "
                    f"where the kv heads do not divide)")
        if plan.attn_seq and seq_len is not None and seq_len % m:
            raise NotImplementedError(
                f"a sequence of {seq_len} over a sequence-parallel model axis of {m}: the axis "
                f"must divide it (the reference's GSPMD would pad it; the port does not)")
    data = math.prod(mesh.shape[a] for a in plan.batch_axes)
    if cfg.moe is not None and data > 1:
        raise NotImplementedError(
            f"{cfg.name}: MoE over a data axis of {data}: the reference routes the whole "
            f"batch with capacity from the global token count; global routing comes with "
            f"expert parallelism ({A4C})")


@dataclasses.dataclass(frozen=True)
class Cut:
    """How a checkpoint leaf is split on a rank: the dimension split over
    the data axes and the one split over the model axis (None: whole)."""

    data: Optional[int] = None
    model: Optional[int] = None


class Layout:
    """Each parameter leaf's placement on this rank (module docstring),
    from the whole parameters' shapes (`params`: the tree or its meta
    struct) under `plan` over `mesh`; rank and world are the running
    process group's (0 and 1 without one), or `rank` of the mesh with no
    group (a meta trace)."""

    def __init__(self, params, mesh, plan: ParallelPlan, *, int8_moments: bool = False,
                 rank: Optional[int] = None):
        mesh = MeshShape.of(mesh)
        if rank is None:
            self.rank, self.world = world()
            if mesh.size != self.world:
                raise ValueError(f"a mesh of {mesh.size} over a world of {self.world}")
        else:
            self.rank, self.world = rank, mesh.size
        self.mesh, self.plan = mesh, plan
        self.coord = mesh.coordinate(self.rank)
        self.data_axes = tuple(plan.batch_axes)
        self.model_axis = plan.model_axis
        if int8_moments and self.model_axis is not None:
            raise NotImplementedError(
                f"int8 moments under a model axis: their 128-element blocks would cut a "
                f"rank's columns ({A4C})")
        self.template = params
        self.int8_moments = int8_moments
        self.dims: List[Optional[int]] = []          # split over the data axes
        self.model_dims: List[Optional[int]] = []    # split over the model axis
        self.partial: List[bool] = []                # summed over the model axis too
        n_data = self.size(self.data_axes)
        for ns, (path, x) in zip(tree_lib.leaves(param_sharding(params, mesh, plan)),
                                 tree_lib.leaves_with_paths(params)):
            dim = mdim = None
            for d, entry in enumerate(ns.spec):
                axes = axes_of(entry)
                if self.model_axis is not None and self.model_axis in axes:
                    mdim = self._only(d, axes, (self.model_axis,), ns.spec)
                elif axes and plan.fsdp:
                    if dim is not None:
                        raise NotImplementedError(f"spec {ns.spec}: two dimensions over the "
                                                  f"data axes ({A4C})")
                    dim = self._only(d, axes, self.data_axes, ns.spec)
            shape = tuple(x.shape)
            if dim is not None and int8_moments and not (
                    math.prod(shape[:dim]) == 1 and math.prod(shape) // n_data % _BLOCK == 0):
                dim = None          # its pieces would cut 128-element blocks
            self.dims.append(dim)
            self.model_dims.append(mdim)
            self.partial.append(self.model_axis is not None and mdim is None and (
                plan.attn_seq or PARTIAL_OVER_MODEL.search(_path_str(path)) is not None))
        self.collectives = collections.Counter()   # kind -> calls
        self.collective_bytes = collections.Counter()
        self.groups = {}
        if rank is None and dist.is_initialized():
            axis_sets = [self.data_axes] + ([(self.model_axis,)] if self.model_axis else [])
            for axes in axis_sets:
                self.groups[axes] = self._new_group(axes)
        self.model = None        # the operators' axis (parallel/tensor.py)
        if self.model_axis is not None:
            self.model = tensor.ModelAxis(
                size=mesh.shape[self.model_axis], index=self.coord[self.model_axis],
                group=self.groups.get((self.model_axis,)), seq=plan.attn_seq,
                collectives=self.collectives, collective_bytes=self.collective_bytes)

    @staticmethod
    def _only(d: int, axes: Tuple[str, ...], want: Tuple[str, ...], spec) -> int:
        if axes != want:
            raise NotImplementedError(f"spec {spec}: dimension {d} over {axes}, where the "
                                      f"port splits a dimension over {want} ({A4C})")
        return d

    def _new_group(self, axes: Tuple[str, ...]):
        """This rank's group over `axes` (the ranks that share every other
        coordinate), made on every rank in the same order; None (the
        default group) where it holds every rank.  A group's ranks in
        ascending order are its row-major order over `axes`, since
        `axes` lie in the mesh's order."""
        names = self.mesh.axis_names
        if [a for a in names if a in axes] != list(axes):
            raise NotImplementedError(f"axes {axes} out of the mesh's order {names}")
        others = [a for a in names if a not in axes]
        members = collections.defaultdict(list)
        for r in range(self.world):
            c = self.mesh.coordinate(r)
            members[tuple(c[a] for a in others)].append(r)
        if len(members) == 1:
            return None
        mine = None
        for key in sorted(members):
            group = dist.new_group(members[key])
            if self.rank in members[key]:
                mine = group
        return mine

    def size(self, axes) -> int:
        return math.prod(self.mesh.shape[a] for a in axes)

    @property
    def sharded(self) -> int:
        """How many leaves are split into pieces over the data axes."""
        return sum(d is not None for d in self.dims)

    @property
    def model_sharded(self) -> int:
        """How many leaves are split into pieces over the model axis."""
        return sum(d is not None for d in self.model_dims)

    # -- placing a whole tree ------------------------------------------------------

    def shard(self, params):
        """This rank's pieces of whole parameters (a replicated leaf is the
        leaf itself; a piece a copy of its own, a matrix's rows 16-byte
        aligned as `init_model` stores them)."""
        return tree_lib.unflatten(params, [
            self.piece(x, d, m) for x, d, m in
            zip(tree_lib.leaves(params), self.dims, self.model_dims)])

    def piece(self, x, dim: Optional[int], model_dim: Optional[int] = None):
        if dim is None and model_dim is None:
            return x
        for d, axes in ((dim, self.data_axes), (model_dim, (self.model_axis,))):
            if d is not None:
                index, count = shard_index(axes, self.mesh, self.rank)
                n = x.shape[d] // count
                x = x.narrow(d, index * n, n)
        x = x.clone(memory_format=torch.contiguous_format)
        return gemm.aligned_rows(x) if x.dim() == 2 else x

    # -- collectives --------------------------------------------------------------

    def _count(self, kind: str, t: torch.Tensor) -> None:
        self.collectives[kind] += 1
        self.collective_bytes[kind] += t.numel() * t.element_size()

    def _axes(self, over: str) -> Tuple[str, ...]:
        return {"data": self.data_axes, "model": (self.model_axis,),
                "world": self.mesh.axis_names}[over]

    def all_reduce(self, t: torch.Tensor, over: str = "data") -> torch.Tensor:
        """`t` summed over the ranks of the batch axes ("data"), the model
        axis ("model") or every rank ("world"), in place."""
        self._count("all_reduce", t)
        if t.device.type != "meta":
            dist.all_reduce(t, group=self.groups.get(self._axes(over)))
        return t

    def all_gather(self, x: torch.Tensor, dim: int, over: str = "data") -> torch.Tensor:
        """The leaf whole over `over`'s axes from each rank's piece along `dim`."""
        n = self.size(self._axes(over))
        x = x.detach().contiguous()
        out = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
        self._count("all_gather", out)
        if x.device.type != "meta":
            # 1-D, the pieces concatenated: the form both gloo and NCCL take
            dist.all_gather_into_tensor(out, x.reshape(-1),
                                        group=self.groups.get(self._axes(over)))
        shape = list(x.shape)
        shape[dim] *= n
        return out.reshape((n,) + tuple(x.shape)).movedim(0, dim).reshape(shape)

    def reduce_scatter(self, g: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's piece along `dim` of `g` summed over the batch axes."""
        n_ranks = self.size(self.data_axes)
        shape = list(g.shape)
        n = shape[dim] // n_ranks
        stacked = g.reshape(shape[:dim] + [n_ranks, n] + shape[dim + 1:]) \
            .movedim(dim, 0).contiguous()
        out = torch.empty(stacked.shape[1:], dtype=g.dtype, device=g.device)
        self._count("reduce_scatter", stacked)
        if g.device.type != "meta":
            dist.reduce_scatter_tensor(out.view(-1), stacked.view(-1),
                                       group=self.groups.get(self.data_axes))
        return out

    def barrier(self) -> None:
        if dist.is_initialized():
            dist.barrier()

    # -- the step's pieces ----------------------------------------------------------

    def gather(self, leaves) -> list:
        """The parameters of this rank's pieces whole over the data axes
        (leaf order), each requiring a gradient: a leaf held whole there is
        marked in place, a sharded one gathered.  Model-axis pieces stay
        pieces."""
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
        """Each gradient summed over the batch axes (module docstring): this
        rank's piece of a leaf split over them, the whole of another; a
        partial leaf's over the model axis too."""
        # A gradient may be a strided view into a buffer it shares with
        # others (the sLSTM's four recurrent gates): reduce a copy of it.
        out = []
        for g, dim, partial in zip(grads, self.dims, self.partial):
            if dim is None:
                out.append(self.all_reduce(g.contiguous(), "world" if partial else "data"))
            else:
                piece = self.reduce_scatter(g, dim)
                out.append(self.all_reduce(piece, "model") if partial else piece)
        return out

    def norm_reduce(self, sq: torch.Tensor) -> torch.Tensor:
        """Per-leaf sums of squares of this rank's gradient pieces -> the
        whole leaves' (`adamw.global_norm`): each piece counts once, from
        the rank at coordinate 0 of every axis the leaf is whole over."""
        own = []
        for dim, mdim in zip(self.dims, self.model_dims):
            held = (self.data_axes if dim is not None else ()) + \
                ((self.model_axis,) if mdim is not None else ())
            own.append(1.0 if all(self.coord[a] == 0 for a in self.mesh.axis_names
                                  if a not in held) else 0.0)
        return self.all_reduce(sq * torch.tensor(own, device=sq.device), "world")

    # -- checkpoints --------------------------------------------------------------

    def state_dims(self, opt_state) -> dict:
        """Per leaf of a checkpoint's {"params", "opt", "step"} tree, how its
        pieces split: a `Cut`, or None where it is whole on every rank; a
        BlockQ moment's q and scale split along their block axis."""
        cuts = [None if d is None and m is None else Cut(d, m)
                for d, m in zip(self.dims, self.model_dims)]

        def moment(m):
            if not self.int8_moments:
                return tree_lib.unflatten(self.template, cuts)
            return tree_lib.unflatten(self.template, [
                BlockQ(Cut(0), Cut(0)) if isinstance(b, BlockQ) and d is not None else
                BlockQ(None, None) if isinstance(b, BlockQ) else c
                for b, d, c in zip(_moments(m, True), self.dims, cuts)])

        return {"params": tree_lib.unflatten(self.template, cuts), "step": None,
                "opt": {"m": moment(opt_state["m"]), "v": moment(opt_state["v"]),
                        "count": None}}

    def gather_to_host(self, tree, dims) -> Optional[Any]:
        """The whole tree on the host at rank 0 (None elsewhere): pieces
        gathered leaf by leaf over the data axes, then the model axis
        (`dims`: `state_dims`'s tree); every rank takes part."""
        out = []
        for x, c in zip(tree_lib.leaves(tree), tree_lib.leaves(dims)):
            if isinstance(x, torch.Tensor):
                x = x.detach()
                if c is not None and c.data is not None:
                    x = self.all_gather(x, c.data)
                if c is not None and c.model is not None:
                    x = self.all_gather(x, c.model, "model")
                x = x.to("cpu", copy=True) if self.rank == 0 else None
            out.append(x)
        return tree_lib.unflatten(tree, out) if self.rank == 0 else None

    def pieces(self, dims) -> list:
        """Per leaf: None (whole) or the (dim, index, count) cuts of this
        rank's piece, for `checkpoint.restore_checkpoint`."""
        return [None if c is None else
                [(d, *shard_index(axes, self.mesh, self.rank))
                 for d, axes in ((c.data, self.data_axes), (c.model, (self.model_axis,)))
                 if d is not None]
                for c in tree_lib.leaves(dims)]
