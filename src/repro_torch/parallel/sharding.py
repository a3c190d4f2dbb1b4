"""Sharding rules: DP / FSDP (ZeRO-3) / TP / EP plans over a mesh (port of
repro/parallel/sharding.py).

Two rule layers, as in the reference:
  * activation rules: the logical names `parallel.logical.shard` reads;
  * parameter rules: a path-pattern table mapping every parameter of the
    zoo to a `Spec`.

Every function takes a `launch.mesh.MeshShape` (or a `DeviceMesh`, read
through `MeshShape.of`) where the reference takes a `jax.sharding.Mesh`,
and returns `logical.NamedSharding`s of the port's `Spec`.

Layout: the port's parameter tree holds a flat "layers" list (and
whisper's "encoder_blocks" list) where the reference stacks each group on
a leading axis, so a layer leaf's spec here is the reference's spec of
the stacked leaf without its leading None; dp mode's "largest divisible
dim" and the divisibility guard run on the per-layer shape and pick the
same dimension.  Likewise a decode-state leaf here is one layer's, the
reference's stacked leaf without its leading group axis.

The port executes the dp-mode plans (data parallelism, and ZeRO-3 where
`fsdp`) and the tp-mode training plans of the dense decoders, head-parallel
or with sequence-parallel attention (`attn_seq`) (`parallel/fsdp.py`,
`parallel/tensor.py`); expert parallelism and the serving plans
(`serving=True`: seq-sharded prefill, static 2-D expert weights) are
computed and checked against the reference, not run (ROADMAP A.4c).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional, Tuple

from repro_torch import tree as tree_lib
from repro_torch.launch.mesh import MeshShape
from repro_torch.parallel.logical import NamedSharding, Rules, Spec as P, axes_of


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    """Resolved parallelism decisions for one (arch, mesh) pair.

    Two modes over the same mesh:
      * "tp": tensor parallel over the "model" axis + DP over pod / data,
        with FSDP over the DP axes for models whose replicated state would
        not fit device memory.  For the 12B-480B archs.
      * "dp": the model axis joins the batch axes (pure data parallelism)
        and parameters are FSDP-sharded over everything.  For the < 4B
        archs whose head / ffn dims cannot feed a 16-way TP axis.
    """

    batch_axes: Tuple[str, ...]          # mesh axes carrying data parallelism
    model_axis: Optional[str] = "model"  # None => dp mode (no TP)
    fsdp: bool = False                   # ZeRO-3 parameter sharding
    fsdp_axes: Tuple[str, ...] = ()      # axes used for FSDP
    # Attention over the sequence on the model axis where the KV heads do
    # not divide it (the reference's reasoning: head-TP is collective-free
    # only when they do); the projections then replicate over "model".
    attn_seq: bool = False
    # Serving: parameters statically 2D-sharded instead of FSDP-gathered;
    # expert FFN weights spread E -> model, d_ff_expert -> data.
    expert_2d: bool = False

    def activation_rules(self) -> Rules:
        b = self.batch_axes if len(self.batch_axes) > 1 else self.batch_axes[0]
        M = self.model_axis
        return {
            "batch": b,
            "seq": M if self.attn_seq else None,
            "embed": None,
            "heads": None if self.attn_seq else M,
            "kv_heads": None if self.attn_seq else M,
            "attn_seq": M if self.attn_seq else None,
            "mlp": M,
            "vocab": M,
            "expert": M,
        }


def make_plan(
    mesh,
    param_count: int,
    *,
    n_kv_heads: Optional[int] = None,
    tp_threshold: int = 4_000_000_000,
    fsdp_threshold: int = 8_000_000_000,
    force_fsdp: Optional[bool] = None,
    force_mode: Optional[str] = None,
    force_attn_seq: Optional[bool] = None,
    serving: bool = False,
) -> ParallelPlan:
    mesh = MeshShape.of(mesh)
    axes = mesh.axis_names
    dp_axes = tuple(a for a in axes if a in ("pod", "data"))
    mode = force_mode or ("tp" if param_count > tp_threshold else "dp")
    if "model" not in axes or mesh.shape.get("model", 1) == 1:
        mode = "dp" if force_mode is None else mode
    if serving and mode == "tp":
        # Static weight sharding for inference: TP for dense weights, 2D
        # (model x data) for the experts; no optimizer state to co-shard.
        model_size = mesh.shape["model"]
        if force_attn_seq is not None:
            attn_seq = force_attn_seq
        else:
            attn_seq = bool(n_kv_heads) and (n_kv_heads % model_size != 0)
        return ParallelPlan(
            batch_axes=dp_axes, model_axis="model",
            fsdp=True, fsdp_axes=dp_axes,
            attn_seq=attn_seq, expert_2d=True,
        )
    if mode == "dp":
        if serving:
            # Small-model serving: static TP over the model axis.
            return ParallelPlan(
                batch_axes=dp_axes, model_axis="model",
                fsdp=False, fsdp_axes=(), attn_seq=False,
            )
        batch_axes = tuple(a for a in axes)
        return ParallelPlan(
            batch_axes=batch_axes, model_axis=None,
            fsdp=True if force_fsdp is None else force_fsdp,
            fsdp_axes=batch_axes,
        )
    fsdp = param_count > fsdp_threshold if force_fsdp is None else force_fsdp
    model_size = mesh.shape["model"]
    if force_attn_seq is not None:
        attn_seq = force_attn_seq
    else:
        attn_seq = bool(n_kv_heads) and (n_kv_heads % model_size != 0)
    return ParallelPlan(
        batch_axes=dp_axes,
        model_axis="model",
        fsdp=fsdp,
        fsdp_axes=dp_axes if fsdp else (),
        attn_seq=attn_seq,
    )


# --- parameter sharding -------------------------------------------------------

# (path regex, spec by rank) -- first match wins.  `F` is the FSDP axis
# group (or None), "model" the tensor-parallel axis.
def _param_spec(path: str, ndim: int, plan: ParallelPlan) -> P:
    F = plan.fsdp_axes if plan.fsdp else None
    M = plan.model_axis
    AM = None if plan.attn_seq else M
    table = [
        # embeddings / unembedding
        (r"embed$", {2: P(M, F)}),
        (r"head$", {2: P(F, M)}),
        (r"projector$", {2: P(F, M)}),
        # attention projections
        (r"(wq|wk|wv)$", {2: P(F, AM)}),
        (r"(bq|bk|bv)$", {1: P(AM)}),
        (r"wo$", {2: P(AM, F)}),
        # MLP (rank-3 = MoE expert weights; 2D-sharded when serving)
        (r"(w_gate|w_up|w_ff_up)$",
         {2: P(F, M), 3: P(M, None, plan.fsdp_axes) if plan.expert_2d else P(M, F, None)}),
        (r"(w_down|w_ff_down)$",
         {2: P(M, F), 3: P(M, plan.fsdp_axes, None) if plan.expert_2d else P(M, None, F)}),
        (r"(b_up|b_down)$", {1: P(M)}),
        # MoE
        (r"router$", {2: P(F, None)}),
        # Mamba
        (r"w_in$", {2: P(F, M)}),
        (r"conv_[wb]$", {1: P(M), 2: P(None, M)}),
        (r"w_x$", {2: P(M, None)}),
        (r"w_dt$", {2: P(None, M)}),
        (r"b_dt$", {1: P(M)}),
        (r"A_log$", {2: P(M, None)}),
        (r"D$", {1: P(M)}),
        (r"w_out$", {2: P(M, F)}),
        # xLSTM
        (r"w_(q|k|v|i|f)$", {2: P(None, M)}),
        (r"w_[izfo]$", {2: P(F, M)}),
        (r"r_[izfo]$", {3: P(None, None, None)}),
        (r"b_[if]$", {1: P(None), 2: P(None, None)}),
        # norms and everything else: replicated
    ]
    for pat, by_rank in table:
        if re.search(pat, path):
            spec = by_rank.get(ndim)
            if spec is not None:
                return spec
    return P(*([None] * ndim))


def _size(mesh: MeshShape, entry) -> int:
    axs = entry if isinstance(entry, tuple) else (entry,)
    n = 1
    for a in axs:
        n *= mesh.shape[a]
    return n


def param_spec(path: str, shape, mesh, plan: ParallelPlan) -> P:
    """The spec of one parameter leaf (`path` "/"-joined, e.g.
    "layers/3/mixer/wq"), by the per-layer shape."""
    mesh = MeshShape.of(mesh)
    ndim = len(shape)
    if plan.model_axis is None:
        # dp mode: pure FSDP -- shard the largest divisible dim over all
        # FSDP axes.  The reference does so whether or not `plan.fsdp` is
        # set; the port's placements follow `plan.fsdp` (parallel/fsdp.py).
        size = 1
        for a in plan.fsdp_axes:
            size *= mesh.shape[a]
        spec_l: list = [None] * ndim
        for d in sorted(range(ndim), key=lambda d: -shape[d]):
            if shape[d] % size == 0 and shape[d] >= size:
                spec_l[d] = plan.fsdp_axes
                break
        return P(*spec_l)
    spec = _param_spec(path, ndim, plan)
    # Guard: drop mesh axes that don't divide the dim (replicate tiny dims).
    return P(*(None if ax is None or dim % _size(mesh, ax) else ax
               for dim, ax in zip(shape, spec)))


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def param_sharding(params, mesh, plan: ParallelPlan):
    """A tree like `params` of each leaf's `NamedSharding`."""
    mesh = MeshShape.of(mesh)
    specs = [NamedSharding(mesh, param_spec(_path_str(path), tuple(x.shape), mesh, plan))
             for path, x in tree_lib.leaves_with_paths(params)]
    return tree_lib.unflatten(params, specs)


def _best_batch_axes(bsz: int, axes: Tuple[str, ...], mesh: MeshShape) -> Tuple[str, ...]:
    """Largest contiguous subsequence of `axes` whose size divides `bsz`."""
    best: Tuple[str, ...] = ()
    best_size = 1
    n = len(axes)
    for i in range(n):
        for j in range(i + 1, n + 1):
            sub = axes[i:j]
            size = 1
            for a in sub:
                size *= mesh.shape[a]
            if bsz % size == 0 and size > best_size:
                best, best_size = sub, size
    return best


def shard_index(entry, mesh, rank: int) -> Tuple[int, int]:
    """(index, count) of `rank`'s piece of a dimension whose spec entry is
    `entry`: the dimension splits into `count` equal pieces, the product
    of the entry's axis sizes, numbered row-major over those axes (as JAX
    places a dimension sharded over several axes); (0, 1) for None."""
    mesh = MeshShape.of(mesh)
    coord = mesh.coordinate(rank)
    index, count = 0, 1
    for a in axes_of(entry):
        index, count = index * mesh.shape[a] + coord[a], count * mesh.shape[a]
    return index, count


def batch_spec(shape, mesh, plan: ParallelPlan) -> P:
    """A batch leaf's spec: its leading (batch) dimension over the largest
    divisor subset of the DP axes, or replicated."""
    mesh = MeshShape.of(mesh)
    if len(shape) == 0:
        return P()
    axes = _best_batch_axes(shape[0], plan.batch_axes, mesh)
    if not axes:
        return P(*([None] * len(shape)))
    return P(axes if len(axes) > 1 else axes[0], *([None] * (len(shape) - 1)))


def batch_sharding(batch, mesh, plan: ParallelPlan):
    """Shard every batch leaf on its leading (batch) dimension, using the
    largest divisor subset of the DP axes (decode_32k's batch 128 shards
    16-way on "data" under the 256-card mesh; long_500k's batch 1
    replicates)."""
    mesh = MeshShape.of(mesh)
    return tree_lib.map_tree(
        lambda x: NamedSharding(mesh, batch_spec(tuple(x.shape), mesh, plan)), batch)


def _cache_spec(shape, mesh: MeshShape, plan: ParallelPlan) -> P:
    M = plan.model_axis
    spec: list = [None] * len(shape)
    if len(shape) >= 1:
        axes = _best_batch_axes(shape[0], plan.batch_axes, mesh)
        if axes:
            spec[0] = axes if len(axes) > 1 else axes[0]
    # shard the "wide" state dim on model where divisible
    if M is not None:
        for d in range(1, len(shape)):
            if shape[d] % mesh.shape[M] == 0 and shape[d] >= mesh.shape[M]:
                spec[d] = M
                break
    return P(*spec)


def cache_sharding(cache_struct, mesh, plan: ParallelPlan):
    """Decode-state sharding: batch on the data axes, heads / d_inner on
    model.  `cache_struct` is a `models.model.DecodeState` (or any tree of
    its leaves); per layer:
      KV:        (B, S, H_kv, hd)
      Mamba h:   (B, d_inner, d_state);  conv (B, dc-1, d_inner)
      mLSTM C:   (B, H, hd, hd); n (B, H, hd); m (B, H)
      sLSTM:     (B, H, hd) x3; m (B, H)
    and the 0-d index replicated."""
    mesh = MeshShape.of(mesh)

    def tree(t):
        if t is None:
            return None
        if dataclasses.is_dataclass(t) and not isinstance(t, type):
            return dataclasses.replace(t, **{f.name: tree(getattr(t, f.name))
                                             for f in dataclasses.fields(t)})
        return tree_lib.map_tree(
            lambda x: NamedSharding(mesh, _cache_spec(tuple(x.shape), mesh, plan)), t)

    return tree(cache_struct)
