"""Logical axis sharding (port of repro/parallel/logical.py): model code
annotates with logical axis names, the runtime decides the mesh axes.

`resolve_spec(names, rules)` maps logical names to a `Spec`, the port's
own counterpart of JAX's `PartitionSpec`: an immutable sequence whose
entries are None, a mesh axis name or a tuple of names, entry for entry
what the reference's `PartitionSpec` holds (a mesh axis appears once; a
later name that maps to a used axis replicates).

`shard(x, *names)` is the identity, outside `use_rules` and inside it:
every rank holds plain local tensors, its rows of the batch (data
parallelism and ZeRO-3, `parallel/fsdp.py`), under a head-parallel plan
its heads, MLP columns and vocabulary rows, and under a sequence-parallel
one ("seq", "attn_seq" on the model axis) its chunk of the sequence, its
MLP columns and vocabulary rows, which the models' own widths and the
operators of `parallel/tensor.py` carry.  Inside `use_rules` it raises
where a rule puts "expert" on a mesh axis of size > 1: expert parallelism
is ROADMAP A.4c.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

MeshAxes = Union[None, str, Tuple[str, ...]]
Rules = Dict[str, MeshAxes]

_state = threading.local()


class Spec(tuple):
    """A partition spec: one entry per tensor dimension, each None
    (replicated), a mesh axis name, or a tuple of names (sharded over
    their product, row-major)."""

    def __new__(cls, *entries: MeshAxes):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def _entry(e: MeshAxes) -> MeshAxes:
    # As a PartitionSpec holds it: an empty tuple is None, a one-name tuple
    # that name.
    if isinstance(e, tuple) and len(e) <= 1:
        return e[0] if e else None
    return e


def axes_of(entry: MeshAxes) -> Tuple[str, ...]:
    """The mesh axes one spec entry names, in order."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh (the reference's `jax.sharding.NamedSharding`);
    `mesh` is a `launch.mesh.MeshShape`."""

    mesh: object
    spec: Spec


def _current():
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def use_rules(mesh, rules: Rules):
    """Activate a (mesh, logical-rule) context for `shard` annotations;
    `mesh` is a `MeshShape` or a `DeviceMesh`."""
    prev = _current()
    _state.ctx = (mesh, rules)
    try:
        yield
    finally:
        _state.ctx = prev


def resolve_spec(names: Sequence[Optional[str]], rules: Rules) -> Spec:
    axes = []
    used: set = set()
    for n in names:
        if n is None:
            axes.append(None)
            continue
        a = rules.get(n)
        # A mesh axis may appear only once in a spec; later logical dims
        # that map to an already-used axis fall back to replication.
        if a is None:
            axes.append(None)
        elif isinstance(a, tuple):
            fresh = tuple(x for x in a if x not in used)
            used.update(fresh)
            axes.append(fresh if fresh else None)
        else:
            if a in used:
                axes.append(None)
            else:
                used.add(a)
                axes.append(a)
    return Spec(*axes)


# Logical axes the port does not split over a mesh axis of size > 1.
NOT_SPLIT = {"expert": "expert parallelism"}


def shard(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """`x` itself, outside `use_rules` and inside it (module docstring).
    Raises where a rule puts a dimension of `NOT_SPLIT` on a mesh axis of
    size > 1."""
    ctx = _current()
    if ctx is None:
        return x
    from repro_torch.launch.mesh import MeshShape

    mesh, rules = ctx
    if len(names) != x.dim():
        raise ValueError(f"{len(names)} names for rank-{x.dim()} tensor")
    sizes = MeshShape.of(mesh).shape
    for name, entry in zip(names, resolve_spec(names, rules)):
        wide = [a for a in axes_of(entry) if sizes[a] > 1]
        if wide and name in NOT_SPLIT:
            raise NotImplementedError(
                f"logical axis {name!r} sharded over mesh axes {wide}: {NOT_SPLIT[name]} "
                f"is not ported (ROADMAP A.4c)")
    return x


def sharding_for(mesh, rules: Rules, *names: Optional[str]) -> NamedSharding:
    return NamedSharding(mesh, resolve_spec(names, rules))
