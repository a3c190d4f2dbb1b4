"""Sharding plans, the data-parallel / ZeRO-3 / head-parallel placements
and the tensor-parallel operators: the stable ``repro_torch.parallel`` API
(port of repro/parallel/__init__.py).

Lazy re-exports, as in the reference, so ``from repro_torch.parallel
import shard`` does not load the plans into every model import.  The
reference's ``gpipe`` and ``split_stages`` (pipeline parallelism) are not
ported: looking either up raises AttributeError naming ROADMAP A.4c.
"""

import importlib

_SUBMODULES = ("fsdp", "logical", "sharding", "tensor")

_LAZY = {
    # logical axis rules (the model layer's shard() calls resolve here)
    "use_rules": ("repro_torch.parallel.logical", "use_rules"),
    "resolve_spec": ("repro_torch.parallel.logical", "resolve_spec"),
    "shard": ("repro_torch.parallel.logical", "shard"),
    "sharding_for": ("repro_torch.parallel.logical", "sharding_for"),
    # plans: params/batch/cache shardings from a mesh + plan
    "ParallelPlan": ("repro_torch.parallel.sharding", "ParallelPlan"),
    "make_plan": ("repro_torch.parallel.sharding", "make_plan"),
    "param_sharding": ("repro_torch.parallel.sharding", "param_sharding"),
    "batch_sharding": ("repro_torch.parallel.sharding", "batch_sharding"),
    "cache_sharding": ("repro_torch.parallel.sharding", "cache_sharding"),
}

_NOT_PORTED = ("gpipe", "split_stages")

__all__ = sorted(set(_SUBMODULES) | set(_LAZY))


def __getattr__(name: str):
    if name in _LAZY:
        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    if name in _SUBMODULES:
        return importlib.import_module(f"repro_torch.parallel.{name}")
    if name in _NOT_PORTED:
        raise AttributeError(f"repro_torch.parallel.{name}: pipeline parallelism "
                             f"(repro/parallel/pipeline.py) is not ported (ROADMAP A.4c)")
    raise AttributeError(f"module 'repro_torch.parallel' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
