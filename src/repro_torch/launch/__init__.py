"""Launchers, step builders and the analysis tools of the port (port of
repro/launch/__init__.py).

Everything is lazy: ``from repro_torch.launch import dryrun`` or
``repro_torch.launch.make_train_step`` resolves on first touch, without
importing every launcher.

  serve, train        the command-line entry points
  steps               the step builders and the dry run's meta structs
  step_cost           what an eager step computes, moves and holds
                      (the counterpart of the reference's hlo_cost.py)
  roofline, dryrun    a step's roofline on one H100; every (arch x shape) cell
  diagnose            a step's work by source, counted or profiled
  mesh                `MeshShape`, the local and production meshes
"""

import importlib

_SUBMODULES = ("diagnose", "dryrun", "mesh", "roofline", "serve", "step_cost", "steps",
               "train")

_LAZY = {
    "make_train_step": ("repro_torch.launch.steps", "make_train_step"),
    "make_prefill_step": ("repro_torch.launch.steps", "make_prefill_step"),
    "make_serve_step": ("repro_torch.launch.steps", "make_serve_step"),
    "input_specs": ("repro_torch.launch.steps", "input_specs"),
    "optimizer_config": ("repro_torch.launch.steps", "optimizer_config"),
    "make_sharded_train_step": ("repro_torch.launch.steps", "make_sharded_train_step"),
    "make_local_mesh": ("repro_torch.launch.mesh", "make_local_mesh"),
    "make_production_mesh": ("repro_torch.launch.mesh", "make_production_mesh"),
}

__all__ = sorted(set(_SUBMODULES) | set(_LAZY))


def __getattr__(name: str):
    if name in _LAZY:
        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    if name in _SUBMODULES:
        return importlib.import_module(f"repro_torch.launch.{name}")
    raise AttributeError(f"module 'repro_torch.launch' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
