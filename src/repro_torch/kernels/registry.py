"""Kernel registry: the port's GeMM variants by name (port of
repro/kernels/registry.py).

Each entry maps a name to the GeMM function of one variant; `ops.gemm` and
`ops.linear` resolve their backend through this table, so a new variant is
one `register_kernel` call.  The reference's factories specialise a Pallas
kernel for a `TpuGemmSpec` design point; here the design point is a launch
plan (`gemm.GemmLaunchSpec`: split count, tile, K6's ring depth) that every
entry takes per call as `spec=` (None: the hand rule's), so an entry is
the function itself.

  "tiled"      kernels/gemm.py           K1 (the reference's "pallas")
  "pipelined"  kernels/gemm_pipelined.py K6 (depth 3, or the spec's)
  "dequant"    kernels/gemm_int8.py      K3: int8 x int8 -> scaled float
  "w8a8"       kernels/gemm_int8.py      K4's row quantization in K3's prologue (M <= 16)
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.kernels import gemm as _gemm
from repro_torch.kernels import gemm_int8 as _gemm_int8
from repro_torch.kernels import gemm_pipelined as _pipelined

_REGISTRY: Dict[str, Callable] = {}


def register_kernel(name: str, fn: Callable) -> None:
    """Add a kernel variant under a new name."""
    if name in _REGISTRY:
        raise ValueError(f"kernel {name!r} already registered")
    _REGISTRY[name] = fn


def registered_kernels() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def make_kernel(name: str) -> Callable:
    """The GeMM function of variant `name`."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown kernel {name!r}; registered: {registered_kernels()}") from None


def _tiled(a, b, *, out_dtype=None, spec=None):
    """K1: int8 x int8 -> int32 (its int mode), floats -> f32 or out_dtype."""
    if a.dtype == b.dtype == torch.int8:
        return _gemm_int8.gemm_int(a, b, spec=spec)
    return _gemm.gemm(a, b, out_dtype=out_dtype or torch.float32, spec=spec)


register_kernel("tiled", _tiled)
register_kernel("pipelined", _pipelined.gemm)
register_kernel("dequant", _gemm_int8.dequant_gemm)
register_kernel("w8a8", _gemm_int8.gemm_w8a8)
