"""Public GeMM ops (port of repro/kernels/ops.py, float path).

Every dense projection of the port routes through `linear`, so the GeMM
kernel underlies the whole model.  There is no backend switch: a CUDA
tensor always launches the hand-written kernel (kernels/gemm.py) and a CPU
tensor runs its plain version.  The kernel masks ragged edges itself, so
the reference's tile padding (`_pad2`) has no counterpart.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import gemm as _gemm


def gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B, a (M, K), b (K, N); float operands accumulate to f32."""
    return _gemm.gemm(a, b, out_dtype=torch.float32)


def linear(x: torch.Tensor, w, *, quant: Optional[str] = None) -> torch.Tensor:
    """y = x @ w for x (..., K) and a float w (K, N), f32 accumulation, y in
    x's dtype.  The int8 deployment path is not ported yet."""
    if quant not in (None, "none") or not isinstance(w, torch.Tensor) \
            or not w.is_floating_point():
        raise NotImplementedError("int8 slice")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    out = _gemm.gemm(x2, w.to(x2.dtype), out_dtype=x.dtype)
    return out.reshape(*lead, w.shape[-1])
