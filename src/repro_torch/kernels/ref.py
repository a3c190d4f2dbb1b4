"""Plain PyTorch versions of the kernels' arithmetic (port of
repro/kernels/ref.py).

These are the oracles the CUDA kernels are held against, and what the
wrappers run for tensors that lie on the CPU.
"""

from __future__ import annotations

import torch


def gemm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B with the OpenGeMM accumulation rule for float operands:
    accumulate in float32 (f32 out).  bf16 products are exact in f32, so
    upcasting the operands first changes no product.  On a CUDA device TF32
    is switched off so the f32 product stays exact-f32 FMA arithmetic."""
    if not (a.is_floating_point() and b.is_floating_point()):
        raise NotImplementedError("int8 slice")
    if a.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    return torch.matmul(a.to(torch.float32), b.to(a.dtype).to(torch.float32))
