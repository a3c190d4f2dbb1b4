"""Per-row int8 quantization: CUDA kernel wrapper, its plain version, a
launch count; and the w8a8 GeMM that composes it with the dequant GeMM.

Port of repro/kernels/quant.py: `_quant_kernel` (entry `quantize_rows`)
becomes `csrc/quant.cu`, one block per row, so ragged M needs no padding.
x (M, K) float -> (q int8 (M, K), scale f32 (M, 1)) with
scale = max(absmax, 1e-8) * f32(1/127), codes round(x / scale) half to even,
clipped to +-127.

The scale multiplies by the float32 reciprocal of 127 rather than dividing:
that is what the reference computes wherever it runs compiled (XLA turns a
division by a constant into a multiply by its reciprocal), in its Pallas
kernel and in every jitted serving step.  The eager `quantize_ref` divides
and lands one ulp away in about 1 row in 20.

`gemm_w8a8` is `make_w8a8_gemm`'s composition: the rows quantize through
this kernel, then `gemm_int8.dequant_gemm` applies both scale sets on
write-back (two launches on the card; fusing the first into the second's
prologue is later work).

Dispatch is by device: a CUDA tensor launches the kernel (or raises), a CPU
tensor runs the plain version.  No fallback on the card.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build, gemm_int8

# Launches of the CUDA kernel since the last reset (the plain version never
# counts): the proof that a run went through the kernel.
launches = 0

_CODES = {torch.float32: 0, torch.bfloat16: 1}
RCP127 = 1.0 / 127.0   # rounds to the float32 reciprocal of 127 exactly


def reset_launches() -> None:
    global launches
    launches = 0


def _lib():
    fn = _build.load("quant").quantize_rows_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def quantize_rows_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch."""
    xf = x.to(torch.float32)
    absmax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    scale = torch.clamp_min(absmax, 1e-8) * RCP127
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization of x (M, K): (q (M, K) int8,
    scale (M, 1) float32)."""
    if x.dim() != 2:
        raise ValueError(f"quantize_rows takes (M, K), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return quantize_rows_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_rows: no kernel for device {x.device}")
    if x.dtype not in _CODES:
        raise TypeError(f"quantize_rows kernel takes f32/bf16, got {x.dtype}")
    M, K = x.shape
    if min(M, K) < 1 or M >= 2**31 or K >= 2**31:
        raise ValueError(f"quantize_rows kernel shape ({M}, {K}) out of range")
    if x.stride(1) != 1:
        x = x.contiguous()
    q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    s = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    err = _lib()(x.data_ptr(), q.data_ptr(), s.data_ptr(), M, K, x.stride(0),
                 _CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"quantize_rows kernel launch failed: cudaError_t {err}")
    global launches
    launches += 1
    return q, s


def gemm_w8a8(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor, *,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The int8-resident-weight GeMM: float x (M, K), int8 w_q (K, N) and
    its f32 per-column scales (1, N) -> (M, N) in `out_dtype`, activations
    row-quantized on the fly."""
    x_q, sx = quantize_rows(x)
    return gemm_int8.dequant_gemm(x_q, w_q, sx, w_scale.reshape(1, -1),
                                  out_dtype=out_dtype)
