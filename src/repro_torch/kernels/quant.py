"""Per-row int8 quantization: CUDA kernel wrapper, its plain version, a
launch count.

Port of repro/kernels/quant.py: `_quant_kernel` (entry `quantize_rows`)
becomes `csrc/quant.cu`, one block per row, so ragged M needs no padding.
x (M, K) float -> (q int8 (M, K), scale f32 (M, 1)) with
scale = max(absmax, 1e-8) * f32(1/127), codes round(x / scale) half to even,
clipped to +-127.

With a static scale (`act_scale`, one float32 on x's device: calibrated
w8a8) every row takes it, with no absmax, and the codes are round(x / s)
by true division: the reference's static branch (repro/kernels/ops.py,
`gemm_w8a8`), there plain jnp.

The scale multiplies by the float32 reciprocal of 127 rather than dividing:
that is what the reference computes wherever it runs compiled (XLA turns a
division by a constant into a multiply by its reciprocal), in its Pallas
kernel and in every jitted serving step.  The eager `quantize_ref` divides
and lands one ulp away in about 1 row in 20.

This kernel serves `ops.quantize`, the int8 path on float weights
(`ops.linear(..., quant="int8")`) and the w8a8 GeMM above 16 rows
(`gemm_int8.gemm_w8a8`, then the dequant GeMM); at 16 rows or fewer the
w8a8 GeMM runs the same arithmetic in its own prologue, one launch.

Dispatch is by device: a CUDA tensor launches the kernel (or raises), a CPU
tensor runs the plain version.  No fallback on the card.  A meta tensor
reports the launch's cost (kernels/cost.py).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, cost

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
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def quantize_rows_plain(x: torch.Tensor, act_scale=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch."""
    xf = x.to(torch.float32)
    if act_scale is None:
        absmax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
        scale = torch.clamp_min(absmax, 1e-8) * RCP127
    else:
        scale = torch.as_tensor(act_scale, dtype=torch.float32, device=x.device) \
            .reshape(1, 1).expand(x.shape[0], 1)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def check_static_scale(act_scale, device: torch.device) -> None:
    """The kernels read a static scale on the device: a one-element float32
    tensor on `device`, never a host value (no copy, no sync per call)."""
    if not (torch.is_tensor(act_scale) and act_scale.numel() == 1
            and act_scale.dtype == torch.float32 and act_scale.device == device):
        raise TypeError("the kernels take the static scale as a one-element float32 "
                        f"tensor on {device}")


def quantize_rows(x: torch.Tensor, act_scale: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization of x (M, K) per row, or with the static
    scale `act_scale` for every row: (q (M, K) int8, scale (M, 1) float32)."""
    if x.dim() != 2:
        raise ValueError(f"quantize_rows takes (M, K), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return quantize_rows_plain(x, act_scale)
    if x.device.type == "meta":
        M, K = x.shape
        return cost.meta_launch("quantize_rows", cost.quantize_rows(
            M, K, x_bytes=x.element_size()), ((M, K), torch.int8), ((M, 1), torch.float32))
    if x.device.type != "cuda":
        raise ValueError(f"quantize_rows: no kernel for device {x.device}")
    if x.dtype not in _CODES:
        raise TypeError(f"quantize_rows kernel takes f32/bf16, got {x.dtype}")
    if act_scale is not None:
        check_static_scale(act_scale, x.device)
    M, K = x.shape
    if min(M, K) < 1 or M >= 2**31 or K >= 2**31:
        raise ValueError(f"quantize_rows kernel shape ({M}, {K}) out of range")
    if x.stride(1) != 1:
        x = x.contiguous()
    q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    s = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    err = _lib()(x.data_ptr(), q.data_ptr(), s.data_ptr(),
                 None if act_scale is None else act_scale.data_ptr(), M, K, x.stride(0),
                 _CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"quantize_rows kernel launch failed: cudaError_t {err}")
    global launches
    launches += 1
    return q, s

