"""The int8 GeMM: CUDA kernel wrappers, their plain versions, launch counts.

Port of repro/kernels/gemm.py::_dequant_gemm_kernel (the Pallas TPU kernel
built by `make_dequant_gemm`), of the int8 x int8 -> int32 mode of
`_gemm_kernel`, and of their composition with the row quantization in
repro/kernels/quant.py::make_w8a8_gemm.  One CUDA source,
`csrc/gemm_int8.cu`, runs all three on the tensor cores with an int32
accumulator:

  `dequant_gemm`  int8 A and B -> C = (float(A @ B) * sa) * sb     (K3)
  `gemm_int`      int8 A and B -> exact int32 C                    (K1's int mode)
  `gemm_w8a8`     float A, int8 B: A's rows quantized to int8 (per row, or
                  with a static scale), then as K3                  (K4 + K3)

The w8a8 GeMM's plan is a rule on M, like the tile's swap: at M <=
FUSED_ROWS (decode, short prefill chunks, the head at M = 1) the rows are
quantized inside the int8 GeMM's prologue, one launch; above it the row
quantization (K4, kernels/quant.py) runs first and K3 second, since every
one of the GeMM's N / 128 column blocks would quantize the same rows again
(chip_smoke.py phase 5 times both at M = 1, 8 and 64).

Integer sums are exact and the scale arithmetic's order is fixed, so each
kernel equals its plain version bit for bit.  The launch plan, the split-K
workspace and the tile counters are K1's (`gemm.launch_plan`), at 1-byte
elements; a launch allocates only its output.  A tuned `gemm.GemmLaunchSpec`
overrides the split count and, for the w8a8 GeMM at M <= FUSED_ROWS, the
choice of one launch or two (`spec.fused`); neither changes a bit of the
result (exact integer sums, a fixed epilogue).

The kernel reads B K-major: `quant.params` stores every weight as an (N, K)
tensor and hands out its (K, N) `.t()` view.  Another layout is re-laid to
K-major first, and an A whose rows are not K-contiguous and 16-byte
aligned is re-laid as K1's is (never on the model's path).

Dispatch is by device: a CUDA tensor launches the kernel (or raises), a CPU
tensor runs the plain version.  No fallback on the card.  A meta tensor
reports the launch's cost (kernels/cost.py) and returns an empty output.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build, cost, ref
from repro_torch.kernels.gemm import GemmLaunchSpec, check_launch, launch_plan, rows_for_copies
from repro_torch.kernels.quant import check_static_scale, quantize_rows, quantize_rows_plain

# Launches of the CUDA kernel since the last reset (the plain versions never
# count): `launches` with int8 codes and scales (K3), `int_launches` in the
# int mode (K1 on int8 operands), `w8a8_launches` with float activations
# (the row quantization fused into K3).
launches = 0
int_launches = 0
w8a8_launches = 0

FUSED_ROWS = 16   # the w8a8 GeMM quantizes in its prologue at M <= FUSED_ROWS

_A_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}


def reset_launches() -> None:
    global launches, int_launches, w8a8_launches
    launches = int_launches = w8a8_launches = 0


@functools.lru_cache(maxsize=None)
def _lib():
    fn = _build.load("gemm_int8").gemm_int8_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def dequant_gemm_plain(a_q: torch.Tensor, b_q: torch.Tensor, sa: torch.Tensor,
                       sb: torch.Tensor,
                       out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The dequant kernel's function in plain PyTorch."""
    return ref.gemm_dequant_ref(a_q, b_q, sa, sb).to(out_dtype)


def gemm_int_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The int mode's function in plain PyTorch: exact int32 sums."""
    return ref.gemm_ref(a, b)


def gemm_w8a8_plain(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                    act_scale=None,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The w8a8 GeMM's function in plain PyTorch, the composition the
    reference runs: x's rows quantized per row or with the static
    per-tensor `act_scale` (codes round(x / s), a true division, as the
    reference's jnp), then the dequant GeMM."""
    x_q, sx = quantize_rows_plain(x, act_scale)
    return dequant_gemm_plain(x_q, w_q, sx, w_scale.reshape(1, -1), out_dtype)


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"int8 gemm shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8 gemm takes int8 operands, got {a.dtype}, {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"int8 gemm operands on {a.device} and {b.device}")
    if a.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"int8 gemm: no kernel for device {a.device}")


def _elem(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _check_out(out_dtype: torch.dtype) -> None:
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"int8 gemm kernel writes f32 or bf16, not {out_dtype}")


def dequant_gemm(a_q: torch.Tensor, b_q: torch.Tensor, sa: torch.Tensor,
                 sb: torch.Tensor, *, out_dtype: torch.dtype = torch.float32,
                 spec: Optional[GemmLaunchSpec] = None) -> torch.Tensor:
    """C = (float(A_q @ B_q) * sa) * sb for a_q (M, K) and b_q (K, N) int8,
    any strides; sa (M, 1) row scales and sb (1, N) column scales, float32.
    C (M, N) contiguous in `out_dtype` (rounded once from the f32 value)."""
    _check(a_q, b_q)
    M, N = a_q.shape[0], b_q.shape[1]
    if sa.shape != (M, 1) or sb.shape != (1, N):
        raise ValueError(f"dequant scales {tuple(sa.shape)}, {tuple(sb.shape)} "
                         f"for a ({M}, K) x (K, {N}) product")
    if sa.dtype != torch.float32 or sb.dtype != torch.float32:
        raise TypeError(f"dequant scales must be float32, got {sa.dtype}, {sb.dtype}")
    if sa.device != a_q.device or sb.device != a_q.device:
        raise ValueError("dequant gemm: scales on another device than the operands")
    if a_q.device.type == "cpu":
        return dequant_gemm_plain(a_q, b_q, sa, sb, out_dtype)
    _check_out(out_dtype)
    if a_q.device.type == "meta":
        return cost.meta_launch("dequant_gemm", cost.dequant_gemm(
            M, a_q.shape[1], N, out_bytes=_elem(out_dtype)), ((M, N), out_dtype))
    global launches
    out = _launch(a_q, b_q, sa.contiguous(), sb.contiguous(), out_dtype, spec)
    launches += 1
    return out


def gemm_int(a: torch.Tensor, b: torch.Tensor, *,
             spec: Optional[GemmLaunchSpec] = None) -> torch.Tensor:
    """C = A @ B for int8 a (M, K) and b (K, N), any strides: exact int32."""
    _check(a, b)
    if a.device.type == "cpu":
        return gemm_int_plain(a, b)
    if a.device.type == "meta":
        M, K = a.shape
        return cost.meta_launch("gemm_int", cost.gemm(
            M, K, b.shape[1], a_bytes=1, b_bytes=1, out_bytes=4, bits=8),
            ((M, b.shape[1]), torch.int32))
    global int_launches
    out = _launch(a, b, None, None, torch.int32, spec)
    int_launches += 1
    return out


def gemm_w8a8(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
              act_scale: Optional[torch.Tensor] = None, *,
              out_dtype: torch.dtype = torch.float32,
              spec: Optional[GemmLaunchSpec] = None) -> torch.Tensor:
    """The int8-resident-weight GeMM: float x (M, K), int8 w_q (K, N) and
    its f32 per-column scales (1, N) or (N,) -> (M, N) in `out_dtype`
    (rounded once from the f32 value).  x's rows are quantized to int8 per
    row (dynamic), or with the static per-tensor `act_scale`, a one-element
    float32 tensor on x's device (calibrated mode).  On the card: one
    launch at M <= FUSED_ROWS (unless a tuned `spec` says two), else the
    row quantization and K3."""
    if x.dim() != 2 or w_q.dim() != 2 or x.shape[1] != w_q.shape[0]:
        raise ValueError(f"w8a8 gemm shapes {tuple(x.shape)} @ {tuple(w_q.shape)}")
    if w_q.dtype != torch.int8 or not x.is_floating_point():
        raise TypeError(f"w8a8 gemm takes float x and an int8 weight, got {x.dtype}, "
                        f"{w_q.dtype}")
    N = w_q.shape[1]
    if w_scale.dim() not in (1, 2) or w_scale.shape[-1] != N or w_scale.numel() != N:
        raise ValueError(f"w8a8 weight scales {tuple(w_scale.shape)} for {N} columns")
    if w_scale.dtype != torch.float32:
        raise TypeError(f"w8a8 weight scales must be float32, got {w_scale.dtype}")
    if x.device != w_q.device or w_scale.device != x.device:
        raise ValueError(f"w8a8 gemm operands on {x.device}, {w_q.device}, {w_scale.device}")
    if x.device.type == "cpu":
        return gemm_w8a8_plain(x, w_q, w_scale, act_scale, out_dtype)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"w8a8 gemm: no kernel for device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"w8a8 gemm kernel takes f32/bf16 activations, got {x.dtype}")
    _check_out(out_dtype)
    if act_scale is not None:
        check_static_scale(act_scale, x.device)
    if x.shape[0] <= FUSED_ROWS and (spec is None or spec.fused):
        if x.device.type == "meta":
            M, K = x.shape
            return cost.meta_launch("gemm_w8a8", cost.gemm_w8a8(
                M, K, N, x_bytes=x.element_size(), out_bytes=_elem(out_dtype)),
                ((M, N), out_dtype))
        return _w8a8_fused(x, w_q, w_scale, act_scale, out_dtype, spec)
    x_q, sx = quantize_rows(x, act_scale)
    return dequant_gemm(x_q, w_q, sx, w_scale.reshape(1, -1), out_dtype=out_dtype,
                        spec=spec)


def _w8a8_fused(x, w_q, w_scale, act_scale, out_dtype, spec=None):
    """The one-launch w8a8 GeMM at any M, on operands `gemm_w8a8` checked
    (chip_smoke.py also times it above FUSED_ROWS, the rule's evidence)."""
    global w8a8_launches
    out = _launch(x, w_q, act_scale, w_scale.contiguous(), out_dtype, spec)
    w8a8_launches += 1
    return out


def _launch(a, b, sa, sb, out_dtype, spec):
    M, N, K = check_launch(a, b, "int8 gemm")
    a, b = rows_for_copies(a), rows_for_copies(b.t()).t()   # B K-major
    dev = a.device
    plan, ws, counters = launch_plan(M, N, K, True, 1, dev, spec)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    err = _lib()(a.data_ptr(), b.data_ptr(),
                 None if sa is None else sa.data_ptr(),
                 None if sb is None else sb.data_ptr(),
                 out.data_ptr(), ws, counters, M, N, K, a.stride(0), b.stride(1),
                 _A_CODES[a.dtype], _OUT_CODES[out_dtype], plan.swap, plan.kps,
                 plan.splits, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"int8 gemm kernel launch failed: cudaError_t {err}")
    return out
