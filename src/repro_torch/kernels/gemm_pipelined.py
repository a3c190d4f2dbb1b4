"""The depth-D pipelined GeMM: CUDA kernel wrapper, its plain version, a
launch count.

Port of repro/kernels/gemm_pipelined.py (`_pipelined_kernel`, built by
`make_pipelined_gemm`), the paper's D_stream knob: input tiles pre-fetched
`depth` K steps ahead of the compute, through a ring of `depth` buffers per
operand.  The kernel, `csrc/gemm_pipelined.cu`, fills a shared-memory ring
with cp.async copies and computes C = A @ B with f32 accumulation for f32 or
bf16 operands (bf16 on the tensor cores, through the body it shares with
K1), or exact int32 sums for int8 operands (the reference writes the
accumulator dtype).  Bound by B's bytes at decode batch sizes; the note at
the top of the .cu file says what the design does about that.  One launch
per call: the launch plan and the split-K scratch are K1's
(`gemm.gemm_plan`, `gemm.splitk_scratch`), overridden, with the depth, by a
tuned `gemm.GemmLaunchSpec`.

`depth` is 2, 3 or 4 (default 3, the case study's D_stream =
repro/core/generator.py:63); it is clamped as the reference clamps it:
max(2, depth), then at most the K steps.

Dispatch is by device: a CUDA tensor launches the kernel (or raises), a CPU
tensor runs the plain version `gemm_plain`.  No fallback on the card.  A
meta tensor reports the launch's cost (`gemm.meta_gemm`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.gemm import (GemmLaunchSpec, check_launch, launch_plan,
                                      meta_gemm, operands_for_copies)

# Launches of the CUDA kernel since the last reset (the plain version never
# counts): the proof that a run went through the kernel.
launches = 0

DEFAULT_DEPTH = 3
MAX_DEPTH = 4                      # instantiated in csrc/gemm_pipelined.cu
_IN_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}


def reset_launches() -> None:
    global launches
    launches = 0


@functools.lru_cache(maxsize=None)
def _lib():
    fn = _build.load("gemm_pipelined").gemm_pipelined_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def clamp_depth(depth: int, k_steps: int) -> int:
    """The ring depth a launch runs: max(2, depth), then at most the K
    steps (but never below 2, the kernel's least ring)."""
    if not 1 <= depth <= MAX_DEPTH:
        raise ValueError(f"pipelined gemm depth must be in 1..{MAX_DEPTH}, got {depth}")
    return max(2, min(max(2, depth), k_steps))


def _acc_dtype(a: torch.Tensor, b: torch.Tensor) -> torch.dtype:
    return torch.int32 if a.dtype == b.dtype == torch.int8 else torch.float32


def gemm_plain(a: torch.Tensor, b: torch.Tensor,
               out_dtype=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: int8 -> exact int32, floats
    f32-accumulated (`out_dtype` defaults to the accumulator's)."""
    return ref.gemm_ref(a, b).to(out_dtype or _acc_dtype(a, b))


def gemm(a: torch.Tensor, b: torch.Tensor, *, depth: Optional[int] = None,
         out_dtype=None, spec: Optional[GemmLaunchSpec] = None) -> torch.Tensor:
    """C = A @ B for a (M, K) and b (K, N), any strides.  Floats accumulate
    in f32 and C is f32 unless `out_dtype` is bf16 (rounded once); int8
    operands give exact int32.  `spec`: a tuned launch plan (None: K1's
    rule); `depth` None takes the spec's depth, else DEFAULT_DEPTH."""
    if depth is None:
        depth = spec.depth if spec is not None and spec.depth else DEFAULT_DEPTH
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"pipelined gemm shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"pipelined gemm operands on {a.device} and {b.device}")
    acc = _acc_dtype(a, b)
    out_dtype = out_dtype or acc
    if acc == torch.int32 and out_dtype != torch.int32:
        raise TypeError(f"pipelined gemm writes int8 x int8 as int32, not {out_dtype}")
    clamp_depth(depth, 1)                            # validate on every device
    if a.device.type == "meta":
        return meta_gemm("gemm_pipelined", a, b, out_dtype)
    if a.device.type == "cpu":
        return gemm_plain(a, b, out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"pipelined gemm: no kernel for device {a.device}")
    return _gemm_cuda(a, b, depth, out_dtype, spec)


def _gemm_cuda(a: torch.Tensor, b: torch.Tensor, depth: int,
               out_dtype: torch.dtype, spec: Optional[GemmLaunchSpec]) -> torch.Tensor:
    global launches
    if a.dtype != b.dtype or a.dtype not in _IN_CODES:
        raise TypeError(f"pipelined gemm kernel takes f32/bf16/int8 pairs, "
                        f"got {a.dtype}, {b.dtype}")
    if out_dtype not in _OUT_CODES:
        raise TypeError(f"pipelined gemm kernel writes f32, bf16 or int32, not {out_dtype}")
    M, N, K = check_launch(a, b, "pipelined gemm")
    a, b, kmajor = operands_for_copies(a, b)
    dev = a.device
    plan, ws, counters = launch_plan(M, N, K, kmajor, a.element_size(), dev, spec)
    d = clamp_depth(depth, -(-K // plan.bk))
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    err = _lib()(a.data_ptr(), b.data_ptr(), out.data_ptr(), ws, counters, M, N, K,
                 a.stride(0), *b.stride(), _IN_CODES[a.dtype], _OUT_CODES[out_dtype], d,
                 plan.swap, plan.kmajor, plan.kps, plan.splits,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"pipelined gemm kernel launch failed: cudaError_t {err}")
    launches += 1
    return out
