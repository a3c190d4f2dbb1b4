"""The depth-D pipelined GeMM: CUDA kernel wrapper, its plain version, a
launch count.

Port of repro/kernels/gemm_pipelined.py (`_pipelined_kernel`, built by
`make_pipelined_gemm`), the paper's D_stream knob: input tiles pre-fetched
`depth` K steps ahead of the compute, through a ring of `depth` buffers per
operand.  The kernel, `csrc/gemm_pipelined.cu`, fills a shared-memory ring
with cp.async copies and computes C = A @ B with f32 accumulation for f32 or
bf16 operands, or exact int32 sums for int8 operands (the reference writes
the accumulator dtype).  Bound by B's bytes at decode batch sizes; the note
at the top of the .cu file says what the design does about that.

`depth` is 2, 3 or 4 (default 3, the case study's D_stream =
repro/core/generator.py:63); it is clamped as the reference clamps it:
max(2, depth), then at most the K steps.

Dispatch is by device: a CUDA tensor launches the kernel (or raises), a CPU
tensor runs the plain version `gemm_plain`.  No fallback on the card.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.gemm import sm_count, split_k

# Launches of the CUDA kernel since the last reset (the plain version never
# counts): the proof that a run went through the kernel.
launches = 0

DEFAULT_DEPTH = 3
MAX_DEPTH = 4                      # instantiated in csrc/gemm_pipelined.cu
TILE = (16, 64, 128, 32)           # small-M rows, rows, columns, K depth: the .cu file
_IN_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_INT_MAX = 2**31 - 1


def reset_launches() -> None:
    global launches
    launches = 0


def _lib():
    fn = _build.load("gemm_pipelined").gemm_pipelined_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
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


def gemm(a: torch.Tensor, b: torch.Tensor, *, depth: int = DEFAULT_DEPTH,
         out_dtype=None) -> torch.Tensor:
    """C = A @ B for a (M, K) and b (K, N), any strides.  Floats accumulate
    in f32 and C is f32 unless `out_dtype` is bf16 (rounded once); int8
    operands give exact int32."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"pipelined gemm shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"pipelined gemm operands on {a.device} and {b.device}")
    acc = _acc_dtype(a, b)
    out_dtype = out_dtype or acc
    if acc == torch.int32 and out_dtype != torch.int32:
        raise TypeError(f"pipelined gemm writes int8 x int8 as int32, not {out_dtype}")
    clamp_depth(depth, 1)                            # validate on every device
    if a.device.type == "cpu":
        return gemm_plain(a, b, out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"pipelined gemm: no kernel for device {a.device}")
    return _gemm_cuda(a, b, depth, out_dtype)


def _aligned(t: torch.Tensor, lead_stride: int) -> bool:
    """Every row of `t` along its unit-stride axis starts 16-byte aligned."""
    return t.data_ptr() % 16 == 0 and (lead_stride * t.element_size()) % 16 == 0


def _relaid(t: torch.Tensor) -> torch.Tensor:
    """A copy of 2-D `t` with its last axis contiguous and each row padded
    to a multiple of 16 bytes (the view keeps the logical shape)."""
    rows, cols = t.shape
    per = 16 // t.element_size()
    buf = torch.zeros((rows, -(-cols // per) * per), dtype=t.dtype, device=t.device)
    buf[:, :cols] = t
    return buf[:, :cols]


def _gemm_cuda(a: torch.Tensor, b: torch.Tensor, depth: int,
               out_dtype: torch.dtype) -> torch.Tensor:
    global launches
    if a.dtype != b.dtype or a.dtype not in _IN_CODES:
        raise TypeError(f"pipelined gemm kernel takes f32/bf16/int8 pairs, "
                        f"got {a.dtype}, {b.dtype}")
    if out_dtype not in _OUT_CODES:
        raise TypeError(f"pipelined gemm kernel writes f32, bf16 or int32, not {out_dtype}")
    M, K = a.shape
    N = b.shape[1]
    if min(M, N, K) < 1 or max(M, N, K) > _INT_MAX or M * N > _INT_MAX:
        raise ValueError(f"pipelined gemm kernel shape ({M}, {K}, {N}) out of range")
    if min(*a.stride(), *b.stride()) < 0:
        raise ValueError("pipelined gemm kernel takes non-negative strides only")
    # The copies move 16-byte chunks along each operand's unit-stride axis.
    if not (a.stride(1) == 1 and _aligned(a, a.stride(0))):
        a = _relaid(a)
    if b.stride(0) == 1 and b.stride(1) != 1:         # (N, K) store, K contiguous
        if not _aligned(b, b.stride(1)):
            b = _relaid(b.t()).t()
    elif not (b.stride(1) == 1 and _aligned(b, b.stride(0))):
        b = _relaid(b)
    sbk, sbn = b.stride()
    k_steps = -(-K // TILE[3])
    d = clamp_depth(depth, k_steps)
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    splits = split_k(M, N, K, sm_count(a.device), tile=TILE)
    ws = (torch.empty((splits, M, N), dtype=_acc_dtype(a, b), device=a.device)
          if splits > 1 else None)
    err = _lib()(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                 None if ws is None else ws.data_ptr(), M, N, K, a.stride(0), sbk, sbn,
                 _IN_CODES[a.dtype], _OUT_CODES[out_dtype], d, splits,
                 torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"pipelined gemm kernel launch failed: cudaError_t {err}")
    launches += 1
    return out
