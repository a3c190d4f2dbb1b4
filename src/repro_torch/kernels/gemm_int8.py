"""The int8 GeMM: CUDA kernel wrappers, their plain versions, launch counts.

Port of repro/kernels/gemm.py::_dequant_gemm_kernel (the Pallas TPU kernel
built by `make_dequant_gemm`) and of the int8 x int8 -> int32 mode of
`_gemm_kernel`.  One CUDA source, `csrc/gemm_int8.cu`, holds both: an
int32 accumulator in registers, and either the fused dequant epilogue
C = (float(A @ B) * sa) * sb (`dequant_gemm`) or the raw int32 sums
(`gemm_int`).  Integer sums are exact and the epilogue's order is fixed, so
the kernel equals its plain version bit for bit.

The kernel reads B fastest when it is K-contiguous: `quant.params` stores
every weight as an (N, K) tensor and hands out its (K, N) `.t()` view.

Dispatch is by device: a CUDA tensor launches the kernel (or raises), a CPU
tensor runs the plain version.  No fallback on the card.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.gemm import sm_count

# Launches of the CUDA kernel since the last reset (the plain versions never
# count): `launches` for the dequant mode (K3), `int_launches` for the int
# mode (K1 on int8 operands).
launches = 0
int_launches = 0

TILE = (16, 64, 128, 64)   # small-M rows, rows, columns, K bytes: csrc/gemm_int8.cu
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_INT_MAX = 2**31 - 1


def reset_launches() -> None:
    global launches, int_launches
    launches = int_launches = 0


def split_k(M: int, N: int, K: int, sms: int) -> int:
    """K splits for one launch on a card with `sms` multiprocessors: 1 when
    the output tiles alone give every SM two blocks, else enough splits to
    get there, keeping >= 4 K-steps per split (capped at 16).  The kernel
    writes each split's partial tile to a workspace that a second pass
    reduces in split order."""
    bm_small, bm_large, bn, bk = TILE
    bm = bm_small if M <= bm_small else bm_large
    tiles = -(-M // bm) * -(-N // bn)
    k_steps = -(-K // bk)
    if tiles >= 2 * sms:
        return 1
    splits = max(1, min(-(-2 * sms // tiles), k_steps // 4, 16))
    kps = -(-k_steps // splits)
    return -(-k_steps // kps)          # no empty trailing split


def _lib():
    fn = _build.load("gemm_int8").gemm_int8_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
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


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"int8 gemm shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8 gemm takes int8 operands, got {a.dtype}, {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"int8 gemm operands on {a.device} and {b.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"int8 gemm: no kernel for device {a.device}")


def dequant_gemm(a_q: torch.Tensor, b_q: torch.Tensor, sa: torch.Tensor,
                 sb: torch.Tensor, *,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
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
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dequant gemm kernel writes f32 or bf16, not {out_dtype}")
    global launches
    out = _launch(a_q, b_q, sa.contiguous(), sb.contiguous(), out_dtype)
    launches += 1
    return out


def gemm_int(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B for int8 a (M, K) and b (K, N), any strides: exact int32."""
    _check(a, b)
    if a.device.type == "cpu":
        return gemm_int_plain(a, b)
    global int_launches
    out = _launch(a, b, None, None, torch.int32)
    int_launches += 1
    return out


def _launch(a, b, sa, sb, out_dtype):
    M, K = a.shape
    N = b.shape[1]
    if min(M, N, K) < 1 or max(M, N, K) > _INT_MAX or M * N > _INT_MAX:
        raise ValueError(f"int8 gemm kernel shape ({M}, {K}, {N}) out of range")
    strides = (*a.stride(), *b.stride())
    if min(strides) < 0:
        raise ValueError("int8 gemm kernel takes non-negative strides only")
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    splits = split_k(M, N, K, sm_count(a.device))
    ws = (torch.empty((splits, M, N), dtype=torch.int32, device=a.device)
          if splits > 1 else None)
    err = _lib()(a.data_ptr(), b.data_ptr(),
                 None if sa is None else sa.data_ptr(),
                 None if sb is None else sb.data_ptr(),
                 out.data_ptr(), None if ws is None else ws.data_ptr(),
                 M, N, K, *strides, _OUT_CODES[out_dtype], splits,
                 torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"int8 gemm kernel launch failed: cudaError_t {err}")
    return out
