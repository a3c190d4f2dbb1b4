"""The tiled GeMM: CUDA kernel wrapper, its plain version, a launch count.

Port of repro/kernels/gemm.py::_gemm_kernel (the Pallas TPU kernel built by
`make_gemm`).  The kernel, `csrc/gemm.cu`, computes C = A @ B with float32
accumulation for float32 or bfloat16 operands and writes C in the dtype the
caller asks for.  It is bound by B's bytes at decode batch sizes (every
launch reads all of B; the note at the top of gemm.cu says what the simple
design does about that and what a later PR changes).

Dispatch is by device: a CUDA tensor launches the kernel (or raises), a CPU
tensor runs the plain version `gemm_plain`.  No fallback on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref

# Launches of the CUDA kernel since the last reset (the plain version never
# counts): the proof that a run went through the kernel.
launches = 0

BM_SMALL, BM_LARGE, BN, BK = 16, 64, 128, 32   # must match csrc/gemm.cu
_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2**31 - 1


def reset_launches() -> None:
    global launches
    launches = 0


def _lib():
    lib = _build.load("gemm")
    fn = lib.gemm_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def split_k(M: int, N: int, K: int, sms: int, *,
            tile=(BM_SMALL, BM_LARGE, BN, BK)) -> int:
    """K splits for one launch on a card with `sms` multiprocessors: 1 when
    the output tiles alone give every SM two blocks, else enough splits to
    get there, keeping >= 4 K-steps per split (capped at 16).  `tile` is
    the kernel's (small-M rows, rows, columns, K depth)."""
    bm_small, bm_large, bn, bk = tile
    bm = bm_small if M <= bm_small else bm_large
    tiles = -(-M // bm) * -(-N // bn)
    k_steps = -(-K // bk)
    if tiles >= 2 * sms:
        return 1
    splits = max(1, min(-(-2 * sms // tiles), k_steps // 4, 16))
    kps = -(-k_steps // splits)
    return -(-k_steps // kps)          # no empty trailing split


def gemm_plain(a: torch.Tensor, b: torch.Tensor,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel's function in plain PyTorch: f32-accumulated A @ B."""
    return ref.gemm_ref(a, b).to(out_dtype)


def gemm(a: torch.Tensor, b: torch.Tensor, *,
         out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """C = A @ B for a (M, K) and b (K, N), any strides, f32 accumulation,
    C (M, N) contiguous in `out_dtype`."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"gemm operands on {a.device} and {b.device}")
    if a.device.type == "cpu":
        return gemm_plain(a, b, out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"gemm: no kernel for device {a.device}")
    return _gemm_cuda(a, b, out_dtype)


def _gemm_cuda(a: torch.Tensor, b: torch.Tensor,
               out_dtype: torch.dtype) -> torch.Tensor:
    global launches
    if a.dtype != b.dtype or a.dtype not in _CODES:
        raise TypeError(f"gemm kernel takes f32/bf16 pairs, got {a.dtype}, {b.dtype}")
    if out_dtype not in _CODES:
        raise TypeError(f"gemm kernel writes f32 or bf16, not {out_dtype}")
    M, K = a.shape
    N = b.shape[1]
    if min(M, N, K) < 1 or max(M, N, K) > _INT_MAX or M * N > _INT_MAX:
        raise ValueError(f"gemm kernel shape ({M}, {K}, {N}) out of range")
    strides = (*a.stride(), *b.stride())
    if min(strides) < 0:
        raise ValueError("gemm kernel takes non-negative strides only")
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    splits = split_k(M, N, K, sm_count(a.device))
    ws = (torch.empty((splits, M, N), dtype=torch.float32, device=a.device)
          if splits > 1 else None)
    err = _lib()(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                 None if ws is None else ws.data_ptr(),
                 M, N, K, *strides, _CODES[a.dtype], _CODES[out_dtype], splits,
                 torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"gemm kernel launch failed: cudaError_t {err}")
    launches += 1
    return out
