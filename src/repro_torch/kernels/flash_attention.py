"""Flash attention: CUDA kernel wrapper, its plain version, a launch count.

Port of repro/kernels/flash_attention.py: `flash_attention` launches
`csrc/flash_attention.cu`, the hand-written replacement for the Pallas TPU
kernel `_flash_kernel`: full-sequence attention over q (B, Sq, Hq, D) and
k/v (B, Skv, Hkv, D) with causal and sliding-window masks and GQA, online
softmax, the score matrix never in device memory.  It is bound by its
operations (~2 * Sq * Skv * D multiply-adds per q head, halved by the
causal mask): bf16 inputs run on the tensor cores (mma.sync), f32 inputs on
a SIMT FMA body that keeps full f32; the note at the top of the .cu file
says what each design does about it.

The plain version `flash_attention_plain` is the reference kernel's
arithmetic (q scaled in f32 before the dot, p rounded to v's dtype before
PV) as an online-softmax walk over kv blocks of `block_kv` keys.

Dispatch is by device: a CUDA tensor launches the kernel (or raises), a CPU
tensor runs the plain version.  No fallback on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

# Launches of the CUDA kernel since the last reset (the plain version never
# counts): the proof that a run went through the kernel.
launches = 0

_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 256)   # instantiated in csrc/flash_attention.cu
_INT_MAX = 2**31 - 1


def reset_launches() -> None:
    global launches
    launches = 0


def _lib():
    fn = _build.load("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: Optional[int] = None,
                          block_kv: int = 512) -> torch.Tensor:
    """The kernel's function in plain PyTorch (kv blocks of `block_kv` keys,
    the reference kernel's default tile)."""
    return ref.blockwise_attention_ref(q, k, v, causal=causal, window=window,
                                       block_kv=block_kv, scale_in_f32=True)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3] \
            or k.shape[2] < 1 or q.shape[2] % k.shape[2]:
        raise ValueError(f"flash attention shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"flash attention operands on {q.device}, {k.device}, {v.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Attention of q (B, Sq, Hq, D) over k, v (B, Skv, Hkv, D), query and
    key positions both from 0: out (B, Sq, Hq, D) in q's dtype."""
    _check(q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"flash attention window must be >= 1, got {window}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention: no kernel for device {q.device}")
    return _flash_cuda(q, k, v, causal, window)


def _flash_cuda(q, k, v, causal: bool, window: Optional[int]) -> torch.Tensor:
    global launches
    if q.dtype not in _CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention kernel takes f32/bf16 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash attention kernel: head_dim {D} not in {_HEAD_DIMS}")
    if min(B, Sq, Skv) < 1 or max(q.numel(), k.numel()) > _INT_MAX:
        raise ValueError(f"flash attention kernel shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)} out of range")
    # 16-byte copies: a contiguous view that starts off a 16-byte boundary is
    # copied (fresh allocations are aligned).
    q, k, v = (t if t.is_contiguous() and t.data_ptr() % 16 == 0 else t.clone(
        memory_format=torch.contiguous_format) for t in (q, k, v))
    out = torch.empty_like(q)
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Sq, Skv, Hq, Hkv, D, int(causal),
                 0 if window is None else int(window), D ** -0.5, _CODES[q.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash attention kernel launch failed: cudaError_t {err}")
    launches += 1
    return out
