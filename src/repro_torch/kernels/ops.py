"""Public GeMM ops (port of repro/kernels/ops.py).

Every dense projection of the port routes through `linear`, so the GeMM
kernels underlie the whole model.  The device decides whether a kernel
runs: a CUDA tensor always launches a hand-written kernel (or raises) and a
CPU tensor runs its plain version.  The backend only chooses which of two
hand kernels runs the float GeMM (and `gemm`'s int8 x int8 -> int32):

  "tiled"      kernels/gemm.py            K1 (the default; the reference's "pallas")
  "pipelined"  kernels/gemm_pipelined.py  K6, ring depth 3 (the case study's D_stream)

set process-wide with `set_default_backend` or per call with `backend=`.
The reference's "auto", "interpret" and "xla" have no counterpart (the
device decides) and raise.  The other kernels take no backend:

  int8 + dequant        kernels/gemm_int8.py  (K3)
  row quantization      kernels/quant.py      (K4)
  w8a8                  kernels/gemm_int8.py  (K4's arithmetic fused into K3)

As in the reference, int8-resident weights (`QuantTensor`) ignore the
backend: their activations quantize per row or with a static scale inside
the int8 GeMM at M <= 16 (`gemm_int8.gemm_w8a8`, one launch), through K4
then K3 above; float weights under quant="int8" take K4, then K3.

The kernels mask ragged edges themselves, so the reference's tile padding
(`_pad2`) has no counterpart.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import gemm_int8 as _gemm_int8
from repro_torch.kernels import quant as _quant
from repro_torch.kernels import ref
from repro_torch.kernels.registry import make_kernel
from repro_torch.quant import modes as _modes
from repro_torch.quant.params import QuantTensor

BACKENDS = ("tiled", "pipelined")
_NO_COUNTERPART = ("auto", "interpret", "xla")
_DEFAULT_BACKEND = "tiled"
_DEFAULT_GEMM = make_kernel(_DEFAULT_BACKEND)   # resolved once, not per call


def _check_backend(backend: str) -> str:
    if backend in _NO_COUNTERPART:
        raise ValueError(
            f"backend {backend!r} has no counterpart in the port: the tensor's "
            f"device decides between a hand kernel (CUDA) and its plain version "
            f"(CPU); choose one of {BACKENDS}")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; known: {BACKENDS}")
    return backend


def set_default_backend(backend: str) -> None:
    """Process-wide choice of the float GeMM kernel: "tiled" or "pipelined"."""
    global _DEFAULT_BACKEND, _DEFAULT_GEMM
    _DEFAULT_GEMM = make_kernel(_check_backend(backend))
    _DEFAULT_BACKEND = backend


def get_default_backend() -> str:
    return _DEFAULT_BACKEND


def _resolve(backend: Optional[str]):
    """The float GeMM function of `backend` (None: the default)."""
    return _DEFAULT_GEMM if backend is None else make_kernel(_check_backend(backend))


def gemm(a: torch.Tensor, b: torch.Tensor, *,
         backend: Optional[str] = None) -> torch.Tensor:
    """C = A @ B, a (M, K), b (K, N): int8 inputs accumulate to int32,
    floats to f32, through the backend's kernel."""
    return _resolve(backend)(a, b)


def gemm_int8_dequant(a_q: torch.Tensor, b_q: torch.Tensor,
                      scale_a: torch.Tensor, scale_b: torch.Tensor, *,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(A_q @ B_q) * sa * sb, scales (M, 1) and (1, N), fused in the kernel
    epilogue."""
    return _gemm_int8.dequant_gemm(a_q, b_q, scale_a, scale_b, out_dtype=out_dtype)


def quantize(x: torch.Tensor, axis: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-channel int8 quantization.  Rows of a matrix (axis -1)
    go through `quant.quantize_rows` (the K4 kernel on the card, its plain
    version on the CPU), whose scale is the reference's compiled one;
    every other case is `quantize_ref`."""
    if x.dim() == 2 and axis in (-1, 1):
        return _quant.quantize_rows(x)
    return ref.quantize_ref(x, axis)


def gemm_w8a8(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor, *,
              act_scale: Optional[torch.Tensor] = None,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The int8-resident-weight GeMM: float x (M, K), int8 w_q (K, N) with
    f32 per-column scales -> (M, N) in `out_dtype` (f32 by default).

    Activations quantize per row on the fly (dynamic), or with the static
    per-tensor `act_scale` when given (calibrated mode; on the card a
    one-element float32 tensor on x's device, as `QuantTensor.act_scale`
    is).  On the card both modes are one launch at M <= 16
    (`gemm_int8.gemm_w8a8`); on the CPU the reference's composition."""
    return _gemm_int8.gemm_w8a8(x, w_q, w_scale, act_scale, out_dtype=out_dtype)


def linear(x: torch.Tensor, w, *, quant: Optional[str] = None,
           backend: Optional[str] = None) -> torch.Tensor:
    """y = x @ w for x (..., K) and w (K, N), y in x's dtype.

    `w` is a float matrix or an int8-resident `QuantTensor` (the serving
    deployment path: activations row-quantized on the fly, the stored
    weight codes and scales used as they are).  quant="int8" runs the int8
    path on a float weight, quantizing the weight per call; quant=None
    defers to the active precision mode (quant/modes.py); quant="none"
    forces float.  `backend` picks the float GeMM kernel (module docstring)."""
    if _modes.capturing():
        _modes.capture(x, w)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if isinstance(w, QuantTensor):
        act = w.act_scale if _modes.is_calibrated() else None
        out = gemm_w8a8(x2, w.q, w.scale, act_scale=act, out_dtype=x.dtype)
        return out.reshape(*lead, w.q.shape[-1])
    if quant is None:
        quant = _modes.default_quant()
    if quant == "int8":
        xq, sx = quantize(x2, axis=-1)
        wq, sw = ref.quantize_ref(w, axis=0)
        out = gemm_int8_dequant(xq, wq, sx, sw.reshape(1, -1), out_dtype=x.dtype)
    elif quant in (None, "none"):
        out = _resolve(backend)(x2, w.to(x2.dtype), out_dtype=x.dtype)
    else:
        raise ValueError(f"unknown quant mode {quant!r}")
    return out.reshape(*lead, w.shape[-1])
