"""Public GeMM ops (port of repro/kernels/ops.py).

Every dense projection of the port routes through `linear`, so the GeMM
kernels underlie the whole model.  There is no backend switch: a CUDA
tensor always launches a hand-written kernel and a CPU tensor runs its
plain version.

  float operands        kernels/gemm.py       (K1, f32 accumulation)
  int8 x int8 -> int32  kernels/gemm_int8.py  (K1's int mode)
  int8 + dequant        kernels/gemm_int8.py  (K3)
  row quantization      kernels/quant.py      (K4)

The kernels mask ragged edges themselves, so the reference's tile padding
(`_pad2`) has no counterpart.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import gemm as _gemm
from repro_torch.kernels import gemm_int8 as _gemm_int8
from repro_torch.kernels import quant as _quant
from repro_torch.kernels import ref
from repro_torch.quant import modes as _modes
from repro_torch.quant.params import QuantTensor


def gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B, a (M, K), b (K, N): int8 inputs accumulate to int32,
    floats to f32."""
    if a.dtype == torch.int8 and b.dtype == torch.int8:
        return _gemm_int8.gemm_int(a, b)
    return _gemm.gemm(a, b, out_dtype=torch.float32)


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
    per-tensor `act_scale` when given (calibrated mode, plain PyTorch as the
    reference's jnp)."""
    M = x.shape[0]
    w_scale = w_scale.reshape(1, -1)
    if act_scale is None:
        return _quant.gemm_w8a8(x, w_q, w_scale, out_dtype=out_dtype)
    s = torch.as_tensor(act_scale, dtype=torch.float32, device=x.device).reshape(())
    xq = torch.clamp(torch.round(x.to(torch.float32) / s), -127, 127).to(torch.int8)
    sx = s.expand(M, 1)
    return gemm_int8_dequant(xq, w_q, sx, w_scale, out_dtype=out_dtype)


def linear(x: torch.Tensor, w, *, quant: Optional[str] = None) -> torch.Tensor:
    """y = x @ w for x (..., K) and w (K, N), y in x's dtype.

    `w` is a float matrix or an int8-resident `QuantTensor` (the serving
    deployment path: activations row-quantized on the fly, the stored
    weight codes and scales used as they are).  quant="int8" runs the int8
    path on a float weight, quantizing the weight per call; quant=None
    defers to the active precision mode (quant/modes.py); quant="none"
    forces float."""
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
        out = _gemm.gemm(x2, w.to(x2.dtype), out_dtype=x.dtype)
    else:
        raise ValueError(f"unknown quant mode {quant!r}")
    return out.reshape(*lead, w.shape[-1])
