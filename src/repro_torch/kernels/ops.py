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

Training: when grad mode is on and an operand requires a gradient, the
float path of `linear` and `gemm` runs through the autograd Function
`_FloatGemm`, whose backward is two more launches of the same kernel (K1,
or K6 under "pipelined"): dA = dC @ B^T (B^T is a K-major B, read in
place) and dB = A^T @ dC (A^T is re-laid by `gemm.rows_for_copies`,
counted in `gemm.relaid`).  The reference differentiates through its
kernel call with `jax.value_and_grad` (launch/steps.py:36).  Every other
call, every serving path and every captured graph, launches as before.
The int8 paths (`QuantTensor`, quant="int8", the w8a8 GeMM) have no
backward and raise if asked for one: the reference trains in float.

A call that names no launch plan takes the hand rule's, unless the tile
autotuner is enabled (repro_torch.tuning: `enable()`, the engine's
`autotune=True`, or REPRO_AUTOTUNE=1): then `_dispatch_spec` asks it for
the tuned plan of (shape, dtype, kernel).  With tuning off the default path
stays inert: the tuning package is not even imported.
"""

from __future__ import annotations

import os
import sys
from typing import Optional, Tuple

import torch

from repro_torch.kernels import gemm_int8 as _gemm_int8
from repro_torch.kernels import quant as _quant
from repro_torch.kernels import ref
from repro_torch.kernels.gemm import GemmLaunchSpec
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


def _dispatch_spec(a: torch.Tensor, b: torch.Tensor, dtype, kernel: str
                   ) -> Optional[GemmLaunchSpec]:
    """The launch plan for a call that names none: the tuner's when tuning
    is enabled, else None (the hand rule's).  `repro_torch.tuning` is only
    consulted when it is already imported (someone called `enable()` or
    built a tuning engine) or REPRO_AUTOTUNE asks for it, so a plain call
    never pays the import."""
    tuning = sys.modules.get("repro_torch.tuning")
    if tuning is None:
        # The truthiness rule of tuning.env_truthy: "0"/"false"/"" disable.
        if os.environ.get("REPRO_AUTOTUNE", "").strip().lower() in (
                "", "0", "false", "no", "off"):
            return None
        import repro_torch.tuning as tuning
    if not tuning.is_enabled():
        return None
    shape = tuning.GemmShape(a.shape[0], a.shape[1], b.shape[1])
    kmajor = b.stride(0) == 1 and b.stride(1) != 1
    return tuning.tuned_spec(shape, dtype, backend=kernel, kmajor=kmajor)


def _float_kernel(backend: Optional[str]) -> str:
    return _DEFAULT_BACKEND if backend is None else _check_backend(backend)


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in ts)


def _no_backward(what: str) -> RuntimeError:
    return RuntimeError(f"{what} has no backward: the port trains in float, as the "
                        f"reference does")


class _FloatGemm(torch.autograd.Function):
    """C = A @ B through one float GeMM kernel `fn` (K1 or K6; the plain
    version on the CPU), C in `out_dtype`.  Backward: dA = dC @ B^T in A's
    dtype and dB = A^T @ dC in B's, each one more launch of `fn`, dC first
    rounded to the operands' dtype (the kernels take one dtype for both)."""

    @staticmethod
    def forward(ctx, a, b, fn, kernel, out_dtype, spec):
        ctx.save_for_backward(a, b)
        ctx.fn, ctx.kernel = fn, kernel
        if spec is None:
            spec = _dispatch_spec(a, b, a.dtype, kernel)
        return fn(a, b, out_dtype=out_dtype, spec=spec)

    @staticmethod
    def backward(ctx, dc):
        a, b = ctx.saved_tensors
        fn, kernel = ctx.fn, ctx.kernel
        dc = dc.to(a.dtype)
        da = db = None
        if ctx.needs_input_grad[0]:
            bt = b.t()
            da = fn(dc, bt, out_dtype=a.dtype, spec=_dispatch_spec(dc, bt, dc.dtype, kernel))
        if ctx.needs_input_grad[1]:
            at = a.t()
            db = fn(at, dc, out_dtype=b.dtype, spec=_dispatch_spec(at, dc, dc.dtype, kernel))
        return da, db, None, None, None, None


def gemm(a: torch.Tensor, b: torch.Tensor, *, backend: Optional[str] = None,
         spec: Optional[GemmLaunchSpec] = None) -> torch.Tensor:
    """C = A @ B, a (M, K), b (K, N): int8 inputs accumulate to int32,
    floats to f32, through the backend's kernel, at `spec` (None: the
    tuner's plan when tuning is enabled, else the rule's).  Float operands
    that need a gradient go through `_FloatGemm`."""
    fn = _resolve(backend)
    if _needs_grad(a, b):
        return _FloatGemm.apply(a, b, fn, _float_kernel(backend), torch.float32, spec)
    if spec is None:
        spec = _dispatch_spec(a, b, a.dtype, _float_kernel(backend))
    return fn(a, b, spec=spec)


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
        if _needs_grad(x2):
            raise _no_backward("an int8-resident weight (the w8a8 GeMM)")
        act = w.act_scale if _modes.is_calibrated() else None
        out = _gemm_int8.gemm_w8a8(x2, w.q, w.scale, act, out_dtype=x.dtype,
                                   spec=_dispatch_spec(x2, w.q, "int8", "w8a8"))
        return out.reshape(*lead, w.q.shape[-1])
    if quant is None:
        quant = _modes.default_quant()
    if quant == "int8":
        if _needs_grad(x2, w):
            raise _no_backward('linear(quant="int8")')
        xq, sx = quantize(x2, axis=-1)
        wq, sw = ref.quantize_ref(w, axis=0)
        out = _gemm_int8.dequant_gemm(xq, wq, sx, sw.reshape(1, -1), out_dtype=x.dtype,
                                      spec=_dispatch_spec(xq, wq, "int8", "dequant"))
    elif quant in (None, "none"):
        w = w.to(x2.dtype)
        if _needs_grad(x2, w):
            out = _FloatGemm.apply(x2, w, _resolve(backend), _float_kernel(backend),
                                   x.dtype, None)
        else:
            out = _resolve(backend)(x2, w, out_dtype=x.dtype,
                                    spec=_dispatch_spec(x2, w, x2.dtype, _float_kernel(backend)))
    else:
        raise ValueError(f"unknown quant mode {quant!r}")
    return out.reshape(*lead, w.shape[-1])
