"""Precision modes: the process-wide execution-precision switch (a copy of
repro/quant/modes.py).

The paper's accelerator is an int8 engine (P_A = P_B = 8, P_C = 32); this
module makes that deployment precision a *mode* of the port:

  "float"             every `ops.linear` runs in the model dtype (default)
  "w8a8"              int8 weights x int8 activations, activations quantized
                      per-row on the fly (dynamic quantization)
  "w8a8-calibrated"   as w8a8, with static per-tensor activation scales
                      (quant/calibrate.py makes them)

`kernels/ops.py::linear` reads the active mode.  The reference binds the
mode when jax traces a step; PyTorch runs eagerly and reads it on every
call, so the serving engine enters `precision(...)` around every step it
runs, not only in warmup, and the mode is "float" again between steps.

The activation-capture hook is the calibration tap: an observer installed
with `activation_capture` receives every (activation, weight) pair that
`linear` sees.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional

MODES = ("float", "w8a8", "w8a8-calibrated")

_state = threading.local()


def _get() -> str:
    return getattr(_state, "mode", "float")


def get_mode() -> str:
    """The active precision mode ("float" unless something set one)."""
    return _get()


def set_mode(mode: str) -> str:
    """Set the precision mode; returns the previous one (for restoring)."""
    if mode not in MODES:
        raise ValueError(f"unknown precision mode {mode!r}; known: {MODES}")
    prev = _get()
    _state.mode = mode
    return prev


@contextlib.contextmanager
def precision(mode: str):
    """Run a block under a precision mode, restoring the previous mode on
    exit (exception-safe, re-entrant)."""
    prev = set_mode(mode)
    try:
        yield
    finally:
        _state.mode = prev


def default_quant() -> Optional[str]:
    """The `quant=` default `ops.linear` should assume under the active mode
    (None in float mode; "int8" in the w8a8 modes).  Callers opt *out* of the
    mode by passing an explicit quant="none" (e.g. numerically sensitive
    SSM gate/dt projections)."""
    return "int8" if _get() != "float" else None


def is_calibrated() -> bool:
    """True when static (calibrated) activation scales should be preferred
    over dynamic per-row quantization."""
    return _get() == "w8a8-calibrated"


# ---------------------------------------------------------------------------
# calibration tap
# ---------------------------------------------------------------------------

_capture_fn: Optional[Callable] = None


def capturing() -> bool:
    return _capture_fn is not None


def capture(x, w) -> None:
    """Feed one (activation, weight) pair to the installed observer hook."""
    if _capture_fn is not None:
        _capture_fn(x, w)


@contextlib.contextmanager
def activation_capture(fn: Callable):
    """Install `fn(x, w)` as the linear-call tap for the duration of the
    block.  Not re-entrant by design: nested calibrations would silently
    cross-contaminate observers."""
    global _capture_fn
    if _capture_fn is not None:
        raise RuntimeError("activation capture already active")
    _capture_fn = fn
    try:
        yield
    finally:
        _capture_fn = None


@contextlib.contextmanager
def capture_paused():
    """Hide the block's `linear` calls from an installed tap.  The
    reference's tap skips the calls traced inside its scans (Mamba's
    chunked dt / B / C projections), so its calibration tables have no
    entry for them; the port pauses the tap there to make the same table."""
    global _capture_fn
    fn, _capture_fn = _capture_fn, None
    try:
        yield
    finally:
        _capture_fn = fn
