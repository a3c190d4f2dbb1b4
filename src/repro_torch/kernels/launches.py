"""The hand kernels' launch counters, read and zeroed together.

Each wrapper adds one to a counter of its module where it launches its
kernel, and nowhere else: the proof that a run went through the kernel.
A CUDA graph replays its kernels without calling the wrappers, so the
serving engine keeps the counts of replayed steps itself
(`Engine.replayed_launches`)."""

from __future__ import annotations

from typing import Dict

from repro_torch.kernels import flash_attention, flash_decode, gemm, gemm_int8
from repro_torch.kernels import gemm_pipelined, quant

# counter name -> (module, attribute)
COUNTERS = {
    "gemm": (gemm, "launches"),
    "flash_decode": (flash_decode, "launches"),
    "gemm_int": (gemm_int8, "int_launches"),
    "dequant_gemm": (gemm_int8, "launches"),
    "gemm_w8a8": (gemm_int8, "w8a8_launches"),
    "quantize_rows": (quant, "launches"),
    "flash_decode_int8": (flash_decode, "launches_int8"),
    "flash_attention": (flash_attention, "launches"),
    "gemm_pipelined": (gemm_pipelined, "launches"),
}


def counts() -> Dict[str, int]:
    """Every counter's value, by name."""
    return {name: getattr(mod, attr) for name, (mod, attr) in COUNTERS.items()}


def reset() -> None:
    """Zero every counter."""
    for mod in {id(m): m for m, _ in COUNTERS.values()}.values():
        mod.reset_launches()
