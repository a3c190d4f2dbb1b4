"""Analytic ranking of launch plans: a roofline model of the H100.

Port of repro/tuning/model.py.  The reference re-targets the paper's cycle
model at a TPU in tile-pass units; that proxy has no meaning on a card of
132 SMs, so the port ranks a plan by the least time the card could take
for its launch:

  * max(bytes at 3.35 TB/s, operations at the tensor cores' peak: 989
    TFLOP/s bf16, 1979 TOP/s int8; 67 TFLOP/s f32 outside them), each
    operand read once and C written once;
  * stretched by the plan's waves of blocks over the SM count: a launch of
    b blocks keeps min(b, sms) SMs busy, so it runs ceil(b / sms) x sms / b
    times the roofline time (a lone block draws on one SM's share);
  * plus the split partials' write and read-back, 2 x splits x M x N x 4
    bytes at the same rate, and a constant per launch and per split-K
    fix-up (LAUNCH_S, FIXUP_S; the w8a8 GeMM in two launches adds the row
    quantization's launch and bytes).

LAUNCH_S and FIXUP_S are fitted to the K1 times of one gemma3-1b decode
step on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md: 183 launches of the
rule's plans in 1.817 ms against a 0.602 ms bytes bound).  Only the order
of the predictions is consumed (the tuner's analytic mode, the MFU meter's
step bound); the wall-clock mode times the card instead.

The reference's surface stays: `predict`, `predict_clocks`,
`TilePrediction`.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.hw import CLOCK_HZ, HBM_BW, PEAK_OPS  # predictions also read in clocks
from repro_torch.kernels import gemm as _gemm
from repro_torch.kernels import gemm_int8 as _gemm_int8
from repro_torch.kernels.gemm import GemmLaunchSpec
from repro_torch.tuning.candidates import (H100_SMS, GemmShape, dtype_bits,
                                           elem_bytes)

LAUNCH_S = 3.5e-6           # per kernel launch (graph replay), fitted
FIXUP_S = 1.5e-6            # per split-K fix-up (the last block's read-back), fitted


@dataclasses.dataclass(frozen=True)
class TilePrediction:
    """Model-predicted performance of one (spec, shape, dtype) point."""

    spec: GemmLaunchSpec
    clocks: float            # predicted SM clocks for one GeMM call
    utilization: float       # useful operations / (time x peak)

    @property
    def time_s(self) -> float:
        return self.clocks / CLOCK_HZ

    def gops(self, shape: GemmShape) -> float:
        return 2 * shape.macs / self.time_s / 1e9


def _waves(blocks: int, sms: int) -> float:
    return -(-blocks // sms) * sms / blocks


def predict_time_s(spec: GemmLaunchSpec, shape: GemmShape, dtype="bfloat16", *,
                   backend: str = "tiled", sms: int = H100_SMS,
                   kmajor: bool = False) -> float:
    """Predicted seconds of one GeMM call at `spec` (see the module note)."""
    M, K, N = shape.M, shape.K, shape.N
    eb = elem_bytes(dtype, backend)
    a_bytes = dtype_bits(dtype) // 8 if backend == "w8a8" else eb
    # C: f32 in f32, int32 from K1's int mode, else the activations' bf16
    int_mode = eb == 1 and backend in ("tiled", "pipelined")
    out_bytes = 4 if dtype_bits(dtype) == 32 or int_mode else 2
    plan = _gemm.gemm_plan(M, N, K, kmajor, sms, eb, spec.splits, spec.swap)
    peak = PEAK_OPS[8 if eb == 1 else dtype_bits(dtype)]
    nbytes = M * K * a_bytes + K * N * eb + M * N * out_bytes
    blocks = plan.grid[0] * plan.grid[1] * plan.grid[2]
    t = max(nbytes / HBM_BW, 2.0 * M * K * N / peak) * _waves(blocks, sms) + LAUNCH_S
    if plan.splits > 1:
        t += 2 * plan.splits * M * N * 4 / HBM_BW + FIXUP_S
    if backend == "w8a8" and not (M <= _gemm_int8.FUSED_ROWS and spec.fused):
        # the row quantization's own launch: A read, codes and scales written
        t += LAUNCH_S + (M * K * (a_bytes + 1) + M * 4) / HBM_BW
    return t


def predict(spec: GemmLaunchSpec, shape: GemmShape, dtype="bfloat16", *,
            backend: str = "tiled", sms: int = H100_SMS,
            kmajor: bool = False) -> TilePrediction:
    """Predicted clocks / utilization for one GeMM call at `spec`."""
    t = predict_time_s(spec, shape, dtype, backend=backend, sms=sms, kmajor=kmajor)
    peak = PEAK_OPS[8 if elem_bytes(dtype, backend) == 1 else dtype_bits(dtype)]
    return TilePrediction(spec=spec, clocks=t * CLOCK_HZ,
                          utilization=2.0 * shape.macs / (t * peak))


def predict_clocks(spec: GemmLaunchSpec, shape: GemmShape, dtype="bfloat16",
                   **kw) -> float:
    return predict(spec, shape, dtype, **kw).clocks
