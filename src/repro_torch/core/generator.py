"""OpenGeMM accelerator *generator*: design-time parameterization.

The paper's Table 1 enumerates the design-time parameters of the Chisel
generator.  `OpenGeMMConfig` mirrors them exactly, plus the three run-time
utilization mechanisms as feature flags (for the ablation of Fig. 5).

An `OpenGeMMConfig` can be turned into:
  * a cycle-accurate simulator instance   -> core/simulator.py
  * a launch plan of the port's GeMMs     -> kernels/gemm.py (via launch_spec)

Port of repro/core/generator.py.  The reference also maps a design point
onto Pallas tiles (`tpu_kernel_spec`, `TpuGemmSpec`, the MXU / VMEM tile
legality); the port has no counterpart of those: the hand kernels' tile
sizes are compiled into kernels/csrc/gemm_mma.cuh, and what a design point
still chooses on the card is a `GemmLaunchSpec` (`launch_spec`): K6's ring
depth from D_stream and the hand rule's split count.

Clocks and throughputs here (the 200 MHz default, GOPS) are the modelled
OpenGeMM ASIC's, not a TPU's or the card's.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.dataflow import (
    Dataflow,
    GemmShape,
    SpatialUnrolling,
    TemporalUnrolling,
)


@dataclasses.dataclass(frozen=True)
class OpenGeMMConfig:
    """Design-time parameters (paper Table 1) + mechanism flags (Sec. 3)."""

    # --- GeMM core ---------------------------------------------------------
    Mu: int = 8            # rows of the DotProd mesh
    Nu: int = 8            # columns of the DotProd mesh
    Ku: int = 8            # lanes per DotProd unit
    P_A: int = 8           # operand A precision (bits)
    P_B: int = 8           # operand B precision (bits)
    P_C: int = 32          # accumulator / result precision (bits)

    # --- memory system -----------------------------------------------------
    D_stream: int = 3      # pre-fetch / output buffer depth
    R_mem: int = 16        # input memory ports
    W_mem: int = 32        # output memory ports
    P_word: int = 64       # memory port width (bits)
    N_bank: int = 32       # scratchpad banks
    D_mem: int = 1056      # bank depth (words)

    # --- run-time mechanism flags (Fig. 5 ablation axes) --------------------
    cfg_preload: bool = True       # CPL  (Sec. 3.2)
    input_prefetch: bool = True    # pre-fetch + output buffering (Sec. 3.3)
    strided_access: bool = True    # SMA  (Sec. 3.4)

    # --- control-path model constants (calibrated, see EXPERIMENTS.md) ------
    # The configuration routine on the Snitch host (computing loop bounds,
    # addresses and strides, then writing the consolidated CSRs at
    # 32 bits/cycle) -> modeled as csr_cycles per (re)configuration, plus a
    # fixed launch handshake.  Calibrated against Fig. 5's median ratios.
    csr_cycles: int = 2600
    launch_cycles: int = 6
    # Bank-conflict penalty multiplier on SPM accesses when the layout is NOT
    # interleaved (no SMA): tiles mapping to the same bank serialize on a
    # fraction of accesses.  Calibrated against Fig. 5.
    bank_conflict_factor: float = 1.5
    # SPM read pipeline latency (cycles); deeper pre-fetch buffers hide it.
    spm_latency: int = 2

    def __post_init__(self) -> None:
        if min(self.Mu, self.Nu, self.Ku) < 1:
            raise ValueError("array dims must be positive")
        if self.D_stream < 1:
            raise ValueError("D_stream must be >= 1")
        for p in (self.P_A, self.P_B, self.P_C):
            if p not in (2, 4, 8, 16, 32):
                raise ValueError(f"unsupported precision {p}")

    # -- derived hardware facts ----------------------------------------------

    @property
    def dataflow(self) -> Dataflow:
        return Dataflow(
            spatial=SpatialUnrolling(self.Mu, self.Ku, self.Nu),
            temporal=TemporalUnrolling(),  # output stationary (Sec. 2.3)
        )

    @property
    def peak_macs_per_cycle(self) -> int:
        return self.Mu * self.Ku * self.Nu

    def peak_gops(self, freq_hz: float = 200e6) -> float:
        """Peak throughput of the modelled ASIC (not the card's); paper:
        8x8x8 @ 200MHz = 204.8 GOPS."""
        return 2 * self.peak_macs_per_cycle * freq_hz / 1e9

    @property
    def a_tile_bits(self) -> int:
        return self.Mu * self.Ku * self.P_A

    @property
    def b_tile_bits(self) -> int:
        return self.Ku * self.Nu * self.P_B

    @property
    def c_tile_bits(self) -> int:
        return self.Mu * self.Nu * self.P_C

    @property
    def read_bw_bits(self) -> int:
        """Input SPM bandwidth (bits / cycle)."""
        return self.R_mem * self.P_word

    @property
    def write_bw_bits(self) -> int:
        """Output SPM bandwidth (bits / cycle)."""
        return self.W_mem * self.P_word

    @property
    def input_fetch_cycles(self) -> int:
        """Cycles to fetch one A' + one B' tile at full input bandwidth."""
        return max(1, -(-(self.a_tile_bits + self.b_tile_bits) // self.read_bw_bits))

    @property
    def output_write_cycles(self) -> int:
        """Cycles to drain one C' tile at full output bandwidth."""
        return max(1, -(-self.c_tile_bits // self.write_bw_bits))

    @property
    def spm_bytes(self) -> int:
        """Scratchpad capacity; case-study config = 270 KiB."""
        return self.N_bank * self.D_mem * self.P_word // 8

    # -- ablation helpers ------------------------------------------------------

    def with_mechanisms(
        self, *, cpl: bool, prefetch: bool, sma: bool, depth: int | None = None
    ) -> "OpenGeMMConfig":
        return dataclasses.replace(
            self,
            cfg_preload=cpl,
            input_prefetch=prefetch,
            strided_access=sma,
            D_stream=self.D_stream if depth is None else depth,
        )

    # -- launch plan on the card ----------------------------------------------

    def launch_spec(self, shape: GemmShape | None = None):
        """The design point as a launch plan of the port's GeMMs
        (`kernels.gemm.GemmLaunchSpec`): K6's ring depth is D_stream,
        clamped as K6 clamps it (at most its deepest ring, then
        `gemm_pipelined.clamp_depth`: at least 2, at most the K steps of
        `shape`); the split count and tile are the hand rule's
        (`gemm.gemm_plan` on the H100's SMs at the operands' width, B
        N-contiguous), one split without a shape.  The tile sizes stay
        compiled into csrc/gemm_mma.cuh."""
        from repro_torch.core.hw import H100_SMS
        from repro_torch.kernels import gemm, gemm_pipelined

        depth = min(self.D_stream, gemm_pipelined.MAX_DEPTH)
        if shape is None:
            return gemm.GemmLaunchSpec(splits=1, depth=gemm_pipelined.clamp_depth(depth, depth))
        elem_bytes = max(1, max(self.P_A, self.P_B) // 8)
        plan = gemm.gemm_plan(shape.M, shape.N, shape.K, False, H100_SMS, elem_bytes)
        k_steps = -(-shape.K // plan.bk)
        return gemm.GemmLaunchSpec(splits=plan.splits, swap=plan.swap,
                                   depth=gemm_pipelined.clamp_depth(depth, k_steps))


# The paper's case-study instance (Table 1, "Case study values").
CASE_STUDY = OpenGeMMConfig()
