"""Cycle-level performance model of the OpenGeMM platform.

Models the timing behaviour described in Sec. 3 / Fig. 4 of the paper:

  * a GeMM call = CSR configuration + launch handshake + tile pipeline,
  * streamers fetch one A'+B' tile pair per `input_fetch_cycles` and drain one
    C' tile per `output_write_cycles` (derived from R_mem/W_mem/P_word),
  * bank conflicts multiply streamer latency when the layout is not
    interleaved (no SMA),
  * configuration pre-loading (CPL) overlaps the CSR routine of call i+1 with
    the compute of call i,
  * input pre-fetch buffers of depth D hide a fraction (D-1)/D of streamer
    latency jitter; output buffers let write-back overlap the next
    accumulation group.

The model is deliberately closed-form per call (the tile pipeline is regular,
so an event-driven simulation collapses to arithmetic); the free constants
(`csr_cycles`, `bank_conflict_factor`) are calibrated once against the
paper's Fig. 5 median ratios — see benchmarks/fig5_ablation.py and
EXPERIMENTS.md.

Port of repro/core/simulator.py.  Cycles, the 200 MHz default clock and
GOPS are the modelled OpenGeMM ASIC's, not the card's.

Utilization definitions match the paper (Table 2 footnotes):
  SU = useful MACs / padded MACs,  TU = busy cycles / total cycles,
  OU = SU * TU = useful MACs / (total cycles * peak MACs/cycle).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, List, Sequence, Tuple

from repro_torch.core.dataflow import GemmShape, aggregate_utilization
from repro_torch.core.generator import OpenGeMMConfig


@dataclasses.dataclass(frozen=True)
class CallTiming:
    """Cycle breakdown of one GeMM call on the accelerator."""

    shape: GemmShape
    config_cycles: int          # exposed (non-hidden) configuration time
    fill_cycles: int            # pipeline fill (first fetches)
    compute_cycles: int         # MAC-array busy cycles (incl. padding tiles)
    input_stall_cycles: int     # array idle waiting on operand streamers
    output_stall_cycles: int    # array idle waiting on write-back
    total_cycles: int
    padded_shape: GemmShape     # shape rounded up to the (Mu, Ku, Nu) tiles

    @property
    def busy_cycles(self) -> int:
        return self.compute_cycles

    @property
    def temporal_utilization(self) -> float:
        return self.compute_cycles / self.total_cycles

    @property
    def spatial_utilization(self) -> float:
        """SU = useful MACs / MACs issued on the tile-padded problem; < 1
        whenever M, K or N is not a multiple of the array dims (edge tiles
        run with part of the array idle)."""
        return self.shape.macs / self.padded_shape.macs

    @property
    def overall_utilization(self) -> float:
        return self.spatial_utilization * self.temporal_utilization


@dataclasses.dataclass(frozen=True)
class WorkloadReport:
    """Aggregated utilization over a sequence of calls (one model / workload)."""

    su: float
    tu: float
    ou: float
    total_cycles: int
    calls: int
    macs: int

    def gops(self, freq_hz: float = 200e6) -> float:
        # at the modelled ASIC's clock (paper: 200 MHz)
        return 2 * self.macs / (self.total_cycles / freq_hz) / 1e9


class OpenGeMMSimulator:
    """Performance model for a generated OpenGeMM instance."""

    def __init__(self, config: OpenGeMMConfig | None = None):
        self.cfg = config or OpenGeMMConfig()
        df = self.cfg.dataflow
        self.spatial = df.spatial
        self.df = df

    # -- single call --------------------------------------------------------

    def simulate_call(
        self, shape: GemmShape, *, first_call: bool = True, prev_busy_cycles: int = 0
    ) -> CallTiming:
        cfg = self.cfg
        m, k, n = self.spatial.tile_counts(shape)
        compute = m * k * n

        conflict = 1.0 if cfg.strided_access else float(cfg.bank_conflict_factor)
        f_eff = cfg.input_fetch_cycles * conflict      # streamer cycles / tile pair
        w_eff = cfg.output_write_cycles * conflict     # streamer cycles / C' tile

        if cfg.input_prefetch:
            # Depth-D buffer hides (D-1)/D of the above-1-cycle fetch latency:
            # the streamer runs ahead while the array computes, and only the
            # un-hidable residue stalls the array.
            tile_t = 1.0 + max(0.0, f_eff - 1.0) / cfg.D_stream
            fill = int(math.ceil(f_eff + cfg.spm_latency - 1))  # first fetch exposed
            # Output buffers drain while the next accumulation group runs;
            # stall only if draining outlasts the group (small-K workloads),
            # plus the SPM pipeline restart bubble per group, which deeper
            # buffers progressively hide (paper: depth 3/4 keep improving).
            group_cycles = k * tile_t
            restart_bubble = (cfg.spm_latency - 1.0) / max(1, cfg.D_stream - 1)
            out_stall_per_group = max(0.0, w_eff - (group_cycles - 1.0)) + restart_bubble
            input_stall = int(math.ceil(compute * (tile_t - 1.0)))
        else:
            # Fetch and compute fully serialize (Fig. 4(a) case 2).
            tile_t = f_eff + 1.0
            fill = 0
            out_stall_per_group = w_eff  # write-back blocks the array (case 3)
            input_stall = int(math.ceil(compute * (tile_t - 1.0)))

        output_stall = int(math.ceil(m * n * out_stall_per_group))

        csr = cfg.csr_cycles
        if cfg.cfg_preload and not first_call:
            # CSR routine for this call ran during the previous call's busy
            # time (Fig. 4(b) case 1); only the un-hidden residue is exposed.
            csr = max(0, csr - prev_busy_cycles)
        config_cycles = csr + cfg.launch_cycles

        total = config_cycles + fill + compute + input_stall + output_stall
        return CallTiming(
            shape=shape,
            config_cycles=config_cycles,
            fill_cycles=fill,
            compute_cycles=compute,
            input_stall_cycles=input_stall,
            output_stall_cycles=output_stall,
            total_cycles=total,
            padded_shape=self.spatial.padded_shape(shape),
        )

    # -- call sequences ------------------------------------------------------

    def simulate_sequence(self, shapes: Sequence[GemmShape]) -> List[CallTiming]:
        """Simulate back-to-back GeMM calls (a layer list / repeated workload)."""
        out: List[CallTiming] = []
        prev_busy = 0
        for i, s in enumerate(shapes):
            t = self.simulate_call(s, first_call=(i == 0), prev_busy_cycles=prev_busy)
            out.append(t)
            prev_busy = t.total_cycles - t.config_cycles
        return out

    def report(self, shapes: Sequence[GemmShape]) -> WorkloadReport:
        timings = self.simulate_sequence(shapes)
        pairs = [(t.shape, t.total_cycles) for t in timings]
        su, tu, ou, total = aggregate_utilization(self.df, pairs)
        # Per-call SU must reproduce the MAC-weighted aggregate: the same
        # padding arithmetic through two code paths (CallTiming vs dataflow).
        per_call_su = (sum(t.shape.macs for t in timings)
                       / sum(t.padded_shape.macs for t in timings))
        assert abs(per_call_su - su) < 1e-12, (per_call_su, su)
        return WorkloadReport(
            su=su,
            tu=tu,
            ou=ou,
            total_cycles=total,
            calls=len(timings),
            macs=sum(t.shape.macs for t in timings),
        )

    def utilization(self, shape: GemmShape, repeats: int = 1) -> float:
        """Overall utilization of one workload repeated back-to-back (Fig. 5)."""
        rep = self.report([shape] * repeats)
        return rep.ou

    def report_grouped(
        self, calls: Sequence[Tuple[GemmShape, int]]
    ) -> WorkloadReport:
        """Aggregate over (shape, count) groups without materializing every call.

        Identical back-to-back calls reach a steady state after the first
        (CPL hides the CSR routine behind the previous call's busy time), so a
        group of `count` calls costs t_first + (count-1) * t_steady.  The very
        first call of the whole workload pays the full configuration time.
        """
        total_cycles = 0
        total_macs = 0
        padded_macs = 0
        compute_cycles = 0
        ncalls = 0
        prev_busy = 0
        first = True
        for shape, count in calls:
            if count < 1:
                raise ValueError(f"count must be >= 1, got {count} for {shape}")
            t_first = self.simulate_call(
                shape, first_call=first, prev_busy_cycles=prev_busy
            )
            busy = t_first.total_cycles - t_first.config_cycles
            t_steady = self.simulate_call(shape, first_call=False, prev_busy_cycles=busy)
            total_cycles += t_first.total_cycles + (count - 1) * t_steady.total_cycles
            compute_cycles += count * t_first.compute_cycles
            total_macs += count * shape.macs
            padded_macs += count * self.spatial.padded_shape(shape).macs
            ncalls += count
            prev_busy = t_steady.total_cycles - t_steady.config_cycles
            first = False
        return WorkloadReport(
            su=total_macs / padded_macs,
            tu=compute_cycles / total_cycles,
            ou=total_macs / (total_cycles * self.spatial.macs_per_cycle),
            total_cycles=total_cycles,
            calls=ncalls,
            macs=total_macs,
        )


# ---------------------------------------------------------------------------
# Fig. 5 ablation architectures
# ---------------------------------------------------------------------------

def ablation_architectures(
    base: OpenGeMMConfig | None = None,
) -> "dict[str, OpenGeMMConfig]":
    """The four platform variants of the paper's Fig. 5 (+ depth sweeps)."""
    base = base or OpenGeMMConfig()
    return {
        "arch1_baseline": base.with_mechanisms(cpl=False, prefetch=False, sma=False),
        "arch2_cpl": base.with_mechanisms(cpl=True, prefetch=False, sma=False),
        "arch3_cpl_buf2": base.with_mechanisms(cpl=True, prefetch=True, sma=False, depth=2),
        "arch4_all_buf2": base.with_mechanisms(cpl=True, prefetch=True, sma=True, depth=2),
        "arch4_all_buf3": base.with_mechanisms(cpl=True, prefetch=True, sma=True, depth=3),
        "arch4_all_buf4": base.with_mechanisms(cpl=True, prefetch=True, sma=True, depth=4),
    }


def random_fig5_shapes(count: int = 500, seed: int = 0) -> List[GemmShape]:
    """500 random (M,K,N), each dim drawn from {8, 16, ..., 256} (Sec. 4.2)."""
    import random as _random

    rng = _random.Random(seed)
    choices = list(range(8, 257, 8))
    return [
        GemmShape(rng.choice(choices), rng.choice(choices), rng.choice(choices))
        for _ in range(count)
    ]


def fig5_median_utilizations(
    shapes: Iterable[GemmShape] | None = None,
    base: OpenGeMMConfig | None = None,
    repeats: int = 10,
) -> "dict[str, float]":
    """Median overall utilization per ablation arch (the paper's box medians)."""
    shapes = list(shapes) if shapes is not None else random_fig5_shapes()
    meds: dict[str, float] = {}
    for name, cfg in ablation_architectures(base).items():
        sim = OpenGeMMSimulator(cfg)
        utils = sorted(sim.utilization(s, repeats=repeats) for s in shapes)
        mid = len(utils) // 2
        meds[name] = (
            utils[mid] if len(utils) % 2 else 0.5 * (utils[mid - 1] + utils[mid])
        )
    return meds
