"""Dataflow representation for the OpenGeMM accelerator generator.

The paper (Sec. 2.1) represents a GeMM C[M,N] = A[M,K] @ B[K,N] as six
nested loops: three *spatial* unrollings (the (Mu, Nu) DotProd mesh, each
DotProd of length Ku) executed in a single clock cycle, and three *temporal*
unrollings (the tile schedule).  The output-stationary schedule keeps the
K-tile loop innermost so the int32 partial sum stays in the accumulator
register of each DotProd (Sec. 2.3).

This module is the pure-math layer: tiling arithmetic, loop orders and the
analytic spatial / temporal / overall utilization definitions used throughout
the simulator and the benchmarks.  Port of repro/core/dataflow.py; its GOPS
and cycles are the modelled OpenGeMM ASIC's, not the card's.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence, Tuple

# ---------------------------------------------------------------------------
# Problem and tiling descriptions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GemmShape:
    """A single GeMM problem C[M,N] = A[M,K] @ B[K,N]."""

    M: int
    K: int
    N: int

    def __post_init__(self) -> None:
        if min(self.M, self.K, self.N) < 1:
            raise ValueError(f"GeMM dims must be >= 1, got {self}")

    @property
    def macs(self) -> int:
        """Useful multiply-accumulates."""
        return self.M * self.K * self.N

    @property
    def flops(self) -> int:
        return 2 * self.macs

    def operand_bytes(self, p_a: int = 8, p_b: int = 8, p_c: int = 32) -> int:
        """Total operand traffic in bytes for one read of A,B and write of C."""
        return (
            self.M * self.K * p_a + self.K * self.N * p_b + self.M * self.N * p_c
        ) // 8


@dataclasses.dataclass(frozen=True)
class SpatialUnrolling:
    """The three innermost (spatial) loops: the (Mu, Nu) x Ku MAC array."""

    Mu: int = 8
    Ku: int = 8
    Nu: int = 8

    def __post_init__(self) -> None:
        if min(self.Mu, self.Ku, self.Nu) < 1:
            raise ValueError(f"array dims must be >= 1, got {self}")

    @property
    def macs_per_cycle(self) -> int:
        return self.Mu * self.Ku * self.Nu

    @property
    def peak_ops_per_cycle(self) -> int:
        # 1 MAC = 2 ops (mul + add): the paper's 8x8x8 @ 200MHz = 204.8 GOPS
        # (the modelled ASIC's clock).
        return 2 * self.macs_per_cycle

    def tile_counts(self, g: GemmShape) -> Tuple[int, int, int]:
        """Temporal tile counts (m, k, n) = ceil(M/Mu), ceil(K/Ku), ceil(N/Nu)."""
        return (
            -(-g.M // self.Mu),
            -(-g.K // self.Ku),
            -(-g.N // self.Nu),
        )

    def padded_shape(self, g: GemmShape) -> GemmShape:
        m, k, n = self.tile_counts(g)
        return GemmShape(m * self.Mu, k * self.Ku, n * self.Nu)


# Canonical loop orders.  Following the paper, the innermost temporal loop is
# the K-tile loop (output stationary); weight stationary keeps the B' tile
# fixed by iterating M-tiles innermost.
OUTPUT_STATIONARY = ("m1", "n1", "k1")  # outer -> inner
WEIGHT_STATIONARY = ("k1", "n1", "m1")


@dataclasses.dataclass(frozen=True)
class TemporalUnrolling:
    """The three outermost (temporal) loops: the tile schedule."""

    order: Tuple[str, str, str] = OUTPUT_STATIONARY

    def __post_init__(self) -> None:
        if sorted(self.order) != ["k1", "m1", "n1"]:
            raise ValueError(f"order must be a permutation of (m1,n1,k1): {self.order}")

    @property
    def is_output_stationary(self) -> bool:
        return self.order[-1] == "k1"

    @property
    def is_weight_stationary(self) -> bool:
        return self.order[-1] == "m1"

    def iterate(
        self, counts: Tuple[int, int, int]
    ) -> Iterator[Tuple[int, int, int]]:
        """Yield (m1, k1, n1) tile indices in schedule order."""
        m, k, n = counts
        bounds = {"m1": m, "k1": k, "n1": n}
        o0, o1, o2 = self.order
        for i0 in range(bounds[o0]):
            for i1 in range(bounds[o1]):
                for i2 in range(bounds[o2]):
                    idx = {o0: i0, o1: i1, o2: i2}
                    yield idx["m1"], idx["k1"], idx["n1"]


@dataclasses.dataclass(frozen=True)
class Dataflow:
    """The full 6-loop nest of Fig. 2."""

    spatial: SpatialUnrolling = SpatialUnrolling()
    temporal: TemporalUnrolling = TemporalUnrolling()

    def compute_cycles(self, g: GemmShape) -> int:
        """Ideal MAC-array-busy cycles: one (Mu,Ku,Nu) tile per cycle."""
        m, k, n = self.spatial.tile_counts(g)
        return m * k * n

    def output_tiles(self, g: GemmShape) -> int:
        m, _, n = self.spatial.tile_counts(g)
        return m * n

    # -- utilization definitions (paper Table 2 footnotes) ------------------

    def spatial_utilization(self, g: GemmShape) -> float:
        """SU: useful MACs over MACs issued on the padded (tile-aligned) problem.

        SU < 1 whenever M, K or N is not a multiple of Mu, Ku, Nu: edge tiles
        run with part of the array idle.
        """
        return g.macs / self.spatial.padded_shape(g).macs

    def temporal_utilization(self, compute_cycles: int, total_cycles: int) -> float:
        """TU: fraction of cycles the MAC array is busy (not stalled/configuring)."""
        if total_cycles < compute_cycles:
            raise ValueError(
                f"total cycles {total_cycles} < compute cycles {compute_cycles}"
            )
        return compute_cycles / total_cycles if total_cycles else 1.0

    def overall_utilization(self, g: GemmShape, total_cycles: int) -> float:
        """OU = SU * TU: useful MACs over peak MACs in the elapsed time."""
        return g.macs / (total_cycles * self.spatial.macs_per_cycle)


def aggregate_utilization(
    df: Dataflow,
    shapes_cycles: Sequence[Tuple[GemmShape, int]],
) -> Tuple[float, float, float, int]:
    """MAC-weighted SU / TU / OU and total cycles over a workload list.

    This matches how the paper aggregates per-layer numbers into the per-model
    Table 2 entries: big layers dominate.
    """
    if not shapes_cycles:
        raise ValueError("empty workload")
    total_cycles = sum(c for _, c in shapes_cycles)
    total_macs = sum(g.macs for g, _ in shapes_cycles)
    padded_macs = sum(df.spatial.padded_shape(g).macs for g, _ in shapes_cycles)
    compute_cycles = sum(df.compute_cycles(g) for g, _ in shapes_cycles)
    su = total_macs / padded_macs
    tu = compute_cycles / total_cycles
    ou = total_macs / (total_cycles * df.spatial.macs_per_cycle)
    # OU == SU * TU by construction: macs/(cyc*peak) == (macs/padded) * (padded/ (cyc*peak))
    return su, tu, ou, total_cycles


def roofline_time_s(
    g: GemmShape,
    *,
    peak_flops: float,
    mem_bw: float,
    p_a: int = 8,
    p_b: int = 8,
    p_c: int = 32,
) -> Tuple[float, float]:
    """(compute_s, memory_s) roofline terms for one GeMM on an abstract device."""
    return g.flops / peak_flops, g.operand_bytes(p_a, p_b, p_c) / mem_bw


def arithmetic_intensity(g: GemmShape, p_a: int = 8, p_b: int = 8, p_c: int = 32) -> float:
    """FLOPs per byte of operand traffic."""
    return g.flops / g.operand_bytes(p_a, p_b, p_c)


def choose_loop_order(g: GemmShape, spatial: SpatialUnrolling) -> TemporalUnrolling:
    """Pick the stationarity that minimizes operand traffic (paper Sec. 2.3).

    Output-stationary saves traffic when the K extent (partial-sum reuse,
    wide P_C accumulators) dominates; this is essentially always true for
    im2col'd convolutions and transformer projections, matching the paper's
    fixed choice.  We keep the DSE hook for completeness.
    """
    m, k, n = spatial.tile_counts(g)
    # Partial-sum write traffic if NOT output stationary: every K-tile step
    # spills + reloads a 32b C' tile; if output stationary, C' written once.
    os_traffic = m * n * (k * 0 + 1)
    ws_traffic = m * n * k
    return TemporalUnrolling(OUTPUT_STATIONARY if os_traffic <= ws_traffic else WEIGHT_STATIONARY)
