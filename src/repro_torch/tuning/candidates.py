"""The tuner's design space: the launch plans of the hand GeMMs on one card.

Port of repro/tuning/candidates.py.  The reference enumerates TPU tile
shapes (TM, TK, TN) that fit the MXU lanes and the VMEM budget.  On the
H100 the tile sizes are compiled into csrc/gemm_mma.cuh and stay fixed; a
candidate is a launch plan of those kernels as they are
(`kernels.gemm.GemmLaunchSpec`):

  * the split-K count, 1..MAX_SPLITS (K1, K6 and the int8 GeMM);
  * at M <= SWAP_ROWS, the swapped 16-row tile or the 64-row tile (K1, K6:
    both bodies sum each output in the same order, so both give the same
    bits; chip_smoke.py checks it at every gemma3-1b shape);
  * K6's ring depth, 2 / 3 / 4 (the paper's D_stream axis);
  * the w8a8 GeMM at M <= FUSED_ROWS: one launch, or the row quantization
    then K3 (the same bits: exact integer sums, a fixed epilogue).

Legality, checked before anything launches:

  * every plan's split-K fits the scratch `gemm.splitk_scratch` allocates
    (`gemm.plan_fits`), at the largest M the plan serves: up to FULL_ROWS
    rows a plan is keyed without M (tuning/cache.py), so it is checked at M
    = FULL_ROWS;
  * no split is left empty: requested counts that round to the same
    partition are one candidate;
  * the hand rule's plan (`rule_spec`) is always a candidate and comes
    first, so the tuner can only match or beat it (at the first depth of
    a K6 sweep that leaves out the default one).

The order is deterministic: the rule, then ascending split count, swapped
tile first, ascending depth, one launch first.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.core.hw import H100_SMS  # noqa: F401  (the analytic target)
from repro_torch.kernels import gemm as _gemm
from repro_torch.kernels import gemm_int8 as _gemm_int8
from repro_torch.kernels import gemm_pipelined as _pipelined
from repro_torch.kernels.gemm import GemmLaunchSpec

DEPTHS = (2, 3, 4)      # K6's ring depths (csrc/gemm_pipelined.cu)
# The kernel each tuning backend names: the float GeMMs K1 ("tiled") and K6
# ("pipelined"), and the int8 GeMMs K3 ("dequant": int8 codes and scales in)
# and the w8a8 GeMM ("w8a8": float activations quantized in K3's prologue).
BACKENDS = ("tiled", "pipelined", "dequant", "w8a8")


@dataclasses.dataclass(frozen=True)
class GemmShape:
    """A single GeMM problem C[M,N] = A[M,K] @ B[K,N] (the port's copy of
    repro/core/dataflow.py::GemmShape)."""

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


def dtype_bits(dtype) -> int:
    """Operand width in bits for a torch dtype or a dtype name."""
    name = str(dtype).replace("torch.", "")
    if "int8" in name or "fp8" in name:
        return 8
    if "bfloat16" in name or "float16" in name:
        return 16
    return 32


def elem_bytes(dtype, backend: str) -> int:
    """Bytes of the operand the plan's K stages are cut in: the int8 GeMMs
    stage int8 codes whatever the activations' type."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown tuning backend {backend!r}; known: {BACKENDS}")
    return 1 if backend in ("dequant", "w8a8") else dtype_bits(dtype) // 8


def plan_rows(M: int) -> int:
    """The largest M a plan tuned at M serves: FULL_ROWS for every M up to
    it (the plan is keyed without M there), else M."""
    return max(M, _gemm.FULL_ROWS) if M <= _gemm.FULL_ROWS else M


def rule_spec(shape: GemmShape, dtype="bfloat16", *, backend: str = "tiled",
              sms: int = H100_SMS, kmajor: bool = False) -> GemmLaunchSpec:
    """The hand rule's plan as a spec: `gemm.gemm_plan`'s split count and
    tile, K6's default depth, the w8a8 GeMM in one launch."""
    plan = _gemm.gemm_plan(shape.M, shape.N, shape.K, kmajor, sms,
                           elem_bytes(dtype, backend))
    return GemmLaunchSpec(
        splits=plan.splits, swap=plan.swap,
        depth=_pipelined.DEFAULT_DEPTH if backend == "pipelined" else 0)


def enumerate_tiles(shape: GemmShape, dtype="bfloat16", *, backend: str = "tiled",
                    depth=None, sms: int = H100_SMS, kmajor: bool = False,
                    max_candidates: Optional[int] = None) -> List[GemmLaunchSpec]:
    """Every legal launch plan for `shape` / `dtype` on `backend`'s kernel,
    the rule's first.  `depth` (K6 only): an int or a sequence of ring
    depths to sweep; None sweeps DEPTHS.  `max_candidates` keeps the first
    that many (the rule among them)."""
    eb = elem_bytes(dtype, backend)
    rows = plan_rows(shape.M)
    if backend == "pipelined":
        depths = DEPTHS if depth is None else ((depth,) if isinstance(depth, int)
                                               else tuple(depth))
        for d in depths:
            if d not in DEPTHS:
                raise ValueError(f"K6's ring depth must be one of {DEPTHS}, got {d}")
    else:
        depths = (0,)
    small = shape.M <= _gemm.SWAP_ROWS
    swaps = (True, False) if small and backend in ("tiled", "pipelined") else (small,)
    fuseds = (True, False) if backend == "w8a8" and shape.M <= _gemm_int8.FUSED_ROWS \
        else (True,)
    k_tiles = -(-shape.K // (_gemm.K_TILE_BYTES // eb))
    rule = rule_spec(shape, dtype, backend=backend, sms=sms, kmajor=kmajor)
    if rule.depth not in depths:      # a sweep without the default depth
        rule = dataclasses.replace(rule, depth=depths[0])
    out, seen = [rule], {rule}
    for splits in range(1, min(_gemm.MAX_SPLITS[True], k_tiles) + 1):
        for swap in swaps:
            plan = _gemm.gemm_plan(rows, shape.N, shape.K, kmajor, sms, eb, splits, swap)
            if plan.splits != splits or not _gemm.plan_fits(plan, sms):
                continue            # an empty split, or past the scratch
            for d in depths:
                for fused in fuseds:
                    spec = GemmLaunchSpec(splits=splits, swap=swap, depth=d, fused=fused)
                    if spec not in seen:
                        seen.add(spec)
                        out.append(spec)
    return out if max_candidates is None else out[:max(1, max_candidates)]
