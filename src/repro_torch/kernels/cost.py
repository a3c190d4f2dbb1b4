"""What each hand kernel must move and compute: one cost function a kernel.

A launch's bound, the least time the card could take for it, is the larger
of its bytes (each input read once, each output written once) over the HBM
rate and its operations over the peak for its operands' width (core/hw.py).
`chip_smoke.py`'s phase 5 reckons every bound it prints from these
functions, and every kernel wrapper's meta route (tensors on the "meta"
device: no data, nothing launched) reports the same count to whoever is
recording (`recording`, used by launch/step_cost.py), so the two counts
cannot drift.  Where the work depends on data, the caller counts what its
data needs: `decode_work` from the slots' query positions, and the meta
route, which sees no positions, every slot at the end of its table.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, Iterable, List, Optional, Tuple

import torch

from repro_torch.core import hw

_BITS = {torch.int8: 8, torch.bfloat16: 16, torch.float16: 16, torch.float32: 32}


@dataclasses.dataclass(frozen=True)
class Cost:
    """ops at the peak of `bits`-wide operands; nbytes moved."""

    ops: float
    nbytes: float
    bits: int = 16

    @property
    def bytes_s(self) -> float:
        return self.nbytes / hw.HBM_BW

    @property
    def ops_s(self) -> float:
        return self.ops / hw.PEAK_OPS[self.bits]

    @property
    def bound_s(self) -> float:
        return max(self.bytes_s, self.ops_s)

    @property
    def bound_by(self) -> str:
        return "bytes" if self.bytes_s >= self.ops_s else "operations"


def bits_of(dtype: torch.dtype) -> int:
    return _BITS[dtype]


def gemm(M: int, K: int, N: int, *, a_bytes: int = 2, b_bytes: int = 2,
         out_bytes: int = 2, bits: int = 16) -> Cost:
    """K1 / K6 (and K1's int mode): C (M, N) = A (M, K) @ B (K, N)."""
    return Cost(2 * M * K * N, M * K * a_bytes + K * N * b_bytes + M * N * out_bytes, bits)


def dequant_gemm(M: int, K: int, N: int, *, out_bytes: int = 2) -> Cost:
    """K3: int8 A and B, f32 row and column scales in, C out."""
    return Cost(2 * M * K * N, M * K + K * N + 4 * (M + N) + out_bytes * M * N, 8)


def gemm_w8a8(M: int, K: int, N: int, *, x_bytes: int = 2, out_bytes: int = 2) -> Cost:
    """The w8a8 GeMM in one launch: float x rows quantized in K3's prologue,
    int8 weights and their f32 column scales."""
    return Cost(2 * M * K * N, x_bytes * M * K + K * N + 4 * N + out_bytes * M * N, 8)


def quantize_rows(M: int, K: int, *, x_bytes: int = 2) -> Cost:
    """K4: float rows in; int8 codes and a f32 scale a row out; an absmax, a
    divide and a round an element, off the tensor cores."""
    return Cost(3 * M * K, M * K * x_bytes + M * K + 4 * M, 32)


@functools.lru_cache(maxsize=4096)
def attention_pairs(Sq: int, Skv: int, causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0) -> int:
    """(query, key) pairs a head scores: query i at position q_offset + i
    sees key j < Skv if j <= its position (causal) and its position - j <
    window."""
    n = 0
    for i in range(Sq):
        pos = q_offset + i
        hi = min(Skv - 1, pos) if causal else Skv - 1
        lo = 0 if window is None else max(0, pos - window + 1)
        n += max(0, hi - lo + 1)
    return n


def flash_attention(B: int, Sq: int, Skv: int, Hq: int, Hkv: int, D: int, *,
                    pairs: int, elem_bytes: int = 2, lse: bool = False) -> Cost:
    """K5: q and out (B, Sq, Hq, D), k and v (B, Skv, Hkv, D), and the f32
    lse (B, Hq, Sq) when asked; two products of D a scored pair."""
    nbytes = elem_bytes * B * D * (2 * Sq * Hq + 2 * Skv * Hkv) + (4 * B * Hq * Sq if lse else 0)
    return Cost(4 * B * Hq * D * pairs, nbytes, 8 * elem_bytes)


def flash_attention_bwd(B: int, Sq: int, Skv: int, Hq: int, Hkv: int, D: int, *,
                        pairs: int, elem_bytes: int = 2) -> Cost:
    """K5b: q, out, dO in and dq out (Hq heads), k, v in and dk, dv out (Hkv
    heads), the lse in and Delta out (f32); five products of D a pair."""
    nbytes = elem_bytes * B * D * (4 * Sq * Hq + 4 * Skv * Hkv) + 2 * 4 * B * Hq * Sq
    return Cost(5 * 2 * B * Hq * D * pairs, nbytes, 8 * elem_bytes)


def decode_work(starts: Iterable[int], Sq: int, window: Optional[int]) -> Tuple[int, int]:
    """(keys read, query-key pairs scored per head) of K2 over slots whose
    first query sits at each of `starts`."""
    keys = visible = 0
    for i0 in starts:
        lo = 0 if window is None else max(0, i0 - window + 1)
        keys += (i0 + Sq) - lo
        visible += attention_pairs(Sq, i0 + Sq, True, window, i0)
    return keys, visible


def flash_decode(B: int, Sq: int, Hq: int, Hkv: int, D: int, *, keys: int, visible: int,
                 table_entries: int, q_bytes: int = 2, pool_int8: bool = False) -> Cost:
    """K2: q in and out, each read key's K and V rows (int8 codes with a f32
    scale per head, or q's dtype), the slots' positions and block tables."""
    row_bytes = Hkv * (D + 4) if pool_int8 else Hkv * D * q_bytes
    nbytes = 2 * keys * row_bytes + 2 * q_bytes * B * Sq * Hq * D + 4 * B + 4 * table_entries
    return Cost(4 * Hq * D * visible, nbytes, 8 * q_bytes)


# -- the meta routes ----------------------------------------------------------

_SINKS: List[Callable[[str, Cost], None]] = []


@contextlib.contextmanager
def recording(sink: Callable[[str, Cost], None]):
    """Within the block every meta-route launch calls sink(kernel, cost)."""
    _SINKS.append(sink)
    try:
        yield
    finally:
        _SINKS.remove(sink)


def meta_launch(kernel: str, cost: Cost, *outs: Tuple[tuple, torch.dtype]):
    """A kernel's meta route: report its cost and return empty meta
    outputs of the shapes and dtypes it would write (one tensor, or a
    tuple for several)."""
    for sink in list(_SINKS):
        sink(kernel, cost)
    made = tuple(torch.empty(shape, dtype=dt, device="meta") for shape, dt in outs)
    return made[0] if len(made) == 1 else made
