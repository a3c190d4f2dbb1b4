"""Streaming log-bucketed histograms for latency/throughput percentiles
(port of repro/obs/hist.py, copied: no imports beyond the standard library).

``EngineMetrics`` used to keep every finished request's latency in an
unbounded Python list and sort it per percentile query — fine for a
benchmark, wrong for a serving process that lives for days.  A
``Histogram`` holds a *bounded* sketch instead: geometric buckets at growth
factor g (default 2^(1/32), ~2.2% per bucket), a count per touched bucket,
plus exact count/sum/min/max.  Properties:

  * **O(1) add**, O(buckets) percentile, O(buckets) merge — and the bucket
    count is bounded by the dynamic range (~1500 buckets across 14 decades),
    not by the number of observations.
  * **Nearest-rank compatible.**  ``percentile(q)`` uses the exact rank
    formula of ``serving.engine.percentile`` (k = ceil(q/100 * n) - 1,
    clamped; 0.0 when empty) over the bucket counts, returning the selected
    bucket's geometric midpoint clamped into [min, max].  The result is
    within half a bucket of the exact nearest-rank value: relative error
    <= sqrt(g) - 1 (~1.1% at the default growth) — `rel_error` states the
    bound, tests/test_torch_obs.py verifies it against the list
    implementation.
  * **Mergeable.**  Bucket counts add, so a cluster can aggregate
    per-replica histograms instead of concatenating raw request lists, so
    cluster-wide tails cost O(replicas x buckets), not O(total requests).

Values at or below ``min_value`` (including zeros) collapse into one
underflow bucket represented by the tracked minimum — TTFTs and tok/s are
positive, so in practice only an all-zero stream lands there.
"""

from __future__ import annotations

import math
from typing import Dict

DEFAULT_GROWTH = 2.0 ** (1.0 / 32.0)
_UNDERFLOW = -(1 << 30)          # bucket index for values <= min_value


def nearest_rank_index(q: float, n: int) -> int:
    """0-based nearest-rank index for percentile q over n samples:
    k = ceil(q/100 * n) - 1, clamped into [0, n-1]."""
    return min(n - 1, max(0, int(math.ceil(q / 100.0 * n)) - 1))


def percentile(vals, q: float) -> float:
    """Exact nearest-rank percentile over any iterable of numbers; 0.0 when
    empty.

    The one shared definition — ``serving.engine`` re-exports it and
    ``Histogram.percentile`` applies the same rank formula to its bucket
    counts, so list-based and sketch-based tails agree to bucket error."""
    s = sorted(float(v) for v in vals)
    if not s:
        return 0.0
    return s[nearest_rank_index(q, len(s))]


class Histogram:
    __slots__ = ("growth", "min_value", "_log_g", "counts", "count",
                 "total", "min", "max")

    def __init__(self, growth: float = DEFAULT_GROWTH,
                 min_value: float = 1e-9):
        if growth <= 1.0:
            raise ValueError(f"growth must be > 1, got {growth}")
        if min_value <= 0.0:
            raise ValueError(f"min_value must be > 0, got {min_value}")
        self.growth = growth
        self.min_value = min_value
        self._log_g = math.log(growth)
        self.counts: Dict[int, int] = {}
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    @property
    def rel_error(self) -> float:
        """Max relative error of percentile() vs the exact nearest-rank
        value (half a bucket each way from the geometric midpoint)."""
        return math.sqrt(self.growth) - 1.0

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def add(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if v <= self.min_value:
            b = _UNDERFLOW
        else:
            b = int(math.floor(math.log(v / self.min_value) / self._log_g))
        self.counts[b] = self.counts.get(b, 0) + 1

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold `other` into self (in place); returns self.  Histograms must
        share bucketing (growth, min_value) — merged counts are only
        meaningful over one bucket grid."""
        if (other.growth != self.growth
                or other.min_value != self.min_value):
            raise ValueError(
                f"cannot merge histograms with different bucketing: "
                f"(g={self.growth}, min={self.min_value}) vs "
                f"(g={other.growth}, min={other.min_value})")
        for b, c in other.counts.items():
            self.counts[b] = self.counts.get(b, 0) + c
        self.count += other.count
        self.total += other.total
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        return self

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile (engine.percentile semantics) to within
        half-bucket relative error; 0.0 when empty."""
        if not self.count:
            return 0.0
        k = nearest_rank_index(q, self.count)
        seen = 0
        for b in sorted(self.counts):
            seen += self.counts[b]
            if seen > k:
                if b == _UNDERFLOW:
                    rep = self.min
                else:
                    rep = self.min_value * self.growth ** (b + 0.5)
                return min(self.max, max(self.min, rep))
        raise AssertionError("bucket counts do not cover count")  # unreachable

    def count_above(self, threshold: float) -> int:
        """Observations whose bucket representative exceeds `threshold` —
        the "bad events" numerator for SLO burn rates (obs/slo.py).  Uses
        the same representative as percentile() (geometric midpoint clamped
        into [min, max]), so count_above(percentile(q)) and the rank math
        stay consistent to bucket error."""
        if not self.count:
            return 0
        bad = 0
        for b, c in self.counts.items():
            if b == _UNDERFLOW:
                rep = self.min
            else:
                rep = self.min_value * self.growth ** (b + 0.5)
            if min(self.max, max(self.min, rep)) > threshold:
                bad += c
        return bad

    def to_dict(self) -> dict:
        """JSON-serializable form (launch/serve.py --metrics-json)."""
        return {
            "growth": self.growth,
            "min_value": self.min_value,
            "count": self.count,
            "total": self.total,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
            "buckets": {str(b): c for b, c in sorted(self.counts.items())},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Histogram":
        h = cls(growth=d["growth"], min_value=d["min_value"])
        h.count = int(d["count"])
        h.total = float(d["total"])
        h.min = math.inf if d["min"] is None else float(d["min"])
        h.max = -math.inf if d["max"] is None else float(d["max"])
        h.counts = {int(b): int(c) for b, c in d["buckets"].items()}
        return h

    def __repr__(self) -> str:
        if not self.count:
            return "Histogram(empty)"
        return (f"Histogram(n={self.count}, mean={self.mean:.4g}, "
                f"p50={self.percentile(50):.4g}, "
                f"p95={self.percentile(95):.4g}, "
                f"min={self.min:.4g}, max={self.max:.4g})")
