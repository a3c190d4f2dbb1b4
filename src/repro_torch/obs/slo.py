"""Declarative SLO targets with multi-window burn-rate evaluation (port of
repro/obs/slo.py, copied).

The observability layer collects the raw signals — streaming
histograms (TTFT, per-token latency, tok/s), cumulative scheduler counters
(admitted / rejected), and live MFU gauges.  This module turns them into an
answer to the operator's question: *are we inside our service objective,
and how fast are we spending the error budget?*

The evaluation scheme is the SRE multi-window burn rate:

  * Every target defines a **bad-event fraction** per evaluation window —
    for a histogram target, the fraction of observations above the latency
    threshold (``Histogram.count_above``); for a ratio target, a counter
    ratio (shed / offered); for a floor target, how far a gauge sits below
    its floor.
  * **burn = bad fraction / error budget.**  Burn 1.0 means spending the
    budget exactly as fast as allowed; 2.0 means the budget is gone in half
    the period.
  * Two windows, evaluated over *deltas* of the cumulative series the
    monitor keeps per target: a short window (reacts fast, noisy) and a
    long window (slow, stable).  **BREACH requires both** windows at or
    above ``breach_burn`` — the classic guard against paging on a blip —
    while WARN fires on the long window alone at ``warn_burn``.
  * **Hysteresis on the way down**: escalation is immediate, de-escalation
    waits for ``clear_after`` consecutive calmer evaluations, so a target
    oscillating around a threshold doesn't flap ok/warn every tick.

Monitors are snapshot-driven, not wall-clock-driven: ``observe()`` takes a
dict of named histograms/counters/gauges (``engine_snapshot`` builds one
from a live Engine; histograms merge losslessly, so a cluster's burn
equals the burn of the concatenated per-replica streams).  Each observe() is one
evaluation step; windows are counted in observations, which makes the math
deterministic and directly testable (tests/test_torch_slo.py feeds synthetic
series across the thresholds).

On a transition into BREACH, wire the report into
``obs/recorder.py::FlightRecorder.record_breaches`` to capture an incident
bundle with the ring-buffer evidence of what the engine was doing.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

from repro_torch.obs.hist import Histogram

OK = "ok"
WARN = "warn"
BREACH = "breach"

_RANK = {OK: 0, WARN: 1, BREACH: 2}

HISTOGRAM = "histogram"
RATIO = "ratio"
FLOOR = "floor"


@dataclasses.dataclass(frozen=True)
class SloTarget:
    """One declarative objective.

    kind="histogram": `source` names a Histogram in the snapshot; a bad
        event is an observation above `threshold` (seconds, tokens/s, ...);
        `budget` is the allowed bad fraction (p95 target => budget 0.05).
    kind="ratio": `source` is "num/den" naming two cumulative counters; the
        windowed ratio num_delta/den_delta burns against `budget` (e.g.
        shed_rate 0.05 => more than 5% shed burns > 1).
    kind="floor": `source` names a gauge that must stay >= `threshold`
        (e.g. decode MFU); burn = threshold / windowed gauge mean.  A gauge
        at or below zero reads as "no signal yet", not a breach.
    """

    name: str
    kind: str
    source: str
    threshold: float
    budget: float = 0.05

    def __post_init__(self):
        if self.kind not in (HISTOGRAM, RATIO, FLOOR):
            raise ValueError(f"unknown SLO kind {self.kind!r}")
        if self.kind != FLOOR and self.budget <= 0.0:
            raise ValueError(f"{self.name}: budget must be > 0")
        if self.kind == RATIO and "/" not in self.source:
            raise ValueError(f"{self.name}: ratio source must be 'num/den'")


@dataclasses.dataclass
class TargetState:
    """Evaluation result for one target at one observe() step."""

    name: str
    state: str
    prev_state: str
    burn_short: float
    burn_long: float
    bad_total: int = 0
    total: int = 0

    @property
    def transitioned(self) -> bool:
        return self.state != self.prev_state


class SloReport:
    """The result of one SloMonitor.observe() call."""

    def __init__(self, targets: List[TargetState]):
        self.targets = targets

    @property
    def state(self) -> str:
        """Worst per-target state (ok < warn < breach)."""
        if not self.targets:
            return OK
        return max(self.targets, key=lambda t: _RANK[t.state]).state

    @property
    def transitions(self) -> List[TargetState]:
        return [t for t in self.targets if t.transitioned]

    @property
    def breaches(self) -> List[TargetState]:
        return [t for t in self.targets
                if t.transitioned and t.state == BREACH]

    def summary(self) -> str:
        parts = [f"slo={self.state}"]
        for t in self.targets:
            mark = "" if not t.transitioned else f"<-{t.prev_state}"
            parts.append(f"{t.name}={t.state}{mark}"
                         f"(burn {t.burn_short:.2f}/{t.burn_long:.2f})")
        return " ".join(parts)

    def as_dict(self) -> dict:
        return {
            "state": self.state,
            "targets": [dataclasses.asdict(t) | {"transitioned":
                                                 t.transitioned}
                        for t in self.targets],
        }


class SloMonitor:
    """Evaluates a set of SloTargets over a stream of metric snapshots.

    Windows are counted in observe() calls: `short_window`/`long_window`
    are how many trailing observations each burn rate is computed over.
    The monitor keeps a cumulative (bad, total) series per target, seeded
    with a virtual (0, 0) so the first observation evaluates over
    everything seen so far.
    """

    def __init__(self, targets: Sequence[SloTarget], *,
                 short_window: int = 1, long_window: int = 4,
                 warn_burn: float = 1.0, breach_burn: float = 2.0,
                 clear_after: int = 2):
        if short_window < 1 or long_window < short_window:
            raise ValueError("need 1 <= short_window <= long_window")
        if clear_after < 1:
            raise ValueError("clear_after must be >= 1")
        self.targets = list(targets)
        self.short_window = short_window
        self.long_window = long_window
        self.warn_burn = warn_burn
        self.breach_burn = breach_burn
        self.clear_after = clear_after
        # cumulative (bad, total) per histogram/ratio target; raw gauge
        # series per floor target — both seeded for window math
        self._series: Dict[str, List[Tuple[float, float]]] = {
            t.name: [(0.0, 0.0)] for t in self.targets}
        self._state: Dict[str, str] = {t.name: OK for t in self.targets}
        self._calm: Dict[str, int] = {t.name: 0 for t in self.targets}

    # -- per-kind cumulative extraction --------------------------------------

    def _cumulative(self, t: SloTarget, snapshot: dict
                    ) -> Tuple[float, float]:
        """(bad_events, total_events) since process start, per target kind.
        Floor targets return (gauge_value, 1.0) — windowed mean, not a
        counter delta."""
        if t.kind == HISTOGRAM:
            h = snapshot.get(t.source)
            if not isinstance(h, Histogram) or not h.count:
                return 0.0, 0.0
            return float(h.count_above(t.threshold)), float(h.count)
        if t.kind == RATIO:
            num_key, den_key = t.source.split("/", 1)
            return (float(snapshot.get(num_key, 0) or 0),
                    float(snapshot.get(den_key, 0) or 0))
        # FLOOR: stash the raw gauge sample
        return float(snapshot.get(t.source, 0.0) or 0.0), 1.0

    def _burn(self, t: SloTarget, window: int) -> float:
        s = self._series[t.name]
        if t.kind == FLOOR:
            # windowed mean of the gauge samples (skip the (0,0) seed)
            samples = [v for v, _ in s[1:]][-window:]
            if not samples:
                return 0.0
            mean = sum(samples) / len(samples)
            if mean <= 0.0:
                return 0.0          # no signal yet — don't alarm on startup
            return t.threshold / mean
        cur_bad, cur_total = s[-1]
        prev_bad, prev_total = s[max(0, len(s) - 1 - window)]
        bad = max(0.0, cur_bad - prev_bad)
        total = max(0.0, cur_total - prev_total)
        if total <= 0.0:
            return 0.0              # idle window spends no budget
        return (bad / total) / t.budget

    # -- evaluation ----------------------------------------------------------

    def observe(self, snapshot: dict) -> SloReport:
        """Fold one metrics snapshot in and re-evaluate every target."""
        states: List[TargetState] = []
        for t in self.targets:
            self._series[t.name].append(self._cumulative(t, snapshot))
            burn_s = self._burn(t, self.short_window)
            burn_l = self._burn(t, self.long_window)
            if burn_s >= self.breach_burn and burn_l >= self.breach_burn:
                level = BREACH
            elif burn_l >= self.warn_burn:
                level = WARN
            else:
                level = OK
            prev = self._state[t.name]
            if _RANK[level] > _RANK[prev]:
                new, self._calm[t.name] = level, 0    # escalate immediately
            elif _RANK[level] < _RANK[prev]:
                self._calm[t.name] += 1               # hysteretic clear
                if self._calm[t.name] >= self.clear_after:
                    new, self._calm[t.name] = level, 0
                else:
                    new = prev
            else:
                new, self._calm[t.name] = prev, 0
            self._state[t.name] = new
            bad, total = self._series[t.name][-1]
            states.append(TargetState(
                name=t.name, state=new, prev_state=prev,
                burn_short=burn_s, burn_long=burn_l,
                bad_total=int(bad) if t.kind != FLOOR else 0,
                total=int(total) if t.kind != FLOOR else 0))
        return SloReport(states)

    @property
    def state(self) -> str:
        if not self.targets:
            return OK
        return max(self._state.values(), key=lambda s: _RANK[s])


# -- snapshot builders / spec parsing ----------------------------------------

def engine_snapshot(engine) -> dict:
    """Metric snapshot for SloMonitor.observe() from a live Engine (duck-
    typed: anything with .metrics and .scheduler quacks the same)."""
    m = engine.metrics
    sched = engine.scheduler
    offered = (sched.rejected + sched.admitted_total + len(sched.queue))
    return {
        "ttft": m.ttft_hist,
        "latency": m.latency_hist,
        "tok_s": m.tok_s_hist,
        "shed": sched.rejected,
        "offered": offered,
        "mfu_decode": m.mfu.mfu("decode") if m.mfu else 0.0,
    }


_P_SUFFIX = "_p"


def parse_slo_spec(spec: str) -> List[SloTarget]:
    """Parse the --slo CLI string into targets.

    Grammar: comma-separated `key=value` pairs —

        ttft_p95=0.25        TTFT p95 <= 0.25s   (histogram over "ttft")
        latency_p99=1.0      per-token p99 <= 1s (histogram over "latency")
        shed_rate=0.05       <= 5% of offered requests shed  (ratio)
        mfu_floor=1e-6       decode MFU stays above the floor

    A pNN suffix sets the error budget to 1 - NN/100.
    """
    targets: List[SloTarget] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"bad SLO clause {part!r} (want key=value)")
        key, _, raw = part.partition("=")
        key = key.strip()
        try:
            value = float(raw)
        except ValueError:
            raise ValueError(f"bad SLO value in {part!r}") from None
        if key == "shed_rate":
            targets.append(SloTarget(name=key, kind=RATIO,
                                     source="shed/offered",
                                     threshold=value, budget=value))
        elif key == "mfu_floor":
            targets.append(SloTarget(name=key, kind=FLOOR,
                                     source="mfu_decode", threshold=value))
        elif _P_SUFFIX in key:
            source, _, pct = key.rpartition(_P_SUFFIX)
            if source not in ("ttft", "latency", "tok_s"):
                raise ValueError(f"unknown SLO histogram {source!r} in "
                                 f"{part!r}")
            try:
                q = float(pct)
            except ValueError:
                raise ValueError(f"bad percentile in {part!r}") from None
            if not 0.0 < q < 100.0:
                raise ValueError(f"percentile out of range in {part!r}")
            # round away float noise (1 - 95/100 = 0.0500...04) so a burn
            # of exactly breach_burn compares clean against the budget
            budget = round(1.0 - q / 100.0, 12)
            targets.append(SloTarget(name=key, kind=HISTOGRAM,
                                     source=source, threshold=value,
                                     budget=budget))
        else:
            raise ValueError(f"unknown SLO key {key!r}")
    if not targets:
        raise ValueError(f"empty SLO spec {spec!r}")
    return targets
