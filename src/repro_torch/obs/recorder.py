"""Anomaly flight recorder: snapshot ring-buffer evidence on trigger (port
of repro/obs/recorder.py, copied).

When an SLO burns or the engine sheds, the aggregate gauges tell you *that*
something went wrong; the flight recorder captures *what the system was
doing at that moment*.  A trigger snapshots, into one self-contained JSON
incident bundle:

  * the newest events from every registered tracer ring (the last
    ``max_events`` per tracer — the tick phases, request lifecycle spans,
    flow steps, and shed/eviction instants leading up to the trigger);
  * every registered metric source (engine metrics, allocator counters,
    scheduler queue state, drafter acceptance) evaluated at trigger time;
  * the trigger record itself: reason, wall/monotonic timestamps, sequence
    number, and any caller-supplied context (e.g. the SLO report that
    transitioned into breach).

Design rules:

  * **Never write into a foreign tracer.**  Tracers are single-writer
    rings owned by their engine thread (obs/trace.py); the recorder may
    fire from the router thread or a monitoring loop while replicas are
    mid-tick.  Reading can at worst see one torn record at the ring head
    (annotated in the bundle as ``live_read``); writing would corrupt the
    ring.  The trigger annotation therefore lives in the bundle JSON, not
    in the trace.
  * **Rate-limited per reason.**  A pressure trigger evaluated per tick
    must not write a thousand bundles; ``min_interval_s`` drops repeat
    triggers for the same reason inside the window (counted in
    ``suppressed``).
  * **Sources never take the recorder down.**  A metric source that raises
    is captured as its error string — an incident bundle with one missing
    section beats no bundle during an incident.

Wiring: ``attach_engine`` registers an Engine's tracer + standard sources;
``record_breaches`` consumes an ``obs/slo.py::SloReport``;
``check_engine`` evaluates built-in pressure triggers (allocator
exhaustion, speculative-acceptance collapse).  launch/serve.py exposes the
lot as ``--incident-dir`` on both the single-engine and cluster paths.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Callable, Dict, List, Optional

from repro_torch.obs.slo import BREACH, SloReport

_REASON_RE = re.compile(r"[^a-zA-Z0-9_.-]+")


class FlightRecorder:
    """Collects tracers + metric sources; dumps incident bundles on
    trigger().  Thread-safe: triggers may arrive concurrently from the
    router, a monitor loop, and test code."""

    def __init__(self, incident_dir: str, *, tracers=(),
                 max_events: int = 512, min_interval_s: float = 0.0,
                 metadata: Optional[dict] = None):
        self.incident_dir = incident_dir
        self.max_events = int(max_events)
        self.min_interval_s = float(min_interval_s)
        self.metadata = dict(metadata or {})
        self._tracers: List = []
        self._sources: Dict[str, Callable[[], dict]] = {}
        self._lock = threading.Lock()
        self._seq = 0
        self._last_trigger: Dict[str, float] = {}   # reason -> monotonic s
        self.suppressed = 0
        self.incidents: List[str] = []
        for t in tracers:
            self.add_tracer(t)

    # -- registration --------------------------------------------------------

    def add_tracer(self, tracer) -> None:
        if tracer is not None and getattr(tracer, "enabled", False):
            self._tracers.append(tracer)

    def add_source(self, name: str, fn: Callable[[], dict]) -> None:
        """Register a zero-arg callable returning a JSON-able dict,
        evaluated at trigger time (not registration time)."""
        self._sources[name] = fn

    def attach_engine(self, engine, name: str = "engine") -> None:
        """Register an Engine's tracer and its standard evidence sources."""
        self.add_tracer(engine.tracer)
        m, sched, alloc = engine.metrics, engine.scheduler, engine.alloc
        self.add_source(f"{name}.metrics", m.as_dict)
        self.add_source(f"{name}.allocator", alloc.stats)
        self.add_source(f"{name}.scheduler", lambda: {
            "queue_depth": len(sched.queue),
            "rejected": sched.rejected,
            "admitted_total": sched.admitted_total,
            "preemptions": sched.preemptions,
            "active": sum(1 for s in sched.slots if s is not None),
        })
        if engine.drafter is not None:
            d = engine.drafter
            self.add_source(f"{name}.drafter", lambda: {
                "draft_calls": d.draft_calls,
                "draft_hits": d.draft_hits,
                "drafted_tokens": d.drafted_tokens,
                "hit_rate": d.hit_rate,
            })

    # -- triggering ----------------------------------------------------------

    def trigger(self, reason: str, extra: Optional[dict] = None
                ) -> Optional[str]:
        """Capture an incident bundle; returns its path, or None when the
        per-reason rate limit suppressed it."""
        now = time.monotonic()
        with self._lock:
            last = self._last_trigger.get(reason)
            if (last is not None and self.min_interval_s > 0.0
                    and now - last < self.min_interval_s):
                self.suppressed += 1
                return None
            self._last_trigger[reason] = now
            self._seq += 1
            seq = self._seq
            bundle = self._capture(reason, seq, extra)
            path = self._write(reason, seq, bundle)
            self.incidents.append(path)
            return path

    def _capture(self, reason: str, seq: int, extra: Optional[dict]) -> dict:
        bundle = {
            "trigger": {
                "reason": reason,
                "seq": seq,
                "ts_unix": time.time(),
                "ts_ns": time.perf_counter_ns(),
                **({"context": extra} if extra else {}),
            },
            "metadata": self.metadata,
            "tracers": [],
            "sources": {},
        }
        for t in self._tracers:
            evs = t.events()[-self.max_events:]
            bundle["tracers"].append({
                "name": t.name,
                "pid": t.pid,
                "events": evs,
                "recorded": t.recorded,
                "dropped": t.dropped,
                "live_read": True,   # rings may be mid-write; see docstring
            })
        for name, fn in self._sources.items():
            try:
                bundle["sources"][name] = fn()
            except Exception as e:  # evidence > purity during an incident
                bundle["sources"][name] = {"error": repr(e)}
        return bundle

    def _write(self, reason: str, seq: int, bundle: dict) -> str:
        os.makedirs(self.incident_dir, exist_ok=True)
        slug = _REASON_RE.sub("-", reason).strip("-") or "incident"
        path = os.path.join(self.incident_dir,
                            f"incident-{seq:03d}-{slug}.json")
        with open(path, "w") as f:
            json.dump(bundle, f, default=str)
        return path

    # -- built-in trigger policies -------------------------------------------

    def record_breaches(self, report: SloReport) -> List[str]:
        """One bundle per target transitioning into BREACH this report."""
        paths = []
        for t in report.breaches:
            p = self.trigger(f"slo-breach-{t.name}", extra={
                "target": t.name,
                "burn_short": t.burn_short,
                "burn_long": t.burn_long,
                "prev_state": t.prev_state,
                "report": report.as_dict(),
            })
            if p:
                paths.append(p)
        return paths

    def check_engine(self, engine, *, free_frac: float = 0.05,
                     min_accept: float = 0.2, min_drafted: int = 64,
                     max_preempt_frac: float = 0.5) -> List[str]:
        """Evaluate built-in pressure triggers against a live engine:
        allocator nearly exhausted (free fraction below `free_frac`, the
        CoW-eviction death spiral precursor), speculative acceptance
        collapse (acceptance below `min_accept` once at least `min_drafted`
        tokens have been drafted — an ngram drafter gone pathological costs
        a full verify step per miss), and preemption pressure (KV swap-outs
        exceeding `max_preempt_frac` of admitted requests — the scheduler
        is thrashing batch work in and out instead of making progress;
        admission or pool sizing needs attention)."""
        paths = []
        st = engine.alloc.stats()
        total = st["in_use"] + st["reserved"] + st["free"]
        if total > 0 and st["free"] / total < free_frac:
            p = self.trigger("allocator-pressure", extra=st)
            if p:
                paths.append(p)
        m = engine.metrics
        if (m.spec_draft_tokens >= min_drafted
                and m.acceptance_rate < min_accept):
            p = self.trigger("spec-acceptance-collapse", extra={
                "drafted": m.spec_draft_tokens,
                "accepted": m.spec_accepted_tokens,
                "acceptance_rate": m.acceptance_rate,
            })
            if p:
                paths.append(p)
        # getattr-guarded: check_engine also serves partial engine doubles
        # (tests, external health probes) that predate preemption fields.
        admitted = getattr(getattr(engine, "scheduler", None),
                           "admitted_total", 0)
        preempts = getattr(m, "preemptions", 0)
        if (admitted > 0 and preempts > 0
                and preempts / admitted > max_preempt_frac):
            p = self.trigger("preemption-pressure", extra={
                "preemptions": preempts,
                "admitted_total": admitted,
                "swap_out_blocks": getattr(m, "swap_out_blocks", 0),
                "swap_in_blocks": getattr(m, "swap_in_blocks", 0),
                "swap_time_s": getattr(m, "swap_time_s", 0.0),
            })
            if p:
                paths.append(p)
        return paths

    @staticmethod
    def is_breach(report: SloReport) -> bool:
        return report.state == BREACH
