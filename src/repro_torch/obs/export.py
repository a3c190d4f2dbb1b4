"""Chrome-trace / Perfetto export of recorded tracers (port of
repro/obs/export.py, copied).

Converts one or more ``Tracer`` ring buffers into the Chrome Trace Event
JSON format (the `traceEvents` array form), loadable in Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing``:

  * each tracer becomes one (pid, tid) lane, named via "M" metadata events
    — a ReplicaPool export shows one process row per replica;
  * BEGIN/END become nested "B"/"E" duration events (per-tick phases);
  * ASYNC_BEGIN/END become "b"/"e" events with ``cat="request"`` and the
    request id as ``id`` — Perfetto draws each request's
    queued -> prefill -> decode lifecycle as its own async track;
  * COUNTER becomes "C" events — kv_blocks_in_use / queue_depth render as
    stacked counter charts over the timeline;
  * FLOW_START/STEP/END become "s"/"t"/"f" events with ``cat="flow"`` and
    the request's trace id as ``id`` — Perfetto draws connected arrows from
    the router's admit slice through every prefill chunk / decode tick the
    request touched, across pid lanes, to the finishing tick ("f" carries
    ``bp="e"`` so the arrowhead lands on the enclosing slice);
  * INSTANT becomes thread-scoped "i" events (shed decisions, prefix-cache
    hits, CoW evictions) with the payload under ``args``.

Timestamps are microseconds (the format's unit) relative to the earliest
event across all tracers, so multi-replica traces align on one clock
(every tracer samples the same process-wide ``time.perf_counter_ns``).
"""

from __future__ import annotations

import json
from typing import Iterable, List, Optional

from repro_torch.obs.trace import (
    ASYNC_BEGIN,
    ASYNC_END,
    BEGIN,
    COUNTER,
    END,
    FLOW_END,
    FLOW_START,
    FLOW_STEP,
    INSTANT,
    Tracer,
)

_PH = {BEGIN: "B", END: "E", COUNTER: "C", ASYNC_BEGIN: "b", ASYNC_END: "e",
       FLOW_START: "s", FLOW_STEP: "t", FLOW_END: "f", INSTANT: "i"}
_FLOW_KINDS = (FLOW_START, FLOW_STEP, FLOW_END)


def chrome_trace_events(tracers: Iterable[Tracer], *,
                        origin_ns: Optional[int] = None) -> List[dict]:
    """Flatten tracers into a Chrome-trace `traceEvents` list."""
    decoded = [(t, t.events()) for t in tracers if len(t)]
    if not decoded:
        return []
    if origin_ns is None:
        # ring order is chronological, so the first held event is the oldest
        origin_ns = min(evs[0]["ts_ns"] for _, evs in decoded)
    events: List[dict] = []
    for t, evs in decoded:
        pid, tid = t.pid, 0
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": tid, "args": {"name": t.name}})
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": t.name}})
        for ev in evs:
            kind = ev["kind"]
            out = {
                "ph": _PH[kind],
                "name": ev["name"],
                "pid": pid,
                "tid": tid,
                "ts": (ev["ts_ns"] - origin_ns) / 1e3,   # microseconds
            }
            if kind == COUNTER:
                out["args"] = {ev["name"]: ev["value"]}
            elif kind in (ASYNC_BEGIN, ASYNC_END):
                out["cat"] = "request"
                out["id"] = ev["id"]
            elif kind in _FLOW_KINDS:
                out["cat"] = "flow"
                out["id"] = ev["id"]
                if kind == FLOW_END:
                    out["bp"] = "e"
            elif kind == INSTANT:
                out["s"] = "t"
                out["args"] = {"value": ev["value"]}
            events.append(out)
    return events


def trace_document(tracers: Iterable[Tracer], *,
                   metadata: Optional[dict] = None) -> dict:
    """The full JSON-object trace form ({"traceEvents": [...], ...})."""
    doc = {
        "traceEvents": chrome_trace_events(tracers),
        "displayTimeUnit": "ms",
    }
    dropped = sum(t.dropped for t in tracers)
    meta = dict(metadata or {})
    if dropped:
        meta["dropped_events"] = dropped
    if meta:
        doc["metadata"] = meta
    return doc


def write_chrome_trace(path: str, tracers: Iterable[Tracer], *,
                       metadata: Optional[dict] = None) -> dict:
    """Write a Perfetto-loadable trace JSON; returns the written document."""
    doc = trace_document(tracers, metadata=metadata)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc
