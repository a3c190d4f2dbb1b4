"""repro_torch.obs — live utilization tracing, streaming metrics, and SLOs
(port of repro/obs; the modules but mfu.py are copies, numpy only).

The pieces, one layer (see each module's docstring):

  * trace.py    — pre-allocated ring-buffer span/event log (per-request
                  lifecycle + per-tick phases + cross-lane request flows),
                  single-writer per engine thread, Chrome-trace exportable;
  * hist.py     — log-bucketed streaming histograms with nearest-rank
                  percentiles and merge (bounded replacement for raw
                  request lists in engine/cluster metrics), plus the one
                  shared nearest-rank ``percentile`` helper;
  * mfu.py      — per-phase utilization (measured vs the H100 roofline
                  bound of tuning/model.py) and MFU gauges on the H100's
                  peaks, the paper's Table 2 utilization computed live at
                  serving time;
  * export.py   — Perfetto/chrome://tracing JSON export, flow arrows and
                  instants included;
  * slo.py      — declarative SLO targets with multi-window burn-rate
                  evaluation and an ok/warn/breach state machine;
  * recorder.py — anomaly flight recorder: ring-buffer + metric snapshots
                  into JSON incident bundles on breach/pressure triggers.

Threaded through serving/engine.py (``Engine(trace=True)``) and
launch/serve.py (``--trace-out`` / ``--metrics-json`` / ``--slo`` /
``--incident-dir``).
"""

from repro_torch.obs.hist import Histogram, nearest_rank_index, percentile
from repro_torch.obs.mfu import MfuMeter, PHASES, PhaseStat
from repro_torch.obs.trace import NULL_TRACER, NullTracer, Tracer
from repro_torch.obs.export import (
    chrome_trace_events,
    trace_document,
    write_chrome_trace,
)
from repro_torch.obs.slo import (
    BREACH,
    OK,
    WARN,
    SloMonitor,
    SloReport,
    SloTarget,
    engine_snapshot,
    parse_slo_spec,
)
from repro_torch.obs.recorder import FlightRecorder

__all__ = [
    "Histogram",
    "nearest_rank_index",
    "percentile",
    "MfuMeter",
    "PHASES",
    "PhaseStat",
    "NULL_TRACER",
    "NullTracer",
    "Tracer",
    "chrome_trace_events",
    "trace_document",
    "write_chrome_trace",
    "OK",
    "WARN",
    "BREACH",
    "SloMonitor",
    "SloReport",
    "SloTarget",
    "engine_snapshot",
    "parse_slo_spec",
    "FlightRecorder",
]
