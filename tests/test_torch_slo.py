"""SLO telemetry of the port (repro_torch.obs.slo / .recorder), copied
from the reference: multi-window burn-rate math over synthetic feeds, the
escalation / hysteresis state machine, --slo spec parsing, merged
histograms, flight-recorder bundles and the built-in trigger policies, each
also held against the reference's monitor on the same feeds; and the
single-engine path end to end (a port Engine's snapshot, the serve CLI's
--slo / --incident-dir on the CPU).  The reference's benchmark compare
gate (benchmarks/compare.py) has no port counterpart yet, and its cluster
acceptance run waits for the port's cluster."""

import json
import os
import types

import numpy as np
import pytest

from repro import obs as robs
from repro_torch import configs
from repro_torch.obs import (
    BREACH,
    OK,
    WARN,
    FlightRecorder,
    Histogram,
    NULL_TRACER,
    SloMonitor,
    SloTarget,
    Tracer,
    engine_snapshot,
    parse_slo_spec,
)

ARCH = "gemma3-1b"


# ---------------------------------------------------------------------------
# burn-rate math + state machine (synthetic feeds, no engine)
# ---------------------------------------------------------------------------


def _ttft_target(threshold=0.1, budget=0.05):
    return SloTarget(name="ttft_p95", kind="histogram", source="ttft",
                     threshold=threshold, budget=budget)


def _observe(mon, h, n_good=0, n_bad=0):
    """Extend the cumulative histogram feed, then evaluate one step."""
    for _ in range(n_good):
        h.add(0.01)
    for _ in range(n_bad):
        h.add(1.0)
    return mon.observe({"ttft": h})


def test_burn_crossing_warn_breach_and_hysteresis():
    """The canonical trajectory: clean -> bad burst -> clean again.  Burn
    rates are exact (windows are observe() counts, feeds are synthetic), so
    every state on the way up and down is asserted."""
    mon = SloMonitor([_ttft_target()])        # short=1 long=4, clear_after=2
    h = Histogram()

    r = _observe(mon, h, n_good=100)
    t = r.targets[0]
    assert (t.state, t.burn_short, t.burn_long) == (OK, 0.0, 0.0)
    assert r.state == OK and not r.transitions

    # burst: 20% bad in the step -> short burn 4.0; 10% bad overall -> long
    # burn 2.0.  Both windows at breach_burn: immediate escalation.
    r = _observe(mon, h, n_good=80, n_bad=20)
    t = r.targets[0]
    assert t.state == BREACH and t.transitioned and t.prev_state == OK
    assert t.burn_short == pytest.approx(4.0)
    assert t.burn_long == pytest.approx(2.0)
    assert r.breaches and r.state == BREACH
    assert t.bad_total == 20 and t.total == 200
    assert "breach" in r.summary()

    # clean step: level drops to WARN (long window still burns 1.33) but
    # hysteresis holds BREACH for clear_after=2 evaluations
    r = _observe(mon, h, n_good=100)
    t = r.targets[0]
    assert t.state == BREACH and not t.transitioned
    assert t.burn_short == 0.0
    assert t.burn_long == pytest.approx(20 / 300 / 0.05)

    # second calm evaluation: clears — to WARN, since the long window still
    # spends budget exactly at rate 1.0
    r = _observe(mon, h, n_good=100)
    t = r.targets[0]
    assert t.state == WARN and t.transitioned and t.prev_state == BREACH
    assert t.burn_long == pytest.approx(1.0)

    _observe(mon, h, n_good=100)              # long window 1.0: WARN holds
    r = _observe(mon, h, n_good=100)          # bad burst slides out: calm 1
    assert r.targets[0].state == WARN
    r = _observe(mon, h, n_good=100)          # calm 2: clears to OK
    t = r.targets[0]
    assert t.state == OK and t.transitioned and t.prev_state == WARN
    assert mon.state == OK


def test_breach_requires_both_windows():
    """A short-window spike over a calm long window must not page: that is
    the whole point of multi-window burn."""
    mon = SloMonitor([_ttft_target()])
    h = Histogram()
    _observe(mon, h, n_good=400)
    # 20% bad in this step (short burn 4.0) but only ~1% bad overall
    r = _observe(mon, h, n_good=16, n_bad=4)
    t = r.targets[0]
    assert t.burn_short == pytest.approx(4.0)
    assert t.burn_long < 1.0
    assert t.state == OK


def test_ratio_target_and_idle_window():
    mon = SloMonitor([SloTarget(name="shed_rate", kind="ratio",
                                source="shed/offered", threshold=0.05,
                                budget=0.05)])
    r = mon.observe({"shed": 0, "offered": 100})
    assert r.targets[0].state == OK
    r = mon.observe({"shed": 20, "offered": 200})
    t = r.targets[0]
    assert t.burn_short == pytest.approx(0.2 / 0.05)
    assert t.burn_long == pytest.approx(0.1 / 0.05)
    assert t.state == BREACH
    # idle window (counters unchanged) spends no budget: level drops, the
    # hysteresis holds the state
    r = mon.observe({"shed": 20, "offered": 200})
    t = r.targets[0]
    assert t.burn_short == 0.0 and t.state == BREACH and not t.transitioned


def test_floor_target_gauge_mean_and_startup_grace():
    mon = SloMonitor([SloTarget(name="mfu_floor", kind="floor",
                                source="mfu_decode", threshold=0.5)])
    r = mon.observe({"mfu_decode": 1.0})
    assert r.targets[0].state == OK
    assert r.targets[0].burn_short == pytest.approx(0.5)
    # gauge collapses: short burn jumps at once, long mean degrades slowly
    r = mon.observe({"mfu_decode": 0.1})
    t = r.targets[0]
    assert t.burn_short == pytest.approx(5.0)
    assert t.burn_long == pytest.approx(0.5 / 0.55)
    assert t.state == OK                       # long window still healthy
    mon.observe({"mfu_decode": 0.1})
    r = mon.observe({"mfu_decode": 0.1})
    assert r.targets[0].state == WARN          # long mean now 0.325
    r = mon.observe({"mfu_decode": 0.1})       # window all-collapsed
    assert r.targets[0].state == BREACH
    # zero gauge = no signal yet, never an alarm (serve-loop startup)
    calm = SloMonitor([SloTarget(name="mfu_floor", kind="floor",
                                 source="mfu_decode", threshold=0.5)])
    r = calm.observe({"mfu_decode": 0.0})
    assert r.targets[0].state == OK and r.targets[0].burn_short == 0.0


def test_missing_or_empty_sources_burn_nothing():
    mon = SloMonitor([_ttft_target(),
                      SloTarget(name="shed_rate", kind="ratio",
                                source="shed/offered", threshold=0.05,
                                budget=0.05)])
    r = mon.observe({})                        # nothing wired yet
    assert r.state == OK
    r = mon.observe({"ttft": Histogram(), "shed": 0, "offered": 0})
    assert r.state == OK


def test_report_worst_of_and_dict_shape():
    mon = SloMonitor([_ttft_target(),
                      SloTarget(name="mfu_floor", kind="floor",
                                source="mfu_decode", threshold=1e-9)])
    h = Histogram()
    for _ in range(10):
        h.add(1.0)                             # 100% bad
    r = mon.observe({"ttft": h, "mfu_decode": 1.0})
    assert [t.state for t in r.targets] == [BREACH, OK]
    assert r.state == BREACH                   # worst-of
    d = json.loads(json.dumps(r.as_dict()))
    assert d["state"] == BREACH
    assert d["targets"][0]["transitioned"] is True
    assert SloMonitor([]).observe({}).state == OK


def test_target_and_monitor_validation():
    with pytest.raises(ValueError, match="unknown SLO kind"):
        SloTarget(name="x", kind="gauge", source="y", threshold=1.0)
    with pytest.raises(ValueError, match="budget"):
        SloTarget(name="x", kind="histogram", source="y", threshold=1.0,
                  budget=0.0)
    with pytest.raises(ValueError, match="num/den"):
        SloTarget(name="x", kind="ratio", source="shed", threshold=0.05)
    targets = [_ttft_target()]
    with pytest.raises(ValueError):
        SloMonitor(targets, short_window=0)
    with pytest.raises(ValueError):
        SloMonitor(targets, short_window=4, long_window=2)
    with pytest.raises(ValueError):
        SloMonitor(targets, clear_after=0)


def test_parse_slo_spec():
    by = {t.name: t for t in parse_slo_spec(
        "ttft_p95=0.25, latency_p99=1.0, shed_rate=0.05, mfu_floor=1e-6")}
    t = by["ttft_p95"]
    assert (t.kind, t.source, t.threshold) == ("histogram", "ttft", 0.25)
    assert t.budget == pytest.approx(0.05)
    assert by["latency_p99"].budget == pytest.approx(0.01)
    # budgets parse to clean decimals so burn==breach_burn compares exact
    assert by["ttft_p95"].budget == 0.05
    s = by["shed_rate"]
    assert (s.kind, s.source, s.budget) == ("ratio", "shed/offered", 0.05)
    f = by["mfu_floor"]
    assert (f.kind, f.source, f.threshold) == ("floor", "mfu_decode", 1e-6)
    for bad in ("", "   ", "nope=1", "ttft_p95", "ttft_p95=fast",
                "ttft_pxx=1", "ttft_p0=1", "ttft_p100=1", "queue_p95=1"):
        with pytest.raises(ValueError):
            parse_slo_spec(bad)


def test_cluster_merged_histogram_burns_like_concatenated_feed():
    """The cluster path merges per-replica histograms losslessly, so the
    merged monitor must report exactly the burn of one monitor fed the
    concatenated stream."""
    rng = np.random.default_rng(0)
    a_vals = list(rng.lognormal(-3, 1, 120)) + [1.0] * 9
    b_vals = list(rng.lognormal(-3, 1, 80)) + [1.0] * 13
    a, b, one = Histogram(), Histogram(), Histogram()
    for v in a_vals:
        a.add(float(v))
        one.add(float(v))
    for v in b_vals:
        b.add(float(v))
        one.add(float(v))
    a.merge(b)
    m_merged = SloMonitor([_ttft_target(threshold=0.5)])
    m_single = SloMonitor([_ttft_target(threshold=0.5)])
    rm = m_merged.observe({"ttft": a}).targets[0]
    rs = m_single.observe({"ttft": one}).targets[0]
    assert rm.state == rs.state
    assert rm.burn_short == rs.burn_short and rm.burn_long == rs.burn_long
    assert (rm.bad_total, rm.total) == (rs.bad_total, rs.total)


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------


def test_recorder_bundle_contents(tmp_path):
    tr = Tracer(capacity=64, name="unit", pid=7)
    c = tr.intern("work")
    tr.begin(c)
    tr.flow_start(tr.intern("req"), 3)
    tr.end(c)
    rec = FlightRecorder(str(tmp_path), tracers=[tr, NULL_TRACER],
                         metadata={"arch": "unit"})
    rec.add_source("counts", lambda: {"x": 1})
    rec.add_source("boom", lambda: 1 / 0)
    path = rec.trigger("unit test: weird/reason!", extra={"k": "v"})
    assert os.path.basename(path) == "incident-001-unit-test-weird-reason.json"
    with open(path) as f:
        b = json.load(f)                       # self-contained valid JSON
    assert b["trigger"]["reason"] == "unit test: weird/reason!"
    assert b["trigger"]["seq"] == 1 and b["trigger"]["context"] == {"k": "v"}
    assert b["metadata"] == {"arch": "unit"}
    [lane] = b["tracers"]                      # NULL_TRACER never registers
    assert (lane["name"], lane["pid"], lane["live_read"]) == ("unit", 7, True)
    assert [e["ph"] for e in lane["events"]] == ["B", "s", "E"]
    assert lane["recorded"] == 3 and lane["dropped"] == 0
    assert b["sources"]["counts"] == {"x": 1}
    assert "ZeroDivisionError" in b["sources"]["boom"]["error"]
    assert rec.incidents == [path]


def test_recorder_caps_events_to_newest(tmp_path):
    tr = Tracer(capacity=256, name="t")
    c = tr.intern("v")
    for i in range(100):
        tr.counter(c, float(i))
    rec = FlightRecorder(str(tmp_path), tracers=[tr], max_events=10)
    with open(rec.trigger("cap")) as f:
        evs = json.load(f)["tracers"][0]["events"]
    assert [e["value"] for e in evs] == [float(i) for i in range(90, 100)]


def test_recorder_rate_limits_per_reason(tmp_path):
    rec = FlightRecorder(str(tmp_path), min_interval_s=60.0)
    assert rec.trigger("shed") is not None
    assert rec.trigger("shed") is None         # same reason, inside window
    assert rec.suppressed == 1
    other = rec.trigger("allocator-pressure")  # different reason passes
    assert other is not None and "incident-002" in other
    assert len(rec.incidents) == 2


def test_record_breaches_only_on_transition(tmp_path):
    mon = SloMonitor([_ttft_target()])
    h = Histogram()
    _observe(mon, h, n_good=100)
    report = _observe(mon, h, n_bad=100)       # transition into breach
    assert FlightRecorder.is_breach(report)
    rec = FlightRecorder(str(tmp_path))
    paths = rec.record_breaches(report)
    assert len(paths) == 1
    with open(paths[0]) as f:
        b = json.load(f)
    assert b["trigger"]["reason"] == "slo-breach-ttft_p95"
    ctx = b["trigger"]["context"]
    assert ctx["prev_state"] == OK and ctx["burn_short"] >= 2.0
    assert ctx["report"]["state"] == BREACH
    # still breaching, but no transition: no new bundle
    report = _observe(mon, h, n_bad=100)
    assert report.state == BREACH and rec.record_breaches(report) == []


def _fake_engine(free, in_use, drafted=0, accepted=0,
                 preemptions=0, admitted=0):
    alloc = types.SimpleNamespace(stats=lambda: {
        "in_use": in_use, "reserved": 0, "free": free})
    metrics = types.SimpleNamespace(
        spec_draft_tokens=drafted, spec_accepted_tokens=accepted,
        acceptance_rate=accepted / max(1, drafted),
        preemptions=preemptions)
    sched = types.SimpleNamespace(admitted_total=admitted)
    return types.SimpleNamespace(alloc=alloc, metrics=metrics,
                                 scheduler=sched)


def test_check_engine_pressure_triggers(tmp_path):
    rec = FlightRecorder(str(tmp_path))
    assert rec.check_engine(_fake_engine(free=50, in_use=50)) == []
    paths = rec.check_engine(_fake_engine(free=2, in_use=98))
    assert len(paths) == 1 and "allocator-pressure" in paths[0]
    with open(paths[0]) as f:
        assert json.load(f)["trigger"]["context"]["free"] == 2
    paths = rec.check_engine(
        _fake_engine(free=50, in_use=50, drafted=100, accepted=5))
    assert len(paths) == 1 and "spec-acceptance-collapse" in paths[0]
    # below min_drafted: too little evidence to call a collapse
    assert rec.check_engine(
        _fake_engine(free=50, in_use=50, drafted=10, accepted=0)) == []
    # preemption pressure: victims swapped for over half of admissions
    paths = rec.check_engine(
        _fake_engine(free=50, in_use=50, preemptions=6, admitted=8))
    assert len(paths) == 1 and "preemption-pressure" in paths[0]
    with open(paths[0]) as f:
        ctx = json.load(f)["trigger"]["context"]
    assert ctx["preemptions"] == 6 and ctx["admitted_total"] == 8
    # same ratio under the threshold: no bundle
    assert rec.check_engine(
        _fake_engine(free=50, in_use=50, preemptions=2, admitted=8)) == []


# ---------------------------------------------------------------------------
# the reference's outputs on the same feeds
# ---------------------------------------------------------------------------


def _strip(d):
    return json.loads(json.dumps(d))


def test_monitor_reports_equal_the_reference():
    """Random cumulative feeds of every target kind through the port's and
    the reference's monitors: every report is the same."""
    spec = "ttft_p95=0.1,latency_p99=0.5,shed_rate=0.05,mfu_floor=0.2"
    mine, theirs = SloMonitor(parse_slo_spec(spec)), robs.SloMonitor(robs.parse_slo_spec(spec))
    rng = np.random.default_rng(7)
    h = {k: (Histogram(), robs.Histogram()) for k in ("ttft", "latency")}
    shed = offered = 0
    for step in range(12):
        for k, (a, b) in h.items():
            for v in rng.lognormal(-2.5 + 0.2 * (step % 5), 1.0, size=40):
                a.add(float(v))
                b.add(float(v))
        offered += 50
        shed += int(rng.integers(0, 8))
        mfu = float(rng.uniform(0.05, 0.6))
        ra = mine.observe({"ttft": h["ttft"][0], "latency": h["latency"][0],
                           "shed": shed, "offered": offered, "mfu_decode": mfu})
        rb = theirs.observe({"ttft": h["ttft"][1], "latency": h["latency"][1],
                             "shed": shed, "offered": offered, "mfu_decode": mfu})
        assert _strip(ra.as_dict()) == _strip(rb.as_dict())
        assert ra.summary() == rb.summary()


def test_parse_slo_spec_equals_the_reference():
    spec = "ttft_p95=0.25, latency_p99=1.0, shed_rate=0.05, mfu_floor=1e-6"
    for a, b in zip(parse_slo_spec(spec), robs.parse_slo_spec(spec)):
        assert (a.name, a.kind, a.source, a.threshold, a.budget) == \
            (b.name, b.kind, b.source, b.threshold, b.budget)


# ---------------------------------------------------------------------------
# a port engine end to end (CPU)
# ---------------------------------------------------------------------------


def test_engine_snapshot_and_recorder_on_a_port_engine(tmp_path):
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import RequestSpec

    cfg = configs.get_smoke(ARCH)
    eng = Engine(cfg, slots=2, max_seq=32, block_size=4, max_chunk=8, device="cpu",
                 trace=True, max_queue=1)
    eng.warmup()
    rng = np.random.default_rng(0)
    assert eng.submit(RequestSpec(prompt=rng.integers(0, cfg.vocab, size=6),
                                  max_new=3)) is not None
    assert eng.submit(RequestSpec(prompt=rng.integers(0, cfg.vocab, size=6),
                                  max_new=3)) is None          # shed
    eng.run()
    snap = engine_snapshot(eng)
    assert snap["shed"] == 1 and snap["offered"] == 2
    assert snap["ttft"].count == 1 and snap["mfu_decode"] > 0
    report = SloMonitor(parse_slo_spec("ttft_p95=1e-9,shed_rate=0.05")).observe(snap)
    assert report.state == BREACH
    rec = FlightRecorder(str(tmp_path), metadata={"arch": cfg.name})
    rec.attach_engine(eng)
    paths = rec.record_breaches(report)
    assert len(paths) == 2
    with open(paths[0]) as f:
        b = json.load(f)
    assert b["sources"]["engine.allocator"]["total_allocated"] == \
        b["sources"]["engine.allocator"]["total_freed"]
    assert b["sources"]["engine.scheduler"]["rejected"] == 1
    assert b["sources"]["engine.metrics"]["requests"] == 1
    assert [t["name"] for t in b["tracers"]] == [f"engine[{cfg.name}]"]
    assert any(e["name"] == "shed" for e in b["tracers"][0]["events"])


def test_serve_cli_observability_flags(tmp_path):
    """--trace-out / --metrics-json / --slo / --incident-dir on the CPU: a
    valid Chrome trace with one flow chain per request, the metrics with
    per-phase utilization and MFU, a breach bundle."""
    from repro_torch.launch import serve as tserve

    trace, metrics, inc = tmp_path / "t.json", tmp_path / "m.json", tmp_path / "inc"
    gen = tserve.main(["--device", "cpu", "--requests", "3", "--gen-len", "4",
                       "--trace-out", str(trace), "--metrics-json", str(metrics),
                       "--slo", "ttft_p95=1e-9", "--incident-dir", str(inc)])
    assert gen.shape == (3, 4)
    doc = json.loads(trace.read_text())
    flows = {e["id"] for e in doc["traceEvents"] if e.get("cat") == "flow"}
    assert len(flows) == 3
    m = json.loads(metrics.read_text())
    assert m["requests"] == 3
    for phase in ("prefill", "decode"):
        st = m["mfu"]["phases"][phase]
        assert st["utilization"] > 0 and st["mfu"] > 0
    assert m["mfu"]["peak_flops"] == 989e12
    assert [p for p in os.listdir(inc) if "slo-breach-ttft_p95" in p]
