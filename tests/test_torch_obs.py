"""The port's observability (repro_torch.obs and the engine's side of it)
against the reference's (repro.obs): the copied modules give the
reference's outputs exactly on the same inputs (tracer rings, Chrome-trace
export, histograms, percentiles), and a traced port Engine records the
reference's lifecycle spans, flow chains, instants, counters and metrics
(gemma3-1b smoke, float32, CPU).  The tracing-overhead bar is a card check
(tests/test_torch_gpu.py); the cluster cases wait for the port's cluster."""

import itertools
import json

import numpy as np
import pytest
import torch

from repro import obs as robs
from repro_torch import configs
from repro_torch import obs
from repro_torch.obs import (Histogram, MfuMeter, NULL_TRACER, Tracer,
                             chrome_trace_events, nearest_rank_index,
                             trace_document, write_chrome_trace)
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import RequestSpec

ARCH = "gemma3-1b"


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _engine(**kw):
    return Engine(configs.get_smoke(ARCH), device="cpu", **kw)


def _clock():
    ticks = itertools.count(1000, 250)
    return lambda: next(ticks)


def _script(tr):
    """One event stream of every kind, recorded into `tr`."""
    a, g, r, f, i = (tr.intern(n) for n in ("phase", "gauge", "req", "flow", "mark"))
    tr.begin(a)
    tr.counter(g, 7.5)
    tr.flow_start(f, 3)
    tr.async_begin(r, 42)
    tr.flow_step(f, 3)
    tr.instant(i, 2.0)
    tr.end(a)
    tr.begin(a)
    tr.flow_end(f, 3)
    tr.end(a)
    tr.async_end(r, 42)


# ---------------------------------------------------------------------------
# tracer ring
# ---------------------------------------------------------------------------


def test_tracer_records_and_decodes():
    tr = Tracer(capacity=64, name="t")
    a, g = tr.intern("phase"), tr.intern("gauge")
    assert tr.intern("phase") == a
    tr.begin(a)
    tr.counter(g, 7.5)
    tr.end(a)
    tr.async_begin(tr.intern("req"), 42)
    tr.async_end(tr.intern("req"), 42)
    evs = tr.events()
    assert [e["ph"] for e in evs] == ["B", "C", "E", "b", "e"]
    assert evs[1]["value"] == 7.5 and evs[3]["id"] == 42
    assert evs[0]["ts_ns"] <= evs[-1]["ts_ns"]
    assert tr.dropped == 0 and tr.recorded == 5 and len(tr) == 5
    # the same stream on the same clock decodes as the reference's does
    mine, theirs = Tracer(capacity=64, clock=_clock()), robs.Tracer(capacity=64,
                                                                  clock=_clock())
    _script(mine)
    _script(theirs)
    assert mine.events() == theirs.events()


def test_tracer_ring_wraps_and_counts_dropped():
    tr = Tracer(capacity=8)
    c = tr.intern("x")
    for i in range(20):
        tr.counter(c, float(i))
    assert len(tr) == 8
    assert tr.recorded == 20 and tr.dropped == 12
    assert [e["value"] for e in tr.events()] == [float(i) for i in range(12, 20)]
    tr.clear()
    assert len(tr) == 0 and tr.events() == []


def test_null_tracer_is_inert():
    assert not NULL_TRACER.enabled
    NULL_TRACER.begin(NULL_TRACER.intern("x"))
    NULL_TRACER.counter(0, 1.0)
    with NULL_TRACER.span("y"):
        pass
    assert len(NULL_TRACER) == 0 and NULL_TRACER.events() == []


def test_span_contextmanager_balances_on_exception():
    tr = Tracer(capacity=16)
    with pytest.raises(RuntimeError):
        with tr.span("work"):
            raise RuntimeError("boom")
    assert [e["ph"] for e in tr.events()] == ["B", "E"]


# ---------------------------------------------------------------------------
# histograms
# ---------------------------------------------------------------------------


def test_percentile_helper_is_the_shared_definition():
    assert engine_mod.percentile is obs.percentile
    vals = [5.0, 1.0, 3.0, 2.0, 4.0]
    assert obs.percentile(vals, 50) == 3.0
    assert obs.percentile(vals, 100) == 5.0
    assert obs.percentile(vals, 0) == 1.0
    assert obs.percentile([], 95) == 0.0
    assert obs.percentile(iter(vals), 95) == 5.0
    assert nearest_rank_index(50, 5) == 2
    assert nearest_rank_index(0, 5) == 0
    assert nearest_rank_index(100, 5) == 4
    assert nearest_rank_index(99, 1) == 0
    rng = np.random.default_rng(3)
    for n in (1, 2, 7, 100):
        v = rng.lognormal(size=n).tolist()
        for q in (0, 1, 50, 95, 99, 100):
            assert obs.percentile(v, q) == robs.percentile(v, q)
            assert nearest_rank_index(q, n) == robs.nearest_rank_index(q, n)


def test_histogram_count_above():
    h = Histogram()
    assert h.count_above(1.0) == 0
    for v in (0.5, 0.5, 2.0, 3.0, 100.0):
        h.add(v)
    assert h.count_above(1.0) == 3
    assert h.count_above(0.01) == 5
    assert h.count_above(1e9) == 0
    h2 = Histogram()
    h2.add(0.0)
    h2.add(5.0)
    assert h2.count_above(1.0) == 1


def test_histogram_empty_and_single_value():
    h = Histogram()
    assert h.percentile(50) == 0.0 and h.mean == 0.0
    h.add(3.25)
    assert h.percentile(50) == pytest.approx(3.25)
    assert h.percentile(99) == pytest.approx(3.25)
    assert h.count == 1 and h.mean == pytest.approx(3.25)


def test_histogram_matches_nearest_rank_within_rel_error():
    rng = np.random.default_rng(0)
    vals = np.concatenate([rng.lognormal(-3.0, 1.0, size=400),
                           rng.uniform(1e-4, 1e-1, size=100)])
    h, ref = Histogram(), robs.Histogram()
    for v in vals:
        h.add(float(v))
        ref.add(float(v))
    for q in (5, 25, 50, 90, 95, 99, 100):
        assert h.percentile(q) == pytest.approx(obs.percentile(vals, q), rel=h.rel_error)
        assert h.percentile(q) == ref.percentile(q)      # the reference's, exactly
    assert h.to_dict() == ref.to_dict()
    for t in (1e-3, 0.05, 1.0):
        assert h.count_above(t) == ref.count_above(t)


def test_histogram_merge_equals_single_feed():
    rng = np.random.default_rng(1)
    a_vals, b_vals = rng.lognormal(0, 1, 200), rng.lognormal(0.5, 0.7, 150)
    one = Histogram()
    for v in np.concatenate([a_vals, b_vals]):
        one.add(float(v))
    a, b = Histogram(), Histogram()
    for v in a_vals:
        a.add(float(v))
    for v in b_vals:
        b.add(float(v))
    a.merge(b)
    assert a.count == one.count and a.total == pytest.approx(one.total)
    assert a.counts == one.counts
    for q in (50, 95, 99):
        assert a.percentile(q) == one.percentile(q)


def test_histogram_merge_rejects_mismatched_bucketing():
    with pytest.raises(ValueError, match="bucketing"):
        Histogram().merge(Histogram(growth=2.0))


def test_histogram_dict_roundtrip():
    h = Histogram()
    for v in (0.0, 1e-12, 0.5, 2.0, 2.0, 1e6):
        h.add(v)
    d = json.loads(json.dumps(h.to_dict()))
    h2 = Histogram.from_dict(d)
    assert h2.count == h.count and h2.counts == h.counts
    assert h2.percentile(50) == h.percentile(50)
    assert h2.min == h.min and h2.max == h.max
    # the reference reads the port's dict and vice versa
    r = robs.Histogram.from_dict(d)
    assert r.to_dict() == h.to_dict()
    assert Histogram.from_dict(r.to_dict()).to_dict() == h.to_dict()


# ---------------------------------------------------------------------------
# traced serving run: export validity + instrumentation coverage
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def traced_run():
    cfg = configs.get_smoke(ARCH)
    eng = _engine(slots=2, max_seq=64, block_size=4, max_chunk=8, trace=True,
                  speculative=True)
    eng.warmup()
    rng = np.random.default_rng(0)
    for _ in range(5):
        p = rng.integers(0, cfg.vocab, size=int(rng.integers(4, 12)))
        eng.submit(RequestSpec(prompt=p, max_new=int(rng.integers(2, 8))))
    eng.run()
    return eng


def test_trace_export_is_valid_chrome_trace(traced_run, tmp_path):
    path = tmp_path / "trace.json"
    write_chrome_trace(str(path), [traced_run.tracer],
                       metadata={"arch": traced_run.cfg.name})
    doc = json.loads(path.read_text())
    evs = doc["traceEvents"]
    assert doc["metadata"]["arch"] == traced_run.cfg.name
    assert evs
    stacks = {}
    for e in evs:
        key = (e["pid"], e["tid"])
        if e["ph"] == "B":
            stacks.setdefault(key, []).append(e["name"])
        elif e["ph"] == "E":
            assert stacks[key], f"E without B for {e['name']}"
            assert stacks[key].pop() == e["name"]
    assert all(not s for s in stacks.values()), stacks
    open_spans = {}
    for e in evs:
        if e["ph"] in ("b", "e"):
            assert e["cat"] == "request"
            k = (e["name"], e["id"])
            open_spans[k] = open_spans.get(k, 0) + (1 if e["ph"] == "b" else -1)
            assert open_spans[k] in (0, 1), k
    assert all(v == 0 for v in open_spans.values()), open_spans
    assert min(e["ts"] for e in evs if "ts" in e) >= 0.0
    # The export of one stream on one clock is the reference's, exactly.
    mine, theirs = Tracer(name="x", clock=_clock()), robs.Tracer(name="x", clock=_clock())
    _script(mine)
    _script(theirs)
    assert chrome_trace_events([mine]) == robs.chrome_trace_events([theirs])
    assert trace_document([mine], metadata={"a": 1}) == \
        robs.trace_document([theirs], metadata={"a": 1})


def test_trace_covers_lifecycle_and_phases(traced_run):
    names = {e["name"] for e in chrome_trace_events([traced_run.tracer])}
    assert {"tick", "sched", "prefill", "decode", "warmup"} <= names
    assert {"queued", "req_prefill", "req_decode"} <= names
    assert {"kv_blocks_in_use", "kv_blocks_reserved", "queue_depth"} <= names


def test_trace_document_counts_dropped():
    tr = Tracer(capacity=4)
    c = tr.intern("x")
    for i in range(10):
        tr.counter(c, i)
    assert trace_document([tr])["metadata"]["dropped_events"] == 6


def test_untraced_engine_records_nothing():
    eng = _engine(slots=2, max_seq=32, block_size=4, max_chunk=8)
    eng.warmup()
    eng.submit(RequestSpec(prompt=[1, 2, 3, 4], max_new=3))
    eng.run()
    assert eng.tracer is NULL_TRACER
    assert chrome_trace_events([eng.tracer]) == []


def test_flow_events_connect_each_request(traced_run):
    evs = chrome_trace_events([traced_run.tracer])
    flows = [e for e in evs if e.get("cat") == "flow"]
    assert flows and all(e["name"] == "req" for e in flows)
    want = {(traced_run.tracer.pid << 24) + r.rid for r in traced_run.metrics.requests}
    by_id = {}
    for e in flows:
        by_id.setdefault(e["id"], []).append(e)
    assert set(by_id) == want
    for fid, chain in by_id.items():
        phs = [e["ph"] for e in chain]
        assert phs[0] == "s" and phs[-1] == "f", (fid, phs)
        assert set(phs[1:-1]) <= {"t"}, (fid, phs)
        assert chain[-1]["bp"] == "e"
        ts = [e["ts"] for e in chain]
        assert ts == sorted(ts)


def test_flow_events_bind_to_open_slices(traced_run):
    depth = {}
    for e in chrome_trace_events([traced_run.tracer]):
        key = (e.get("pid"), e.get("tid"))
        if e["ph"] == "B":
            depth[key] = depth.get(key, 0) + 1
        elif e["ph"] == "E":
            depth[key] = depth.get(key, 0) - 1
        elif e["ph"] in ("s", "t", "f"):
            assert depth.get(key, 0) > 0, e


def test_flow_events_gated_by_trace_flow():
    eng = _engine(slots=2, max_seq=32, block_size=4, max_chunk=8, trace=True,
                  trace_flow=False)
    eng.warmup()
    eng.submit(RequestSpec(prompt=[1, 2, 3, 4], max_new=3))
    eng.run()
    evs = chrome_trace_events([eng.tracer])
    assert evs
    assert not [e for e in evs if e["ph"] in ("s", "t", "f", "i")]


def test_shed_and_prefix_hit_instants():
    cfg = configs.get_smoke(ARCH)
    eng = _engine(slots=2, max_seq=32, block_size=4, max_chunk=8, trace=True,
                  prefix_cache=True, max_queue=1)
    eng.warmup()
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab, size=8).astype(np.int32)
    p1 = np.concatenate([prefix, rng.integers(0, cfg.vocab, size=3)]).astype(np.int32)
    p2 = np.concatenate([prefix, rng.integers(0, cfg.vocab, size=4)]).astype(np.int32)
    assert eng.submit(RequestSpec(prompt=p1, max_new=3)) is not None
    assert eng.submit(RequestSpec(prompt=p2, max_new=3)) is None
    eng.run()
    assert eng.submit(RequestSpec(prompt=p2, max_new=3)) is not None
    eng.run()
    inst = [e for e in chrome_trace_events([eng.tracer]) if e["ph"] == "i"]
    assert {"shed", "prefix_hit"} <= {e["name"] for e in inst}
    assert all(e["s"] == "t" for e in inst)
    hit = [e for e in inst if e["name"] == "prefix_hit"]
    assert hit[0]["args"]["value"] >= 4


def test_cache_evict_instant_under_pool_pressure():
    cfg = configs.get_smoke(ARCH)
    eng = _engine(slots=1, max_seq=16, block_size=4, num_blocks=5, max_chunk=4,
                  prefix_cache=True, trace=True)
    eng.warmup()
    rng = np.random.default_rng(1)
    for _ in range(3):
        eng.submit(RequestSpec(prompt=rng.integers(0, cfg.vocab, size=9).astype(np.int32),
                               max_new=3))
        eng.run()
    evict = [e for e in chrome_trace_events([eng.tracer])
             if e["ph"] == "i" and e["name"] == "cache_evict"]
    assert evict and evict[0]["args"]["value"] > 0


# ---------------------------------------------------------------------------
# engine metrics: histogram percentiles, request-log capping
# ---------------------------------------------------------------------------


def test_engine_metrics_percentiles_follow_raw_log_until_dropped():
    from repro.serving.engine import EngineMetrics as REngineMetrics
    from repro.serving.engine import RequestMetrics as RRequestMetrics
    from repro_torch.serving.engine import EngineMetrics, RequestMetrics

    m, r = EngineMetrics(), REngineMetrics()
    for i, t in enumerate([0.010, 0.020, 0.200]):
        kw = dict(rid=i, prompt_len=4, new_tokens=5, ttft_s=t, latency_s=t + 0.1,
                  queue_steps=0)
        m.note_request(RequestMetrics(**kw))
        r.note_request(RRequestMetrics(**kw))
    assert m.ttft_percentile(50) == pytest.approx(0.020)
    assert m.finished_requests == 3 and m.requests_dropped == 0
    m2, r2 = EngineMetrics(), REngineMetrics()
    for i, t in enumerate([0.010, 0.020, 0.200]):
        kw = dict(rid=i, prompt_len=4, new_tokens=5, ttft_s=t, latency_s=t + 0.1,
                  queue_steps=0)
        m2.note_request(RequestMetrics(**kw), 2)
        r2.note_request(RRequestMetrics(**kw), 2)
    assert len(m2.requests) == 2 and m2.requests_dropped == 1
    assert m2.finished_requests == 3
    assert m2.ttft_percentile(50) == pytest.approx(0.020, rel=m2.ttft_hist.rel_error)
    assert "requests=3" in m2.summary()
    for a, b in ((m, r), (m2, r2)):
        for q in (50, 95):
            assert a.ttft_percentile(q) == b.ttft_percentile(q)
            assert a.latency_percentile(q) == b.latency_percentile(q)
            assert a.decode_tok_s_percentile(q) == b.decode_tok_s_percentile(q)
        assert [x.decode_tok_s for x in a.requests] == [x.decode_tok_s for x in b.requests]


def test_engine_as_dict_is_json_serializable(traced_run):
    from repro.serving.engine import EngineMetrics as REngineMetrics

    d = traced_run.metrics.as_dict()
    json.dumps(d)
    assert d["requests"] == traced_run.metrics.finished_requests
    assert d["ttft_hist"]["count"] == d["requests"]
    assert d["mfu"]["phases"]["decode"]["steps"] > 0
    assert set(REngineMetrics().as_dict()) <= set(d)      # the reference's keys


# ---------------------------------------------------------------------------
# MFU / utilization gauges
# ---------------------------------------------------------------------------


def test_mfu_meter_accounting_and_merge():
    cfg = configs.get_smoke(ARCH)
    a = MfuMeter(cfg)
    assert a.peak_flops == 989e12 and a.hbm_bw == 3.35e12     # the H100's peaks
    assert a.utilization("decode") == 0.0 and a.mfu("decode") == 0.0
    a.note("decode", tokens=2, rows=4, time_s=1e-3)
    a.note("decode", tokens=2, rows=4, time_s=1e-3)
    a.note("prefill", tokens=8, rows=8, time_s=2e-3)
    assert list(a.active_phases()) == ["prefill", "decode"]
    st = a.phases["decode"]
    assert st.steps == 2 and st.tokens == 4 and st.rows == 8
    assert st.flops == pytest.approx(4 * a.flops_per_token)
    assert a.utilization("decode") > 0
    assert a.mfu("decode") == pytest.approx(st.flops / (st.time_s * a.peak_flops))
    assert a.step_bound_s(4) == a.step_bound_s(4)
    assert a.step_bound_s(64) >= a.step_bound_s(4)
    # the GeMM term is the tuning model's, never a silent 0
    assert a._gemm_step_s(4) > 0 and a.step_bound_s(4) >= a._gemm_step_s(4)
    # also for a stack without an FFN (xLSTM), where the reference's term
    # reads 0 behind its `except`
    assert MfuMeter(configs.get_smoke("xlstm-1.3b"))._gemm_step_s(4) > 0
    b = MfuMeter(cfg)
    b.note("decode", tokens=1, rows=4, time_s=5e-4)
    merged = MfuMeter.merged([a, b])
    assert merged.phases["decode"].steps == 3
    assert merged.phases["decode"].tokens == 5
    assert merged.phases["prefill"].steps == 1
    assert MfuMeter.merged([]) is None
    frag = a.summary()
    assert "util[decode]=" in frag and "mfu[prefill]=" in frag
    json.dumps(a.as_dict())


def test_engine_mfu_phases_populated(traced_run):
    mfu = traced_run.mfu
    active = set(mfu.active_phases())
    assert {"prefill", "decode"} <= active
    for p in active:
        st = mfu.phases[p]
        assert st.time_s > 0 and st.steps > 0 and st.bound_s > 0
        assert 0 < mfu.utilization(p)
        assert 0 < mfu.mfu(p) < 1
    assert "util[decode]=" in traced_run.metrics.summary()


# ---------------------------------------------------------------------------
# satellite counters: allocator, scheduler, drafter
# ---------------------------------------------------------------------------


def test_allocator_traffic_counters(traced_run):
    alloc = traced_run.alloc
    s = alloc.stats()
    assert s["total_allocated"] == s["total_freed"]
    assert s["in_use"] == 0 and s["reserved"] == 0
    assert 0 < s["peak_in_use"] <= alloc.num_blocks - 1
    assert alloc.reserved == 0 and alloc.free_blocks == s["free"]


def test_scheduler_and_drafter_counters(traced_run):
    sched = traced_run.scheduler
    assert sched.admitted_total == 5
    assert sched.peak_queue_depth >= 1
    d = traced_run.drafter
    assert d.draft_calls > 0
    assert 0 <= d.draft_hits <= d.draft_calls
    assert 0.0 <= d.hit_rate <= 1.0
    if d.draft_hits:
        assert d.drafted_tokens >= d.draft_hits
