"""The port's cluster layer (repro_torch.cluster) against the reference's
(repro.cluster) on the CPU: the routing policies pick the same replica,
the traffic generators draw the same traces and each package loads the
other's saved traces, the router sheds and counts tenants as the
reference's does, a cluster of one gives a bare engine's tokens and the
reference's cluster-of-one tokens (gemma3-1b, jamba, xlstm smoke configs on
the reference's weights), a threaded pool serves every request, `aggregate`
folds replicas as the reference's does, per-replica trace lanes, the
cluster's flow chains, shed incidents and SLO breach end to end, and the
engine-side pieces the threaded pool rests on (`submit(trace_id=)`,
`as_spec`, `share_steps_from`, the per-engine split-K scratch binding, no
capture after `start()`)."""

import json
import threading

import jax
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.cluster import metrics as rmetrics
from repro.cluster import router as rrouter
from repro.cluster import traffic as rtraffic
from repro.cluster.replica import ReplicaPool as RPool
from repro.cluster.replica import ReplicaView as RView
from repro.models import model as RM
from repro.obs import chrome_trace_events as r_events
from repro.serving import engine as rengine
from repro.serving.request import RequestSpec as RSpec
from repro.serving.request import as_spec as r_as_spec
from repro_torch import bridge
from repro_torch import cluster
from repro_torch import configs as tconfigs
from repro_torch.cluster import metrics as tmetrics
from repro_torch.cluster import router as trouter
from repro_torch.cluster import traffic as ttraffic
from repro_torch.cluster.replica import ReplicaPool as TPool
from repro_torch.cluster.replica import ReplicaView as TView
from repro_torch.kernels import gemm as tgemm
from repro_torch.obs import (BREACH, OK, FlightRecorder, SloMonitor, Tracer,
                             parse_slo_spec, percentile)
from repro_torch.obs import chrome_trace_events as t_events
from repro_torch.serving import engine as tengine
from repro_torch.serving.request import RequestSpec as TSpec
from repro_torch.serving.request import as_spec

FAMILY_ARCHS = ["gemma3-1b", "jamba-1.5-large-398b", "xlstm-1.3b"]
KW = dict(slots=2, max_seq=32, block_size=4, max_chunk=4)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _bridged(arch):
    rcfg, tcfg = rconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    rparams = RM.init_model(jax.random.PRNGKey(0), rcfg)
    tparams = bridge.params_from_reference(
        jax.tree_util.tree_map(np.asarray, rparams), tcfg, "cpu")
    return rcfg, rparams, tcfg, tparams


@pytest.fixture(scope="module")
def gemma():
    return _bridged("gemma3-1b")


# -- routing policies ----------------------------------------------------------


@pytest.mark.parametrize("name", sorted(trouter.POLICIES))
def test_policies_pick_as_the_reference(name):
    """Every policy is a pure function of (views, prompt, step, seed) and
    picks the reference's index on the same random load snapshots."""
    assert sorted(trouter.POLICIES) == sorted(rrouter.POLICIES)
    assert (trouter.AFFINITY_TOKENS, trouter.AFFINITY_SLACK) == \
        (rrouter.AFFINITY_TOKENS, rrouter.AFFINITY_SLACK) == (16, 8)
    rng = np.random.default_rng(3)
    tpick, rpick = trouter.POLICIES[name], rrouter.POLICIES[name]
    for trial in range(300):
        n = int(rng.integers(1, 6))
        rows = [dict(idx=i, inbox=int(rng.integers(0, 12)), queued=int(rng.integers(0, 4)),
                     active=int(rng.integers(0, 3)), free_blocks=int(rng.integers(0, 6)))
                for i in range(n)]
        prompt = rng.integers(0, 1000, size=int(rng.integers(1, 40))).astype(np.int32)
        step, seed = int(rng.integers(0, 50)), int(rng.integers(0, 4))
        got = tpick([TView(**r) for r in rows], prompt, step=step, seed=seed)
        assert got == rpick([RView(**r) for r in rows], prompt, step=step, seed=seed), trial
        assert got == tpick([TView(**r) for r in rows], prompt, step=step, seed=seed)


def test_prefix_affinity_sticks_and_yields_to_overload():
    views = [TView(idx=i, inbox=0, queued=0, active=0, free_blocks=100) for i in range(4)]
    p1 = np.arange(24, dtype=np.int32)
    home = trouter.pick_prefix_affinity(views, p1, step=0, seed=0)
    for extra in (0, 5, 11):      # the first 16 tokens decide the home
        q = np.concatenate([p1[:16], np.full(extra, 7, np.int32)])
        assert trouter.pick_prefix_affinity(views, q, step=3, seed=0) == home
    loaded = [TView(idx=i, inbox=trouter.AFFINITY_SLACK + 5 if i == home else 0,
                    queued=0, active=0, free_blocks=100) for i in range(4)]
    assert trouter.pick_prefix_affinity(loaded, p1, step=0, seed=0) != home
    assert [trouter.pick_round_robin(views, None, step=s) for s in range(6)] == \
        [0, 1, 2, 3, 0, 1]


# -- traffic -------------------------------------------------------------------


TRAFFIC_CASES = {
    "generate": lambda t: t.generate(t.TrafficConfig(
        n_requests=40, rate_rps=100.0, vocab=64, mixture=((0.5, 2, 6), (0.5, 10, 20)),
        max_new=(1, 5), seed=3)),
    "mixed": lambda t: t.mixed_traffic(262144, n=16, seed=0, max_prompt=768,
                                       max_new=(16, 48)),
    "mixed_labelled": lambda t: t.mixed_traffic(
        512, n=24, seed=5, rate_rps=50.0, class_mix=(("interactive", 0.7), ("batch", 0.3)),
        tenants=3),
    "shared": lambda t: t.shared_system_prompt(262144, n=16, prefix_len=512,
                                               suffix=(16, 64), max_new=(16, 32)),
}


@pytest.mark.parametrize("case", sorted(TRAFFIC_CASES))
def test_traffic_equals_reference(case):
    got, want = TRAFFIC_CASES[case](ttraffic), TRAFFIC_CASES[case](rtraffic)
    assert len(got) == len(want) > 0
    for a, b in zip(got.items, want.items):
        assert (a.t, a.prompt, a.max_new, a.priority, a.tenant) == \
            (b.t, b.prompt, b.max_new, b.priority, b.tenant)
    assert got.meta == want.meta
    assert (got.prompt_tokens, got.gen_tokens) == (want.prompt_tokens, want.gen_tokens)


def test_trace_files_load_across_packages(tmp_path):
    """A trace saved by either package is the same bytes and loads in the
    other; an unknown version is refused."""
    tr, rr = (m.mixed_traffic(128, n=7, seed=5, rate_rps=50.0, tenants=2)
              for m in (ttraffic, rtraffic))
    tp, rp = tmp_path / "port.json", tmp_path / "ref.json"
    tr.save(str(tp))
    rr.save(str(rp))
    assert tp.read_bytes() == rp.read_bytes()
    assert ttraffic.Trace.load(str(rp)).items == tr.items
    assert [(i.t, i.prompt, i.max_new) for i in rtraffic.Trace.load(str(tp)).items] == \
        [(i.t, i.prompt, i.max_new) for i in tr.items]
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"version": 2, "items": []}))
    with pytest.raises(ValueError, match="version"):
        ttraffic.Trace.load(str(bad))


def test_replay_counts_shed():
    seen = {}
    for mod in (ttraffic, rtraffic):
        tr = mod.mixed_traffic(64, n=6, seed=0)
        calls = []

        def submit(spec):
            calls.append((tuple(int(x) for x in spec.prompt), spec.max_new, spec.tenant))
            return None if len(calls) % 2 == 0 else object()

        handles, shed = mod.replay(tr, submit)
        assert shed == 3 and len(handles) == 3
        seen[mod] = calls
    assert seen[ttraffic] == seen[rtraffic]
    assert [c[0] for c in seen[ttraffic]] == \
        [it.prompt for it in ttraffic.mixed_traffic(64, n=6, seed=0).items]


def test_replay_paces_arrivals():
    tr = ttraffic.mixed_traffic(64, n=5, seed=1, rate_rps=10.0)
    now, naps = [0.0], []

    def sleep(s):
        naps.append(s)
        now[0] += s

    ttraffic.replay(tr, lambda spec: object(), speed=2.0, sleep=sleep, clock=lambda: now[0])
    assert len(naps) == 5
    assert now[0] == pytest.approx(tr.items[-1].t / 2.0)


# -- cluster of one, threaded pool --------------------------------------------


def _prompts(vocab):
    rng = np.random.default_rng(2)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in (6, 3, 5, 4)]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_cluster_of_one_matches_bare_engine_and_reference(arch):
    """A one-replica pool behind a synchronous router gives a bare port
    engine's tokens and the reference's cluster-of-one tokens, on the same
    weights, for the dense, hybrid and recurrent families."""
    rcfg, rparams, tcfg, tparams = _bridged(arch)
    prompts = _prompts(tcfg.vocab)

    bare = tengine.Engine(tcfg, tparams, device="cpu", **KW)
    bare.warmup()
    bare_reqs = [bare.submit(TSpec(prompt=p, max_new=3)) for p in prompts]
    want = bare.run()
    pool = TPool(tcfg, 1, device="cpu", params=tparams, **KW)
    pool.engines[0].share_steps_from(bare)
    pool.warmup()
    router = trouter.Router(pool, policy="round-robin", async_dispatch=False)
    handles = [router.submit(TSpec(prompt=p, max_new=3)) for p in prompts]
    router.dispatch_sync()
    pool.run_sync(max_ticks=10_000)

    rpool = RPool(rcfg, 1, params=rparams, **KW)
    rpool.warmup()
    rrouter_ = rrouter.Router(rpool, policy="round-robin", async_dispatch=False)
    rhandles = [rrouter_.submit(RSpec(prompt=p, max_new=3)) for p in prompts]
    rrouter_.dispatch_sync()
    rpool.run_sync(max_ticks=10_000)

    for br, h, rh in zip(bare_reqs, handles, rhandles):
        np.testing.assert_array_equal(h.result(timeout=0), want[br.rid])
        np.testing.assert_array_equal(h.result(timeout=0), np.asarray(rh.result(timeout=0)))
        assert h.trace_id == h.crid == rh.crid
    assert router.shed == 0
    pool.engines[0].alloc.check()
    m = tmetrics.aggregate(pool, router, elapsed_s=1.0)
    rm = rmetrics.aggregate(rpool, rrouter_, elapsed_s=1.0)
    assert m.requests == rm.requests == len(prompts) and m.shed == 0
    for k in ("decode_tokens", "prefill_tokens", "per_replica_requests", "offered", "tenants"):
        assert getattr(m, k) == getattr(rm, k), k
    assert pool.engines[0].metrics.cold_compiles == 0


def test_threaded_pool_serves_all_requests(gemma):
    """Threaded replicas + the async router: every request resolves with its
    full budget, both replicas serve, the allocators stay clean, and no
    replica captured or compiled a cold shape."""
    _, _, tcfg, tparams = gemma
    pool = TPool(tcfg, 2, device="cpu", params=tparams, **KW)
    pool.warmup()
    assert pool.engines[1].tuner is pool.engines[0].tuner
    pool.start()
    assert all(not e.capture_cold for e in pool.engines)
    router = trouter.Router(pool, policy="least-loaded")
    try:
        trace = ttraffic.mixed_traffic(tcfg.vocab, n=8, seed=0, max_prompt=8,
                                       max_new=(2, 4))
        handles, shed = ttraffic.replay(trace, router.submit)
        assert shed == 0
        router.drain(timeout=120)
        for h, it in zip(handles, trace.items):
            assert len(h.result(timeout=0)) == it.max_new
            assert h.ttft_s is not None and h.ttft_s >= 0
        m = tmetrics.aggregate(pool, router, elapsed_s=1.0)
        assert m.requests == 8 and sum(m.per_replica_requests) == 8
        assert all(n > 0 for n in m.per_replica_requests)
        for e in pool.engines:
            e.alloc.check()
            assert e.metrics.cold_compiles == 0
    finally:
        router.close()
    assert all(e.capture_cold for e in pool.engines)


def test_dead_replica_fails_its_handles_and_drain_raises(gemma):
    _, _, tcfg, tparams = gemma
    pool = TPool(tcfg, 1, device="cpu", params=tparams, **KW)
    pool.warmup()

    def broken():
        raise RuntimeError("step failed")

    pool.engines[0].tick = broken
    pool.start()
    with trouter.Router(pool) as router:
        h = router.submit(TSpec(prompt=np.arange(1, 5), max_new=2))
        with pytest.raises(RuntimeError, match="step failed"):
            router.drain(timeout=30)
        with pytest.raises(RuntimeError, match="step failed"):
            h.result(timeout=5)


# -- router admission -----------------------------------------------------------


ROUTER_CASES = {
    "window": dict(max_pending=5),
    "batch_frac": dict(max_pending=6, batch_pending_frac=0.5),
    "tenant_share": dict(max_pending=8, tenant_share=0.25, batch_pending_frac=0.75),
}


@pytest.fixture(scope="module")
def pools(gemma):
    rcfg, rparams, tcfg, tparams = gemma
    small = dict(slots=1, max_seq=48, block_size=4, max_chunk=4)
    return (RPool(rcfg, 2, params=rparams, **small),
            TPool(tcfg, 2, device="cpu", params=tparams, **small))


@pytest.mark.parametrize("policy", ["least-loaded", "prefix-affinity"])
@pytest.mark.parametrize("case", sorted(ROUTER_CASES))
def test_router_sheds_routes_and_counts_tenants_as_reference(pools, case, policy):
    """The same sequence of submits (a labelled trace: two classes, three
    tenants), replicas not started, so every accepted request stays in
    flight: the same accept / shed decisions, shed counts by class, tenant
    stats, and the same replica for every dispatched request."""
    rpool, tpool = pools
    trace = ttraffic.mixed_traffic(256, n=20, seed=7, max_prompt=24,
                                   class_mix=(("interactive", 0.5), ("batch", 0.5)), tenants=3)
    routers = (rrouter.Router(rpool, policy=policy, async_dispatch=False, seed=1,
                              **ROUTER_CASES[case]),
               trouter.Router(tpool, policy=policy, async_dispatch=False, seed=1,
                              **ROUTER_CASES[case]))
    out = []
    for r, spec_cls in zip(routers, (RSpec, TSpec)):
        accepted = []
        for k, it in enumerate(trace.items):
            h = r.submit(spec_cls(prompt=np.asarray(it.prompt, np.int32), max_new=it.max_new,
                                  priority=it.priority, tenant=it.tenant))
            accepted.append(None if h is None else h.crid)
            if k % 3 == 2:
                r.dispatch_sync()
        r.dispatch_sync()
        out.append((accepted, r.offered, r.shed, dict(r.shed_by_class), r.tenant_stats(),
                    [(h.crid, h.replica, h.trace_id) for h in r.handles], r.shed_rate))
        for rep in r.pool.replicas:          # empty the inboxes for the next case
            while not rep.inbox.empty():
                rep.inbox.get_nowait()
    assert out[1] == out[0]
    assert out[1][2] > 0


def test_router_rejects_unknown_policy_and_bad_knobs(pools):
    _, tpool = pools
    with pytest.raises(ValueError, match="unknown policy"):
        trouter.Router(tpool, policy="fastest-first", async_dispatch=False)
    with pytest.raises(ValueError, match="batch_pending_frac"):
        trouter.Router(tpool, batch_pending_frac=0.0, async_dispatch=False)
    with pytest.raises(ValueError, match="tenant_share"):
        trouter.Router(tpool, tenant_share=1.5, async_dispatch=False)


# -- metrics ---------------------------------------------------------------------


def _fake_pool(mod, per_replica, log_limit=None):
    """A pool of engines holding only metrics: each replica's (ttft,
    new_tokens, decode_tokens) rows, fed through `note_request`."""
    class Pool:
        engines = []

    class E:
        pass

    pool = Pool()
    pool.engines = []
    for rows in per_replica:
        e = E()
        e.metrics = mod.EngineMetrics()
        for i, (ttft, n) in enumerate(rows):
            e.metrics.note_request(mod.RequestMetrics(
                rid=i, prompt_len=2, new_tokens=n, ttft_s=ttft, latency_s=ttft + 0.05 * n,
                queue_steps=0), log_limit)
        e.metrics.decode_tokens = sum(n - 1 for _, n in rows)
        e.metrics.occupancy_sum, e.metrics.occupancy_samples = 0.5 * len(rows), max(1, len(rows))
        pool.engines.append(e)
    return pool


_RNG = np.random.default_rng(7)
_TTFTS = [float(t) for t in _RNG.lognormal(-3.5, 0.8, size=60)]
AGG_CASES = {
    "folds": ([[(0.01, 3), (0.02, 3)], [(0.03, 3)]], None),
    "empty": ([[], [], []], None),
    "raw": ([[(t, 4) for t in _TTFTS[:40]], [(t, 4) for t in _TTFTS[40:]]], None),
    "capped": ([[(t, 4) for t in _TTFTS[:40]], [(t, 4) for t in _TTFTS[40:]]], 1),
}


@pytest.mark.parametrize("case", sorted(AGG_CASES))
def test_aggregate_folds_replicas_as_reference(case):
    """`aggregate` over replicas (some empty, some with a capped request
    log) gives the reference's ClusterMetrics field for field; merged-
    histogram percentiles track the exact nearest-rank ones within the
    histogram's resolution."""
    per_replica, limit = AGG_CASES[case]
    got = tmetrics.aggregate(_fake_pool(tengine, per_replica, limit), elapsed_s=2.0)
    want = rmetrics.aggregate(_fake_pool(rengine, per_replica, limit), elapsed_s=2.0)
    assert got.as_dict() == want.as_dict()
    assert got.summary() == want.summary()
    n = sum(map(len, per_replica))
    assert got.requests == n and got.replicas == len(per_replica)
    assert got.per_replica_requests == [len(r) for r in per_replica]
    assert got.shed_rate == 0.0
    if case == "empty":
        assert got.ttft_p50_s == got.ttft_p95_s == got.req_tok_s_p50 == 0.0
        assert got.throughput_tok_s == 0.0
    if case in ("raw", "capped"):
        rel = got.ttft_hist.rel_error if limit else 1e-9
        for q, v in ((50, got.ttft_p50_s), (95, got.ttft_p95_s)):
            assert v == pytest.approx(percentile(_TTFTS, q), rel=rel), q
    snap = tmetrics.slo_snapshot(got)
    assert set(snap) == set(rmetrics.slo_snapshot(want))


def test_cluster_metrics_shed_rate_zero_offered():
    m = tmetrics.ClusterMetrics()
    assert m.shed_rate == 0.0 and m.prefix_hit_rate == 0.0
    m.shed, m.offered = 5, 10
    assert m.shed_rate == pytest.approx(0.5)


# -- tracing, SLOs, incidents -----------------------------------------------------


def test_replica_pool_trace_multi_pid(gemma, tmp_path):
    _, _, tcfg, tparams = gemma
    pool = TPool(tcfg, 2, device="cpu", params=tparams, slots=2, max_seq=32, block_size=4,
                 max_chunk=8, trace=True)
    pool.warmup()
    rng = np.random.default_rng(0)
    for i in range(4):
        pool.submit_to(i % 2, cluster.ClusterRequest(
            i, TSpec(prompt=rng.integers(0, tcfg.vocab, size=6), max_new=3)))
    pool.run_sync(max_ticks=500)
    path = tmp_path / "cluster_trace.json"
    doc = pool.export_trace(str(path), metadata={"replicas": 2})
    evs = json.loads(path.read_text())["traceEvents"]
    assert {e["pid"] for e in evs} == {0, 1}
    for pid in (0, 1):
        assert any(e["ph"] == "B" and e["name"] == "tick" and e["pid"] == pid for e in evs)
    names = {e["args"]["name"] for e in evs if e["ph"] == "M" and e["name"] == "process_name"}
    assert names == {f"replica0[{tcfg.name}]", f"replica1[{tcfg.name}]"}
    assert doc["metadata"]["replicas"] == 2


def test_replica_pool_without_trace_refuses_export(gemma, tmp_path):
    _, _, tcfg, tparams = gemma
    pool = TPool(tcfg, 1, device="cpu", params=tparams, **KW)
    with pytest.raises(RuntimeError, match="trace=True"):
        pool.export_trace(str(tmp_path / "x.json"))


def test_cluster_trace_slo_and_incidents_end_to_end(gemma, tmp_path):
    """Two traced replicas with the prefix cache and speculation on, a
    traced router with a tight in-flight window: every finished request's
    flow chain starts on the router's lane and finishes on the lane of the
    replica that served it under the router's id; the forced sheds leave
    one instant each, a shed incident with every lane and source, and a
    shed-rate breach of the merged SLO evaluation."""
    _, _, tcfg, tparams = gemma
    pool = TPool(tcfg, 2, device="cpu", params=tparams, slots=2, max_seq=48, block_size=4,
                 max_chunk=8, trace=True, prefix_cache=True, speculative=True)
    pool.warmup()
    router_tracer = Tracer(name="router", pid=len(pool))
    rec = FlightRecorder(str(tmp_path / "incidents"), tracers=[router_tracer],
                         metadata={"arch": tcfg.name})
    for i, e in enumerate(pool.engines):
        rec.attach_engine(e, name=f"replica{i}")
    router = trouter.Router(pool, policy="round-robin", max_pending=3, async_dispatch=False,
                            tracer=router_tracer, recorder=rec)
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, tcfg.vocab, size=8).astype(np.int32)
    handles = []
    for k in range(8):
        tail = rng.integers(0, tcfg.vocab, size=int(rng.integers(2, 6)))
        h = router.submit(TSpec(prompt=np.concatenate([prefix, tail]).astype(np.int32),
                                max_new=4))
        if h is not None:
            handles.append(h)
        router.dispatch_sync()
        if k == 3:
            pool.run_sync(max_ticks=5000)
    router.dispatch_sync()
    pool.run_sync(max_ticks=5000)

    assert router.shed >= 1 and len(handles) == 8 - router.shed
    for h in handles:
        assert len(h.result(timeout=0)) == 4
        assert h.trace_id == h.crid
    doc = pool.export_trace(str(tmp_path / "trace.json"), extra_tracers=[router_tracer])
    evs = doc["traceEvents"]
    assert {e["pid"] for e in evs} >= {0, 1, len(pool)}
    flows = {}
    for e in evs:
        if e.get("cat") == "flow":
            flows.setdefault(e["id"], []).append(e)
    assert set(flows) == {h.trace_id for h in handles}
    finish_pids = set()
    for h in handles:
        chain = sorted(flows[h.trace_id], key=lambda e: e["ts"])
        assert chain[0]["ph"] == "s" and chain[0]["pid"] == len(pool)
        assert chain[1]["ph"] == "t" and chain[1]["pid"] == len(pool)
        assert chain[-1]["ph"] == "f" and chain[-1]["pid"] in (0, 1)
        assert {e["ph"] for e in chain[1:-1]} == {"t"}
        finish_pids.add(chain[-1]["pid"])
    assert finish_pids == {0, 1}
    sheds = [e for e in evs if e["ph"] == "i" and e["name"] == "shed" and e["pid"] == len(pool)]
    assert len(sheds) == router.shed
    assert sum(e.metrics.prefix_hits for e in pool.engines) >= 1

    assert rec.incidents
    with open(rec.incidents[0]) as f:
        b = json.load(f)
    assert b["trigger"]["reason"] == "shed"
    assert b["trigger"]["context"]["max_pending"] == 3
    lanes = {t["name"] for t in b["tracers"]}
    assert "router" in lanes and len(lanes) == 3
    assert "replica0.metrics" in b["sources"] and "replica1.scheduler" in b["sources"]
    assert "in_use" in b["sources"]["replica0.allocator"]

    m = tmetrics.aggregate(pool, router, elapsed_s=1.0)
    report = SloMonitor(parse_slo_spec(
        "ttft_p95=60.0, latency_p95=60.0, shed_rate=0.01, mfu_floor=1e-12")).observe(
        cluster.slo_snapshot(m))
    by = {t.name: t for t in report.targets}
    assert by["ttft_p95"].state == OK and by["mfu_floor"].state == OK
    assert by["shed_rate"].state == BREACH
    paths = rec.record_breaches(report)
    assert len(paths) == 1 and "slo-breach-shed_rate" in paths[0]
    for e in pool.engines:
        e.alloc.check()


def test_serve_cli_replicas_on_cpu(tmp_path, capsys):
    """`--replicas 2` serves through the pool and router with every
    observability flag: sheds, a shed bundle, two replica lanes and the
    router's, and a metrics file with `cluster` and two `replicas`."""
    from repro_torch.launch import serve as tserve

    m = tserve.main(["--device", "cpu", "--replicas", "2", "--router-policy",
                     "prefix-affinity", "--max-pending", "4", "--tenants", "2",
                     "--requests", "16", "--trace-out", str(tmp_path / "t.json"),
                     "--metrics-json", str(tmp_path / "m.json"), "--slo", "shed_rate=0.01",
                     "--incident-dir", str(tmp_path / "inc")])
    text = capsys.readouterr().out
    assert m.replicas == 2 and m.shed > 0 and m.offered == 16
    assert "cluster[prefix-affinity]" in text and "shed_rate=breach" in text
    assert any(p.name.endswith("-shed.json") for p in (tmp_path / "inc").iterdir())
    evs = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    assert {e["pid"] for e in evs} == {0, 1, 2}
    doc = json.loads((tmp_path / "m.json").read_text())
    assert doc["cluster"]["replicas"] == 2 and len(doc["replicas"]) == 2


def test_pool_and_cli_need_a_card_unless_told_cpu(gemma, monkeypatch):
    from repro_torch.launch import serve as tserve

    _, _, tcfg, _ = gemma
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TPool(tcfg, 2, slots=2, max_seq=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--replicas", "2", "--requests", "2"])


# -- the engine under the pool ---------------------------------------------------


def test_as_spec_matches_reference():
    p = np.arange(1, 6, dtype=np.int32)
    for mod_as_spec, cls in ((as_spec, TSpec), (r_as_spec, RSpec)):
        with pytest.warns(DeprecationWarning):
            s = mod_as_spec(p, 3, eos_token=2, trace_id=9)
        assert (s.max_new, s.eos_token, s.trace_id) == (3, 2, 9)
        assert s.prompt.tolist() == [1, 2, 3, 4, 5]
        spec = cls(prompt=p, max_new=4)
        assert mod_as_spec(spec) is spec
        assert mod_as_spec(spec, trace_id=7).trace_id == 7
        assert mod_as_spec(cls(prompt=p, max_new=4, trace_id=1), trace_id=7).trace_id == 1
        with pytest.raises(TypeError):
            mod_as_spec(spec, 5)
        with pytest.raises(TypeError):
            mod_as_spec(spec, eos_token=3)
        with pytest.raises(TypeError):
            mod_as_spec(p)
        with pytest.warns(DeprecationWarning):
            assert mod_as_spec(p, 2).max_new == 2


def test_submit_trace_id_matches_reference(gemma):
    """An outside-minted trace id (the router's) continues the request's
    flow chain (a step, not a start) and names its lifecycle spans; the
    legacy form and an engine-minted id as the reference's."""
    rcfg, rparams, tcfg, tparams = gemma
    kw = dict(KW, max_chunk=8)
    reng = rengine.Engine(rcfg, rparams, trace=True, **kw)
    teng = tengine.Engine(tcfg, tparams, device="cpu", trace=True, **kw)
    for eng, cls in ((reng, RSpec), (teng, TSpec)):
        eng.warmup()
        a = eng.submit(cls(prompt=np.arange(1, 7), max_new=3), trace_id=1000)
        b = eng.submit(cls(prompt=np.arange(2, 9), max_new=2, trace_id=2000))
        with pytest.warns(DeprecationWarning):
            c = eng.submit(np.arange(3, 8), 2)
        assert (a.trace_id, b.trace_id, c.trace_id) == (1000, 2000, (eng.tracer.pid << 24) + 2)
        eng.run()
    np.testing.assert_array_equal(teng.results[0], np.asarray(reng.results[0]))

    def chains(evs):
        out = {}
        for e in evs:
            if e.get("cat") == "flow":
                out.setdefault(e["id"], []).append(e["ph"])
        return out

    tch, rch = chains(t_events([teng.tracer])), chains(r_events([reng.tracer]))
    assert tch == rch
    assert tch[1000][0] == "t" and tch[(teng.tracer.pid << 24) + 2][0] == "s"
    spans = {(e["name"], e["ph"], e["id"]) for e in t_events([teng.tracer]) if e["ph"] in "be"}
    assert ("queued", "b", 1000) in spans and ("req_decode", "e", 2000) in spans


def test_share_steps_from_shares_plans_not_graphs(gemma, tmp_path, monkeypatch):
    _, _, tcfg, tparams = gemma
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tc.json"))
    src = tengine.Engine(tcfg, tparams, device="cpu", autotune=True, **KW)
    late = tengine.Engine(tcfg, tparams, device="cpu", autotune=True, **KW)
    with pytest.raises(RuntimeError, match="warm up"):
        late.share_steps_from(src)        # src not warm yet
    src.warmup()
    for eng in (late, tengine.Engine(tcfg, tparams, device="cpu", **KW)):
        eng.share_steps_from(src)
        assert eng.tuner is src.tuner and eng.decode_spec == src.decode_spec
        assert eng.tune_results is src.tune_results and not eng.autotune
        assert eng.splitk is not src.splitk
    for kw in (dict(slots=3), dict(precision="w8a8"), dict(max_seq=40),
               dict(kv_precision="int8")):
        with pytest.raises(ValueError, match="share_steps_from"):
            tengine.Engine(tcfg, tparams, device="cpu", **dict(KW, **kw)).share_steps_from(src)


def test_engine_binds_its_own_splitk_scratch_per_thread(gemma):
    """Inside an engine's step context its own split-K scratch is what the
    GeMMs take, on that thread only; elsewhere the device's.  (The scratch
    tensors are allocated on the card; a CPU stand-in is planted here.)"""
    _, _, tcfg, tparams = gemma
    engines = [tengine.Engine(tcfg, tparams, device="cpu", **KW) for _ in range(2)]
    dev = torch.device("cpu")
    for i, e in enumerate(engines):
        e.splitk._by_device[dev] = (torch.full((4,), float(i)), torch.zeros(2, dtype=torch.int32))
    default = tgemm._DEVICE_SCRATCH
    default._by_device[dev] = (torch.full((4,), -1.0), torch.zeros(2, dtype=torch.int32))
    seen, gate = {}, threading.Barrier(2, timeout=30)

    def work(i):
        with engines[i]._step_ctx():
            gate.wait()                   # both threads inside at once
            seen[i] = float(tgemm.splitk_scratch(dev)[0][0])
            gate.wait()

    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
        assert seen == {0: 0.0, 1: 1.0}
        assert float(tgemm.splitk_scratch(dev)[0][0]) == -1.0
    finally:
        del default._by_device[dev]


def test_cold_shape_in_a_started_pool_is_not_captured(gemma):
    """`start()` turns capture of uncovered shapes off (a capture would stall
    the other replicas); `stop()` turns it back on.  On the CPU nothing is
    captured either way: the flag is what the card's engine reads."""
    _, _, tcfg, tparams = gemma
    pool = TPool(tcfg, 2, device="cpu", params=tparams, **KW)
    assert all(e.capture_cold for e in pool.engines)
    pool.start()
    try:
        assert all(not e.capture_cold for e in pool.engines)
    finally:
        pool.stop()
    assert all(e.capture_cold for e in pool.engines)
    assert all(r._thread is None for r in pool.replicas)
