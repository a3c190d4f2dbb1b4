"""Cluster-wide metric aggregation (port of repro/cluster/metrics.py).

One struct answering the system-level questions a single ``EngineMetrics``
cannot: tail TTFT across every replica *including router queue wait*,
per-replica occupancy (is the load balancer actually balancing?), prefix
cache effectiveness, and the shed rate the backpressure policy produced.
Percentiles reuse ``repro_torch.obs.percentile`` (the shared nearest-rank
helper) so per-engine and cluster-wide tails are computed with one
definition; ``slo_snapshot`` feeds the merged result into the SLO monitor
(obs/slo.py).

Aggregation is histogram-native (repro_torch.obs.hist): each engine's
streaming TTFT/rate sketches merge in O(replicas x buckets), so cluster
tails stay cheap and exact-enough (within Histogram.rel_error) even when
engines run with a capped request log.  While every engine's raw log is complete, the
engine-TTFT percentiles are computed exactly from the concatenated lists —
merged-histogram and raw-list answers agree to within the bucket width
(tests/test_torch_cluster.py pins this).  Per-phase utilization/MFU
meters fold the same way (repro_torch.obs.mfu.MfuMeter.merged).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.obs import Histogram, MfuMeter, percentile


@dataclasses.dataclass
class ClusterMetrics:
    replicas: int = 0
    requests: int = 0             # finished
    offered: int = 0              # submitted to the router (incl. shed)
    shed: int = 0
    shed_by_class: Dict[str, int] = dataclasses.field(default_factory=dict)
    preemptions: int = 0          # KV swap-outs across all engines
    swap_time_s: float = 0.0      # host<->device KV swap wall time
    tenants: Dict[str, dict] = dataclasses.field(default_factory=dict)
    elapsed_s: float = 0.0        # caller-timed serving window
    decode_tokens: int = 0
    prefill_tokens: int = 0
    ttft_mean_s: float = 0.0      # router wait + engine TTFT
    ttft_p50_s: float = 0.0
    ttft_p95_s: float = 0.0
    req_tok_s_p50: float = 0.0    # per-request decode rate percentiles
    req_tok_s_p95: float = 0.0
    per_replica_requests: List[int] = dataclasses.field(default_factory=list)
    per_replica_occupancy: List[float] = dataclasses.field(default_factory=list)
    prefix_lookups: int = 0
    prefix_hits: int = 0
    prefix_hit_tokens: int = 0
    # Merged streaming sketches across all engines (engine-side TTFT — the
    # handles-based ttft_* fields above additionally include router wait)
    # and the pool-wide per-phase utilization meter.  None until aggregate()
    # fills them.
    ttft_hist: Optional[Histogram] = None
    latency_hist: Optional[Histogram] = None
    tok_s_hist: Optional[Histogram] = None
    mfu: Optional[MfuMeter] = None

    @property
    def shed_rate(self) -> float:
        return self.shed / max(1, self.offered)

    @property
    def prefix_hit_rate(self) -> float:
        return self.prefix_hits / max(1, self.prefix_lookups)

    @property
    def throughput_tok_s(self) -> float:
        """Generated tokens over the serving window — the system number a
        capacity plan cares about (per-engine decode-tick throughput lives
        in each EngineMetrics)."""
        return self.decode_tokens / self.elapsed_s if self.elapsed_s else 0.0

    def summary(self) -> str:
        occ = "/".join(f"{o:.0%}" for o in self.per_replica_occupancy)
        out = (
            f"replicas={self.replicas} requests={self.requests}"
            f"/{self.offered} shed={self.shed} ({self.shed_rate:.0%}) "
            f"decode={self.decode_tokens} tok "
            f"({self.throughput_tok_s:.1f} tok/s over {self.elapsed_s:.2f}s) "
            f"ttft p50={self.ttft_p50_s * 1e3:.0f}ms "
            f"p95={self.ttft_p95_s * 1e3:.0f}ms "
            f"req_tok_s p50={self.req_tok_s_p50:.1f} "
            f"p95={self.req_tok_s_p95:.1f} "
            f"occupancy=[{occ}] "
            f"balance={self.per_replica_requests}"
        )
        if self.prefix_lookups:
            out += (f" prefix_hit_rate={self.prefix_hit_rate:.0%} "
                    f"({self.prefix_hit_tokens} tok reused)")
        if self.preemptions:
            out += (f" preemptions={self.preemptions} "
                    f"(swap {self.swap_time_s * 1e3:.0f}ms)")
        if self.tenants:
            frag = " ".join(
                f"{t}:{s['admitted']}/{s['offered']}"
                for t, s in sorted(self.tenants.items()))
            out += f" tenants=[{frag}]"
        if self.mfu is not None:
            frag = self.mfu.summary()
            if frag:
                out += " " + frag
        return out

    def as_dict(self) -> dict:
        """JSON-serializable snapshot (launch/serve.py --metrics-json)."""
        return {
            "replicas": self.replicas,
            "requests": self.requests,
            "offered": self.offered,
            "shed": self.shed,
            "shed_rate": self.shed_rate,
            "shed_by_class": dict(self.shed_by_class),
            "preemptions": self.preemptions,
            "swap_time_s": self.swap_time_s,
            "tenants": {t: dict(s) for t, s in self.tenants.items()},
            "elapsed_s": self.elapsed_s,
            "decode_tokens": self.decode_tokens,
            "prefill_tokens": self.prefill_tokens,
            "throughput_tok_s": self.throughput_tok_s,
            "ttft_mean_s": self.ttft_mean_s,
            "ttft_p50_s": self.ttft_p50_s,
            "ttft_p95_s": self.ttft_p95_s,
            "req_tok_s_p50": self.req_tok_s_p50,
            "req_tok_s_p95": self.req_tok_s_p95,
            "per_replica_requests": list(self.per_replica_requests),
            "per_replica_occupancy": list(self.per_replica_occupancy),
            "prefix_lookups": self.prefix_lookups,
            "prefix_hits": self.prefix_hits,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "ttft_hist": (self.ttft_hist.to_dict()
                          if self.ttft_hist is not None else None),
            "latency_hist": (self.latency_hist.to_dict()
                             if self.latency_hist is not None else None),
            "tok_s_hist": (self.tok_s_hist.to_dict()
                           if self.tok_s_hist is not None else None),
            "mfu": self.mfu.as_dict() if self.mfu is not None else None,
        }


def aggregate(pool, router=None, *, elapsed_s: float = 0.0,
              handles: Optional[list] = None) -> ClusterMetrics:
    """Fold a pool (and optionally its router / resolved handles) into one
    ClusterMetrics.  With handles, TTFT includes router + inbox wait; without
    (e.g. driving engines directly), engine-side TTFT is used."""
    engines = pool.engines
    m = ClusterMetrics(replicas=len(engines), elapsed_s=elapsed_s)
    per_req, dropped = [], 0
    m.ttft_hist, m.tok_s_hist = Histogram(), Histogram()
    m.latency_hist = Histogram()
    for e in engines:
        m.decode_tokens += e.metrics.decode_tokens
        m.prefill_tokens += e.metrics.prefill_tokens
        m.prefix_lookups += e.metrics.prefix_lookups
        m.prefix_hits += e.metrics.prefix_hits
        m.prefix_hit_tokens += e.metrics.prefix_hit_tokens
        m.per_replica_requests.append(e.metrics.finished_requests)
        m.per_replica_occupancy.append(e.metrics.mean_occupancy)
        m.preemptions += e.metrics.preemptions
        m.swap_time_s += e.metrics.swap_time_s
        per_req.extend(e.metrics.requests)
        dropped += e.metrics.requests_dropped
        m.ttft_hist.merge(e.metrics.ttft_hist)
        m.latency_hist.merge(e.metrics.latency_hist)
        m.tok_s_hist.merge(e.metrics.tok_s_hist)
    m.mfu = MfuMeter.merged([e.metrics.mfu for e in engines])
    m.requests = len(per_req) + dropped
    # Every request's first token leaves a prefill chunk, so fold those
    # tokens into the generated total alongside decode-step tokens.
    m.decode_tokens += m.requests
    if handles is None and router is not None:
        handles = [h for h in router.handles if h.done.is_set()]
    if handles:
        # Handle timestamps include router/inbox wait — finer than the
        # engine-side sketches, so prefer them when available.
        ttfts = [h.ttft_s for h in handles if h.ttft_s is not None]
        m.ttft_mean_s = sum(ttfts) / len(ttfts) if ttfts else 0.0
        m.ttft_p50_s = percentile(ttfts, 50)
        m.ttft_p95_s = percentile(ttfts, 95)
    elif not dropped:
        # Complete raw logs: exact concatenated-list percentiles.
        ttfts = [r.ttft_s for r in per_req]
        m.ttft_mean_s = sum(ttfts) / len(ttfts) if ttfts else 0.0
        m.ttft_p50_s = percentile(ttfts, 50)
        m.ttft_p95_s = percentile(ttfts, 95)
    else:
        # Capped logs dropped entries: the merged histograms are the source
        # of truth (same nearest-rank semantics, bounded state).
        m.ttft_mean_s = m.ttft_hist.mean
        m.ttft_p50_s = m.ttft_hist.percentile(50)
        m.ttft_p95_s = m.ttft_hist.percentile(95)
    if per_req and not dropped:
        rates = [r.decode_tok_s for r in per_req]
        m.req_tok_s_p50 = percentile(rates, 50)
        m.req_tok_s_p95 = percentile(rates, 95)
    else:
        m.req_tok_s_p50 = m.tok_s_hist.percentile(50)
        m.req_tok_s_p95 = m.tok_s_hist.percentile(95)
    # A request can be shed at the router (in-flight bound) or by an
    # engine-side admission-queue bound after routing; both are refusals.
    engine_shed = sum(1 for h in (handles or []) if h.shed)
    if router is not None:
        m.offered = router.offered
        m.shed = router.shed + engine_shed
        m.shed_by_class = dict(router.shed_by_class)
        m.tenants = router.tenant_stats()
    else:
        m.offered = m.requests + engine_shed
        m.shed = engine_shed
    return m


def slo_snapshot(m: ClusterMetrics) -> dict:
    """ClusterMetrics -> the snapshot dict obs/slo.py::SloMonitor.observe()
    evaluates (same keys as obs.engine_snapshot, so one SLO spec serves
    both the single-engine and cluster paths).  The merged histograms make
    cluster-wide burn equal to the burn of the concatenated per-replica
    request streams."""
    return {
        "ttft": m.ttft_hist,
        "latency": m.latency_hist,
        "tok_s": m.tok_s_hist,
        "shed": m.shed,
        "offered": m.offered,
        "mfu_decode": m.mfu.mfu("decode") if m.mfu is not None else 0.0,
    }
