"""Cluster front-end: bounded admission, shed policy, pluggable routing
(port of repro/cluster/router.py).

The router is the cluster's single entry point.  ``submit`` applies
backpressure — a bounded in-flight window; beyond it requests are *shed*
(counted and refused, never silently dropped) — and an async dispatcher
thread moves accepted requests onto replica inboxes under a routing
policy.

Policies are pure functions ``pick(views, prompt, step=, seed=) -> idx``
over plain ``ReplicaView`` snapshots, so they are unit-testable and
deterministic given their inputs:

  * ``round-robin``    — step modulo N; oblivious, perfectly fair.
  * ``least-loaded``   — min (depth, -free KV blocks, idx): queue depth
                         first, then the replica with the most free pool
                         blocks (the KV analogue of picking the bank with
                         the most headroom).
  * ``prefix-affinity``— hash of the prompt's first KV block of tokens
                         picks a home replica, so shared-prefix traffic
                         lands where its prefix is cached (engine-local
                         prefix caches combine with this to act like one
                         cluster-wide cache); falls back to least-loaded
                         when the home replica is overloaded.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import zlib
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

import numpy as np

from repro_torch.cluster.replica import ClusterRequest, ReplicaPool, ReplicaView
from repro_torch.obs import NULL_TRACER
from repro_torch.serving.request import PRIORITIES, as_spec, priority_rank

# Tokens hashed by prefix-affinity: one engine KV block's worth keeps the
# key aligned with what the prefix cache can actually share.
AFFINITY_TOKENS = 16
# Depth gap beyond which affinity yields to least-loaded (hot-prefix storms
# must not wedge one replica while others idle).
AFFINITY_SLACK = 8


def pick_round_robin(views: List[ReplicaView], prompt, *, step: int,
                     seed: int = 0) -> int:
    return step % len(views)


def pick_least_loaded(views: List[ReplicaView], prompt, *, step: int,
                      seed: int = 0) -> int:
    return min(views, key=lambda v: (v.depth, -v.free_blocks, v.idx)).idx


def pick_prefix_affinity(views: List[ReplicaView], prompt, *, step: int,
                         seed: int = 0) -> int:
    key = np.asarray(prompt[:AFFINITY_TOKENS], np.int64).tobytes()
    home = zlib.crc32(key + seed.to_bytes(8, "little")) % len(views)
    fallback = pick_least_loaded(views, prompt, step=step, seed=seed)
    if views[home].depth > views[fallback].depth + AFFINITY_SLACK:
        return fallback
    return home


POLICIES: Dict[str, Callable] = {
    "round-robin": pick_round_robin,
    "least-loaded": pick_least_loaded,
    "prefix-affinity": pick_prefix_affinity,
}


@dataclasses.dataclass
class TenantStats:
    """Per-tenant admission ledger (offered/admitted/shed counters survive
    the run; in-flight is recomputed live from the handle list)."""

    offered: int = 0
    admitted: int = 0
    shed: int = 0


class Router:
    """Admission queue + dispatcher thread over a ReplicaPool.

    Admission is class- and tenant-aware:

      * ``batch_pending_frac`` shrinks the in-flight window for
        non-interactive classes — batch work sheds at
        ``max_pending * frac`` so a batch flood leaves headroom the
        interactive class can still claim (shed reason ``"window"``).
      * ``tenant_share`` caps any single tenant's in-flight share of the
        window at ``ceil(max_pending * share)`` (shed reason ``"tenant"``)
        so one tenant cannot monopolize admission.

    Dispatch is priority-ordered: accepted requests queue per class and
    the dispatcher always forwards the best class first, so interactive
    work reaches replica inboxes ahead of batch work admitted earlier.
    """

    def __init__(self, pool: ReplicaPool, policy="round-robin", *,
                 max_pending: Optional[int] = None, seed: int = 0,
                 batch_pending_frac: float = 1.0,
                 tenant_share: Optional[float] = None,
                 async_dispatch: bool = True, tracer=None, recorder=None):
        if isinstance(policy, str):
            if policy not in POLICIES:
                raise ValueError(
                    f"unknown policy {policy!r}; known: {sorted(POLICIES)}")
            policy = POLICIES[policy]
        self.pool = pool
        self.policy = policy
        self.max_pending = max_pending     # in-flight bound; None = unbounded
        if not 0.0 < batch_pending_frac <= 1.0:
            raise ValueError(
                f"batch_pending_frac must be in (0, 1], got {batch_pending_frac}")
        if tenant_share is not None and not 0.0 < tenant_share <= 1.0:
            raise ValueError(
                f"tenant_share must be in (0, 1], got {tenant_share}")
        self.batch_pending_frac = batch_pending_frac
        self.tenant_share = tenant_share
        self.seed = seed
        # Distributed request tracing: the router lane mints every accepted
        # request's trace id (= crid, cluster-unique) and starts its flow
        # chain; replicas continue the chain under the same id.  The tracer
        # is written from submit() callers *and* the dispatcher thread, so
        # — unlike the single-writer engine rings — every write here stays
        # under self._lock.
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._ev_admit = self.tracer.intern("admit")
        self._ev_route = self.tracer.intern("route")
        self._ev_shed = self.tracer.intern("shed")
        self._ev_flow = self.tracer.intern("req")
        # Anomaly capture (obs/recorder.py): a shed fires a rate-limited
        # incident bundle — the evidence of *why* backpressure hit.
        self.recorder = recorder
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        # Per-class dispatch deques, drained best class first.
        self._queues: Dict[str, Deque[ClusterRequest]] = {
            p: deque() for p in PRIORITIES}
        self._live: List[ClusterRequest] = []
        self.handles: List[ClusterRequest] = []   # every accepted request
        self.offered = 0
        self.shed = 0
        self.shed_by_class: Dict[str, int] = {p: 0 for p in PRIORITIES}
        self.tenants: Dict[str, TenantStats] = {}
        self.dispatched = 0
        self._crid = 0
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        if async_dispatch:
            self._thread = threading.Thread(
                target=self._dispatch_loop, name="router", daemon=True)
            self._thread.start()

    # -- admission -----------------------------------------------------------

    def _in_flight_locked(self) -> int:
        self._live = [h for h in self._live if not h.done.is_set()]
        return len(self._live)

    def _tenant_in_flight_locked(self, tenant: str) -> int:
        # Only meaningful right after _in_flight_locked pruned the list.
        return sum(1 for h in self._live if h.spec.tenant == tenant)

    def _shed_bound_locked(self, priority: str) -> Optional[int]:
        """In-flight window for this class: batch classes see a shrunken
        window so interactive arrivals always find headroom."""
        if self.max_pending is None:
            return None
        if priority_rank(priority) > 0:
            return max(1, int(self.max_pending * self.batch_pending_frac))
        return self.max_pending

    def submit(self, request, max_new: Optional[int] = None, *,
               eos_token: Optional[int] = None) -> Optional[ClusterRequest]:
        """Admit or shed a ``RequestSpec`` (or the legacy ``(prompt,
        max_new)`` form).  Backpressure is an in-flight window: accepted but
        unfinished requests (queued here, queued at a replica, or running)
        count against the class's window; a tenant over its share sheds
        even with window headroom."""
        spec = as_spec(request, max_new, eos_token=eos_token)
        with self._lock:
            self.offered += 1
            stats = self.tenants.setdefault(spec.tenant, TenantStats())
            stats.offered += 1
            in_flight = self._in_flight_locked()
            bound = self._shed_bound_locked(spec.priority)
            reason = None
            if bound is not None and in_flight >= bound:
                reason = "window"
            elif (self.tenant_share is not None
                  and self.max_pending is not None
                  and self._tenant_in_flight_locked(spec.tenant) >= max(
                      1, math.ceil(self.max_pending * self.tenant_share))):
                reason = "tenant"
            if reason is not None:
                self.shed += 1
                self.shed_by_class[spec.priority] += 1
                stats.shed += 1
                self.tracer.instant(self._ev_shed, len(self._live))
                recorder = self.recorder
            else:
                stats.admitted += 1
                h = ClusterRequest(self._crid, spec)
                h.trace_id = h.crid
                self._crid += 1
                self._queues[spec.priority].append(h)
                self._live.append(h)
                self.handles.append(h)
                if self.tracer.enabled:
                    # flows bind to the open slice: chain starts in a tiny
                    # admit slice on the router lane
                    self.tracer.begin(self._ev_admit)
                    self.tracer.flow_start(self._ev_flow, h.trace_id)
                    self.tracer.end(self._ev_admit)
                self._not_empty.notify()
                return h
        # shed path, outside the lock: the recorder snapshots tracers and
        # metric sources, which must not run under the admission lock
        if recorder is not None:
            recorder.trigger("shed", extra={
                "offered": self.offered, "shed": self.shed,
                "max_pending": self.max_pending, "reason": reason,
                "priority": spec.priority, "tenant": spec.tenant})
        return None

    @property
    def shed_rate(self) -> float:
        return self.shed / max(1, self.offered)

    def tenant_stats(self) -> Dict[str, Dict[str, int]]:
        """Per-tenant admission snapshot, live in-flight included."""
        with self._lock:
            self._in_flight_locked()
            return {
                t: {"offered": s.offered, "admitted": s.admitted,
                    "shed": s.shed,
                    "in_flight": self._tenant_in_flight_locked(t)}
                for t, s in sorted(self.tenants.items())}

    # -- dispatch ------------------------------------------------------------

    def _next_locked(self) -> Optional[ClusterRequest]:
        """Pop the head of the best non-empty class queue."""
        for p in PRIORITIES:
            if self._queues[p]:
                return self._queues[p].popleft()
        return None

    def _dispatch_loop(self) -> None:
        while True:
            with self._not_empty:
                while (not any(self._queues.values())) and not self._stop:
                    self._not_empty.wait(0.05)
                h = self._next_locked()
                if h is None:
                    if self._stop:
                        return
                    continue
                step = self.dispatched
                self.dispatched += 1
            # Policy outside the lock: views poll replica state, which may
            # block briefly, and submit() must stay non-blocking.
            idx = self.policy(self.pool.views(), h.prompt,
                              step=step, seed=self.seed)
            self._trace_route(h)
            self.pool.submit_to(idx, h)

    def _trace_route(self, h: ClusterRequest) -> None:
        """Step the request's flow at the routing decision (locked — see
        __init__ on the router tracer's shared-writer discipline)."""
        if self.tracer.enabled:
            with self._lock:
                self.tracer.begin(self._ev_route)
                self.tracer.flow_step(self._ev_flow, h.trace_id)
                self.tracer.end(self._ev_route)

    def dispatch_sync(self) -> None:
        """Drain the admission queue on the caller's thread (the
        deterministic twin of the dispatcher, for run_sync tests)."""
        while True:
            with self._lock:
                h = self._next_locked()
                if h is None:
                    return
                step = self.dispatched
                self.dispatched += 1
            idx = self.policy(self.pool.views(), h.prompt,
                              step=step, seed=self.seed)
            self._trace_route(h)
            self.pool.submit_to(idx, h)

    # -- lifecycle -----------------------------------------------------------

    def drain(self, timeout: float = 120.0) -> None:
        self.pool.drain(list(self.handles), timeout=timeout)

    def close(self) -> None:
        with self._not_empty:
            self._stop = True
            self._not_empty.notify_all()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None
        self.pool.stop()

    def __enter__(self) -> "Router":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
