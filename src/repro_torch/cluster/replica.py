"""Replica pool: N serving engines, thread-per-replica, device-pinned (port
of repro/cluster/replica.py).

One `Engine` keeps one card busy through its replayed step graphs; the
pool is the system layer above it: N engines, each driven by its own
thread through the engine's `tick()` loop and fed by a router
(cluster/router.py).  With more than one CUDA card, replicas pin
round-robin to `cuda:i` and each gets the weights moved to its card; with
one, every replica shares it, as the reference's replicas share one
device, and the gain comes from overlap: each engine runs on its own
stream, replays release the interpreter lock, and one replica's host
scheduling runs while another's step computes.

What threaded replicas on one card need from the engine (serving/engine.py)
the engine owns: its stream, its split-K scratch (so two graphs replaying
at once never share a workspace or a tile counter) and its tuner binding
(thread-local).  `start()` also switches every engine to run a step shape
that warmup did not cover eagerly, without capturing it, since a capture
stalls the card for every other replica; `warmup()` stays serial, so only
one capture runs at a time.

Engines are single-thread-confined: only the owning replica thread calls
`submit` / `tick` on its engine.  The router hands work over through a
thread-safe inbox; results come back through `ClusterRequest` handles
(future-like: `result()` blocks, `done` is an Event).

Construction cost is shared where correctness allows: the weights are made
once and handed to every engine (the same tensors on one card, a copy per
card otherwise), and replicas of one config serve under replica 0's launch
plans (`Engine.share_steps_from`), so the pool tunes once; each engine
captures its own graphs, which read its own buffers.
"""

from __future__ import annotations

import dataclasses
import queue as queue_lib
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.obs import Tracer, write_chrome_trace
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import RequestSpec, as_spec


class ClusterRequest:
    """Handle for one routed request; resolves when its engine finishes.

    Carries the full `RequestSpec`, so eos_token, sampling, priority class
    and tenant survive the router -> replica hop; `prompt` / `max_new` are
    read-through properties for the policies and metrics."""

    __slots__ = ("crid", "spec", "replica", "tokens", "shed",
                 "error", "done", "t_submit", "t_engine_submit", "t_done",
                 "engine_metrics", "trace_id")

    def __init__(self, crid: int, request, max_new: Optional[int] = None):
        self.crid = crid
        self.spec: RequestSpec = as_spec(request, max_new)
        self.trace_id = -1                   # minted at router admission
        self.replica: Optional[int] = None
        self.tokens: Optional[np.ndarray] = None
        self.shed = False
        self.error: Optional[BaseException] = None
        self.done = threading.Event()
        self.t_submit = time.monotonic()
        self.t_engine_submit: Optional[float] = None
        self.t_done: Optional[float] = None
        self.engine_metrics = None           # serving.engine.RequestMetrics

    @property
    def prompt(self) -> np.ndarray:
        return self.spec.prompt

    @property
    def max_new(self) -> int:
        return self.spec.max_new

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self.done.wait(timeout):
            raise TimeoutError(f"request {self.crid} still in flight")
        if self.error is not None:
            raise self.error
        if self.shed:
            raise RuntimeError(f"request {self.crid} was shed")
        return self.tokens

    @property
    def ttft_s(self) -> Optional[float]:
        """Cluster TTFT: router / inbox wait plus the engine-side TTFT."""
        if self.engine_metrics is None or self.t_engine_submit is None:
            return None
        return (self.t_engine_submit - self.t_submit
                + self.engine_metrics.ttft_s)


@dataclasses.dataclass(frozen=True)
class ReplicaView:
    """Load snapshot a routing policy sees: plain data, so policies stay
    pure functions of their inputs (testable without a live pool)."""

    idx: int
    inbox: int           # routed but not yet engine-submitted
    queued: int          # in the engine's admission queue
    active: int          # occupying a slot (prefill or decode)
    free_blocks: int     # KV pool blocks not allocated

    @property
    def depth(self) -> int:
        return self.inbox + self.queued + self.active


def _to_device(tree, device: torch.device):
    """A weight tree (dicts, lists, tuples of tensors) on `device`."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        moved = [_to_device(v, device) for v in tree]
        return type(tree)(*moved) if hasattr(tree, "_fields") else type(tree)(moved)
    if tree is None:
        return None
    raise TypeError(f"cannot move a {type(tree).__name__} of the weights to {device}")


class Replica:
    """One engine, the thread that drives it, and its inbox."""

    def __init__(self, idx: int, cfg, *, device, params=None, **engine_kwargs):
        self.idx = idx
        self.device = torch.device(device)
        if params is not None and params["embed"].device != self.device:
            params = _to_device(params, self.device)
        self.engine = Engine(cfg, params, device=self.device, **engine_kwargs)
        self.inbox: "queue_lib.Queue[ClusterRequest]" = queue_lib.Queue()
        self._pending: Dict[int, ClusterRequest] = {}   # engine rid -> handle
        self._metrics_seen = 0
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None

    def warmup(self) -> None:
        self.engine.warmup()

    # -- router-facing -------------------------------------------------------

    def submit(self, handle: ClusterRequest) -> None:
        handle.replica = self.idx
        if self.error is not None:          # dead replica: fail fast, don't
            handle.error = self.error       # park work in an undrained inbox
            handle.done.set()
            return
        self.inbox.put(handle)
        self._wake.set()

    def view(self) -> ReplicaView:
        eng = self.engine
        return ReplicaView(
            idx=self.idx,
            inbox=self.inbox.qsize(),
            queued=sum(len(q) for q in eng.scheduler.queues.values()),
            active=sum(r is not None for r in eng.scheduler.slots),
            free_blocks=eng.alloc.free_blocks,
        )

    # -- the drive loop ------------------------------------------------------

    def _drain_inbox(self) -> None:
        while True:
            try:
                h = self.inbox.get_nowait()
            except queue_lib.Empty:
                return
            try:
                h.t_engine_submit = time.monotonic()
                # The router-minted trace id continues the request's flow
                # chain from the router lane into this replica's lane.
                req = self.engine.submit(
                    h.spec, trace_id=(h.trace_id if h.trace_id >= 0 else None))
            except ValueError as e:         # a prompt the engine cannot hold:
                h.error = e                 # fail the handle, not the thread
                h.done.set()
                continue
            if req is None:                 # engine-side queue bound hit
                h.shed = True
                h.done.set()
            else:
                self._pending[req.rid] = h

    def _resolve(self) -> None:
        if not self._pending:
            return
        em = self.engine.metrics
        # _metrics_seen counts finished requests ever observed; with a capped
        # request log (Engine(request_log=N)) the raw list's head is trimmed,
        # so the unseen suffix starts at seen - dropped.
        by_rid = {m.rid: m for m in em.requests[self._metrics_seen - em.requests_dropped:]}
        self._metrics_seen = em.finished_requests
        for rid, m in by_rid.items():
            h = self._pending.pop(rid, None)
            if h is None:
                continue
            h.engine_metrics = m
            h.tokens = self.engine.results[rid]
            h.t_done = time.monotonic()
            h.done.set()

    def step(self) -> bool:
        """One synchronous pump: drain the inbox, tick once, resolve
        finishes.  Returns True while the engine still has work."""
        self._drain_inbox()
        busy = False
        if self.engine.scheduler.has_work:
            busy = self.engine.tick()
            self._resolve()
        return busy or not self.inbox.empty()

    def _run(self) -> None:
        # The thread does the engine's work alone, so it runs on the
        # engine's stream: its steps then wait on no other stream.
        try:
            with torch.cuda.stream(self.engine.stream):
                self._serve()
        except Exception as e:              # the thread's boundary: record it,
            self.error = e                  # fail every waiter; drain re-raises
            self._fail_outstanding(e)

    def _serve(self) -> None:
        while not self._stop.is_set():
            if not self.step():
                # idle: sleep until the router wakes us (bounded, so a
                # lost wakeup costs one nap at most)
                self._wake.wait(0.005)
                self._wake.clear()

    def _fail_outstanding(self, e: BaseException) -> None:
        """Resolve every handle this replica owns, in flight and still in the
        inbox, with the error, so no waiter hangs on a dead replica."""
        for h in self._pending.values():
            h.error = e
            h.done.set()
        self._pending.clear()
        while True:
            try:
                h = self.inbox.get_nowait()
            except queue_lib.Empty:
                return
            h.error = e
            h.done.set()

    def start(self) -> None:
        if self._thread is not None:
            return
        self.engine.capture_cold = False    # no capture beside running replicas
        if self.engine.stream is not None:  # after what the caller queued
            self.engine.stream.wait_stream(torch.cuda.current_stream(self.device))
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name=f"replica-{self.idx}", daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise RuntimeError(f"replica {self.idx} did not stop within {timeout}s")
            self._thread = None
        self.engine.capture_cold = True


class ReplicaPool:
    """N replicas over one config: build, warm, start, submit, drain.

    `device`: where the engines run (CUDA unless the caller names the CPU;
    raises without a card).  With more than one card replica i runs on
    `cuda:(i mod torch.cuda.device_count())`, else every replica runs on
    `device`.  `params` (made from `seed` on the first replica's device when
    None) go to every engine: the same tensors where the devices agree."""

    def __init__(self, cfg, n: int, *, device=None, seed: int = 0,
                 trace: bool = False, **engine_kwargs):
        if n < 1:
            raise ValueError(f"need at least one replica, got {n}")
        self.cfg = cfg
        device = resolve_device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        # Pool-level tracing: one Tracer per replica (pid = i), each written
        # by its replica thread alone; the export shows one process lane
        # per replica on a shared clock.
        self.tracers: List[Tracer] = []
        if trace:
            self.tracers = [Tracer(name=f"replica{i}[{cfg.name}]", pid=i)
                            for i in range(n)]
        count = torch.cuda.device_count() if device.type == "cuda" else 1
        devices = ([torch.device(f"cuda:{i % count}") for i in range(n)]
                   if count > 1 else [device] * n)
        from repro_torch.models import model as M

        params = engine_kwargs.pop("params", None)
        if params is None:
            params = M.init_model(cfg, seed=seed, device=devices[0])
        self.replicas: List[Replica] = []
        for i in range(n):
            kw = dict(engine_kwargs)
            if self.tracers:
                kw["trace"] = self.tracers[i]
            self.replicas.append(Replica(
                i, cfg, device=devices[i], params=params, seed=seed, **kw))

    def __len__(self) -> int:
        return len(self.replicas)

    @property
    def engines(self) -> List[Engine]:
        return [r.engine for r in self.replicas]

    def warmup(self, verbose: bool = False) -> None:
        # Serial on purpose: one capture at a time, and replica 0 tunes the
        # plans every other replica then takes (same config: the graphs
        # stay per engine).
        for r in self.replicas:
            t0 = time.monotonic()
            if r.idx:
                r.engine.share_steps_from(self.replicas[0].engine)
            r.warmup()
            if verbose:
                print(f"replica[{r.idx}] warm in "
                      f"{(time.monotonic() - t0) * 1e3:.0f}ms")

    def start(self) -> None:
        for r in self.replicas:
            r.start()

    def stop(self) -> None:
        for r in self.replicas:
            r.stop()

    def export_trace(self, path: str, *, metadata: Optional[dict] = None,
                     extra_tracers=()) -> dict:
        """Write the pool's Chrome-trace JSON (needs trace=True): one process
        lane per replica.  `extra_tracers` adds lanes on the same clock
        (launch/serve.py appends the router's, so admission flows connect to
        the replica lanes).  Call after stop() / run_sync(): the rings are
        single-writer and read here from the caller's thread."""
        if not self.tracers:
            raise RuntimeError(
                "pool was built without tracing; pass ReplicaPool(trace=True)")
        return write_chrome_trace(path, self.tracers + list(extra_tracers),
                                  metadata=metadata)

    def submit_to(self, idx: int, handle: ClusterRequest) -> None:
        self.replicas[idx].submit(handle)

    def views(self) -> List[ReplicaView]:
        return [r.view() for r in self.replicas]

    def run_sync(self, max_ticks: Optional[int] = None) -> None:
        """Threadless drive: one tick per replica in turn until every inbox
        and engine drains.  The deterministic twin of start() / drain()."""
        ticks = 0
        while True:
            busy = False
            for r in self.replicas:
                busy = r.step() or busy
            ticks += 1
            if not busy:
                return
            if max_ticks is not None and ticks >= max_ticks:
                raise TimeoutError(f"pool still busy after {max_ticks} ticks")

    def drain(self, handles, timeout: float = 120.0) -> None:
        """Block until every accepted handle resolves (threaded mode).  A
        dead replica's exception is raised here, checked while waiting, so
        it is not turned into a TimeoutError."""
        deadline = time.monotonic() + timeout
        for h in handles:
            while not h.done.wait(min(0.25, max(0.0, deadline - time.monotonic()))):
                for r in self.replicas:
                    if r.error is not None:
                        raise r.error
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"request {h.crid} unresolved after {timeout}s "
                        f"(replica {h.replica})")
        for r in self.replicas:
            if r.error is not None:
                raise r.error
