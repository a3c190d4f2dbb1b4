"""Low-overhead span/event tracing: a pre-allocated ring-buffer event log
(port of repro/obs/trace.py, copied: numpy only).

The serving engine's per-tick hot path runs in hundreds of microseconds on
the smoke configs; a tracer that allocates, locks, or formats per event
would show up in the very utilization numbers it exists to explain.  The
design rules, in order:

  * **Pre-allocated ring writes.**  One event = three scalar stores into
    pre-allocated numpy arrays (kind, interned-name code, monotonic
    timestamp) plus an index increment.  tests/test_torch_gpu.py holds
    the events-per-tick x cost product under 2% of a decode tick on the
    card.
  * **No allocation or locks per event.**  Names are interned to small int
    codes once (engine init / first use); the hot path never touches a
    string or a dict.  The only lock guards interning, never recording.
  * **Single-writer, thread-safe by confinement.**  Each engine owns its
    tracer and each engine is single-thread-confined,
    so a ReplicaPool traces race-free with zero synchronization: one tracer
    per replica thread, merged at export (obs/export.py gives each its own
    pid/tid in the Chrome trace).
  * **Bounded memory.**  The ring keeps the most recent `capacity` events;
    older events are overwritten and counted in `dropped` — a serving
    process can trace forever without growing.

Event kinds map 1:1 onto Chrome-trace phases (obs/export.py):

  BEGIN/END         -> "B"/"E"   nested duration spans on this tracer's tid
                                 (per-tick phases: sched, prefill, decode,
                                 verify, draft, reset)
  COUNTER           -> "C"       sampled gauges (kv_blocks_in_use,
                                 queue_depth, ...)
  ASYNC_BEGIN/END   -> "b"/"e"   id-keyed spans that outlive any one tick
                                 (per-request lifecycle: queued -> prefill
                                 -> decode, id = trace id)
  FLOW_*            -> "s"/"t"/"f"  id-keyed flow arrows that CROSS tracer
                                 lanes (request tracing: the router lane
                                 starts a flow at admission, each replica
                                 lane steps it per prefill chunk / decode
                                 tick, the finishing tick ends it — one
                                 request renders as a connected arrow chain
                                 across pid lanes in Perfetto).  Flow
                                 events bind to the duration slice open at
                                 their timestamp, so emit them inside a
                                 BEGIN/END pair.
  INSTANT           -> "i"       point annotations (shed decisions,
                                 prefix-cache hits, CoW cache evictions)

Timestamps are `time.perf_counter_ns()` — monotonic, comparable across
tracers in one process (export aligns every tracer to a common origin).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List

import numpy as np

BEGIN = 0
END = 1
COUNTER = 2
ASYNC_BEGIN = 3
ASYNC_END = 4
FLOW_START = 5
FLOW_STEP = 6
FLOW_END = 7
INSTANT = 8

_KIND_NAMES = ("B", "E", "C", "b", "e", "s", "t", "f", "i")


class Tracer:
    """Single-writer ring-buffer event log (see module docstring).

    `intern()` a name once, then record with the returned code:

        tr = Tracer(name="engine")
        DECODE = tr.intern("decode")
        tr.begin(DECODE); ...; tr.end(DECODE)
    """

    __slots__ = ("capacity", "name", "pid", "enabled", "_kind", "_code",
                 "_aid", "_value", "_ts", "_n", "_names", "_codes", "_lock",
                 "_clock")

    def __init__(self, capacity: int = 1 << 15, *, name: str = "engine",
                 pid: int = 0, clock=time.perf_counter_ns):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.name = name
        self.pid = pid
        self.enabled = True
        self._kind = np.zeros(capacity, np.uint8)
        self._code = np.zeros(capacity, np.uint32)
        self._aid = np.zeros(capacity, np.int64)      # async id (request id)
        self._value = np.zeros(capacity, np.float64)  # counter value
        self._ts = np.zeros(capacity, np.int64)       # perf_counter_ns
        self._n = 0                                   # total events recorded
        self._names: List[str] = []
        self._codes: Dict[str, int] = {}
        self._lock = threading.Lock()                 # interning only
        self._clock = clock

    # -- name interning (off the hot path) -----------------------------------

    def intern(self, name: str) -> int:
        """Name -> small int code; idempotent, safe from any thread."""
        code = self._codes.get(name)
        if code is not None:
            return code
        with self._lock:
            code = self._codes.get(name)
            if code is None:
                code = len(self._names)
                self._names.append(name)
                self._codes[name] = code
            return code

    # -- recording (hot path: 3 scalar stores + 1 increment) -----------------

    def begin(self, code: int) -> None:
        i = self._n % self.capacity
        self._kind[i] = BEGIN
        self._code[i] = code
        self._ts[i] = self._clock()
        self._n += 1

    def end(self, code: int) -> None:
        i = self._n % self.capacity
        self._kind[i] = END
        self._code[i] = code
        self._ts[i] = self._clock()
        self._n += 1

    def counter(self, code: int, value: float) -> None:
        i = self._n % self.capacity
        self._kind[i] = COUNTER
        self._code[i] = code
        self._value[i] = value
        self._ts[i] = self._clock()
        self._n += 1

    def async_begin(self, code: int, aid: int) -> None:
        i = self._n % self.capacity
        self._kind[i] = ASYNC_BEGIN
        self._code[i] = code
        self._aid[i] = aid
        self._ts[i] = self._clock()
        self._n += 1

    def async_end(self, code: int, aid: int) -> None:
        i = self._n % self.capacity
        self._kind[i] = ASYNC_END
        self._code[i] = code
        self._aid[i] = aid
        self._ts[i] = self._clock()
        self._n += 1

    def flow_start(self, code: int, fid: int) -> None:
        """Open flow `fid` (request trace id) at the enclosing slice."""
        i = self._n % self.capacity
        self._kind[i] = FLOW_START
        self._code[i] = code
        self._aid[i] = fid
        self._ts[i] = self._clock()
        self._n += 1

    def flow_step(self, code: int, fid: int) -> None:
        i = self._n % self.capacity
        self._kind[i] = FLOW_STEP
        self._code[i] = code
        self._aid[i] = fid
        self._ts[i] = self._clock()
        self._n += 1

    def flow_end(self, code: int, fid: int) -> None:
        i = self._n % self.capacity
        self._kind[i] = FLOW_END
        self._code[i] = code
        self._aid[i] = fid
        self._ts[i] = self._clock()
        self._n += 1

    def instant(self, code: int, value: float = 0.0) -> None:
        """Point annotation (shed / prefix hit / eviction), with a payload."""
        i = self._n % self.capacity
        self._kind[i] = INSTANT
        self._code[i] = code
        self._value[i] = value
        self._ts[i] = self._clock()
        self._n += 1

    @contextlib.contextmanager
    def span(self, name: str):
        """Convenience span by name (interns; for warm paths only)."""
        code = self.intern(name)
        self.begin(code)
        try:
            yield
        finally:
            self.end(code)

    # -- reading -------------------------------------------------------------

    def __len__(self) -> int:
        """Events currently held (<= capacity)."""
        return min(self._n, self.capacity)

    @property
    def recorded(self) -> int:
        """Total events ever recorded (held + dropped)."""
        return self._n

    @property
    def dropped(self) -> int:
        """Events overwritten by ring wraparound."""
        return max(0, self._n - self.capacity)

    def events(self) -> List[dict]:
        """Held events, oldest first, decoded to plain dicts.

        Call from the writer thread or after it has stopped — a concurrent
        read mid-write may see one torn record at the ring head."""
        n = self._n
        if n <= self.capacity:
            order = range(n)
        else:
            head = n % self.capacity
            order = list(range(head, self.capacity)) + list(range(head))
        out = []
        for i in order:
            kind = int(self._kind[i])
            out.append({
                "kind": kind,
                "ph": _KIND_NAMES[kind],
                "name": self._names[int(self._code[i])],
                "id": int(self._aid[i]),
                "value": float(self._value[i]),
                "ts_ns": int(self._ts[i]),
            })
        return out

    def clear(self) -> None:
        self._n = 0


class NullTracer:
    """No-op stand-in with the full Tracer API: tracing-off engines call the
    same code paths, and each call is one cheap no-op method dispatch (a few
    tens of ns against a ~ms tick)."""

    capacity = 0
    name = "null"
    pid = 0
    enabled = False

    def intern(self, name: str) -> int:
        return 0

    def begin(self, code: int) -> None:
        pass

    def end(self, code: int) -> None:
        pass

    def counter(self, code: int, value: float) -> None:
        pass

    def async_begin(self, code: int, aid: int) -> None:
        pass

    def async_end(self, code: int, aid: int) -> None:
        pass

    def flow_start(self, code: int, fid: int) -> None:
        pass

    def flow_step(self, code: int, fid: int) -> None:
        pass

    def flow_end(self, code: int, fid: int) -> None:
        pass

    def instant(self, code: int, value: float = 0.0) -> None:
        pass

    @contextlib.contextmanager
    def span(self, name: str):
        yield

    def __len__(self) -> int:
        return 0

    recorded = 0
    dropped = 0

    def events(self) -> List[dict]:
        return []

    def clear(self) -> None:
        pass


NULL_TRACER = NullTracer()
