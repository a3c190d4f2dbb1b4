"""The autotuner: search the launch plans per GeMM shape, cache the winner.

Port of repro/tuning/autotuner.py.  The reference elaborates one Pallas
kernel per legal TPU tile and picks the point per workload; the port picks
a launch plan of its hand kernels (tuning/candidates.py) per (K, N):

  1. `candidates.enumerate_tiles`: the legal plans, the hand rule's first;
  2. ranking: "analytic" by the H100 roofline model (tuning/model.py, no
     card needed), or "wallclock" by real launches on the card: each
     candidate is captured as a CUDA graph of repeated launches over
     enough copies of B to keep the L2 cache cold, and one replay is timed
     with CUDA events (the better of ROUNDS rounds).  The rule's plan is
     kept unless a candidate beats it by more than MARGIN (3 %), so that
     noise does not flip winners between runs;
  3. `cache.TuneCache`: winners persist across processes, keyed by the
     card (cache.py).

No fallback hides the card or a kernel: wall-clock mode without a CUDA
device raises (the reference falls back to the analytic ranking), and a
candidate that fails to launch raises (the reference skips it).  Only
plans that the legality rules reject before any launch are left out.  A
wall-clock tuner never reuses an analytic winner, nor trusts an entry of
another source under its own key.

`tuned_gemm(a, b)` is the user-facing entry; `enable()` routes every GeMM
call that names no plan through the tuner (kernels/ops.py), and `scope`
runs a block with one tuner and one decode plan bound for its thread (the
engine runs its steps under its own).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.kernels import launches as _launches
from repro_torch.kernels.gemm import GemmLaunchSpec
from repro_torch.tuning import model as tmodel
from repro_torch.tuning.cache import CacheEntry, TuneCache, cache_key, device_tag
from repro_torch.tuning.candidates import (BACKENDS, H100_SMS, GemmShape,
                                           dtype_bits, enumerate_tiles)

MARGIN = 0.03          # a candidate must beat the rule by more than this to win
ROUNDS = 2             # wall-clock rounds over the candidates; each keeps its best
L2_BYTES = 50 * 2**20  # the H100's L2: operand copies span twice this


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """Outcome of one tuning query.  Scores are seconds per launch (on the
    card, or the analytic model's)."""

    spec: object                 # GemmLaunchSpec, or FlashDecodeSpec (tuning/decode.py)
    score: float
    source: str                  # "analytic" | "wallclock"
    from_cache: bool = False
    candidates: int = 0
    rule_spec: object = None     # the hand rule's plan, the first candidate
    rule_score: Optional[float] = None
    seconds: float = 0.0         # wall time the search took (0 from the cache)
    timings: tuple = ()          # ((spec, score), ...) of every candidate


def _measuring_device(device) -> torch.device:
    """The CUDA device a wall-clock tuner times on; raises without one."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"wall-clock tuning times the kernels on a CUDA device, "
                         f"not {dev}; use mode='analytic' on the CPU")
    return dev


def pick(scores: Sequence[float], margin: float) -> int:
    """Index of the winner of scores whose first entry is the rule's: the
    best (the first of equals), unless it beats the rule by `margin` or
    less."""
    best = min(range(len(scores)), key=lambda i: (scores[i], i))
    return best if scores[best] < scores[0] * (1.0 - margin) else 0


class Autotuner:
    """Launch-plan search with a persistent winner cache.

    mode="analytic"   rank by the H100 roofline model (any host; `device`
                      None takes the model's card, 132 SMs, a CUDA device
                      its own SM count).
    mode="wallclock"  time each candidate on `device` (default "cuda");
                      raises without a CUDA device.
    """

    def __init__(self, cache: Optional[TuneCache] = None, *, mode: str = "analytic",
                 device=None, max_candidates: Optional[int] = None,
                 persist: bool = True):
        if mode not in ("analytic", "wallclock"):
            raise ValueError(f"unknown tuning mode {mode!r}")
        self.mode = mode
        if mode == "wallclock":
            self.device = _measuring_device(device)
        else:
            dev = None if device is None else torch.device(device)
            self.device = dev if dev is not None and dev.type == "cuda" else None
        self.cache = cache if cache is not None else TuneCache()
        self.max_candidates = max_candidates
        self.persist = persist
        # Kernel launches the wall-clock searches made, by launch counter
        # (kernels/launches.py), replays included; and their wall time.
        self.timing_launches: Dict[str, int] = {}
        self.tuning_s = 0.0

    @property
    def tag(self) -> str:
        return device_tag(self.device)

    @property
    def sms(self) -> int:
        if self.device is None:
            return H100_SMS
        return torch.cuda.get_device_properties(self.device).multi_processor_count

    # -- public API ----------------------------------------------------------

    def key(self, shape: GemmShape, dtype, backend: str, *, kmajor: bool = False,
            depth=None) -> str:
        """Registry key of a query; `kmajor` counts for the float GeMMs
        only (the int8 GeMMs read B K-major whatever the caller's layout)."""
        kmajor = kmajor and backend in ("tiled", "pipelined")
        key = cache_key(shape, dtype, backend, self.tag, kmajor=kmajor)
        if self.mode != "analytic":
            key += f"|{self.mode}"
        if depth is not None:
            ds = (depth,) if isinstance(depth, int) else tuple(depth)
            key += "|d" + "-".join(map(str, ds))
        if self.max_candidates is not None:
            key += f"|top{self.max_candidates}"
        return key

    def tune(self, shape: GemmShape, dtype="bfloat16", *, backend: str = "tiled",
             depth=None, kmajor: bool = False, force: bool = False) -> TuneResult:
        """Best plan for (shape, dtype, backend), cached.  `depth` (K6): an
        int or a sequence of ring depths (default: 2, 3, 4).  `kmajor`: B
        is K-contiguous (a tied head); the int8 GeMMs read B K-major
        whatever the caller's layout."""
        if backend not in BACKENDS:
            raise ValueError(f"unknown tuning backend {backend!r}; known: {BACKENDS}")
        kmajor = kmajor and backend in ("tiled", "pipelined")
        key = self.key(shape, dtype, backend, kmajor=kmajor, depth=depth)
        if not force:
            hit = self.cache.get(key)
            if hit is not None and hit.source == self.mode:
                return TuneResult(spec=hit.spec, score=hit.score, source=hit.source,
                                  from_cache=True, rule_score=hit.rule_score)
        if self.device is not None and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"GeMM {shape} ({dtype}, {backend}) was not tuned before "
                               f"a CUDA graph capture; tune the shapes first")
        t0 = time.monotonic()
        cands = enumerate_tiles(shape, dtype, backend=backend, depth=depth,
                                sms=self.sms, kmajor=kmajor,
                                max_candidates=self.max_candidates)
        if self.mode == "wallclock":
            scores = self._time_specs(cands, shape, dtype, backend, kmajor)
            win = pick(scores, MARGIN)
        else:
            scores = [tmodel.predict_time_s(s, shape, dtype, backend=backend,
                                            sms=self.sms, kmajor=kmajor) for s in cands]
            win = pick(scores, 0.0)
        seconds = time.monotonic() - t0
        self.tuning_s += seconds
        self.cache.put(key, CacheEntry(spec=cands[win], score=scores[win],
                                       source=self.mode, rule_score=scores[0]),
                       persist=self.persist)
        return TuneResult(spec=cands[win], score=scores[win], source=self.mode,
                          candidates=len(cands), rule_spec=cands[0],
                          rule_score=scores[0], seconds=seconds,
                          timings=tuple(zip(cands, scores)))

    def spec_for(self, shape: GemmShape, dtype="bfloat16", *, backend: str = "tiled",
                 kmajor: bool = False) -> GemmLaunchSpec:
        return self.tune(shape, dtype, backend=backend, kmajor=kmajor).spec

    def warmup(self, shapes: Sequence[GemmShape], dtype="bfloat16", *,
               backend: str = "tiled", kmajor=()) -> List[TuneResult]:
        """Pre-tune a workload's shapes (a model's GeMMs before serving);
        `kmajor` names the shapes whose B is K-contiguous."""
        return [self.tune(s, dtype, backend=backend, kmajor=s in kmajor) for s in shapes]

    # -- wall clock ----------------------------------------------------------

    def _time_specs(self, cands: Sequence[GemmLaunchSpec], shape: GemmShape, dtype,
                    backend: str, kmajor: bool) -> List[float]:
        """Seconds per launch of each candidate on the card: one CUDA graph
        of repeated launches over L2-cold copies of B, one replay timed with
        CUDA events, the best of ROUNDS.  A failed launch raises."""
        call, copies = _bench_call(shape, dtype, backend, kmajor, self.device)
        iters = max(20, min(400, 4 * copies))
        scores = [float("inf")] * len(cands)
        try:
            for _ in range(ROUNDS):
                for i, spec in enumerate(cands):
                    calls = [lambda c=c, s=spec: call(c, s) for c in range(copies)]
                    scores[i] = min(scores[i], self._time_graph(calls, iters))
        finally:
            del call
            torch.cuda.empty_cache()
        return scores

    def _time_graph(self, calls, iters: int) -> float:
        dev = self.device
        before = _launches.counts()
        for c in calls[:3]:
            c()                     # builds the library, allocates the scratch
        torch.cuda.synchronize(dev)
        mid = _launches.counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for i in range(iters):
                calls[i % len(calls)]()
        captured = _launches.counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        graph.replay()
        torch.cuda.synchronize(dev)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize(dev)
        del graph
        for name, n in captured.items():
            # eager and captured calls, then the captured ones twice replayed
            total = n - before[name] + 2 * (n - mid[name])
            if total:
                self.timing_launches[name] = self.timing_launches.get(name, 0) + total
        return start.elapsed_time(end) * 1e-3 / iters


def _bench_call(shape: GemmShape, dtype, backend: str, kmajor: bool,
                device: torch.device):
    """(call(copy, spec), copies): one launch of `backend`'s kernel at the
    real shape on random operands, B one of `copies` copies spanning twice
    the L2 cache.  The kernels mask the ragged edges, so nothing is padded."""
    from repro_torch.kernels import gemm as _gemm
    from repro_torch.kernels import gemm_int8 as _gemm_int8
    from repro_torch.kernels import gemm_pipelined as _pipelined

    M, K, N = shape.M, shape.K, shape.N
    g = torch.Generator(device=device).manual_seed(0)
    int8 = backend in ("dequant", "w8a8") or dtype_bits(dtype) == 8
    fdt = {16: torch.bfloat16, 32: torch.float32}.get(dtype_bits(dtype), torch.bfloat16)
    copies = max(1, min(128, -(-2 * L2_BYTES // (K * N * (1 if int8 else fdt.itemsize)))))

    def weight():
        if int8:    # int8 weights are stored (N, K): a K-major view
            return torch.randint(-127, 128, (N, K), generator=g, device=device,
                                 dtype=torch.int8).t()
        w = torch.randn((N, K) if kmajor else (K, N), generator=g, device=device).to(fdt)
        return w.t() if kmajor else w

    bs = [weight() for _ in range(copies)]
    if backend == "w8a8":
        x = torch.randn((M, K), generator=g, device=device).to(fdt)
        scales = [torch.rand((N,), generator=g, device=device) / 127 for _ in bs]
        return (lambda c, s: _gemm_int8.gemm_w8a8(x, bs[c], scales[c], out_dtype=fdt,
                                                  spec=s)), copies
    if int8:
        a = torch.randint(-127, 128, (M, K), generator=g, device=device, dtype=torch.int8)
        if backend == "dequant":
            sa = torch.rand((M, 1), generator=g, device=device) / 127
            sb = torch.rand((1, N), generator=g, device=device) / 127
            return (lambda c, s: _gemm_int8.dequant_gemm(
                a, bs[c], sa, sb, out_dtype=torch.bfloat16, spec=s)), copies
        if backend == "pipelined":
            return (lambda c, s: _pipelined.gemm(a, bs[c], spec=s)), copies
        return (lambda c, s: _gemm_int8.gemm_int(a, bs[c], spec=s)), copies
    a = torch.randn((M, K), generator=g, device=device).to(fdt)
    if backend == "pipelined":
        return (lambda c, s: _pipelined.gemm(a, bs[c], out_dtype=fdt, spec=s)), copies
    return (lambda c, s: _gemm.gemm(a, bs[c], out_dtype=fdt, spec=s)), copies


# ---------------------------------------------------------------------------
# Process-wide default tuner + dispatch switch (consumed by kernels/ops.py)
# ---------------------------------------------------------------------------

_DEFAULT_TUNER: Optional[Autotuner] = None


def env_truthy(value: Optional[str]) -> bool:
    """Shared REPRO_AUTOTUNE parse: '0'/'false'/'no'/'off'/'' disable."""
    return (value or "").strip().lower() not in ("", "0", "false", "no", "off")


_ENABLED = env_truthy(os.environ.get("REPRO_AUTOTUNE"))
# A thread's `scope` blocks, innermost last: {"enabled": bool, "tuner":
# Autotuner or None (None: the process-wide default)}.
_scoped = threading.local()


def _frame() -> Optional[dict]:
    stack = getattr(_scoped, "stack", None)
    return stack[-1] if stack else None


def get_tuner() -> Autotuner:
    """The default tuner (inside a `scope`, that scope's): analytic, for the
    card when there is one."""
    global _DEFAULT_TUNER
    f = _frame()
    if f is not None and f["tuner"] is not None:
        return f["tuner"]
    if _DEFAULT_TUNER is None:
        _DEFAULT_TUNER = Autotuner(device="cuda" if torch.cuda.is_available() else None)
    return _DEFAULT_TUNER


def set_tuner(tuner: Optional[Autotuner]) -> None:
    """Install the default tuner: process-wide, or inside a `scope` for
    the rest of that scope on this thread."""
    global _DEFAULT_TUNER
    f = _frame()
    if f is not None:
        f["tuner"] = tuner
    else:
        _DEFAULT_TUNER = tuner


def enable() -> None:
    """Route every GeMM call that names no plan through the tuner
    (process-wide, or inside a `scope` for the rest of it on this thread)."""
    global _ENABLED
    f = _frame()
    if f is not None:
        f["enabled"] = True
    else:
        _ENABLED = True


def disable() -> None:
    global _ENABLED
    f = _frame()
    if f is not None:
        f["enabled"] = False
    else:
        _ENABLED = False


def is_enabled() -> bool:
    f = _frame()
    return f["enabled"] if f is not None else _ENABLED


@contextlib.contextmanager
def scope(tuner: Optional[Autotuner], decode_spec=None):
    """Run a block with `tuner` as the enabled default (None: tuning
    disabled, the outer default kept) and `decode_spec` bound for paged
    decode attention (kernels/flash_decode.py), for this thread only: the
    process-wide state, and what other threads see, stay as they are, and
    `enable()`, `disable()`, `set_tuner` and `set_decode_spec` inside the
    block change the block's binding alone.  The engine runs every step it
    executes or captures under its own, so a later change of the
    process-wide tuner does not reach it, and engines on several threads
    keep theirs apart."""
    from repro_torch.kernels import flash_decode as _fd

    outer = _frame()
    stack = _scoped.__dict__.setdefault("stack", [])
    stack.append({"enabled": tuner is not None,
                  "tuner": tuner if tuner is not None else (outer and outer["tuner"])})
    try:
        with _fd.bound_decode_spec(decode_spec):
            yield
    finally:
        stack.pop()


def tuned_spec(shape: GemmShape, dtype="bfloat16", *, backend: str = "tiled",
               kmajor: bool = False) -> GemmLaunchSpec:
    """Best known plan for this problem via the default tuner."""
    return get_tuner().spec_for(shape, dtype, backend=backend, kmajor=kmajor)


def tuned_gemm(a: torch.Tensor, b: torch.Tensor, *, backend: Optional[str] = None,
               tuner: Optional[Autotuner] = None) -> torch.Tensor:
    """C = A @ B with the tuned plan for (shape, dtype, backend): the plan
    from the cache (tuned on first sight), then `ops.gemm` with it."""
    from repro_torch.kernels import ops

    backend = backend or ops.get_default_backend()
    shape = GemmShape(a.shape[0], a.shape[1], b.shape[1])
    kmajor = b.stride(0) == 1 and b.stride(1) != 1
    spec = (tuner or get_tuner()).spec_for(shape, a.dtype, backend=backend, kmajor=kmajor)
    return ops.gemm(a, b, backend=backend, spec=spec)
