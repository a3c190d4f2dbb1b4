"""Deterministic serving workloads: seeded arrivals, prompt mixtures,
trace record/replay (port of repro/cluster/traffic.py, numpy only, so both
packages draw the same trace from the same config and read each other's
saved traces).

Load tests are only comparable when the load is reproducible, so every
workload here is a pure function of its config (seed included): a
``Trace`` — arrival offsets, token prompts, generation budgets — that can
be saved to JSON, reloaded, and replayed against any submit function (a
bare ``Engine.submit``, a cluster ``Router.submit``) byte-for-byte
identically.  Two canned scenarios cover the cluster benchmarks:

  * ``mixed_traffic`` — Poisson arrivals over a short/long prompt-length
    mixture; the throughput-scaling scenario.
  * ``shared_system_prompt`` — every prompt opens with the same system
    prefix and differs only in a short user suffix; the prefix-cache
    scenario (hit rate and TTFT savings).
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from repro_torch.serving.request import RequestSpec, SamplingParams


@dataclasses.dataclass(frozen=True)
class TraceItem:
    t: float                      # arrival offset (s) from trace start
    prompt: Tuple[int, ...]       # token ids
    max_new: int
    priority: str = "interactive"  # SLO class (serving.request.PRIORITIES)
    tenant: str = "default"


@dataclasses.dataclass
class Trace:
    items: List[TraceItem]
    meta: dict = dataclasses.field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.items)

    @property
    def prompt_tokens(self) -> int:
        return sum(len(it.prompt) for it in self.items)

    @property
    def gen_tokens(self) -> int:
        return sum(it.max_new for it in self.items)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({
                "version": 1,
                "meta": self.meta,
                "items": [
                    {"t": it.t, "prompt": list(it.prompt),
                     "max_new": it.max_new, "priority": it.priority,
                     "tenant": it.tenant}
                    for it in self.items
                ],
            }, f)

    @staticmethod
    def load(path: str) -> "Trace":
        with open(path) as f:
            raw = json.load(f)
        if raw.get("version") != 1:
            raise ValueError(f"unknown trace version {raw.get('version')!r}")
        return Trace(
            items=[TraceItem(t=float(d["t"]),
                             prompt=tuple(int(x) for x in d["prompt"]),
                             max_new=int(d["max_new"]),
                             priority=str(d.get("priority", "interactive")),
                             tenant=str(d.get("tenant", "default")))
                   for d in raw["items"]],
            meta=dict(raw.get("meta", {})),
        )


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """Workload spec; ``generate`` is a pure function of this + nothing else.

    ``rate_rps`` is the Poisson arrival rate (exponential inter-arrival
    gaps); ``inf`` front-loads every request at t=0 (a drain test).
    ``mixture`` rows are ``(weight, lo, hi)`` inclusive prompt-length
    ranges; ``shared_prefix`` tokens are prepended to every prompt.
    ``class_mix`` rows are ``(priority, weight)`` SLO-class assignment
    probabilities (empty = all interactive); ``tenants > 1`` spreads
    requests uniformly over synthetic tenant ids ``t0..t{n-1}``.
    """

    n_requests: int = 32
    rate_rps: float = float("inf")
    vocab: int = 256
    mixture: Tuple[Tuple[float, int, int], ...] = ((0.7, 4, 16), (0.3, 16, 48))
    shared_prefix: Tuple[int, ...] = ()
    max_new: Tuple[int, int] = (4, 16)
    seed: int = 0
    class_mix: Tuple[Tuple[str, float], ...] = ()
    tenants: int = 1


def generate(cfg: TrafficConfig) -> Trace:
    """Seeded workload synthesis: same config -> token-identical trace."""
    rng = np.random.default_rng(cfg.seed)
    # Class/tenant labels draw from their own stream so labelling a
    # workload never perturbs the prompt/arrival draws: a labelled trace
    # stays token-identical to its unlabelled twin.
    lrng = np.random.default_rng(cfg.seed + 0x5EED)
    weights = np.asarray([w for w, _, _ in cfg.mixture], np.float64)
    weights = weights / weights.sum()
    cls_names = [c for c, _ in cfg.class_mix]
    cls_w = np.asarray([w for _, w in cfg.class_mix], np.float64)
    if len(cls_names):
        cls_w = cls_w / cls_w.sum()
    items, t = [], 0.0
    for _ in range(cfg.n_requests):
        if np.isfinite(cfg.rate_rps):
            t += float(rng.exponential(1.0 / cfg.rate_rps))
        bucket = int(rng.choice(len(cfg.mixture), p=weights))
        _, lo, hi = cfg.mixture[bucket]
        length = int(rng.integers(lo, hi + 1))
        suffix = rng.integers(0, cfg.vocab, size=length)
        prompt = cfg.shared_prefix + tuple(int(x) for x in suffix)
        max_new = int(rng.integers(cfg.max_new[0], cfg.max_new[1] + 1))
        priority = ("interactive" if not cls_names
                    else cls_names[int(lrng.choice(len(cls_names), p=cls_w))])
        tenant = ("default" if cfg.tenants <= 1
                  else f"t{int(lrng.integers(0, cfg.tenants))}")
        items.append(TraceItem(t=t, prompt=prompt, max_new=max_new,
                               priority=priority, tenant=tenant))
    meta = dataclasses.asdict(cfg)
    meta["shared_prefix_len"] = len(cfg.shared_prefix)
    meta.pop("shared_prefix")            # keep metadata compact
    return Trace(items=items, meta=meta)


# ---------------------------------------------------------------------------
# canned scenarios
# ---------------------------------------------------------------------------


def mixed_traffic(vocab: int, *, n: int = 32, seed: int = 0,
                  rate_rps: float = float("inf"),
                  max_prompt: int = 48, max_new: Tuple[int, int] = (4, 16),
                  class_mix: Optional[Tuple[Tuple[str, float], ...]] = None,
                  tenants: int = 1) -> Trace:
    """Short/long prompt mixture — the throughput-scaling scenario;
    optionally labelled with SLO classes and synthetic tenants (the
    multi-tenant scheduling scenario)."""
    short_hi = max(4, max_prompt // 3)
    return generate(TrafficConfig(
        n_requests=n, rate_rps=rate_rps, vocab=vocab,
        mixture=((0.7, 4, short_hi), (0.3, short_hi, max_prompt)),
        max_new=max_new, seed=seed,
        class_mix=tuple(class_mix) if class_mix else (), tenants=tenants,
    ))


def shared_system_prompt(vocab: int, *, n: int = 16, seed: int = 0,
                         prefix_len: int = 32,
                         suffix: Tuple[int, int] = (2, 8),
                         max_new: Tuple[int, int] = (4, 8),
                         rate_rps: float = float("inf")) -> Trace:
    """Every request opens with one shared system prompt — the prefix-cache
    scenario.  The prefix tokens themselves are drawn from the seed, so the
    whole trace stays a pure function of (vocab, n, seed, ...)."""
    rng = np.random.default_rng(seed)
    prefix = tuple(int(x) for x in rng.integers(0, vocab, size=prefix_len))
    return generate(TrafficConfig(
        n_requests=n, rate_rps=rate_rps, vocab=vocab,
        mixture=((1.0, suffix[0], suffix[1]),),
        shared_prefix=prefix, max_new=max_new,
        seed=seed + 1,                   # distinct stream from the prefix draw
    ))


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------


def replay(trace: Trace, submit: Callable, *,
           speed: Optional[float] = None,
           sampling: Optional[SamplingParams] = None,
           sleep=time.sleep, clock=time.monotonic) -> Tuple[list, int]:
    """Feed a trace through ``submit(spec)`` — any of the three submit
    surfaces (``Engine.submit``, ``Scheduler.submit``, ``Router.submit``)
    accepts the ``RequestSpec`` built per item, which carries the item's
    priority class and tenant (and, optionally, shared ``sampling``
    params for every request).

    ``speed=None`` replays as fast as possible (a drain/throughput test);
    a finite speed replays arrival offsets scaled by it (2.0 = twice real
    time).  ``submit`` returning None counts as shed.  Returns
    ``(accepted_handles, shed_count)``.
    """
    handles, shed = [], 0
    t0 = clock()
    for it in trace.items:
        if speed is not None:
            wait = it.t / speed - (clock() - t0)
            if wait > 0:
                sleep(wait)
        spec = RequestSpec(
            prompt=np.asarray(it.prompt, np.int32), max_new=it.max_new,
            priority=it.priority, tenant=it.tenant,
            sampling=sampling if sampling is not None else SamplingParams())
        h = submit(spec)
        if h is None:
            shed += 1
        else:
            handles.append(h)
    return handles, shed
