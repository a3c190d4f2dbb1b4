"""Tuning cache: persisted winners, keyed by (shape, dtype, backend, card).

Port of repro/tuning/cache.py.  Two layers, as in the reference:

  * an in-memory LRU (hot plans resolve in O(1) with no I/O);
  * an on-disk JSON registry (survives processes, human-readable).

Writes go through a temp-file rename, so a crashed run never leaves a torn
registry; a file that does not parse is ignored, and so is an entry of a
kind this package does not know (the reference's TPU tiles, say).
`persistent=False` never touches the disk.

Keys carry the card: its name and SM count (`device_tag`), since cards of
one model at one power limit run 20-30 % apart and a plan timed on one is
no measurement of another.  Up to `kernels.gemm.FULL_ROWS` rows a GeMM key
leaves M out: K1's and K3's split count must be the same at every such M,
so that a speculative verify row equals a decode row bit for bit; a plan
tuned at the decode M serves every M up to FULL_ROWS.

The default file is the port's own, ``~/.cache/repro-opengemm/
torch-tunecache.json``, not the reference's ``tunecache.json`` (the two
packages share a process in the tests); ``REPRO_TUNE_CACHE`` relocates it,
as in the reference.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import threading
from collections import OrderedDict
from typing import Dict, Optional

import torch

from repro_torch.kernels.flash_decode import FlashDecodeSpec
from repro_torch.kernels.gemm import FULL_ROWS, GemmLaunchSpec
from repro_torch.tuning.candidates import H100_SMS, GemmShape

_ENV_VAR = "REPRO_TUNE_CACHE"
# The analytic model's card, for keys made without one.
MODEL_TAG = f"H100 SXM (analytic)/{H100_SMS}sm"


def default_cache_path() -> str:
    return os.environ.get(_ENV_VAR) or os.path.join(
        os.path.expanduser("~"), ".cache", "repro-opengemm", "torch-tunecache.json")


def device_tag(device: Optional[torch.device]) -> str:
    """The card a key belongs to: "<name>/<SMs>sm" of a CUDA device, the
    analytic model's target for None."""
    if device is None:
        return MODEL_TAG
    if device.type != "cuda":
        raise ValueError(f"a tuning key names a CUDA device or none, not {device}")
    props = torch.cuda.get_device_properties(device)
    return f"{props.name}/{props.multi_processor_count}sm"


def cache_key(shape: GemmShape, dtype, backend: str, device: str = MODEL_TAG,
              *, kmajor: bool = False) -> str:
    """Registry key of a GeMM plan: M only above FULL_ROWS rows."""
    name = str(dtype).replace("torch.", "")
    m = f"M<={FULL_ROWS}" if shape.M <= FULL_ROWS else str(shape.M)
    return (f"{m}x{shape.K}x{shape.N}|{name}|{backend}"
            + ("|kmajor" if kmajor else "") + f"|{device}")


_KINDS = {"gemm": GemmLaunchSpec, "flash_decode": FlashDecodeSpec}


@dataclasses.dataclass(frozen=True)
class CacheEntry:
    """One tuned winner with its provenance: `score` is seconds (wall clock
    on the card, or the analytic model's); `rule_score` the hand rule's, on
    the same scale."""

    spec: object              # a GemmLaunchSpec or a FlashDecodeSpec
    score: float
    source: str               # "analytic" | "wallclock"
    rule_score: Optional[float] = None

    def to_json(self) -> dict:
        d = dict(self.spec.to_json())        # carries its "kind"
        d.update(score=self.score, source=self.source, rule_score=self.rule_score)
        return d

    @classmethod
    def from_json(cls, d: dict) -> "CacheEntry":
        kind = _KINDS.get(d.get("kind"))
        if kind is None:
            raise ValueError(f"unknown cache entry kind {d.get('kind')!r}")
        rule = d.get("rule_score")
        return cls(spec=kind.from_json(d), score=float(d["score"]),
                   source=str(d["source"]),
                   rule_score=None if rule is None else float(rule))


class TuneCache:
    """JSON-backed winner registry with an in-memory LRU front.

    `persistent=False` makes the cache memory-only: nothing is read from or
    written to disk."""

    def __init__(self, path: Optional[str] = None, *, lru_size: int = 256,
                 persistent: bool = True):
        self.path = path or default_cache_path()
        self.lru_size = lru_size
        self.persistent = persistent
        self._lru: "OrderedDict[str, CacheEntry]" = OrderedDict()
        self._disk: Dict[str, dict] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        if persistent:
            self._load()

    # -- persistence ---------------------------------------------------------

    def _load(self) -> None:
        try:
            with open(self.path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            data = None
        self._disk = ({str(k): v for k, v in data.items()}
                      if isinstance(data, dict) else {})

    def save(self) -> None:
        if not self.persistent:
            return
        with self._lock:
            snapshot = dict(self._disk)
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d or ".", suffix=".tunecache")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(snapshot, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    # -- lookup / insert -----------------------------------------------------

    def get(self, key: str) -> Optional[CacheEntry]:
        with self._lock:
            hit = self._lru.get(key)
            if hit is not None:
                self._lru.move_to_end(key)
                self.hits += 1
                return hit
            raw = self._disk.get(key)
            if raw is not None:
                try:
                    entry = CacheEntry.from_json(raw)
                except (KeyError, ValueError, TypeError):
                    self.misses += 1
                    return None
                self._insert_lru(key, entry)
                self.hits += 1
                return entry
            self.misses += 1
            return None

    def put(self, key: str, entry: CacheEntry, *, persist: bool = True) -> None:
        with self._lock:
            self._insert_lru(key, entry)
            self._disk[key] = entry.to_json()
        if persist:
            self.save()

    def _insert_lru(self, key: str, entry: CacheEntry) -> None:
        self._lru[key] = entry
        self._lru.move_to_end(key)
        while len(self._lru) > self.lru_size:
            self._lru.popitem(last=False)

    def __len__(self) -> int:
        return len(self._disk)

    def dump(self) -> Dict[str, dict]:
        """The on-disk registry as a dict."""
        with self._lock:
            return {k: dict(v) for k, v in sorted(self._disk.items())}
