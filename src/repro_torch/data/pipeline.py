"""Data pipeline: deterministic synthetic LM batches and a device prefetcher
(port of repro/data/pipeline.py).

`SyntheticLMData` is the reference's numpy code, copied: batch `i` is a
pure function of (seed, i), so its batches equal the reference's bit for
bit and a restart from a checkpointed cursor replays the same stream.

`rank_rows` is a rank's share of a batch under a `parallel` plan.

`Prefetcher` is the reference's depth-D buffer filled by a producer thread.
Where the reference stages batches with `jax.device_put`, the producer
here copies each batch to pinned host memory and on to the device with
`non_blocking` copies on a stream of its own, and records an event; the
consumer's stream waits on that event before it uses the batch.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.parallel.sharding import batch_spec, shard_index


class SyntheticLMData:
    """Deterministic, restartable synthetic token stream.

    Batch `i` is a pure function of (seed, i): restarting from a checkpointed
    cursor reproduces the exact stream a real sharded corpus reader would.
    """

    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0,
                 extras: Optional[Dict[str, tuple]] = None):
        self.vocab, self.batch, self.seq, self.seed = vocab, batch, seq, seed
        self.extras = extras or {}

    def batch_at(self, cursor: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed << 32) | (cursor & 0xFFFFFFFF))
        # Markov-ish stream: mixture of a random walk and uniform noise so the
        # LM loss is learnable.
        base = rng.integers(0, self.vocab, size=(self.batch, 1))
        steps = rng.integers(-3, 4, size=(self.batch, self.seq + 1))
        walk = (base + np.cumsum(steps, axis=1)) % self.vocab
        noise = rng.integers(0, self.vocab, size=(self.batch, self.seq + 1))
        use_noise = rng.random((self.batch, self.seq + 1)) < 0.1
        toks = np.where(use_noise, noise, walk).astype(np.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        for name, shape in self.extras.items():
            out[name] = rng.standard_normal((self.batch, *shape)).astype(np.float32)
        return out

    def iterate(self, start: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        cursor = start
        while True:
            yield self.batch_at(cursor)
            cursor += 1


def rank_rows(batch: Dict[str, np.ndarray], mesh, plan, rank: int) -> Dict[str, np.ndarray]:
    """This rank's rows of a global batch by `batch_sharding`'s rule: each
    leaf's leading dimension split over the largest divisor subset of the
    plan's batch axes (`parallel.sharding.batch_spec`), or whole where no
    batch axis divides it (every rank then computes the same rows)."""
    from repro_torch.parallel.sharding import batch_spec, shard_index

    out = {}
    for name, a in batch.items():
        spec = batch_spec(a.shape, mesh, plan)
        index, count = shard_index(spec[0] if spec else None, mesh, rank)
        rows = a.shape[0] // count if a.ndim else 0
        out[name] = a[index * rows:(index + 1) * rows] if count > 1 else a
    return out


def to_device(batch: Dict[str, np.ndarray], device, *, non_blocking: bool = False
              ) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on `device`: integer arrays as int64 (the
    embedding's and the loss's index type), float arrays as float32.  With
    `non_blocking` on a CUDA device the host side is pinned first, so the
    copies run asynchronously on the current stream."""
    device = torch.device(device)
    out = {}
    for name, a in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(a))
        t = t.to(torch.int64) if np.issubdtype(a.dtype, np.integer) else t.to(torch.float32)
        if non_blocking and device.type == "cuda":
            t = t.pin_memory()
        out[name] = t.to(device, non_blocking=non_blocking)
    return out


class Prefetcher:
    """Depth-D device prefetch: a producer thread stages the next batches
    while the current step computes (paper Sec. 3.3, host-scale analogue)."""

    def __init__(self, it: Iterator, depth: int = 3, device=None):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._device = None if device is None else torch.device(device)
        self._stop = threading.Event()
        cuda = self._device is not None and self._device.type == "cuda"
        self._stream = torch.cuda.Stream(self._device) if cuda else None

        def produce():
            for item in it:
                if self._stop.is_set():
                    return
                event = None
                if self._stream is not None:
                    with torch.cuda.stream(self._stream):
                        item = to_device(item, self._device, non_blocking=True)
                        event = torch.cuda.Event()
                        event.record(self._stream)
                elif self._device is not None:
                    item = to_device(item, self._device)
                self._q.put((item, event))
            self._q.put(None)

        self._thread = threading.Thread(target=produce, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        got = self._q.get()
        if got is None:
            raise StopIteration
        item, event = got
        if event is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(event)
            for t in item.values():     # the allocator must not reuse it early
                t.record_stream(consumer)
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
