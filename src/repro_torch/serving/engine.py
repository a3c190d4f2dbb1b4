"""Serving engine: warmup, request lifecycle, metrics (port of
repro/serving/engine.py, greedy float path).

Continuous batching over the paged decode state:

  * `warmup()` runs every step shape the server can execute — the decode
    step, each power-of-two prefill-chunk bucket, the slot reset — once
    before traffic (on the card this builds the kernels and warms the
    allocator), then starts from a fresh state.
  * chunked prefill interleaves with decode; prefill work is proportional
    to real prompt tokens (serving/prefill.py).
  * the paged KV cache hands finished slots' blocks to the next request.

    eng = Engine(cfg, slots=4, max_seq=256)      # device="cuda" by default
    eng.warmup()                                  # precision="w8a8" quantizes here
    for p in prompts:
        eng.submit(RequestSpec(prompt=p, max_new=16))
    results = eng.run()
    print(eng.metrics.summary())

The int8 deployment precision is two orthogonal switches, as in the
reference: `precision="w8a8"` makes the weights int8-resident at warmup
(the float copy is dropped) and runs every projection through the int8
GeMM with activations quantized per row; `precision="w8a8-calibrated"`
first calibrates static per-tensor activation scales by replaying the
unpaged `forward` over calibration batches (`calib_batches`, or two
synthetic (2, min(32, max_seq)) batches from `seed`), so activations
quantize with those scales instead; `kv_precision="int8"` keeps the paged
pool int8 with per-(block, position, head) scales.  PyTorch reads the
precision mode on every call (quant/modes.py), so the engine enters it
around every step it runs.

Not ported yet: speculative decoding, sampling, preemption, the prefix
cache, tracing and MFU gauges.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch import quant
from repro_torch.models import model as M
from repro_torch.serving import kv_cache as kvc
from repro_torch.serving.prefill import chunk_buckets
from repro_torch.serving.request import RequestSpec
from repro_torch.serving.scheduler import Phase, Request, Scheduler


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class RequestMetrics:
    rid: int
    prompt_len: int
    new_tokens: int
    ttft_s: float                 # submit -> first generated token
    latency_s: float              # submit -> finish


@dataclasses.dataclass
class EngineMetrics:
    prefill_chunks: int = 0
    prefill_tokens: int = 0
    prefill_time_s: float = 0.0   # wall clock in prefill-chunk steps (synced)
    decode_steps: int = 0
    decode_tokens: int = 0
    decode_time_s: float = 0.0    # wall clock in decode ticks only (synced)
    aot_steps: int = 0            # step shapes run during warmup
    cold_compiles: int = 0        # steps whose shape warmup did not cover
    precision: str = "float"      # execution precision (quant/modes.py)
    calib_sites: int = 0          # activation sites calibrated (w8a8-calibrated)
    weight_bytes: int = 0         # resident param bytes (post-quantization)
    weight_bytes_float: int = 0   # param bytes before quantization
    peak_blocks_in_use: int = 0
    occupancy_sum: float = 0.0
    occupancy_samples: int = 0
    kv_precision: str = "float"   # pool residency (serving/kv_cache.py)
    kv_pool_bytes: int = 0        # resident KV pool bytes across all layers
    kv_pool_blocks: int = 0       # pool blocks (incl. the null block)
    kv_bytes_per_block: int = 0   # pool bytes per block across all layers
    kv_slot_capacity: int = 0     # max-length requests the pool can hold
    requests: List[RequestMetrics] = dataclasses.field(default_factory=list)

    @property
    def mean_occupancy(self) -> float:
        return self.occupancy_sum / max(1, self.occupancy_samples)

    @property
    def throughput_tok_s(self) -> float:
        """Decode throughput over decode-tick time only."""
        return self.decode_tokens / self.decode_time_s if self.decode_time_s else 0.0

    def summary(self) -> str:
        ttft = np.mean([r.ttft_s for r in self.requests]) if self.requests else 0.0
        lat = np.mean([r.latency_s for r in self.requests]) if self.requests else 0.0
        out = (
            f"requests={len(self.requests)} prefill_chunks={self.prefill_chunks} "
            f"prefill_tokens={self.prefill_tokens} "
            f"decode_steps={self.decode_steps} "
            f"decode={self.decode_tokens} tok ({self.throughput_tok_s:.1f} tok/s) "
            f"ttft={ttft * 1e3:.0f}ms latency={lat * 1e3:.0f}ms "
            f"kv_occupancy={self.mean_occupancy:.0%} "
            f"peak_blocks={self.peak_blocks_in_use} "
            f"warmed={self.aot_steps} cold_compiles={self.cold_compiles} "
            f"kv_pool={self.kv_pool_bytes / 2**20:.1f}MiB "
            f"({self.kv_pool_blocks} blk x {self.kv_bytes_per_block / 2**10:.1f}KiB, "
            f"{self.kv_precision}) "
            f"slots@max_seq={self.kv_slot_capacity}"
        )
        if self.precision != "float":
            saved = (1.0 - self.weight_bytes / self.weight_bytes_float
                     if self.weight_bytes_float else 0.0)
            out += (f" precision={self.precision} "
                    f"weights={self.weight_bytes / 2**20:.1f}MiB ({saved:.0%} smaller)")
            if self.calib_sites:
                out += f" calib_sites={self.calib_sites}"
        return out


class Engine:
    """Continuous-batching serving engine over the paged decode state."""

    def __init__(self, cfg, params=None, *, slots: int = 4, max_seq: int = 256,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 max_chunk: int = 64, max_queue: Optional[int] = None,
                 precision: str = "float", kv_precision: str = "float",
                 calib_batches=None, seed: int = 0, device=None,
                 verbose: bool = False):
        if precision not in quant.MODES:
            raise ValueError(f"unknown precision {precision!r}; known: {quant.MODES}")
        if kv_precision not in ("float", "int8"):
            raise ValueError(
                f"unknown kv_precision {kv_precision!r}; known: float, int8")
        self.precision, self.kv_precision = precision, kv_precision
        self._calib_batches, self._seed = calib_batches, seed
        self.device = resolve_device(device)
        self.cfg = cfg
        if params is None:
            params = M.init_model(cfg, seed=seed, device=self.device)
        elif params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"engine runs on {self.device}")
        self.params = params
        self.slots, self.max_seq = slots, max_seq
        self.block_size = block_size
        self.max_blocks_per_slot = kvc.blocks_for(max_seq, block_size)
        self.num_blocks = num_blocks or kvc.default_pool_blocks(
            slots, max_seq, block_size)
        # No prompt can exceed max_seq, so larger buckets would never run.
        self.max_chunk = min(max_chunk, max_seq)
        self.verbose = verbose

        self.scheduler = Scheduler(slots, max_chunk=max_chunk, max_queue=max_queue)
        self.alloc = kvc.BlockAllocator(self.num_blocks, block_size)
        self.tables = kvc.BlockTables(slots, self.max_blocks_per_slot)
        self.state = self._fresh_state()
        self.metrics = EngineMetrics(kv_precision=kv_precision)
        self._account_kv_pools()
        self._warmed: set = set()                # step shapes run so far
        self._slot_used = [False] * slots        # occupied at least once
        self._last_token = np.zeros((slots,), np.int32)
        self._reserved: Dict[int, int] = {}      # rid -> blocks reserved
        self._step = 0
        self._submit_t: Dict[int, float] = {}
        self._first_tok_t: Dict[int, float] = {}
        self.results: Dict[int, np.ndarray] = {}

    def _fresh_state(self) -> M.PagedDecodeState:
        return M.init_paged_decode_state(
            self.cfg, self.slots, num_blocks=self.num_blocks,
            block_size=self.block_size,
            max_blocks_per_slot=self.max_blocks_per_slot, device=self.device,
            kv_precision=self.kv_precision)

    def _account_kv_pools(self) -> None:
        m = self.metrics
        m.kv_pool_bytes = sum(kvc.pool_bytes(c) for c in self.state.caches)
        m.kv_pool_blocks = self.num_blocks
        m.kv_bytes_per_block = m.kv_pool_bytes // self.num_blocks
        m.kv_slot_capacity = (self.num_blocks - 1) // self.max_blocks_per_slot

    # -- warmup ----------------------------------------------------------------

    def warmup(self) -> None:
        """Run every step shape once before traffic — decode, each prefill
        chunk bucket, the slot reset — then start from a fresh state (the
        chunk steps advanced slot 0's length and wrote the pools).  With
        precision != "float" the weights become int8-resident first, so the
        steps run here are the int8 steps serving runs."""
        if self.precision != "float":
            self._quantize_weights()
        buckets = chunk_buckets(self.max_chunk)
        dev = self.device
        with torch.no_grad(), self._precision_ctx():
            tokens = torch.zeros((self.slots, 1), dtype=torch.int64, device=dev)
            active = torch.zeros((self.slots,), dtype=torch.bool, device=dev)
            _, state = M.paged_decode_step(self.params, self.cfg, self.state,
                                           tokens, active)
            self._warmed.add("decode")
            for c in buckets:
                _, state = M.prefill_chunk(
                    self.params, self.cfg, state,
                    torch.zeros((1, c), dtype=torch.int64, device=dev), 0)
                self._warmed.add(f"chunk{c}")
            M.reset_slots(self.cfg, state, active)
            self._warmed.add("reset")
        _sync(dev)
        del state
        self.state = self._fresh_state()
        self.metrics.aot_steps = len(self._warmed)
        if self.verbose:
            print(f"warmup: {len(self._warmed)} step shapes run "
                  f"(decode + chunks {buckets} + reset) on {dev}"
                  + (f" [{self.precision}]" if self.precision != "float" else ""))

    def _precision_ctx(self):
        """The precision mode every step runs under.  PyTorch reads the mode
        on each `ops.linear` call, so it is entered around every step, and
        the process-wide mode is "float" again between steps."""
        if self.precision == "float":
            return contextlib.nullcontext()
        return quant.precision(self.precision)

    def _quantize_weights(self) -> None:
        """Calibrate (for "w8a8-calibrated") and swap the float params for
        the int8-resident ones; the float copy is dropped, so the memory
        saving is real, not additive."""
        scales = None
        if self.precision == "w8a8-calibrated":
            batches = self._calib_batches
            if batches is None:
                batches = quant.synthetic_batches(
                    self.cfg, n=2, batch=2, seq=min(32, self.max_seq),
                    seed=self._seed)
            scales = quant.collect_scales(self.params, self.cfg, batches)
            self.metrics.calib_sites = len(scales)
            if self.verbose:
                print(f"calibrated {len(scales)} activation sites "
                      f"({scales.observer}, {scales.batches} batches)")
        self.metrics.weight_bytes_float = quant.weight_bytes(self.params)
        self.params = quant.quantize_params(self.params, cfg=self.cfg,
                                            scales=scales)
        self.metrics.weight_bytes = quant.weight_bytes(self.params)
        self.metrics.precision = self.precision
        if self.verbose:
            mb = 2**20
            print(f"quantized {quant.quantized_leaf_count(self.params)} "
                  f"weights int8-resident: "
                  f"{self.metrics.weight_bytes_float / mb:.1f}MiB -> "
                  f"{self.metrics.weight_bytes / mb:.1f}MiB")

    def _note_shape(self, key: str) -> None:
        if key not in self._warmed:
            self.metrics.cold_compiles += 1
            self._warmed.add(key)

    # -- request lifecycle ---------------------------------------------------

    def submit(self, spec: RequestSpec) -> Optional[Request]:
        """Queue a request; None when the admission queue is full."""
        if not isinstance(spec, RequestSpec):
            raise TypeError(f"submit takes a RequestSpec, got {type(spec).__name__}")
        if spec.prompt_len + spec.max_new > self.max_seq:
            raise ValueError(
                f"prompt {spec.prompt_len} + max_new {spec.max_new} exceeds "
                f"max_seq {self.max_seq}")
        if (kvc.blocks_for(spec.prompt_len + spec.max_new, self.block_size)
                > self.num_blocks - 1):
            raise ValueError(
                f"request needs more KV blocks than the whole pool "
                f"({self.num_blocks - 1}); raise num_blocks")
        req = self.scheduler.submit(spec, step=self._step)
        if req is not None:
            self._submit_t[req.rid] = time.monotonic()
        return req

    def _can_admit(self, req: Request) -> bool:
        need = kvc.blocks_for(req.prompt_len + req.max_new, self.block_size)
        return self.alloc.can_reserve(need)

    def _admit_once(self) -> None:
        to_reset = []
        for slot, req in self.scheduler.admit(self._can_admit):
            n = kvc.blocks_for(req.prompt_len + req.max_new, self.block_size)
            if not self.alloc.reserve(n):   # _can_admit just vouched for this
                raise RuntimeError(f"reservation of {n} blocks failed post-admit")
            self._reserved[req.rid] = n
            # A refilled slot needs its length zeroed; a never-used slot is
            # already zero.
            if self._slot_used[slot]:
                to_reset.append(slot)
            self._slot_used[slot] = True
        if to_reset:
            mask = np.zeros((self.slots,), bool)
            mask[to_reset] = True
            self._note_shape("reset")
            self.state = M.reset_slots(
                self.cfg, self.state, torch.from_numpy(mask).to(self.device))

    def _sync_tables(self) -> None:
        if self.tables.dirty:
            self.state.block_tables = self.tables.array(self.device)

    def _finish(self, req: Request) -> None:
        slot = self.scheduler.release(req)
        drawn = len(self.tables.blocks[slot])
        unused = max(0, self._reserved.pop(req.rid, drawn) - drawn)
        self.tables.release(slot, self.alloc, unreserve=unused)
        self.results[req.rid] = np.asarray(req.out_tokens, np.int32)
        now = time.monotonic()
        t_submit = self._submit_t.pop(req.rid)
        t_first = self._first_tok_t.pop(req.rid, now)
        self.metrics.requests.append(RequestMetrics(
            rid=req.rid, prompt_len=req.prompt_len,
            new_tokens=len(req.out_tokens),
            ttft_s=t_first - t_submit, latency_s=now - t_submit,
        ))

    def _record_token(self, req: Request, token: int) -> None:
        if req.first_token_step is None:
            self._first_tok_t[req.rid] = time.monotonic()
        self.scheduler.on_token(req, token, self._step)
        self._last_token[req.slot] = token
        if req.phase is Phase.FINISHED:
            self._finish(req)

    @staticmethod
    def _greedy(logits: torch.Tensor) -> np.ndarray:
        """Host-side argmax over the last position (ties -> first index).
        Syncs with the device, so the step's time covers its kernels."""
        return np.argmax(logits[:, -1].to(torch.float32).cpu().numpy(), axis=-1)

    # -- the serve loop ------------------------------------------------------

    @torch.no_grad()
    def tick(self) -> bool:
        """Admit, then execute one scheduler action.  Returns False when no
        work remains."""
        self._admit_once()
        action = self.scheduler.next_action()
        if action is None:
            return self.scheduler.has_work
        self._step += 1
        with self._precision_ctx():
            self._run_action(action)
        self.metrics.peak_blocks_in_use = max(
            self.metrics.peak_blocks_in_use, self.alloc.in_use)
        self.metrics.occupancy_sum += self.alloc.occupancy()
        self.metrics.occupancy_samples += 1
        return True

    def _run_action(self, action) -> None:
        if action[0] == "prefill":
            _, req, chunk = action
            self.tables.ensure(req.slot, req.prefilled + chunk, self.alloc)
            self._sync_tables()
            tokens = torch.from_numpy(
                req.prompt[None, req.prefilled:req.prefilled + chunk].astype(np.int64)
            ).to(self.device)
            self._note_shape(f"chunk{chunk}")
            t_pre = time.monotonic()
            logits, self.state = M.prefill_chunk(
                self.params, self.cfg, self.state, tokens, req.slot)
            _sync(self.device)
            self.metrics.prefill_time_s += time.monotonic() - t_pre
            self.scheduler.on_prefill(req, chunk, self._step)
            self.metrics.prefill_chunks += 1
            self.metrics.prefill_tokens += chunk
            if req.phase is Phase.DECODE:
                # Prompt complete: the chunk's last logits give the first
                # generated token (no separate step for it).
                self._record_token(req, int(self._greedy(logits)[0]))
        else:
            _, reqs = action
            # The step writes at position r.length - 1 (the last recorded
            # token's KV goes in on the step that consumes it), so covering
            # r.length tokens suffices.
            for r in reqs:
                self.tables.ensure(r.slot, r.length, self.alloc)
            self._sync_tables()
            tokens = torch.from_numpy(
                self._last_token[:, None].astype(np.int64)).to(self.device)
            active = np.zeros((self.slots,), bool)
            active[[r.slot for r in reqs]] = True
            self._note_shape("decode")
            t_dec = time.monotonic()
            logits, self.state = M.paged_decode_step(
                self.params, self.cfg, self.state, tokens,
                torch.from_numpy(active).to(self.device))
            next_tok = self._greedy(logits)
            self.metrics.decode_time_s += time.monotonic() - t_dec
            for r in reqs:
                self._record_token(r, int(next_tok[r.slot]))
            self.metrics.decode_steps += 1
            self.metrics.decode_tokens += len(reqs)

    def run(self, max_ticks: Optional[int] = None) -> Dict[int, np.ndarray]:
        """Drive the loop until the queue and all slots drain."""
        ticks = 0
        while self.scheduler.has_work:
            if max_ticks is not None and ticks >= max_ticks:
                break
            if not self.tick():
                break
            ticks += 1
        return self.results
