"""Serving engine: warmup, request lifecycle, metrics (port of
repro/serving/engine.py).

Continuous batching over the paged decode state:

  * `warmup()` runs every step shape the server can execute — the decode
    step, each power-of-two prefill-chunk bucket, the slot reset — once
    before traffic (on the card this builds the kernels, sets their
    attributes and allocates the split-K scratch), then, on the card,
    captures each shape as a CUDA graph, the counterpart of the
    reference's jit-compiled steps, and returns the state to its fresh
    contents in place.
  * every step reads its inputs from static buffers and updates the state
    in place, so no tensor a graph reads ever moves.  Serving fills the
    buffers, replays the shape's graph and reads back only the greedy
    token ids, taken on the device.  `graphs=False` runs the same steps
    eagerly on the card; the CPU always runs them eagerly.
  * chunked prefill interleaves with decode; prefill work is proportional
    to real prompt tokens (serving/prefill.py).
  * the paged KV cache hands finished slots' blocks to the next request.

    eng = Engine(cfg, slots=4, max_seq=256)      # device="cuda" by default
    eng.warmup()                                  # captures the step graphs;
                                                  # precision="w8a8" quantizes here
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

Beyond greedy decoding, four switches, as in the reference:

  * `speculative` (False, True, a draft length k or a `SpecConfig`): the
    n-gram drafter proposes up to k tokens per request per tick and one
    verify step scores them all at M = slots x S, S in
    `verify_buckets(k)`; blocks drawn for rejected positions are rewound.
    Greedy tokens are identical with it on or off.
  * `sampling`: warm the sampling shapes (`decode_sample`, `sample1`, and
    with speculation `verify_sample{S}`).  Temperature / top-k / top-p run
    on the device from a per-request seeded stream (models/model.py).  An
    all-greedy batch always takes the greedy steps, so greedy traffic is
    bitwise the same whatever the switch says; a sampled request on an
    engine without it costs one cold step.
  * `preempt`: an arrival of a better class swaps a decoding request of a
    lower class out to host memory and restores it on re-admission.
  * `prefix_cache` (True, or a bound on cached blocks): prompts sharing full,
    block-aligned prefixes fork the blocks already written
    (cluster/prefix_cache.py) and prefill only the rest.

On the card each step shape these switches add is captured at warmup too.
The verify steps read (slots, S) tokens, the active mask, the per-slot
limits and eos ids (and the sampling knobs) from static buffers and return
their tokens and accepted counts in one tensor, read back in one copy; the
lengths advance on the device.  The prefill chunks leave their last
position's logits in a static buffer that `sample1` samples a sampled
request's first token from.  Swap-in, the prefix seed and the restored
lengths write the state in place.

Not ported yet: tracing and MFU gauges, and `share_steps_from` (a graph
reads one engine's buffers).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch import quant
from repro_torch.kernels import launches, ops
from repro_torch.models import model as M, ssm
from repro_torch.serving import kv_cache as kvc
from repro_torch.serving.prefill import chunk_buckets
from repro_torch.serving.request import RequestSpec, priority_rank
from repro_torch.serving.scheduler import Phase, Request, Scheduler
from repro_torch.serving.speculative import (NgramDrafter, bucket_for,
                                             coerce_spec, verify_buckets)


_KNOBS = ("temperature", "top_k", "top_p", "seeds", "gen_idx")
_NP_DTYPES = {torch.float32: np.float32, torch.int64: np.int64}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def greedy_ids(logits: torch.Tensor) -> torch.Tensor:
    """Greedy token ids of the last position, on the logits' device:
    (B, S, vocab) -> (B,) int64.  `torch.argmax` returns the first maximal
    index, as `np.argmax` does; on bf16 logits it picks the index their
    exact f32 upcast would."""
    return torch.argmax(logits[:, -1], dim=-1)


@dataclasses.dataclass
class RequestMetrics:
    rid: int
    prompt_len: int
    new_tokens: int
    ttft_s: float                 # submit -> first generated token
    latency_s: float              # submit -> finish
    cached_tokens: int = 0        # prompt tokens served from a shared prefix
    priority: str = "interactive"
    tenant: str = "default"
    preemptions: int = 0          # times this request was swapped out


@dataclasses.dataclass
class EngineMetrics:
    prefill_chunks: int = 0
    prefill_tokens: int = 0
    prefill_time_s: float = 0.0   # wall clock in prefill-chunk steps (synced)
    decode_steps: int = 0
    decode_tokens: int = 0
    decode_time_s: float = 0.0    # wall clock in decode ticks only (synced)
    aot_steps: int = 0            # step shapes captured (CUDA graphs) or run at warmup
    cold_compiles: int = 0        # steps whose shape warmup did not cover
    capture_time_s: float = 0.0   # wall clock capturing CUDA graphs
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
    state_bytes: int = 0          # per-slot recurrent state bytes across all layers
    prefix_lookups: int = 0       # admissions that consulted the prefix cache
    prefix_hits: int = 0          # admissions seeded from a cached prefix
    prefix_hit_tokens: int = 0    # prompt tokens whose prefill was skipped
    spec_ticks: int = 0           # decode ticks that ran a verify step
    spec_draft_tokens: int = 0    # draft tokens proposed to the verifier
    spec_accepted_tokens: int = 0  # draft tokens verification accepted
    preemptions: int = 0          # decode victims swapped out for a better class
    swap_out_blocks: int = 0      # KV blocks copied to host memory
    swap_in_blocks: int = 0       # KV blocks restored on re-admission
    swap_time_s: float = 0.0      # wall clock in swap-out + restore (synced)
    sampled_tokens: int = 0       # tokens emitted by the sampling head
    peak_queue_depth: int = 0     # admission-queue high-water mark
    requests: List[RequestMetrics] = dataclasses.field(default_factory=list)

    @property
    def mean_occupancy(self) -> float:
        return self.occupancy_sum / max(1, self.occupancy_samples)

    @property
    def throughput_tok_s(self) -> float:
        """Decode throughput over decode-tick time only."""
        return self.decode_tokens / self.decode_time_s if self.decode_time_s else 0.0

    @property
    def prefix_hit_rate(self) -> float:
        return self.prefix_hits / max(1, self.prefix_lookups)

    @property
    def acceptance_rate(self) -> float:
        """Fraction of drafted tokens that survived verification."""
        return self.spec_accepted_tokens / max(1, self.spec_draft_tokens)

    @property
    def decode_tok_per_tick(self) -> float:
        """Committed tokens per decode tick, summed over the slots."""
        return self.decode_tokens / max(1, self.decode_steps)

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
            f"warmed={self.aot_steps} cold_compiles={self.cold_compiles}"
        )
        if self.kv_pool_bytes:
            out += (f" kv_pool={self.kv_pool_bytes / 2**20:.1f}MiB "
                    f"({self.kv_pool_blocks} blk x {self.kv_bytes_per_block / 2**10:.1f}KiB, "
                    f"{self.kv_precision}) "
                    f"slots@max_seq={self.kv_slot_capacity}")
        if self.state_bytes:
            out += f" recurrent_state={self.state_bytes / 2**20:.1f}MiB"
        if self.prefix_lookups:
            out += (f" prefix_hits={self.prefix_hits}/{self.prefix_lookups} "
                    f"({self.prefix_hit_tokens} tok reused)")
        if self.spec_ticks:
            out += (f" spec_ticks={self.spec_ticks}/{self.decode_steps} "
                    f"accept={self.acceptance_rate:.0%} "
                    f"tok/tick={self.decode_tok_per_tick:.2f}")
        if self.preemptions:
            out += (f" preemptions={self.preemptions} "
                    f"(swap out={self.swap_out_blocks} blk "
                    f"in={self.swap_in_blocks} blk "
                    f"{self.swap_time_s * 1e3:.0f}ms)")
        if self.sampled_tokens:
            out += f" sampled={self.sampled_tokens} tok"
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
                 graphs: Optional[bool] = None, speculative=False,
                 sampling: bool = False, preempt: bool = False,
                 prefix_cache=False, verbose: bool = False):
        M.check_paged_family(cfg)      # before any weight is made
        if precision not in quant.MODES:
            raise ValueError(f"unknown precision {precision!r}; known: {quant.MODES}")
        if kv_precision not in ("float", "int8"):
            raise ValueError(
                f"unknown kv_precision {kv_precision!r}; known: float, int8")
        self.precision, self.kv_precision = precision, kv_precision
        self._calib_batches, self._seed = calib_batches, seed
        self.device = resolve_device(device)
        if graphs is None:
            graphs = self.device.type == "cuda"
        elif graphs and self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device; the engine runs on "
                             f"{self.device}")
        self.graphs = bool(graphs)
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

        # Speculative decoding: False/None off, True defaults, an int the
        # draft length k, or a SpecConfig.
        self.spec = coerce_spec(speculative)
        self.drafter = NgramDrafter(self.spec) if self.spec else None
        # Sampling: the switch only decides what warmup captures.
        self.sampling = bool(sampling)
        # KV-swap preemption and the prefix cache hold KV blocks only, so
        # a recurrent layer's state would be lost: attention-only stacks.
        attention_only = all(k in ("attn", "attn_local") for k in cfg.layer_kinds())
        self.preempt = bool(preempt)
        if self.preempt and not attention_only:
            raise ValueError("preempt requires an attention-only stack; "
                             f"{cfg.name} has kinds {cfg.layer_kinds()}")
        self._swapped: Dict[int, tuple] = {}     # rid -> (payload, n_blocks)

        self.scheduler = Scheduler(slots, max_chunk=max_chunk, max_queue=max_queue)
        self.alloc = kvc.BlockAllocator(self.num_blocks, block_size)
        self.tables = kvc.BlockTables(slots, self.max_blocks_per_slot)
        self.prefix_cache = None
        if prefix_cache:
            if not attention_only:
                raise ValueError("prefix_cache requires an attention-only stack; "
                                 f"{cfg.name} has kinds {cfg.layer_kinds()}")
            from repro_torch.cluster.prefix_cache import PrefixCache

            # True: unbounded (pool pressure evicts); an int: at most that
            # many cached blocks.
            bound = None if prefix_cache is True else int(prefix_cache)
            self.prefix_cache = PrefixCache(self.alloc, max_blocks=bound)
        self._prefix_match: Dict[int, tuple] = {}  # rid -> (blocks, toks, fresh)
        self._seeded: Dict[int, int] = {}          # rid -> forked block count
        # Allocated once: the steps update it in place, never rebind it.
        self.state = M.init_paged_decode_state(
            self.cfg, self.slots, num_blocks=self.num_blocks,
            block_size=self.block_size,
            max_blocks_per_slot=self.max_blocks_per_slot, device=self.device,
            kv_precision=self.kv_precision)
        self.metrics = EngineMetrics(kv_precision=kv_precision)
        self._account_kv_pools()
        # The steps' static inputs, filled with copy_ before each step.
        dev = self.device
        self._tokens = torch.zeros((slots, 1), dtype=torch.int64, device=dev)
        self._active = torch.zeros((slots,), dtype=torch.bool, device=dev)
        self._chunk_tokens: Dict[int, torch.Tensor] = {}   # C -> (1, C) int64
        self._slot = torch.zeros((1,), dtype=torch.int64, device=dev)
        self._reset_mask = torch.zeros((slots,), dtype=torch.bool, device=dev)
        # The verify steps' tokens, one buffer per width S, and the per-slot
        # limits and eos ids; the sampling knobs per slot, and those of the
        # one request `sample1` samples, from the last chunk's logits.
        self._verify_tokens: Dict[int, torch.Tensor] = {}   # S -> (slots, S)
        self._limits = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self._eos = torch.full((slots,), -1, dtype=torch.int32, device=dev)
        self._knobs = self._knob_buffers(slots)
        self._knobs1 = self._knob_buffers(1)
        self._logits1 = torch.zeros((1, cfg.vocab), dtype=cfg.torch_dtype, device=dev)
        # step shape -> (graph, its ids output); the hand-kernel launches
        # each graph holds, and its replays
        self.step_graphs: Dict[str, Tuple[torch.cuda.CUDAGraph, Optional[torch.Tensor]]] = {}
        self._graph_launches: Dict[str, Dict[str, int]] = {}
        self._replays: Dict[str, int] = {}
        self._graph_backend: Optional[str] = None
        self.graph_pool = None                  # one memory pool for all graphs
        self._warmed: set = set()                # step shapes run so far
        self._slot_used = [False] * slots        # occupied at least once
        self._last_token = np.zeros((slots,), np.int32)
        self._reserved: Dict[int, int] = {}      # rid -> blocks reserved
        self._step = 0
        self._submit_t: Dict[int, float] = {}
        self._first_tok_t: Dict[int, float] = {}
        self.results: Dict[int, np.ndarray] = {}

    def _account_kv_pools(self) -> None:
        """Pool bytes over the attention layers (none in an attention-free
        stack such as xLSTM), their cost per block, the max-length requests
        the pool holds, and the bytes of the recurrent layers' per-slot
        states."""
        m = self.metrics
        pools = [c for c in self.state.caches if isinstance(c, kvc.PagedKVCache)]
        m.kv_pool_bytes = sum(kvc.pool_bytes(c) for c in pools)
        m.state_bytes = sum(ssm.state_bytes(c) for c in self.state.caches
                            if not isinstance(c, kvc.PagedKVCache))
        m.kv_pool_blocks = self.num_blocks
        m.kv_bytes_per_block = m.kv_pool_bytes // self.num_blocks
        m.kv_slot_capacity = (self.num_blocks - 1) // self.max_blocks_per_slot

    # -- warmup ----------------------------------------------------------------

    def warmup(self) -> None:
        """Run every step shape once before traffic — decode, each prefill
        chunk bucket, the slot reset — and on the card capture each as a
        CUDA graph; then return the state to its fresh contents in place
        (the chunk steps advanced slot 0's length and wrote the pools).
        With precision != "float" the weights become int8-resident first,
        so the steps run and captured here are the int8 steps serving runs.

        The eager run comes first: it builds the kernel libraries, makes
        their one-time attribute calls and allocates the split-K scratch,
        none of which may happen inside a capture."""
        if self.precision != "float":
            self._quantize_weights()
        buckets = chunk_buckets(self.max_chunk)
        widths = verify_buckets(self.spec.k) if self.spec else []
        keys = (["decode"] + [f"chunk{c}" for c in buckets]
                + (["decode_sample", "sample1"] if self.sampling else [])
                # widest first: a narrower verify graph reuses the wider
                # one's pool memory (per-position recurrent states)
                + [f"verify{w}" for w in sorted(widths, reverse=True)]
                + ([f"verify_sample{w}" for w in sorted(widths, reverse=True)]
                   if self.sampling else [])
                + ["reset"])
        with torch.no_grad(), self._precision_ctx():
            for key in keys:
                self._step_fn(key)()
                self._warmed.add(key)
            _sync(self.device)
            if self.graphs:
                for key in keys:
                    self._capture(key)
        M.clear_paged_decode_state(self.state)
        _sync(self.device)
        self.metrics.aot_steps = len(self.step_graphs) if self.graphs else len(self._warmed)
        if self.verbose:
            what = "captured as CUDA graphs" if self.graphs else "run"
            extra = (f" + verify {widths}" if widths else "") + (
                " + sampling" if self.sampling else "")
            print(f"warmup: {self.metrics.aot_steps} step shapes {what} "
                  f"(decode + chunks {buckets}{extra} + reset) on {self.device}"
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

    # -- the step shapes ------------------------------------------------------

    def _knob_buffers(self, n: int) -> Dict[str, torch.Tensor]:
        """Static sampling knobs of n rows, as `_KNOBS` names them (top_p
        1, the rest 0: greedy)."""
        return {name: (torch.ones if name == "top_p" else torch.zeros)(
                    (n,), dtype=torch.float32 if name in ("temperature", "top_p")
                    else torch.int64, device=self.device)
                for name in _KNOBS}

    @staticmethod
    def _knob_args(knobs: Dict[str, torch.Tensor]):
        return tuple(knobs[name] for name in _KNOBS)

    def _chunk_buffer(self, c: int) -> torch.Tensor:
        buf = self._chunk_tokens.get(c)
        if buf is None:
            buf = self._chunk_tokens[c] = torch.zeros((1, c), dtype=torch.int64,
                                                      device=self.device)
        return buf

    def _verify_buffer(self, s: int) -> torch.Tensor:
        buf = self._verify_tokens.get(s)
        if buf is None:
            buf = self._verify_tokens[s] = torch.zeros(
                (self.slots, s), dtype=torch.int64, device=self.device)
        return buf

    def _decode_body(self) -> torch.Tensor:
        logits, new = M.paged_decode_step(self.params, self.cfg, self.state,
                                          self._tokens, self._active)
        self.state.lengths.copy_(new.lengths)
        return greedy_ids(logits)

    def _chunk_body(self, c: int) -> torch.Tensor:
        logits, new = M.prefill_chunk(self.params, self.cfg, self.state,
                                      self._chunk_buffer(c), self._slot)
        self.state.lengths.copy_(new.lengths)
        self._logits1.copy_(logits[:, -1])       # for `sample1`
        return greedy_ids(logits)

    def _decode_sample_body(self) -> torch.Tensor:
        ids, new = M.paged_decode_sample_step(
            self.params, self.cfg, self.state, self._tokens, self._active,
            *self._knob_args(self._knobs))
        self.state.lengths.copy_(new.lengths)
        return ids

    def _sample1_body(self) -> torch.Tensor:
        k = self._knobs1
        return M.sample_tokens(self._logits1, k["seeds"], k["gen_idx"],
                               k["temperature"], k["top_k"], k["top_p"])

    def _verify_body(self, s: int, sample: bool) -> torch.Tensor:
        """One verify step of width s: (slots, s + 1) int64, the tokens then
        each slot's committed count, so the host reads both in one copy."""
        args = (self.params, self.cfg, self.state, self._verify_buffer(s),
                self._active, self._limits, self._eos)
        if sample:
            out, n_new, new = M.paged_verify_sample_step(
                *args, *self._knob_args(self._knobs))
        else:
            out, n_new, new = M.paged_verify_step(*args)
        self.state.lengths.copy_(new.lengths)
        return torch.cat([out, n_new.to(out.dtype)[:, None]], dim=1)

    def _reset_body(self) -> None:
        # zeroes the masked slots' lengths and returns their recurrent
        # states to their init in place
        self.state.lengths.copy_(
            M.reset_slots(self.cfg, self.state, self._reset_mask).lengths)

    def _step_fn(self, key: str) -> Callable[[], Optional[torch.Tensor]]:
        """The body of step shape `key` ("decode", "decode_sample",
        "chunk<C>", "sample1", "verify<S>", "verify_sample<S>", "reset"):
        it reads the static inputs, updates the state in place and returns
        its ids on the device (None for the reset)."""
        fixed = {"decode": self._decode_body, "reset": self._reset_body,
                 "decode_sample": self._decode_sample_body,
                 "sample1": self._sample1_body}
        if key in fixed:
            return fixed[key]
        for prefix, sample in (("verify_sample", True), ("verify", False)):
            if key.startswith(prefix):
                s = int(key[len(prefix):])
                return lambda: self._verify_body(s, sample)
        c = int(key[len("chunk"):])
        return lambda: self._chunk_body(c)

    def _capture(self, key: str) -> None:
        """Capture step shape `key` as a CUDA graph in the engine's memory
        pool, under the precision mode the caller entered and the GeMM
        backend in force (both bind here, as the reference binds them at
        trace time), and note the hand-kernel launches the graph holds."""
        backend = ops.get_default_backend()
        if self._graph_backend is None:
            self._graph_backend = backend
        self._check_backend()
        if self.graph_pool is None:
            self.graph_pool = torch.cuda.graph_pool_handle()
        fn = self._step_fn(key)
        before = launches.counts()
        t0 = time.monotonic()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.graph_pool):
            out = fn()
        self.metrics.capture_time_s += time.monotonic() - t0
        after = launches.counts()
        self._graph_launches[key] = {k: after[k] - v for k, v in before.items()
                                     if after[k] != v}
        self.step_graphs[key] = (graph, out)
        self._replays[key] = 0

    def _check_backend(self) -> None:
        backend = ops.get_default_backend()
        if backend != self._graph_backend:
            raise RuntimeError(
                f"the step graphs were captured under the {self._graph_backend!r} "
                f"GeMM backend and the default is now {backend!r}; a graph binds "
                f"its kernels at capture, so build a new engine")

    def _run_step(self, key: str) -> Optional[torch.Tensor]:
        """Run step shape `key` on the filled static inputs: replay its
        graph, or run it eagerly (on the CPU, with graphs=False, and at a
        shape's first use when warmup did not cover it, which counts in
        `cold_compiles` and, on graphs, captures it for its next use).  The
        ids it returns live until the next step."""
        if key in self._warmed and self.graphs:
            self._check_backend()
            graph, out = self.step_graphs[key]
            graph.replay()
            self._replays[key] += 1
            return out
        with torch.no_grad(), self._precision_ctx():
            if key not in self._warmed:
                self.metrics.cold_compiles += 1
                self._warmed.add(key)
                out = self._step_fn(key)()
                if self.graphs:
                    self._capture(key)
                return out
            return self._step_fn(key)()

    def _fill_knobs(self, knobs: Dict[str, torch.Tensor], samp) -> None:
        for name, values in zip(_KNOBS, samp):
            buf = knobs[name]
            buf.copy_(torch.from_numpy(np.asarray(values, _NP_DTYPES[buf.dtype])))

    def step_decode(self, tokens: np.ndarray, active: np.ndarray,
                    samp=None) -> np.ndarray:
        """One decode step for every slot on its last token: tokens and the
        active mask (slots,) -> ids (slots,) on the host, greedy, or drawn
        with the per-slot knobs `samp` (temperature, top_k, top_p, seeds,
        gen_idx).  The active slots' lengths advance by one."""
        self._tokens.copy_(torch.from_numpy(
            np.asarray(tokens, np.int64).reshape(self.slots, 1)))
        self._active.copy_(torch.from_numpy(np.asarray(active, bool)))
        if samp is None:
            return self._run_step("decode").cpu().numpy()
        self._fill_knobs(self._knobs, samp)
        return self._run_step("decode_sample").cpu().numpy()

    def step_verify(self, tokens: np.ndarray, active: np.ndarray,
                    limits: np.ndarray, eos: np.ndarray, samp=None
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """One verify step of width S over tokens (slots, S): (tokens
        (slots, S), committed counts (slots,)) on the host.  The slots'
        lengths advance by their counts on the device."""
        s = tokens.shape[1]
        self._verify_buffer(s).copy_(torch.from_numpy(np.asarray(tokens, np.int64)))
        self._active.copy_(torch.from_numpy(np.asarray(active, bool)))
        self._limits.copy_(torch.from_numpy(np.asarray(limits, np.int32)))
        self._eos.copy_(torch.from_numpy(np.asarray(eos, np.int32)))
        if samp is None:
            key = f"verify{s}"
        else:
            self._fill_knobs(self._knobs, samp)
            key = f"verify_sample{s}"
        res = self._run_step(key).cpu().numpy()
        return res[:, :s], res[:, s]

    def sample_first(self, req: Request) -> int:
        """A sampled request's first token, from the last prefill chunk's
        logits (the `sample1` step)."""
        sp = req.sampling
        self._fill_knobs(self._knobs1, ([sp.temperature], [sp.top_k], [sp.top_p],
                                        [req.sample_seed], [len(req.out_tokens)]))
        return int(self._run_step("sample1").cpu()[0])

    def step_prefill(self, tokens: np.ndarray, slot: int) -> int:
        """One prefill chunk of `tokens` (C,) into `slot`: the greedy id of
        its last position, on the host.  The slot's length advances by C."""
        c = len(tokens)
        self._chunk_buffer(c).copy_(torch.from_numpy(np.asarray(tokens, np.int64)[None]))
        self._slot.fill_(slot)
        return int(self._run_step(f"chunk{c}").cpu()[0])

    def replayed_launches(self) -> Dict[str, int]:
        """Hand-kernel launches the graph replays made, per launch counter:
        the sum over step shapes of replays x the launches captured in the
        shape's graph.  The wrappers' counters see eager calls (and each
        capture once), never a replay."""
        total = dict.fromkeys(launches.COUNTERS, 0)
        for key, n in self._replays.items():
            for name, per in self._graph_launches[key].items():
                total[name] += n * per
        return total

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
        if req.swapped or self.prefix_cache is None:
            # A preempted victim's bytes come back into fresh private
            # blocks: no prefix fork, the full worst-case reservation.
            return self.alloc.can_reserve(need)
        # Prefix path: fork the full blocks of a cached identical prompt
        # prefix and reserve only the fresh worst case; under pool pressure
        # the cache gives blocks back (LRU) before admission is refused.
        # The fork comes first, so an eviction reaching our own match only
        # drops the cache's refs.
        blocks, tokens = self.prefix_cache.lookup(req.prompt)
        if blocks:
            kvc.fork_blocks(self.alloc, blocks)
        n_fresh = need - len(blocks)
        if not self.alloc.can_reserve(n_fresh):
            self.prefix_cache.evict(n_fresh - self.alloc.available)
            if not self.alloc.can_reserve(n_fresh):
                if blocks:
                    self.alloc.free(blocks)     # un-fork: admission refused
                return False
        req.cached_tokens = tokens
        self._prefix_match[req.rid] = (blocks, tokens, n_fresh)
        return True

    def _admit(self) -> None:
        self._admit_once()
        if not self.preempt:
            return
        # While a queued request outranks running decode work, swap the
        # lowest-class, youngest decoding victim out and admit again (at
        # most one slot freed a pass).
        for _ in range(self.slots):
            victim = self._pick_victim()
            if victim is None:
                break
            self._swap_out(victim)
            self._admit_once()

    def _admit_once(self) -> None:
        to_reset, seeds, restores = [], [], []
        for slot, req in self.scheduler.admit(self._can_admit):
            if req.swapped:
                n = kvc.blocks_for(req.prompt_len + req.max_new, self.block_size)
                if not self.alloc.reserve(n):
                    raise RuntimeError(f"reservation of {n} blocks failed post-admit")
                self._reserved[req.rid] = n
                self._seeded[req.rid] = 0       # restored blocks are private
                restores.append((slot, req))
            else:
                blocks, ptoks, n_fresh = self._prefix_match.pop(req.rid, ((), 0, None))
                n = (n_fresh if n_fresh is not None else
                     kvc.blocks_for(req.prompt_len + req.max_new, self.block_size))
                if not self.alloc.reserve(n):   # _can_admit just vouched for this
                    raise RuntimeError(f"reservation of {n} blocks failed post-admit")
                self._reserved[req.rid] = n
                self._seeded[req.rid] = len(blocks)
                if self.prefix_cache is not None:
                    self.metrics.prefix_lookups += 1
                    if blocks:
                        self.metrics.prefix_hits += 1
                        self.metrics.prefix_hit_tokens += ptoks
                        seeds.append((slot, list(blocks), ptoks))
            # A refilled slot needs its length zeroed and its recurrent state
            # returned to its init; a never-used slot is already fresh.
            if self._slot_used[slot]:
                to_reset.append(slot)
            self._slot_used[slot] = True
        if to_reset:
            mask = np.zeros((self.slots,), bool)
            mask[to_reset] = True
            self._reset_mask.copy_(torch.from_numpy(mask))
            self._run_step("reset")
        # The forked prefix goes in after the reset: the slot's table starts
        # with the shared blocks and its length at the block-aligned cached
        # count, so every later write lands past the shared boundary.
        for slot, blocks, ptoks in seeds:
            self.tables.seed(slot, blocks)
            self.state.lengths[slot] = ptoks
        if restores:
            self._restore(restores)

    # -- KV-swap preemption --------------------------------------------------

    def _pick_victim(self) -> Optional[Request]:
        """The decoding request to evict for the queue head: of a strictly
        lower class than the head, the latest submitted first; None when
        there is none (preemption never reorders within a class)."""
        head = self.scheduler.next_queued()
        if head is None:
            return None
        head_rank = priority_rank(head.priority)
        victims = [r for r in self.scheduler.slots
                   if r is not None and r.phase is Phase.DECODE and r.out_tokens
                   and priority_rank(r.priority) > head_rank]
        if not victims:
            return None
        return max(victims, key=lambda r: (priority_rank(r.priority),
                                           r.submit_step, r.rid))

    def _swap_out(self, victim: Request) -> None:
        """Copy the victim's KV blocks to host memory, release its blocks
        and reservation (as `_finish` does) and queue it at the front of
        its class."""
        t0 = time.monotonic()
        slot = victim.slot
        ids = list(self.tables.blocks[slot])
        payload = kvc.swap_out_blocks(self.state.caches, ids)
        self._swapped[victim.rid] = (payload, len(ids))
        # Seeded (forked-prefix) blocks were never reserved.
        fresh = len(ids) - self._seeded.pop(victim.rid, 0)
        unused = max(0, self._reserved.pop(victim.rid, fresh) - fresh)
        self.scheduler.preempt(victim)
        self.tables.release(slot, self.alloc, unreserve=unused)
        _sync(self.device)
        self.metrics.preemptions += 1
        self.metrics.swap_out_blocks += len(ids)
        self.metrics.swap_time_s += time.monotonic() - t0

    def _restore(self, restores) -> None:
        """Write preempted requests' KV back into freshly allocated blocks,
        after the reset step zeroed their slots: the slot's length is one
        behind `req.length` (the newest token is the next step's input, its
        KV written when it is fed), as if never preempted."""
        t0 = time.monotonic()
        for slot, req in restores:
            payload, n_blocks = self._swapped.pop(req.rid)
            ids = self.alloc.alloc(n_blocks)
            self.tables.seed(slot, ids)
            kvc.swap_in_blocks(self.state.caches, ids, payload)
            self.state.lengths[slot] = req.length - 1
            self._last_token[slot] = req.out_tokens[-1]
            req.swapped = False
            self.metrics.swap_in_blocks += n_blocks
        _sync(self.device)
        self.metrics.swap_time_s += time.monotonic() - t0

    def _sync_tables(self) -> None:
        if self.tables.dirty:
            self.tables.copy_to(self.state.block_tables)

    def _finish(self, req: Request) -> None:
        slot = self.scheduler.release(req)
        drawn = len(self.tables.blocks[slot])
        # Seeded (forked-prefix) blocks were never reserved: only the fresh
        # draws count against the reservation.
        fresh_drawn = drawn - self._seeded.pop(req.rid, 0)
        unused = max(0, self._reserved.pop(req.rid, fresh_drawn) - fresh_drawn)
        self.tables.release(slot, self.alloc, unreserve=unused)
        self.results[req.rid] = np.asarray(req.out_tokens, np.int32)
        if self.drafter is not None:
            # The committed stream goes into the drafter's corpus: a repeat
            # of this request regenerates it, and its drafts are then the
            # true continuation.
            self.drafter.remember(np.concatenate([req.prompt, self.results[req.rid]]))
        now = time.monotonic()
        t_submit = self._submit_t.pop(req.rid)
        t_first = self._first_tok_t.pop(req.rid, now)
        self.metrics.requests.append(RequestMetrics(
            rid=req.rid, prompt_len=req.prompt_len,
            new_tokens=len(req.out_tokens),
            ttft_s=t_first - t_submit, latency_s=now - t_submit,
            cached_tokens=req.cached_tokens, priority=req.priority,
            tenant=req.tenant, preemptions=req.preemptions,
        ))

    def _sampling_args(self, reqs: List[Request]):
        """Per-slot sampling knobs of a decode or verify batch, or None when
        every request in it is greedy (the greedy steps then run, so greedy
        traffic is bitwise the same with or without sampling).  Greedy rows
        of a mixed batch get temperature 0 and emit argmax."""
        if all(r.sampling.is_greedy for r in reqs):
            return None
        temp = np.zeros((self.slots,), np.float32)
        top_k = np.zeros((self.slots,), np.int64)
        top_p = np.ones((self.slots,), np.float32)
        seeds = np.zeros((self.slots,), np.int64)
        gen_idx = np.zeros((self.slots,), np.int64)
        for r in reqs:
            sp = r.sampling
            temp[r.slot] = max(sp.temperature, 0.0)
            top_k[r.slot] = sp.top_k
            top_p[r.slot] = sp.top_p
            seeds[r.slot] = r.sample_seed
            gen_idx[r.slot] = len(r.out_tokens)
        return temp, top_k, top_p, seeds, gen_idx

    def _record_token(self, req: Request, token: int) -> None:
        if req.first_token_step is None:
            self._first_tok_t[req.rid] = time.monotonic()
        self.scheduler.on_token(req, token, self._step)
        self._last_token[req.slot] = token
        if req.phase is Phase.FINISHED:
            self._finish(req)

    # -- the serve loop ------------------------------------------------------

    @torch.no_grad()
    def tick(self) -> bool:
        """Admit, then execute one scheduler action.  Returns False when no
        work remains."""
        self._admit()
        self.metrics.peak_queue_depth = self.scheduler.peak_queue_depth
        action = self.scheduler.next_action()
        if action is None:
            return self.scheduler.has_work
        self._step += 1
        self._run_action(action)
        self.metrics.peak_blocks_in_use = max(
            self.metrics.peak_blocks_in_use, self.alloc.in_use)
        self.metrics.occupancy_sum += self.alloc.occupancy()
        self.metrics.occupancy_samples += 1
        return True

    def _run_action(self, action) -> None:
        """Fill the step's inputs, replay it (or run it eagerly) and read
        back its ids; the step times span the three, the read-back being
        the device sync."""
        if action[0] == "prefill":
            self._prefill(*action[1:])
        elif self.spec is None or not self._decode_speculative(action[1]):
            self._decode(action[1])

    def _prefill(self, req: Request, chunk: int) -> None:
        self.tables.ensure(req.slot, req.prefilled + chunk, self.alloc)
        self._sync_tables()
        t_pre = time.monotonic()
        token = self.step_prefill(
            req.prompt[req.prefilled:req.prefilled + chunk], req.slot)
        self.metrics.prefill_time_s += time.monotonic() - t_pre
        self.scheduler.on_prefill(req, chunk, self._step)
        self.metrics.prefill_chunks += 1
        self.metrics.prefill_tokens += chunk
        if req.phase is not Phase.DECODE:
            return
        if self.prefix_cache is not None:
            # The prompt is in the pool: publish its full blocks (the cache
            # takes its own refs; the partial tail keeps receiving writes).
            n_full = req.prompt_len // self.block_size
            if n_full:
                self.prefix_cache.insert(req.prompt[:n_full * self.block_size],
                                         self.tables.blocks[req.slot][:n_full])
        # The chunk's last logits give the first generated token.
        if not req.sampling.is_greedy:
            token = self.sample_first(req)
            self.metrics.sampled_tokens += 1
        self._record_token(req, token)

    def _decode(self, reqs: List[Request]) -> None:
        # The step writes at position r.length - 1 (the last recorded
        # token's KV goes in on the step that consumes it), so covering
        # r.length tokens suffices.
        for r in reqs:
            self.tables.ensure(r.slot, r.length, self.alloc)
        self._sync_tables()
        active = np.zeros((self.slots,), bool)
        active[[r.slot for r in reqs]] = True
        samp = self._sampling_args(reqs)
        t_dec = time.monotonic()
        next_tok = self.step_decode(self._last_token, active, samp)
        self.metrics.decode_time_s += time.monotonic() - t_dec
        for r in reqs:
            self._record_token(r, int(next_tok[r.slot]))
        self.metrics.decode_steps += 1
        self.metrics.decode_tokens += len(reqs)
        if samp is not None:
            self.metrics.sampled_tokens += len(reqs)

    def _decode_speculative(self, reqs: List[Request]) -> bool:
        """One speculative decode tick: the drafter proposes per-request
        continuations, one verify step scores every drafted position, and
        blocks drawn for rejected positions are rewound.  Returns False,
        touching nothing, when no request drafted anything (the plain
        decode step runs instead)."""
        drafts: Dict[int, np.ndarray] = {}
        for r in reqs:
            if r.remaining > 1:
                # The bonus token always rides along, so a request can use
                # at most remaining - 1 drafts.
                d = self.drafter.draft(r.context, k=min(self.spec.k, r.remaining - 1))
                if len(d):
                    drafts[r.rid] = d
        if not drafts:
            return False
        width = bucket_for(max(len(d) for d in drafts.values()), self.spec.k)
        tokens = np.zeros((self.slots, width), np.int64)
        limits = np.zeros((self.slots,), np.int32)
        eos = np.full((self.slots,), -1, np.int32)
        active = np.zeros((self.slots,), bool)
        for r in reqs:
            d = drafts.get(r.rid, ())
            # Real draft positions need covered blocks (writes at
            # r.length - 1 ..); padding past the table goes to the null block.
            self.tables.ensure(r.slot, r.length + len(d), self.alloc)
            tokens[r.slot, 0] = self._last_token[r.slot]
            tokens[r.slot, 1:1 + len(d)] = d
            limits[r.slot] = min(len(d) + 1, r.remaining)
            eos[r.slot] = -1 if r.eos_token is None else r.eos_token
            active[r.slot] = True
        self._sync_tables()
        samp = self._sampling_args(reqs)
        t_dec = time.monotonic()
        out, n_new = self.step_verify(tokens, active, limits, eos, samp)
        self.metrics.decode_time_s += time.monotonic() - t_dec
        emitted = 0
        for r in reqs:
            slot, n = r.slot, int(n_new[r.slot])
            drafted = len(drafts.get(r.rid, ()))
            self.scheduler.on_spec(r, drafted, max(0, n - 1))
            self.metrics.spec_draft_tokens += drafted
            self.metrics.spec_accepted_tokens += max(0, n - 1)
            for t in out[slot, :n]:
                self._record_token(r, int(t))
            emitted += n
            # Blocks drawn for rejected positions go back to the pool and
            # the request's reservation.  A finished request released all.
            if r.phase is not Phase.FINISHED and \
                    kvc.blocks_for(r.length, self.block_size) < len(self.tables.blocks[slot]):
                _, pair = self.tables.rewind(slot, r.length, self.alloc)
                # Speculation runs only past the shared-prefix boundary.
                assert pair is None, "a speculative rewind reached a shared block"
        self.metrics.decode_steps += 1
        self.metrics.decode_tokens += emitted
        self.metrics.spec_ticks += 1
        if samp is not None:
            self.metrics.sampled_tokens += emitted
        return True

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
