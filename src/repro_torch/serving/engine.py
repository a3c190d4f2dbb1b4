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

Configuration pre-loading, the paper's first mechanism, is in warmup as in
the reference: with `autotune=True` the tile autotuner (repro_torch.tuning)
first picks the launch plan of every GeMM shape the engine runs (K1, or K6
under the "pipelined" backend; the w8a8 GeMM in w8a8) and K2's split count
(`tune_mode`: "analytic" by the H100 model, or "wallclock" by real
launches on the card), and only then does warmup run and capture the
steps, so every replay runs the tuned plans.  The engine runs every step it
executes or captures under its own tuner and decode plan
(`tuning.scope`): a later change of the process-wide tuner, of
`enable()` / `disable()` or of `flash_decode.set_decode_spec` has no
effect on it (its graphs keep the plans they were captured with, and its
eager steps keep the same ones).  An engine without `autotune` runs under
what was in force when it was built.

Observability, as in the reference: `EngineMetrics` keeps streaming
histograms of TTFT, latency and per-request decode tok/s beside the raw
log (capped by `request_log`), per-phase utilization and MFU on the H100's
peaks (`MfuMeter`), and `as_dict()` for `--metrics-json`.  `trace=True`
records host spans (tick, sched, prefill, decode, verify, draft, reset,
warmup), the requests' lifecycle spans and, with `trace_flow`, one flow
chain per request in a ring buffer (repro_torch.obs).  The spans hold the
step's read-back of its ids, so they time the device step; tracing adds
nothing to what a graph captures.

Several engines on one card (cluster/replica.py runs one thread per
engine) keep apart what a graph bakes in or a step reads process-wide:
  * each engine owns a CUDA stream (`stream`): its inputs' copies, eager
    steps, captures, replays and read-backs all go on it, after what the
    caller's stream queued before the call, and it waits on that stream
    alone (the preemption swaps too), never on the device;
  * each engine owns its split-K scratch (`splitk`, kernels/gemm.py),
    allocated in its first eager step and bound around its steps and
    captures, so its graphs hold its own workspace and tile counters;
  * the tuner and decode plan bind per thread (`tuning.scope`);
  * `share_steps_from(other)` shares what a graph does not bind to one
    engine's buffers: the tuner, its results and the decode plan (it
    raises on another config, slot count, precision or step shape).  Each
    engine still captures its own graphs, which read its own buffers;
  * `capture_cold = False` (set by `ReplicaPool.start`) runs a shape
    warmup did not cover eagerly, counted in `cold_compiles`, and never
    captures it: a capture in the middle of serving would stall, and fail,
    the other engines' work on the card.
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
from repro_torch import tuning
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import gemm as _gemm
from repro_torch.kernels import launches, ops
from repro_torch.models import model as M, ssm
from repro_torch.obs import Histogram, MfuMeter, NULL_TRACER, Tracer
from repro_torch.obs import percentile
from repro_torch.serving import kv_cache as kvc
from repro_torch.serving.prefill import chunk_buckets
from repro_torch.serving.request import RequestSpec, as_spec, priority_rank
from repro_torch.serving.scheduler import Phase, Request, Scheduler
from repro_torch.serving.speculative import (NgramDrafter, bucket_for,
                                             coerce_spec, verify_buckets)


_KNOBS = ("temperature", "top_k", "top_p", "seeds", "gen_idx")
_NP_DTYPES = {torch.float32: np.float32, torch.int64: np.int64}


# ---------------------------------------------------------------------------
# warmup shape extraction (tile autotuning, configuration pre-loading)
# ---------------------------------------------------------------------------

def serving_gemm_shapes(cfg, *, slots: int, chunks: Optional[List[int]] = None
                        ) -> List[tuning.GemmShape]:
    """The per-step dense-projection GeMMs of the serving path, the shapes to
    pre-tune: per attention layer the q / k / v and output projections, for
    dense-FFN archs the two FFN matmuls, and the vocab head, over `slots`
    rows (decode) and each chunk bucket's rows (prefill).  MoE experts and
    the recurrences are not among them, as in the reference; a stack with
    no FFN (xLSTM, d_ff 0) has no FFN shape, where the reference's list
    raises on it."""
    d, ff, vocab = cfg.d_model, cfg.d_ff, cfg.vocab
    hd = cfg.resolved_head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    G = tuning.GemmShape
    shapes = []
    for m in [slots] + list(chunks or []):
        if cfg.family != "ssm":          # archs with attention layers
            shapes += [G(m, d, hq * hd), G(m, d, hkv * hd), G(m, hq * hd, d)]
        if cfg.moe is None and ff:       # dense FFN (xLSTM's blocks have none)
            shapes += [G(m, d, ff), G(m, ff, d)]
        shapes.append(G(m, d, vocab))    # LM head
    return list(dict.fromkeys(shapes))


def autotune_for_serving(cfg, *, slots: int, mode: str = "analytic",
                         chunks: Optional[List[int]] = None,
                         dtype: Optional[str] = None, backend: str = "tiled",
                         device=None, tuner: Optional[tuning.Autotuner] = None,
                         verbose: bool = True) -> List[Tuple[tuning.GemmShape, tuning.TuneResult]]:
    """Tune this model's GeMM shapes, install the tuner and enable tuned
    dispatch (as the reference does); returns (shape, result) per distinct
    plan key, the decode shape's first.  Up to 64 rows a plan is keyed
    without M, so it is tuned at the decode M (`slots`) and serves every
    chunk bucket.  `dtype` / `backend` select the candidate space: a w8a8
    engine tunes the w8a8 GeMM ("int8", "w8a8")."""
    tuner = tuner or tuning.Autotuner(mode=mode, device=device)
    tuning.set_tuner(tuner)
    dtype = dtype or cfg.dtype
    kmajor = {tuning.GemmShape(m, cfg.d_model, cfg.vocab)
              for m in [slots] + list(chunks or [])} if cfg.tie_embeddings else set()
    out, seen = [], set()
    for s in serving_gemm_shapes(cfg, slots=slots, chunks=chunks):
        key = tuner.key(s, dtype, backend, kmajor=s in kmajor)
        if key in seen:
            continue
        seen.add(key)
        r = tuner.tune(s, dtype, backend=backend, kmajor=s in kmajor)
        out.append((s, r))
        if verbose:
            p = r.spec
            plan = (f"splits={p.splits} tile={16 if p.swap and s.M <= 16 else 64}"
                    + (f" depth={p.depth}" if backend == "pipelined" else "")
                    + (f" {'one launch' if p.fused else 'two launches'}"
                       if backend == "w8a8" and s.M <= 16 else ""))
            how = "cache" if r.from_cache else r.source
            rule = "" if r.rule_score is None else f" (rule {r.rule_score * 1e6:.1f} us)"
            print(f"  {s.M}x{s.K}x{s.N}: {plan} [{how}] {r.score * 1e6:.1f} us{rule}")
    if verbose:
        print(f"autotune[{mode}]: {len(out)} GeMM plans for {cfg.name} ({dtype}/{backend})")
    tuning.enable()
    return out


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
    queue_steps: int = 0          # engine ticks before the first token
    cached_tokens: int = 0        # prompt tokens served from a shared prefix
    priority: str = "interactive"
    tenant: str = "default"
    preemptions: int = 0          # times this request was swapped out

    @property
    def decode_tok_s(self) -> float:
        """Per-request decode rate: tokens after the first over the time
        after the first (the first token falls out of the last prefill
        chunk, so it belongs to TTFT, not decode)."""
        span = self.latency_s - self.ttft_s
        return (self.new_tokens - 1) / span if span > 0 else 0.0


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
    elapsed_s: float = 0.0        # wall clock inside run()
    requests: List[RequestMetrics] = dataclasses.field(default_factory=list)
    # Streaming percentile sketches (repro_torch.obs.hist), fed on every
    # finish and bounded however long the engine lives.  The raw `requests`
    # log may be capped (Engine(request_log=N)); once entries are dropped
    # the histograms are the percentiles' source.
    requests_dropped: int = 0
    ttft_hist: Histogram = dataclasses.field(default_factory=Histogram)
    latency_hist: Histogram = dataclasses.field(default_factory=Histogram)
    tok_s_hist: Histogram = dataclasses.field(default_factory=Histogram)
    # Live utilization gauges (repro_torch.obs.mfu), installed by the engine.
    mfu: Optional[MfuMeter] = None

    def note_request(self, rm: RequestMetrics,
                     log_limit: Optional[int] = None) -> None:
        """Record one finished request: feed the histograms and append to
        the raw log, trimming it to `log_limit` entries (oldest first)."""
        self.ttft_hist.add(rm.ttft_s)
        self.latency_hist.add(rm.latency_s)
        self.tok_s_hist.add(rm.decode_tok_s)
        self.requests.append(rm)
        if log_limit is not None and len(self.requests) > log_limit:
            drop = len(self.requests) - log_limit
            del self.requests[:drop]
            self.requests_dropped += drop

    @property
    def finished_requests(self) -> int:
        """Requests finished: the raw log's length plus the trimmed ones."""
        return len(self.requests) + self.requests_dropped

    def _percentile(self, attr: str, hist: Histogram, q: float) -> float:
        """Nearest-rank percentile: exact over the raw log while it is
        complete, from the histogram (within its rel_error) once entries
        were dropped."""
        if self.requests and not self.requests_dropped:
            return percentile([getattr(r, attr) for r in self.requests], q)
        return hist.percentile(q)

    def ttft_percentile(self, q: float) -> float:
        return self._percentile("ttft_s", self.ttft_hist, q)

    def latency_percentile(self, q: float) -> float:
        return self._percentile("latency_s", self.latency_hist, q)

    def decode_tok_s_percentile(self, q: float) -> float:
        return self._percentile("decode_tok_s", self.tok_s_hist, q)

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
        if self.requests and not self.requests_dropped:
            ttft = np.mean([r.ttft_s for r in self.requests])
            lat = np.mean([r.latency_s for r in self.requests])
        else:
            ttft, lat = self.ttft_hist.mean, self.latency_hist.mean
        out = (
            f"requests={self.finished_requests} prefill_chunks={self.prefill_chunks} "
            f"prefill_tokens={self.prefill_tokens} "
            f"decode_steps={self.decode_steps} "
            f"decode={self.decode_tokens} tok ({self.throughput_tok_s:.1f} tok/s) "
            f"ttft={ttft * 1e3:.0f}ms "
            f"(p50={self.ttft_percentile(50) * 1e3:.0f}ms "
            f"p95={self.ttft_percentile(95) * 1e3:.0f}ms) "
            f"latency={lat * 1e3:.0f}ms "
            f"req_tok_s_p50={self.decode_tok_s_percentile(50):.1f} "
            f"p95={self.decode_tok_s_percentile(95):.1f} "
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
        if self.mfu is not None:
            frag = self.mfu.summary()
            if frag:
                out += " " + frag
        return out

    def as_dict(self) -> dict:
        """JSON-serializable snapshot (launch/serve.py --metrics-json): the
        reference's gauges, percentiles and per-phase utilization / MFU,
        plus the port's capture and pool figures."""
        return {
            "requests": self.finished_requests,
            "requests_dropped_from_log": self.requests_dropped,
            "prefill_chunks": self.prefill_chunks,
            "prefill_tokens": self.prefill_tokens,
            "prefill_time_s": self.prefill_time_s,
            "decode_steps": self.decode_steps,
            "decode_tokens": self.decode_tokens,
            "decode_time_s": self.decode_time_s,
            "throughput_tok_s": self.throughput_tok_s,
            "ttft_p50_s": self.ttft_percentile(50),
            "ttft_p95_s": self.ttft_percentile(95),
            "latency_p50_s": self.latency_percentile(50),
            "latency_p95_s": self.latency_percentile(95),
            "req_tok_s_p50": self.decode_tok_s_percentile(50),
            "req_tok_s_p95": self.decode_tok_s_percentile(95),
            "mean_occupancy": self.mean_occupancy,
            "peak_blocks_in_use": self.peak_blocks_in_use,
            "peak_queue_depth": self.peak_queue_depth,
            "precision": self.precision,
            "kv_precision": self.kv_precision,
            "kv_pool_bytes": self.kv_pool_bytes,
            "state_bytes": self.state_bytes,
            "prefix_hits": self.prefix_hits,
            "prefix_lookups": self.prefix_lookups,
            "spec_ticks": self.spec_ticks,
            "acceptance_rate": self.acceptance_rate,
            "preemptions": self.preemptions,
            "swap_out_blocks": self.swap_out_blocks,
            "swap_in_blocks": self.swap_in_blocks,
            "swap_time_s": self.swap_time_s,
            "sampled_tokens": self.sampled_tokens,
            "aot_steps": self.aot_steps,
            "cold_compiles": self.cold_compiles,
            "capture_time_s": self.capture_time_s,
            "ttft_hist": self.ttft_hist.to_dict(),
            "latency_hist": self.latency_hist.to_dict(),
            "tok_s_hist": self.tok_s_hist.to_dict(),
            "mfu": self.mfu.as_dict() if self.mfu is not None else None,
        }


class Engine:
    """Continuous-batching serving engine over the paged decode state."""

    def __init__(self, cfg, params=None, *, slots: int = 4, max_seq: int = 256,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 max_chunk: int = 64, max_queue: Optional[int] = None,
                 precision: str = "float", kv_precision: str = "float",
                 calib_batches=None, seed: int = 0, device=None,
                 graphs: Optional[bool] = None, speculative=False,
                 sampling: bool = False, preempt: bool = False,
                 prefix_cache=False, autotune: bool = False,
                 tune_mode: str = "analytic", trace=False, trace_flow: bool = True,
                 request_log: Optional[int] = None, verbose: bool = False):
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
        # The tile autotuner (tuning/): with `autotune`, warmup tunes the
        # launch plans before it runs or captures a step.  Until then, and
        # without it, the steps run under what is in force now.
        if tune_mode not in ("analytic", "wallclock"):
            raise ValueError(f"unknown tune_mode {tune_mode!r}; known: analytic, wallclock")
        if autotune and tune_mode == "wallclock" and self.device.type != "cuda":
            raise ValueError(f"wall-clock tuning times the kernels on the card; the "
                             f"engine runs on {self.device}")
        self.autotune, self.tune_mode = bool(autotune), tune_mode
        self.tuner: Optional[tuning.Autotuner] = (
            tuning.get_tuner() if tuning.is_enabled() else None)
        self.decode_spec = _fd.get_decode_spec()
        self.tune_results: List[Tuple[tuning.GemmShape, tuning.TuneResult]] = []
        self.decode_tune_result: Optional[tuning.TuneResult] = None

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
        # Live utilization gauges: a few float adds per step, always on.
        self.mfu = MfuMeter(cfg)
        self.metrics.mfu = self.mfu
        # Raw request-log cap: None keeps every RequestMetrics; an int bounds
        # the log and moves the percentiles onto the histograms.
        self._request_log = request_log
        # Span/event tracing: off by default (NULL_TRACER's calls do
        # nothing).  True makes a ring; a Tracer aggregates several engines.
        if isinstance(trace, Tracer):
            self.tracer = trace
        elif trace:
            self.tracer = Tracer(name=f"engine[{cfg.name}]")
        else:
            self.tracer = NULL_TRACER
        tc = self.tracer.intern
        self._ev_tick = tc("tick")
        self._ev_sched = tc("sched")
        self._ev_prefill = tc("prefill")
        self._ev_decode = tc("decode")
        self._ev_verify = tc("verify")
        self._ev_draft = tc("draft")
        self._ev_reset = tc("reset")
        self._ev_warmup = tc("warmup")
        self._ev_kv_in_use = tc("kv_blocks_in_use")
        self._ev_kv_reserved = tc("kv_blocks_reserved")
        self._ev_queue = tc("queue_depth")
        self._ev_req_queued = tc("queued")
        self._ev_req_prefill = tc("req_prefill")
        self._ev_req_decode = tc("req_decode")
        # Request flows (cross-lane arrows and annotated instants) on top of
        # the spans; trace_flow=False keeps the spans only.
        self._flow = bool(trace_flow) and self.tracer.enabled
        self._ev_submit = tc("submit")
        self._ev_flow = tc("req")            # one flow chain per request
        self._ev_shed = tc("shed")
        self._ev_prefix_hit = tc("prefix_hit")
        self._ev_evict = tc("cache_evict")
        self._ev_preempt = tc("preempt")
        self._ev_restore = tc("restore")
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
        # What the engine owns on the card so that engines on other threads
        # never share it: its stream (which first waits for the weights,
        # state and buffers made on the current one) and its split-K scratch.
        self.splitk = _gemm.SplitKScratch()
        self.stream = None
        if self.device.type == "cuda":
            self.stream = torch.cuda.Stream(self.device)
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
        self.capture_cold = True       # capture an uncovered shape at first use

    def _on_stream(self):
        """The engine's work goes on its own stream (a no-op on the CPU),
        after what the caller's stream has queued so far: a write the
        caller made there (to the state, say) lands before the step reads.
        A caller already on the engine's stream (a replica's thread, a
        nested entry) waits on nothing."""
        if self.stream is not None:
            caller = torch.cuda.current_stream(self.device)
            if caller != self.stream:
                self.stream.wait_stream(caller)
        return torch.cuda.stream(self.stream)

    def _sync(self) -> None:
        """Wait for the engine's stream, never the whole device."""
        if self.stream is not None:
            self.stream.synchronize()

    def share_steps_from(self, other: "Engine") -> None:
        """Serve under `other`'s launch plans: its tuner, tune results and
        decode plan, so this engine's warmup tunes nothing.  A CUDA graph
        reads one engine's buffers, so the graphs are not shared: each
        engine captures its own under the same plans.  Raises unless
        `other` is warm and the two run the same config, slot count,
        precisions and step shapes."""
        for name in ("cfg", "slots", "precision", "kv_precision", "max_seq",
                     "block_size", "max_chunk"):
            if getattr(self, name) != getattr(other, name):
                raise ValueError(f"share_steps_from: {name} {getattr(self, name)!r} "
                                 f"!= {getattr(other, name)!r}")
        if self.device.type != other.device.type:
            raise ValueError(f"share_steps_from: a {self.device.type} engine cannot "
                             f"serve under a {other.device.type} engine's plans")
        if not other._warmed:
            raise RuntimeError("warm up the engine whose steps this one shares first")
        self.tuner, self.decode_spec = other.tuner, other.decode_spec
        self.tune_results = other.tune_results
        self.decode_tune_result = other.decode_tune_result
        self.autotune = False

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
        none of which may happen inside a capture.  With `autotune` the
        launch plans are tuned before all of it (`_autotune`), so the eager
        run and every capture take the tuned plans.  All of it goes on the
        engine's stream."""
        with self._on_stream():
            self._warmup()

    def _warmup(self) -> None:
        self.tracer.begin(self._ev_warmup)
        if self.autotune:
            self._autotune()
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
        with torch.no_grad(), self._step_ctx():
            for key in keys:
                self._step_fn(key)()
                self._warmed.add(key)
            self._sync()
            if self.graphs:
                for key in keys:
                    self._capture(key)
            M.clear_paged_decode_state(self.state)
            self._sync()
        self.metrics.aot_steps = len(self.step_graphs) if self.graphs else len(self._warmed)
        self.tracer.end(self._ev_warmup)
        if self.verbose:
            what = "captured as CUDA graphs" if self.graphs else "run"
            extra = (f" + verify {widths}" if widths else "") + (
                " + sampling" if self.sampling else "")
            print(f"warmup: {self.metrics.aot_steps} step shapes {what} "
                  f"(decode + chunks {buckets}{extra} + reset) on {self.device}"
                  + (f" [{self.precision}]" if self.precision != "float" else ""))

    def _autotune(self) -> None:
        """Configuration pre-loading: tune every GeMM shape's launch plan
        and K2's split count, in `tune_mode`, before any step runs.  The
        engine keeps the tuner and the decode plan and runs its steps under
        them (`_step_ctx`); the process-wide tuner is left as it was."""
        w8a8 = self.precision != "float"
        tuner = tuning.Autotuner(mode=self.tune_mode, device=self.device)
        with tuning.scope(None):
            self.tune_results = autotune_for_serving(
                self.cfg, slots=self.slots, mode=self.tune_mode,
                chunks=chunk_buckets(self.max_chunk), tuner=tuner,
                dtype="int8" if w8a8 else self.cfg.dtype,
                backend="w8a8" if w8a8 else ops.get_default_backend(),
                verbose=self.verbose)
            self.decode_tune_result = tuning.tune_decode_for_serving(
                self.cfg, slots=self.slots, block_size=self.block_size,
                max_blocks=self.max_blocks_per_slot, tuner=tuner,
                kv_precision=self.kv_precision, verbose=self.verbose)
        self.tuner = tuner
        self.decode_spec = (None if self.decode_tune_result is None
                            else self.decode_tune_result.spec)

    def _step_ctx(self):
        """What every eager step and capture runs under: the precision mode
        (PyTorch reads it on each `ops.linear` call, so it is entered around
        every step), the engine's tuner and decode plan (`tuning.scope`) and
        its split-K scratch, all bound for this thread only.  Between steps
        the thread's state is again what it was."""
        stack = contextlib.ExitStack()
        if self.precision != "float":
            stack.enter_context(quant.precision(self.precision))
        stack.enter_context(tuning.scope(self.tuner, self.decode_spec))
        stack.enter_context(_gemm.owned_scratch(self.splitk))
        return stack

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
        pool, on its stream, under the precision mode, plans and split-K
        scratch the caller entered and the GeMM backend in force (all bind
        here, as the reference binds them at trace time), and note the
        hand-kernel launches the graph holds."""
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
        with torch.cuda.graph(graph, pool=self.graph_pool, stream=self.stream):
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
        `cold_compiles` and, on graphs with `capture_cold`, captures it for
        its next use; without, the shape stays eager).  The ids it returns
        live until the next step."""
        if self.graphs and key in self.step_graphs:
            self._check_backend()
            graph, out = self.step_graphs[key]
            graph.replay()
            self._replays[key] += 1
            return out
        with torch.no_grad(), self._step_ctx():
            if key not in self._warmed:
                self.metrics.cold_compiles += 1
                self._warmed.add(key)
                out = self._step_fn(key)()
                if self.graphs and self.capture_cold:
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
        with self._on_stream():
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
        with self._on_stream():
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
        with self._on_stream():
            self._fill_knobs(self._knobs1, ([sp.temperature], [sp.top_k], [sp.top_p],
                                            [req.sample_seed], [len(req.out_tokens)]))
            return int(self._run_step("sample1").cpu()[0])

    def step_prefill(self, tokens: np.ndarray, slot: int) -> int:
        """One prefill chunk of `tokens` (C,) into `slot`: the greedy id of
        its last position, on the host.  The slot's length advances by C."""
        c = len(tokens)
        with self._on_stream():
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

    def submit(self, request, max_new: Optional[int] = None, *,
               eos_token: Optional[int] = None,
               trace_id: Optional[int] = None) -> Optional[Request]:
        """Queue a request, a `RequestSpec` or the legacy `(prompt,
        max_new)` form (`as_spec`); None when the admission queue is full.
        The spec's `trace_id` (or the keyword) threads an id minted outside
        (the cluster router's request id) into the request's flow chain and
        lifecycle spans; without one the engine mints its own, namespaced
        by the tracer's pid so ids never collide across replica lanes."""
        spec = as_spec(request, max_new, eos_token=eos_token, trace_id=trace_id)
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
        tr = self.tracer
        if req is not None:
            req.trace_id = (int(spec.trace_id) if spec.trace_id is not None
                            else (tr.pid << 24) + req.rid)
            self._submit_t[req.rid] = time.monotonic()
            if self._flow:
                # A flow event binds to the slice open at its timestamp, so
                # the chain's first link sits in a tiny "submit" slice (a
                # step when the router already started the chain).
                tr.begin(self._ev_submit)
                if spec.trace_id is None:
                    tr.flow_start(self._ev_flow, req.trace_id)
                else:
                    tr.flow_step(self._ev_flow, req.trace_id)
                tr.end(self._ev_submit)
            tr.async_begin(self._ev_req_queued, req.trace_id)
            tr.counter(self._ev_queue, len(self.scheduler.queue))
        elif self._flow:
            tr.instant(self._ev_shed, len(self.scheduler.queue))
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
            shortfall = n_fresh - self.alloc.available
            if self._flow:
                self.tracer.instant(self._ev_evict, shortfall)
            self.prefix_cache.evict(shortfall)
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
            # The request's queued span ends; its prefill span opens (closed
            # by its last prompt chunk), or a restored victim's decode span
            # reopens.
            self.tracer.async_end(self._ev_req_queued, req.trace_id)
            if req.swapped:
                self.tracer.async_begin(self._ev_req_decode, req.trace_id)
                n = kvc.blocks_for(req.prompt_len + req.max_new, self.block_size)
                if not self.alloc.reserve(n):
                    raise RuntimeError(f"reservation of {n} blocks failed post-admit")
                self._reserved[req.rid] = n
                self._seeded[req.rid] = 0       # restored blocks are private
                restores.append((slot, req))
            else:
                self.tracer.async_begin(self._ev_req_prefill, req.trace_id)
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
                        if self._flow:
                            self.tracer.instant(self._ev_prefix_hit, ptoks)
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
            self.tracer.begin(self._ev_reset)
            self._run_step("reset")
            self.tracer.end(self._ev_reset)
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
        self._sync()
        self.metrics.preemptions += 1
        self.metrics.swap_out_blocks += len(ids)
        self.metrics.swap_time_s += time.monotonic() - t0
        tr = self.tracer
        tr.async_end(self._ev_req_decode, victim.trace_id)
        tr.async_begin(self._ev_req_queued, victim.trace_id)
        if self._flow:
            tr.instant(self._ev_preempt, victim.trace_id)

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
            if self._flow:
                self.tracer.instant(self._ev_restore, req.trace_id)
        self._sync()
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
        self.metrics.note_request(RequestMetrics(
            rid=req.rid, prompt_len=req.prompt_len,
            new_tokens=len(req.out_tokens),
            ttft_s=t_first - t_submit, latency_s=now - t_submit,
            queue_steps=(req.first_token_step or self._step) - req.submit_step,
            cached_tokens=req.cached_tokens, priority=req.priority,
            tenant=req.tenant, preemptions=req.preemptions,
        ), self._request_log)
        if self._flow:
            # Inside the tick slice that finished the request.
            self.tracer.flow_end(self._ev_flow, req.trace_id)
        self.tracer.async_end(self._ev_req_decode, req.trace_id)

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
        """Admit, then execute one scheduler action, on the engine's stream.
        Returns False when no work remains."""
        with self._on_stream():
            return self._tick()

    def _tick(self) -> bool:
        tr = self.tracer
        tr.begin(self._ev_tick)
        tr.begin(self._ev_sched)      # host scheduling: admit + pick action
        self._admit()
        self.metrics.peak_queue_depth = self.scheduler.peak_queue_depth
        action = self.scheduler.next_action()
        tr.end(self._ev_sched)
        if action is None:
            tr.end(self._ev_tick)
            return self.scheduler.has_work
        self._step += 1
        self._run_action(action)
        self.metrics.peak_blocks_in_use = max(
            self.metrics.peak_blocks_in_use, self.alloc.in_use)
        self.metrics.occupancy_sum += self.alloc.occupancy()
        self.metrics.occupancy_samples += 1
        tr.counter(self._ev_kv_in_use, self.alloc.in_use)
        tr.counter(self._ev_kv_reserved, self.alloc.reserved)
        tr.end(self._ev_tick)
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
        tr = self.tracer
        tr.begin(self._ev_prefill)
        if self._flow:
            tr.flow_step(self._ev_flow, req.trace_id)
        t_pre = time.monotonic()
        # the span and the time hold the read-back of the ids: the device step
        token = self.step_prefill(
            req.prompt[req.prefilled:req.prefilled + chunk], req.slot)
        dt_pre = time.monotonic() - t_pre
        tr.end(self._ev_prefill)
        self.metrics.prefill_time_s += dt_pre
        self.mfu.note("prefill", tokens=chunk, rows=chunk, time_s=dt_pre)
        self.scheduler.on_prefill(req, chunk, self._step)
        self.metrics.prefill_chunks += 1
        self.metrics.prefill_tokens += chunk
        if req.phase is not Phase.DECODE:
            return
        # Prompt complete: the prefill span closes, the decode span opens.
        tr.async_end(self._ev_req_prefill, req.trace_id)
        tr.async_begin(self._ev_req_decode, req.trace_id)
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
        tr = self.tracer
        t_dec = time.monotonic()
        tr.begin(self._ev_decode)
        if self._flow:
            for r in reqs:
                tr.flow_step(self._ev_flow, r.trace_id)
        next_tok = self.step_decode(self._last_token, active, samp)
        tr.end(self._ev_decode)
        dt_dec = time.monotonic() - t_dec
        self.metrics.decode_time_s += dt_dec
        # Every slot's row runs (padding included); tokens counts commits.
        self.mfu.note("decode", tokens=len(reqs), rows=self.slots, time_s=dt_dec)
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
        self.tracer.begin(self._ev_draft)     # host-side n-gram lookups
        for r in reqs:
            if r.remaining > 1:
                # The bonus token always rides along, so a request can use
                # at most remaining - 1 drafts.
                d = self.drafter.draft(r.context, k=min(self.spec.k, r.remaining - 1))
                if len(d):
                    drafts[r.rid] = d
        self.tracer.end(self._ev_draft)
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
        self.tracer.begin(self._ev_verify)
        if self._flow:
            for r in reqs:
                self.tracer.flow_step(self._ev_flow, r.trace_id)
        out, n_new = self.step_verify(tokens, active, limits, eos, samp)
        self.tracer.end(self._ev_verify)
        dt_verify = time.monotonic() - t_dec
        self.metrics.decode_time_s += dt_verify
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
        # Verify rows: every slot runs the widened step (padding included).
        self.mfu.note("verify", tokens=emitted, rows=self.slots * width,
                      time_s=dt_verify)
        return True

    def run(self, max_ticks: Optional[int] = None) -> Dict[int, np.ndarray]:
        """Drive the loop until the queue and all slots drain."""
        t0 = time.monotonic()
        ticks = 0
        while self.scheduler.has_work:
            if max_ticks is not None and ticks >= max_ticks:
                break
            if not self.tick():
                break
            ticks += 1
        self.metrics.elapsed_s += time.monotonic() - t0
        return self.results
