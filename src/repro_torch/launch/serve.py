"""Serving launcher: thin CLI over the port's engine (port of the
single-engine path of repro/launch/serve.py).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b --requests 8
  PYTHONPATH=src python -m repro_torch.launch.serve --precision w8a8 --kv-precision int8
  PYTHONPATH=src python -m repro_torch.launch.serve --precision w8a8-calibrated
  PYTHONPATH=src python -m repro_torch.launch.serve --widths published   # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b --widths published
  PYTHONPATH=src python -m repro_torch.launch.serve --speculative --temperature 0.8 \
      --preempt --priority-classes interactive=0.5,batch=0.5 --prefix-cache

  PYTHONPATH=src python -m repro_torch.launch.serve --widths published --compare-prefill
  PYTHONPATH=src python -m repro_torch.launch.serve --widths published --autotune \
      --tune-mode wallclock --trace-out trace.json --metrics-json metrics.json \
      --slo ttft_p95=0.5,latency_p95=2.0 --incident-dir incidents

`--arch` takes any arch the port registers (`configs.list_archs()`): of
the dense family qwen3-14b, mistral-nemo-12b, qwen2.5-14b, gemma3-1b (the
default), bert-base and vit-b-16, and of the recurrent, hybrid and MoE
families xlstm-1.3b, jamba-1.5-large-398b, dbrx-132b and arctic-480b.
whisper-medium and paligemma-3b are registered too, and the engine
refuses them, naming the family, as the reference's does: they decode
through the unpaged `decode_step` only.
`--widths published` sizes the arch's weights first (on the meta device)
and refuses, naming the bytes, when they exceed the card's free memory:
jamba, dbrx and arctic do; xlstm-1.3b (7.4 GB in bf16) does not.

Runs on the CUDA device unless `--device cpu` is given; there the engine
serves through the CUDA graphs its warmup captures.  The prompts are
drawn exactly as the reference CLI draws them (np.random.default_rng(0)),
so with the same weights both print the same tokens.  The model is the
arch's smoke config, as in the reference CLI, or with `--widths
published` the arch at its published widths.  The card needs the latter:
the smoke config's head_dim of 16 is below the decode kernel's smallest
(64).

`--compare-prefill` also times the token-by-token prefill (the unpaged
decode step over the prompts padded to the longest, one position a step;
on the card one CUDA-graph replay a step) against the engine's chunked
prefill on the same prompts, both warmed first, best of 3 interleaved
runs each, and prints both times.

`--speculative` (with `--draft-k`), `--temperature` / `--top-k` /
`--top-p` / `--seed`, `--preempt` with `--priority-classes`, and
`--prefix-cache` switch on the engine's speculative decoding, sampling,
KV-swap preemption and prefix cache, parsed as the reference parses them;
the class of each request is drawn from its own generator (seed 0x5EED),
so labelling never moves the prompt draws.

`--autotune` tunes the launch plans of every GeMM shape and K2's split
count before warmup captures the steps (`--tune-mode analytic` by the H100
model, `wallclock` by timing the kernels on the card; the winners persist
in REPRO_TUNE_CACHE, default ~/.cache/repro-opengemm/torch-tunecache.json).
`--trace-out` writes a Chrome-trace / Perfetto JSON of the run (per-tick
spans, request lifecycles and flow chains), `--metrics-json` the metrics
snapshot (percentile histograms, per-phase utilization and MFU on the
H100's peaks), `--slo` evaluates burn-rate targets after the run, and
`--incident-dir` has the flight recorder write its bundles there, as the
reference's single-engine path does.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List

import numpy as np
import torch

from repro_torch import configs, quant, resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.models import model as M
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import PRIORITIES, RequestSpec, SamplingParams


def _parse_class_mix(spec: str):
    """'interactive=0.7,batch=0.3' -> (('interactive', 0.7), ('batch', 0.3));
    empty -> None (all interactive)."""
    if not spec:
        return None
    mix = []
    for part in spec.split(","):
        name, _, w = part.partition("=")
        name = name.strip()
        if name not in PRIORITIES:
            raise SystemExit(f"--priority-classes: unknown class {name!r}; "
                             f"expected one of {PRIORITIES}")
        mix.append((name, float(w) if w else 1.0))
    return tuple(mix)


def check_weights_fit(cfg, device) -> int:
    """The bytes of `cfg`'s weights, sized on the meta device (nothing is
    allocated); raises when they exceed the free memory of a CUDA
    `device`."""
    need = quant.weight_bytes(M.init_model(cfg, device="meta"))
    device = resolve_device(device)
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        if need > free:
            raise SystemExit(
                f"{cfg.name} at these widths holds {need} bytes ({need / 1e9:.1f} GB) "
                f"of weights; the card has {free} bytes free")
    return need


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def warm_token_by_token(cfg, params, slots: int, max_seq: int):
    """Build the baseline's decode state and run its step once before any
    timed region, the footing `Engine.warmup()` gives the engine; on the
    card then capture the step as a CUDA graph, the counterpart of the
    reference's `jax.jit` (the CPU runs it eager).  Returns (step, state)
    for `token_by_token_prefill`; the state is fresh (the warm step's
    writes are cleared)."""
    device = params["embed"].device
    step = steps_lib.make_serve_step(cfg)
    state = M.init_decode_state(params, cfg, slots, max_seq)
    with torch.no_grad():
        step(params, state, torch.zeros((slots, 1), dtype=torch.int64, device=device))
        _sync(device)
        M.clear_decode_state(state)
        if device.type == "cuda":
            step = steps_lib.GraphedServeStep(cfg, params, state, slots)
    _sync(device)
    return step, state


def token_by_token_prefill(cfg, params, prompts: List[np.ndarray], *,
                           max_seq: int, warmed=None):
    """The pre-engine prefill path, kept as the comparison baseline: pad all
    prompts to the longest and feed them through the decode step one
    position at a time (short prompts burn steps on their padding).

    Pass `warmed` from `warm_token_by_token()` when timing this, so the
    measurement is steady-state dispatch, not the build, capture or state
    allocation; its state is cleared in place first (the reference's
    functional state starts fresh on every call).  Returns (last logits
    (slots, 1, vocab), state, step count)."""
    slots = len(prompts)
    if warmed is None:
        warmed = warm_token_by_token(cfg, params, slots, max_seq)
    step, state = warmed
    device = params["embed"].device
    maxlen = max(len(p) for p in prompts)
    padded = np.zeros((slots, maxlen), np.int64)
    for i, p in enumerate(prompts):
        padded[i, :len(p)] = p
    tokens = torch.from_numpy(padded).to(device)
    last = None
    with torch.no_grad():
        M.clear_decode_state(state)
        for t in range(maxlen):
            last, state = step(params, state, tokens[:, t:t + 1])
        last = last.clone()
    _sync(device)
    return last, state, maxlen


def compare_prefill(cfg, params, prompts: List[np.ndarray], *, slots: int,
                    max_seq: int, block_size: int = 16, num_blocks=None,
                    max_chunk: int = 64, iters: int = 3, device=None):
    """Time the token-by-token prefill against the engine's chunked prefill
    on the same prompts: (t_token_by_token_s, t_chunked_s), each the best
    of `iters` runs, the two interleaved so that load on the host hits
    both alike.  Both are warmed first (`warm_token_by_token`,
    `Engine.warmup`); engine runs after the first refill used slots, as a
    serving engine does.  `params` None: seeded random weights on
    `device`."""
    if params is None:
        params = M.init_model(cfg, seed=0, device=device)
    dev = params["embed"].device
    warmed = warm_token_by_token(cfg, params, slots, max_seq)
    eng = Engine(cfg, params, slots=slots, max_seq=max_seq, block_size=block_size,
                 num_blocks=num_blocks, max_chunk=max_chunk, device=dev)
    eng.warmup()

    def legacy():
        token_by_token_prefill(cfg, params, prompts[:slots], max_seq=max_seq,
                               warmed=warmed)

    def chunked():
        # max_new=1: the first token comes from the last chunk, so a run is
        # prefill alone.
        for p in prompts[:slots]:
            eng.submit(RequestSpec(prompt=p, max_new=1))
        eng.run()

    def timed(fn) -> float:
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        return time.perf_counter() - t0

    t_legacy, t_chunked = float("inf"), float("inf")
    for _ in range(iters):
        t_legacy = min(t_legacy, timed(legacy))
        t_chunked = min(t_chunked, timed(chunked))
    return t_legacy, t_chunked


def report_observability(args, eng) -> None:
    """The run's SLO report, incident bundles, trace and metrics files, as
    the flags ask (the reference's single-engine path)."""
    from repro_torch import obs

    recorder = None
    if args.incident_dir:
        # A storm of one reason writes one bundle a second, not one per event.
        recorder = obs.FlightRecorder(args.incident_dir, min_interval_s=1.0,
                                      metadata={"arch": eng.cfg.name})
        recorder.attach_engine(eng)
    if args.slo:
        report = obs.SloMonitor(obs.parse_slo_spec(args.slo)).observe(
            obs.engine_snapshot(eng))
        print(f"slo: {report.summary()}")
        if recorder is not None:
            recorder.record_breaches(report)
    if recorder is not None:
        recorder.check_engine(eng)
        if recorder.incidents:
            print(f"incidents: {len(recorder.incidents)} bundle(s) -> "
                  + ", ".join(recorder.incidents))
    if args.trace_out:
        doc = obs.write_chrome_trace(args.trace_out, [eng.tracer],
                                     metadata={"arch": eng.cfg.name})
        print(f"trace: {len(doc['traceEvents'])} events -> {args.trace_out} "
              f"(open in https://ui.perfetto.dev)")
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump(eng.metrics.as_dict(), f, indent=2)
        print(f"metrics: {args.metrics_json}")


def main(argv=None, *, params=None):
    """Parse `argv`, serve the generated requests, return the generated
    tokens (requests x gen_len int32).  `params` (port layout) overrides
    the seeded random weights."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b", choices=configs.list_archs())
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--slots", type=int, default=0,
                    help="decode batch slots (default: --requests)")
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--chunk", type=int, default=64,
                    help="max prefill chunk (power-of-two buckets)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV cache block size in tokens")
    ap.add_argument("--kv-blocks", type=int, default=0,
                    help="KV pool blocks (default: worst-case for --slots)")
    ap.add_argument("--precision", default="float",
                    choices=["float", "w8a8", "w8a8-calibrated"],
                    help="execution precision: w8a8 quantizes the weights "
                         "int8-resident at warmup and serves through the int8 "
                         "GeMM (repro_torch.quant); w8a8-calibrated first "
                         "calibrates static activation scales")
    ap.add_argument("--kv-precision", default="float", choices=["float", "int8"],
                    help="KV pool residency: int8 keeps the paged pool int8 "
                         "with per-(block, position, head) scales")
    ap.add_argument("--widths", default="smoke", choices=["smoke", "published"],
                    help="the arch's smoke config (the reference CLI's) or its "
                         "published widths")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda runs the hand-written kernels)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="reuse prefilled KV blocks across requests sharing a "
                         "prompt prefix")
    ap.add_argument("--speculative", action="store_true",
                    help="self-speculative decoding: an n-gram drafter proposes "
                         "tokens and one verify step scores them (greedy tokens "
                         "identical)")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="max drafted tokens per request per tick (with "
                         "--speculative)")
    ap.add_argument("--priority-classes", default="",
                    help="class mix of the generated traffic, e.g. "
                         "'interactive=0.7,batch=0.3' (empty: all interactive)")
    ap.add_argument("--preempt", action="store_true",
                    help="let a better class preempt decoding batch requests: "
                         "the victim's KV blocks swap to host memory and come "
                         "back on re-admission")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0: greedy argmax)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="keep the k most probable tokens (0: off)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (1.0: off)")
    ap.add_argument("--seed", type=int, default=-1,
                    help="sampling seed of every request (-1: each request's id)")
    ap.add_argument("--compare-prefill", action="store_true",
                    help="also time the token-by-token prefill (the unpaged decode "
                         "step) against the engine's chunked prefill")
    ap.add_argument("--autotune", action="store_true",
                    help="tune the GeMMs' launch plans and K2's split count before "
                         "warmup captures the steps")
    ap.add_argument("--tune-mode", default="analytic", choices=["analytic", "wallclock"],
                    help="rank plans by the H100 model or by timing them on the card")
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome-trace/Perfetto JSON of the run (per-request "
                         "lifecycle spans and flow chains, per-tick phases)")
    ap.add_argument("--metrics-json", default="",
                    help="write the metrics snapshot (scalar gauges, percentile "
                         "histograms, per-phase utilization and MFU) as JSON")
    ap.add_argument("--slo", default="",
                    help="SLO spec evaluated after the run, e.g. "
                         "'ttft_p95=0.25,latency_p95=1.0,shed_rate=0.05,mfu_floor=1e-6'")
    ap.add_argument("--incident-dir", default="",
                    help="flight-recorder output directory: SLO breaches and "
                         "allocator / speculation / preemption pressure write JSON "
                         "incident bundles here")
    args = ap.parse_args(argv)

    cfg = configs.get_smoke(args.arch) if args.widths == "smoke" else configs.get(args.arch)
    if params is None:
        check_weights_fit(cfg, args.device)
    sampling = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                              top_p=args.top_p,
                              seed=args.seed if args.seed >= 0 else None)
    class_mix = _parse_class_mix(args.priority_classes)
    slots = args.slots or args.requests
    max_seq = args.prompt_len + args.gen_len + 1
    eng = Engine(cfg, params, slots=slots, max_seq=max_seq,
                 block_size=args.block_size, num_blocks=args.kv_blocks or None,
                 max_chunk=args.chunk, precision=args.precision,
                 kv_precision=args.kv_precision, device=args.device,
                 prefix_cache=args.prefix_cache,
                 speculative=args.draft_k if args.speculative else False,
                 sampling=not sampling.is_greedy, preempt=args.preempt,
                 autotune=args.autotune, tune_mode=args.tune_mode,
                 trace=bool(args.trace_out), verbose=True)
    t0 = time.time()
    eng.warmup()
    t_warm = time.time() - t0

    rng = np.random.default_rng(0)
    prompts = [
        rng.integers(0, cfg.vocab, size=rng.integers(4, args.prompt_len + 1))
        for _ in range(args.requests)
    ]
    crng = np.random.default_rng(0x5EED)
    names = [c for c, _ in (class_mix or ())]
    weights = np.asarray([w for _, w in (class_mix or ())], np.float64)
    if names:
        weights = weights / weights.sum()
    for p in prompts:
        prio = (PRIORITIES[0] if not names
                else names[int(crng.choice(len(names), p=weights))])
        eng.submit(RequestSpec(prompt=p, max_new=args.gen_len, sampling=sampling,
                               priority=prio))
    t0 = time.time()
    results = eng.run()
    t_serve = time.time() - t0

    gen = np.stack([results[rid] for rid in sorted(results)])
    print(f"arch={cfg.name} slots={slots} precision={args.precision} "
          f"kv={args.kv_precision} device={eng.device} "
          f"warmup {t_warm * 1e3:.0f}ms serve {t_serve * 1e3:.0f}ms")
    print(f"engine: {eng.metrics.summary()}")
    print("sample continuations:", gen[:2, :8].tolist())
    report_observability(args, eng)
    if args.compare_prefill:
        t_legacy, t_chunked = compare_prefill(
            cfg, eng.params, prompts, slots=slots, max_seq=max_seq,
            block_size=args.block_size, num_blocks=args.kv_blocks or None,
            max_chunk=args.chunk)
        print(f"prefill: token-by-token {t_legacy * 1e3:.2f}ms vs chunked "
              f"{t_chunked * 1e3:.2f}ms -> {t_legacy / t_chunked:.1f}x speedup")
    return gen


if __name__ == "__main__":
    main()
