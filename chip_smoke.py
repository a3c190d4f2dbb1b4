#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py               # all phases, one card, exit 0 = pass

Phases, in order; any failure exits non-zero:

  1. card name and power limit; build the CUDA kernels from src/ (one nvcc
     per source, all at once) and print the build seconds.
  2. each kernel against its plain PyTorch version on the card, at the
     shapes greedy gemma3-1b serving gives it, with stated tolerances.
  3. the main path at full width: gemma3-1b, 26 layers, bf16, random weights
     from a seeded torch.Generator, served by the continuous-batching
     Engine (8 slots, 12 requests, prompts 200-1100 tokens, 32-64 new
     tokens, chunk 64, block 16).  Launch counters are zeroed just before
     the run and read just after: both kernels must have run, the GeMM
     183 times per prefill chunk and per decode step.
  4. the same weights at full width, depth cut to 6 layers (5 local + 1
     global), float32, served on the card (kernels) and on the CPU (plain
     versions): greedy tokens must be identical.
  5. each kernel timed at its main-path shapes with CUDA events (L2 cold),
     beside its bound, its plain version and the library call.

The line before the card line is the kernels' JSON summary; the last line
is {"ok": true, "device": {...}}.  Exits non-zero, printing no result,
without a CUDA device or without the port package beside this script.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (dense): HBM bytes/s and bf16 / f32 FLOP/s.
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
GEMM_SHAPES = [  # (name, K, N, transposed B view) of one gemma3-1b layer + head
    ("q", 1152, 1024, False), ("k", 1152, 256, False), ("v", 1152, 256, False),
    ("o", 1024, 1152, False), ("gate", 1152, 6912, False),
    ("up", 1152, 6912, False), ("down", 6912, 1152, False),
    ("head", 1152, 262144, True),
]
L2_BYTES = 50e6


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise SystemExit(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"FAIL: {msg}")


def close(got, want, rtol: float, atol: float):
    """(max abs err, max rel err, ok) of got against want, in float32."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ok = bool((err <= atol + rtol * w.abs()).all()) and bool(g.isfinite().all())
    rel = float((err / w.abs().clamp_min(1e-6)).max())
    return float(err.max()), rel, ok


# tolerances, kernel vs plain version on the same inputs
GEMM_TOL = {"float32": (1e-4, 1e-4),      # f32 sums of <= 6912 terms, reordered
            "bfloat16": (2 ** -7, 1e-3)}  # one bf16 ulp of the rounded output
DECODE_TOL = {"float32": (1e-4, 1e-4),    # online softmax over ~1100 keys, reordered
              "bfloat16": (2 ** -7, 2 ** -8)}


def phase_kernels(torch, gemm, fd, kvc):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    worst = {"gemm": 0.0, "flash_decode": 0.0}
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        for M in (8, 64):
            for name, K, N, transposed in GEMM_SHAPES:
                a = torch.randn((M, K), generator=g, device=dev).to(dt)
                b = (torch.randn((N, K) if transposed else (K, N), generator=g,
                                 device=dev) * K ** -0.5).to(dt)
                b = b.t() if transposed else b
                got = gemm.gemm(a, b, out_dtype=dt)
                want = gemm.gemm_plain(a, b, dt)
                rtol, atol = GEMM_TOL[dname]
                abs_e, rel_e, ok = close(got, want, rtol, atol)
                worst["gemm"] = max(worst["gemm"], abs_e)
                print(f"  gemm {dname} M={M} {name} {K}x{N}: max_abs={abs_e:.3e} "
                      f"max_rel={rel_e:.3e} tol=(rtol {rtol:g}, atol {atol:g}) "
                      f"{'ok' if ok else 'FAIL'}")
                check(ok, f"gemm {dname} M={M} {name}")
                del a, b, got, want
    B, Hkv, G, D, bs, max_seq = 8, 1, 4, 256, 16, 1200
    lengths = [1100, 1024, 950, 700, 513, 260, 128, 64]
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        cache, tables = _lived_in_pool(torch, kvc, dev, g, dt, B, Hkv, D, bs,
                                       max_seq, lengths)
        for sq in (1, 64):
            q = torch.randn((B, sq, Hkv * G, D), generator=g, device=dev).to(dt)
            idx = torch.tensor([n - sq for n in lengths], dtype=torch.int32, device=dev)
            for window in (None, 512):
                for splits in (1, 4):
                    spec = fd.FlashDecodeSpec(num_splits=splits)
                    got = fd.flash_decode_attention(q, cache, tables, idx,
                                                    window=window, spec=spec)
                    want = fd.ref_paged_decode(q, cache, tables, idx, window=window)
                    rtol, atol = DECODE_TOL[dname]
                    abs_e, rel_e, ok = close(got, want, rtol, atol)
                    worst["flash_decode"] = max(worst["flash_decode"], abs_e)
                    print(f"  flash_decode {dname} Sq={sq} window={window} "
                          f"splits={splits}: max_abs={abs_e:.3e} max_rel={rel_e:.3e} "
                          f"tol=(rtol {rtol:g}, atol {atol:g}) {'ok' if ok else 'FAIL'}")
                    check(ok, f"flash_decode {dname} Sq={sq} window={window} "
                              f"splits={splits}")
        if dname == "bfloat16":
            oracle_q = torch.randn((B, 1, Hkv * G, D), generator=g, device=dev).to(dt)
            oidx = torch.tensor([n - 1 for n in lengths], dtype=torch.int32, device=dev)
            got = fd.flash_decode_attention(oracle_q, cache, tables, oidx, window=512)
            want = fd.gather_decode(oracle_q, cache, tables, oidx, window=512)
            abs_e, _, ok = close(got, want, *DECODE_TOL[dname])
            print(f"  flash_decode vs gather oracle bf16: max_abs={abs_e:.3e} "
                  f"{'ok' if ok else 'FAIL'}")
            check(ok, "flash_decode vs gather oracle")
        del cache, tables
    torch.cuda.synchronize()
    return worst


def _lived_in_pool(torch, kvc, dev, g, dt, B, Hkv, D, bs, max_seq, lengths):
    """A pool holding random K/V (every block, null included) and block
    tables covering each slot's length, drawn as the engine draws them."""
    max_blocks = kvc.blocks_for(max_seq, bs)
    nb = kvc.default_pool_blocks(B, max_seq, bs)
    alloc, tables = kvc.BlockAllocator(nb, bs), kvc.BlockTables(B, max_blocks)
    for s, n in enumerate(lengths):
        tables.ensure(s, n, alloc)
    cache = kvc.PagedKVCache(
        k=torch.randn((nb, bs, Hkv, D), generator=g, device=dev).to(dt),
        v=torch.randn((nb, bs, Hkv, D), generator=g, device=dev).to(dt))
    return cache, tables.array(dev)


def phase_engine(torch, np, configs, M, Engine, RequestSpec, gemm, fd):
    cfg = configs.get("gemma3-1b")
    check(cfg.dtype == "bfloat16" and cfg.n_layers == 26, "gemma3-1b full config")
    t0 = time.monotonic()
    params = M.init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"  init_model: {time.monotonic() - t0:.1f}s, {cfg.param_count() / 1e9:.3f}B "
          f"matrix params ({cfg.param_count() * 2 / 1e9:.2f} GB bf16)")
    eng = Engine(cfg, params, slots=8, max_seq=1200, block_size=16, max_chunk=64,
                 device="cuda")
    t0 = time.monotonic()
    eng.warmup()
    print(f"  warmup: {time.monotonic() - t0:.2f}s ({eng.metrics.aot_steps} step shapes)")
    rng = np.random.default_rng(0)
    plens = rng.integers(200, 1101, size=12)
    plens[:3] = (1100, 800, 513)                      # several past the 512 window
    max_new = rng.integers(32, 65, size=12)
    for n, m in zip(plens, max_new):
        eng.submit(RequestSpec(prompt=rng.integers(0, cfg.vocab, size=int(n)),
                               max_new=int(m)))
    torch.cuda.reset_peak_memory_stats()
    gemm.reset_launches()
    fd.reset_launches()
    t0 = time.monotonic()
    results = eng.run()
    torch.cuda.synchronize()
    t_run = time.monotonic() - t0
    launches = {"gemm": gemm.launches, "flash_decode": fd.launches}
    m = eng.metrics
    steps = m.prefill_chunks + m.decode_steps
    print(f"  served {len(results)} requests in {t_run:.2f}s: "
          f"{m.prefill_chunks} prefill chunks ({m.prefill_tokens} tok), "
          f"{m.decode_steps} decode steps ({m.decode_tokens} tok)")
    print(f"  prefill step {m.prefill_time_s / m.prefill_chunks * 1e3:.2f} ms/chunk, "
          f"decode step {m.decode_time_s / m.decode_steps * 1e3:.2f} ms/step, "
          f"decode {m.throughput_tok_s:.1f} tok/s, prefill "
          f"{m.prefill_tokens / m.prefill_time_s:.1f} tok/s")
    print(f"  kv pool {m.kv_pool_bytes / 1e9:.3f} GB ({m.kv_pool_blocks} blocks), "
          f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB, "
          f"cold_compiles={m.cold_compiles}")
    print(f"  launches: gemm={launches['gemm']} flash_decode={launches['flash_decode']} "
          f"(steps={steps}, 183 x steps = {183 * steps})")
    check(sorted(results) == list(range(12)), "every request finished")
    for rid, toks in results.items():
        check(len(toks) == int(max_new[rid]), f"request {rid} got its full budget")
        check(bool(((toks >= 0) & (toks < cfg.vocab)).all()), f"request {rid} tokens in vocab")
    check(launches["gemm"] > 0 and launches["flash_decode"] > 0, "both kernels ran")
    check(launches["gemm"] == 183 * steps, "183 GeMM launches per step")
    check(launches["flash_decode"] == cfg.n_layers * steps, "one decode launch per layer per step")
    check(m.cold_compiles == 0, "warmup covered every step shape")
    ops = _count_decode_ops(torch, M, eng, gemm, fd)
    print(f"  one decode step dispatches {ops['ops']} PyTorch ops ({ops['views']} views, "
          f"{ops['empty']} allocations) beside {ops['kernels']} hand-kernel launches")
    summary = {"decode_ms": m.decode_time_s / m.decode_steps * 1e3,
               "prefill_ms": m.prefill_time_s / m.prefill_chunks * 1e3,
               "decode_tok_s": m.throughput_tok_s}
    del eng, params
    torch.cuda.empty_cache()
    return launches, summary


def _count_decode_ops(torch, M, eng, gemm, fd):
    """PyTorch ops one decode step of `eng` dispatches (all slots active),
    and the hand-kernel launches beside them: the host work per step."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = self.views = self.empty = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops += 1
            self.views += bool(func.is_view)
            self.empty += func.overloadpacket.__name__ == "empty"
            return func(*args, **(kwargs or {}))

    k0 = gemm.launches + fd.launches
    tokens = torch.zeros((eng.slots, 1), dtype=torch.int64, device=eng.device)
    active = torch.ones((eng.slots,), dtype=torch.bool, device=eng.device)
    with torch.no_grad(), Count() as c:
        M.paged_decode_step(eng.params, eng.cfg, eng.state, tokens, active)
    torch.cuda.synchronize()
    return {"ops": c.ops, "views": c.views, "empty": c.empty,
            "kernels": gemm.launches + fd.launches - k0}


def phase_parity(torch, np, configs, M, kvc, Engine, RequestSpec):
    cfg = dataclasses.replace(configs.get("gemma3-1b"), n_layers=6, group_size=6,
                              dtype="float32")
    check(cfg.layer_kinds().count("attn_local") == 5, "6-layer cut: 5 local + 1 global")
    params = M.init_model(cfg, seed=1, device="cuda")
    cpu_params = {"embed": params["embed"].cpu(), "final_norm": params["final_norm"].cpu(),
                  "layers": [{k: (v.cpu() if torch.is_tensor(v) else
                                  {kk: vv.cpu() for kk, vv in v.items()})
                              for k, v in layer.items()} for layer in params["layers"]]}
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, size=n) for n in (600, 300)]
    out = {}
    for dev, p in (("cuda", params), ("cpu", cpu_params)):
        t0 = time.monotonic()
        eng = Engine(cfg, p, slots=2, max_seq=640, block_size=16, max_chunk=64,
                     device=dev)
        for pr in prompts:
            eng.submit(RequestSpec(prompt=pr, max_new=8))
        out[dev] = eng.run()
        print(f"  {dev}: {time.monotonic() - t0:.1f}s, tokens "
              f"{[out[dev][r].tolist() for r in sorted(out[dev])]}")
    for rid in out["cpu"]:
        check(np.array_equal(out["cuda"][rid], out["cpu"][rid]),
              f"request {rid}: CUDA tokens equal the CPU plain-version tokens")
    # Greedy tokens of random weights can be few and repetitive; the logits
    # of the long prompt's last prefill chunk and first decode step must
    # agree too (f32 on both sides, sums in another order).
    got = _prompt_logits(torch, M, kvc, cfg, params, prompts[0], "cuda")
    want = _prompt_logits(torch, M, kvc, cfg, cpu_params, prompts[0], "cpu")
    for what, g_, w_ in zip(("last prefill chunk", "first decode step"), got, want):
        scale = float(w_.abs().max())
        err = float((g_ - w_).abs().max())
        top_g, top_w = g_.topk(8).indices.tolist(), w_.topk(8).indices.tolist()
        print(f"  logits after the {what}: max_abs_diff={err:.3e} "
              f"(max |logit| {scale:.3e}), top-8 {'equal' if top_g == top_w else 'DIFFER'}")
        check(err <= 1e-4 * scale and top_g == top_w, f"CUDA vs CPU logits, {what}")
    del params, cpu_params
    torch.cuda.empty_cache()


def _prompt_logits(torch, M, kvc, cfg, params, prompt, dev):
    """Last-position logits of `prompt` prefilled in 64-token chunks, then
    of one greedy decode step, through the model functions on `dev`."""
    from repro_torch.serving.prefill import plan_chunks

    bs = 16
    max_blocks = kvc.blocks_for(len(prompt) + 1, bs)
    state = M.init_paged_decode_state(cfg, 1, num_blocks=1 + max_blocks,
                                      block_size=bs, max_blocks_per_slot=max_blocks,
                                      device=dev)
    tables = kvc.BlockTables(1, max_blocks)
    tables.ensure(0, len(prompt) + 1, kvc.BlockAllocator(1 + max_blocks, bs))
    state.block_tables = tables.array(dev)
    pos = 0
    with torch.no_grad():
        for c in plan_chunks(len(prompt), 64):
            chunk = torch.as_tensor(prompt[None, pos:pos + c], device=dev)
            logits, state = M.prefill_chunk(params, cfg, state, chunk, 0)
            pos += c
        tok = logits[:, -1].argmax(-1)[:, None]
        step_logits, _ = M.paged_decode_step(params, cfg, state, tok)
    return logits[0, -1].float().cpu(), step_logits[0, -1].float().cpu()


def _time_ms(torch, calls, iters: int, graph: bool = True) -> float:
    """Mean ms per call over `iters` calls cycling through `calls`, timed
    with CUDA events.  With `graph` the calls are captured into one CUDA
    graph and replayed, so the time is the device's and not the Python
    wrapper's launch cost; without it (plain versions, which sync) they
    run eagerly."""
    for c in calls[:3]:
        c()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for i in range(iters):
                calls[i % len(calls)]()
        g.replay()
        torch.cuda.synchronize()
        start.record()
        g.replay()
        end.record()
    else:
        start.record()
        for i in range(iters):
            calls[i % len(calls)]()
        end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_times(torch, gemm, fd, kvc):
    import torch.nn.functional as F

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(2)
    dt = torch.bfloat16
    rows = {}
    for M in (8, 64):
        for name, K, N, transposed in GEMM_SHAPES:
            b_bytes = K * N * 2
            copies = max(1, min(128, math.ceil(2 * L2_BYTES / b_bytes)))
            a = torch.randn((M, K), generator=g, device=dev).to(dt)
            bs_ = []
            for _ in range(copies):
                b = torch.randn((N, K) if transposed else (K, N), generator=g,
                                device=dev).to(dt)
                bs_.append(b.t() if transposed else b)
            iters = max(20, min(400, 4 * copies))
            kcalls = [lambda b=b: gemm.gemm(a, b, out_dtype=dt) for b in bs_]
            t_k = _time_ms(torch, kcalls, iters)
            t_e = _time_ms(torch, kcalls, iters, graph=False)
            t_p = _time_ms(torch, [lambda b=b: gemm.gemm_plain(a, b, dt) for b in bs_[:4]],
                           max(4, iters // 10), graph=False)
            t_l = _time_ms(torch, [lambda b=b: torch.matmul(a, b) for b in bs_], iters)
            nbytes = (M * K + K * N + M * N) * 2
            flops = 2 * M * K * N
            bound = max(nbytes / HBM_BPS, flops / PEAK_FLOPS["bfloat16"]) * 1e3
            rows[("gemm", M, name)] = (t_k, t_p, t_l, bound)
            print(f"  gemm bf16 M={M} {name} {K}x{N}: kernel {t_k * 1e3:.1f} us "
                  f"(eager call {t_e * 1e3:.1f} us), plain "
                  f"{t_p * 1e3:.1f} us, torch.matmul {t_l * 1e3:.1f} us, bound "
                  f"{bound * 1e3:.2f} us ({'bytes' if nbytes / HBM_BPS >= flops / PEAK_FLOPS['bfloat16'] else 'operations'}), "
                  f"{bound / t_k:.1%} of bound")
            del a, bs_

    B, Hkv, G, D, bs, max_seq = 8, 1, 4, 256, 16, 1200
    lengths = [1100, 1024, 950, 700, 513, 260, 128, 64]
    pools = [_lived_in_pool(torch, kvc, dev, g, dt, B, Hkv, D, bs, max_seq, lengths)
             for _ in range(12)]                   # ~120 MB: the pool is L2-cold
    for label, b_, sq in (("decode", B, 1), ("prefill", 1, 64)):
        lens = lengths[:b_]
        q = torch.randn((b_, sq, Hkv * G, D), generator=g, device=dev).to(dt)
        idx = torch.tensor([n - sq for n in lens], dtype=torch.int32, device=dev)
        for window in (None, 512):
            sel = [(c, t[:b_].contiguous()) for c, t in pools]
            kcalls = [lambda c=c, t=t: fd.flash_decode_attention(
                q, c, t, idx, window=window) for c, t in sel]
            t_k = _time_ms(torch, kcalls, 120)
            t_e = _time_ms(torch, kcalls, 120, graph=False)
            t_p = _time_ms(torch, [lambda c=c, t=t: fd.ref_paged_decode(
                q, c, t, idx, window=window) for c, t in sel[:4]], 8, graph=False)
            # library yardstick: SDPA over K/V gathered beforehand (gather untimed)
            qpos = idx[:, None].long() + torch.arange(sq, device=dev)[None]
            kpos = torch.arange(sel[0][1].shape[1] * bs, device=dev)
            mask = kpos[None, None, :] <= qpos[..., None]
            if window is not None:
                mask &= (qpos[..., None] - kpos[None, None, :]) < window
            lib_in = []
            for c, t in sel[:4]:
                k, v = kvc.gather_kv(c, t)
                lib_in.append((k.permute(0, 2, 1, 3).repeat_interleave(G, 1),
                               v.permute(0, 2, 1, 3).repeat_interleave(G, 1)))
            qs = q.permute(0, 2, 1, 3)
            t_l = _time_ms(torch, [lambda k=k, v=v: F.scaled_dot_product_attention(
                qs, k, v, attn_mask=mask[:, None]) for k, v in lib_in], 120)
            keys = 0
            flops = 0
            for n, i0 in zip(lens, idx.tolist()):
                lo = 0 if window is None else max(0, i0 - window + 1)
                keys += (i0 + sq) - lo
                for t in range(sq):
                    qp = i0 + t
                    flops += 4 * G * D * (qp + 1 - (0 if window is None else max(0, qp - window + 1)))
            nbytes = 2 * (2 * keys * Hkv * D + 2 * q.numel()) + 4 * idx.numel() + \
                4 * b_ * (max_seq // bs)
            bound = max(nbytes / HBM_BPS, flops / PEAK_FLOPS["bfloat16"]) * 1e3
            rows[("flash_decode", label, window)] = (t_k, t_p, t_l, bound)
            if label == "decode":   # the split count a tuned spec could pick
                t_s4 = _time_ms(torch, [lambda c=c, t=t: fd.flash_decode_attention(
                    q, c, t, idx, window=window, spec=fd.FlashDecodeSpec(num_splits=4))
                    for c, t in sel], 120)
                print(f"  flash_decode bf16 decode window={window} num_splits=4: "
                      f"kernel {t_s4 * 1e3:.1f} us")
            print(f"  flash_decode bf16 {label} B={b_} Sq={sq} window={window}: kernel "
                  f"{t_k * 1e3:.1f} us (eager call {t_e * 1e3:.1f} us), plain {t_p * 1e3:.1f} us, sdpa {t_l * 1e3:.1f} us, "
                  f"bound {bound * 1e3:.2f} us (bytes), {bound / t_k:.1%} of bound")
    del pools
    torch.cuda.empty_cache()
    return rows


def per_step(rows, n_layers: int = 26, n_global: int = 4):
    """Aggregate per-shape times into one decode step of gemma3-1b (M = 8)."""
    layer = ("q", "k", "v", "o", "gate", "up", "down")
    gemm = [sum(n_layers * rows[("gemm", 8, s)][i] for s in layer)
            + rows[("gemm", 8, "head")][i] for i in range(4)]
    fdec = [n_global * rows[("flash_decode", "decode", None)][i]
            + (n_layers - n_global) * rows[("flash_decode", "decode", 512)][i]
            for i in range(4)]
    return {"gemm": gemm, "flash_decode": fdec}


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        raise SystemExit(f"FAIL: {e}")
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: no CUDA device")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        raise SystemExit("FAIL: src/repro_torch is not beside chip_smoke.py")
    from repro_torch import configs
    from repro_torch.kernels import _build, flash_decode as fd, gemm
    from repro_torch.models import model as M
    from repro_torch.serving import kv_cache as kvc
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import RequestSpec

    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.monotonic()
    logs = _build.build()
    print(f"[1] kernels built in {time.monotonic() - t0:.1f}s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {name}: {line.strip()}")

    print("[2] kernels vs plain versions on the card")
    worst = phase_kernels(torch, gemm, fd, kvc)
    print("[3] full-width gemma3-1b engine run (26 layers, bf16)")
    launches, summary = phase_engine(torch, np, configs, M, Engine, RequestSpec, gemm, fd)
    print("[4] 6-layer full-width f32: CUDA kernels vs CPU plain versions")
    phase_parity(torch, np, configs, M, kvc, Engine, RequestSpec)
    print("[5] kernel times at main-path shapes (bf16, CUDA events, L2 cold)")
    rows = phase_times(torch, gemm, fd, kvc)
    agg = per_step(rows)
    print(f"[5] one decode step: gemm {agg['gemm'][0]:.3f} ms (bound {agg['gemm'][3]:.3f}), "
          f"flash_decode {agg['flash_decode'][0]:.3f} ms (bound {agg['flash_decode'][3]:.3f}); "
          f"engine decode step {summary['decode_ms']:.2f} ms")
    kernels = [
        {"name": "gemm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gemm.cu",
         "replaces": "src/repro/kernels/gemm.py:33",
         "per": "one gemma3-1b decode step: 26 x (q,k,v,o,gate,up,down) + tied head, M=8, bf16",
         "launches": launches["gemm"], "max_abs_err": worst["gemm"],
         "ms": agg["gemm"][0], "plain_ms": agg["gemm"][1], "bound_ms": agg["gemm"][3],
         "bound_by": "bytes", "library_ms": agg["gemm"][2]},
        {"name": "flash_decode", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
         "replaces": "src/repro/kernels/flash_decode.py:107",
         "per": "one gemma3-1b decode step: 4 global + 22 window-512 layers, B=8, Sq=1, bf16",
         "launches": launches["flash_decode"], "max_abs_err": worst["flash_decode"],
         "ms": agg["flash_decode"][0], "plain_ms": agg["flash_decode"][1],
         "bound_ms": agg["flash_decode"][3], "bound_by": "bytes",
         "library_ms": agg["flash_decode"][2]},
    ]
    print("kernels " + " ".join(
        f"{k['name']}: launches={k['launches']} max_abs_err={k['max_abs_err']:.3e} "
        f"ms={k['ms']:.3f} plain_ms={k['plain_ms']:.3f} bound_ms={k['bound_ms']:.3f} "
        f"library_ms={k['library_ms']:.3f};" for k in kernels))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
