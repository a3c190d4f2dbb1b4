#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py               # all phases, one card, exit 0 = pass

Phases, in order; any failure exits non-zero:

  1. card name and power limit; build the CUDA kernels from src/ (one nvcc
     per source, all at once) and print the build seconds and each
     source's registers and spill bytes (nvcc -Xptxas -v; the GeMMs, float
     and int8, must not spill); where cuobjdump exists, the tensor-core
     instructions in the GeMMs' libraries (HMMA in the float GeMMs', IMMA
     in the int8 GeMM's), which must be some.
  2. each kernel against its plain PyTorch version on the card, at the
     shapes gemma3-1b gives it (the float GeMMs K1 and K6 at M = 1, 8 and
     64), with stated tolerances; the int8 GeMM
     (dequant epilogue and int mode) and the row quantization bit for bit;
     the w8a8 GeMM (the rows quantized in the int8 GeMM's prologue, per row
     and with a static scale, bf16 and f32 in and out, a zero row) bit for
     bit against its plain composition at M = 1, 8, 64 and 300;
     paged flash-decode (K2) over float and int8 pools at 1 and 4 splits,
     at the split count of its rule and at one split per table column
     (most splits dead for the short slots), the last two also against the
     plain split-K `split_decode_plain`; flash attention (K5) at the
     reference's test shapes, gemma3-1b's (D 256, 4 q heads over 1 kv
     head, S 1024, global and window 512) and S 32 / 100 / 1000 at each
     head dim; the
     pipelined GeMM (K6) at depths 2, 3 and 4 on every projection shape and
     the tied head, f32 / bf16 / int8.  Then the shapes of the dense family
     gemma3-1b never reached: K1 (bf16) and the w8a8 GeMM (bit for bit) at
     M = 1, 8 and 64 on qwen3-14b's q/o (5120 x 5120), k/v (5120 x 1024),
     gate/up (5120 x 17408), down (17408 x 5120) and its N-contiguous
     untied head (5120 x 151936); K2 over float and int8 pools at 40 q heads
     over 8 kv heads (the 16-row tile), D 128, and at 12 / 12, D 64, Sq 1
     and 64; K5 at the same head layouts.  Then the verify steps' shapes
     (8 slots x widths 2, 3, 5): K1 (bf16, within one bf16 ulp) and the
     w8a8 GeMM (bit for bit, as planned) at M = 16, 24 and 40 on
     gemma3-1b's and qwen3-14b's projections and heads; K2 over float and
     int8 pools at B = 8 with Sq = 2, 3 and 5, 4 / 1 heads at D 256
     (global and window 512) and 40 / 8 at D 128, slot lengths 17-1100
     across block boundaries and past the window, against
     `ref_paged_decode` and at the rule's split count (also against
     `split_decode_plain`).  Then whisper-medium's and paligemma-3b's
     shapes: K5 non-causal at Sq != Skv (8 x 1 | 64 | 1500 queries over
     1500 frames, 16 / 16 heads, D 64), bf16 and f32; K1 (bf16) at M =
     12000 (the cross K / V projections of 8 x 1500 frames, 1024 x 1024)
     and M = 2048 (the projector over 8 x 256 patches, 1152 x 2048).
  3. the main path at full width: gemma3-1b, 26 layers, bf16, random weights
     from a seeded torch.Generator, served by the continuous-batching
     Engine (8 slots, 12 requests, prompts 200-1100 tokens, 32-64 new
     tokens, chunk 64, block 16) as it runs on the card: warmup captures
     the decode step, every prefill-chunk bucket and the slot reset as
     CUDA graphs (their count, capture seconds and graph pool bytes are
     printed) and serving replays them.  An eager engine (graphs=False)
     on the same weights serves the same requests in lockstep, one tick
     each in turns: every request's tokens must be identical, and each
     step pairs with the same step of the other engine (medians and the
     pairs the graphed step won, for the decode step and the 64-token
     chunk).  Launch counters are zeroed just before the run and read just
     after: the graphed engine's launches are counted from its replays
     (replays x the launches each graph captured), the eager one's by the
     wrappers; both must match the plan, the GeMM 183 times per prefill
     chunk and per decode step, and no shape may compile cold.  Then the
     device time of one replayed decode step and 64-token chunk (CUDA
     events, 8 slots live), one torch.profiler breakdown of a replayed
     decode step (hand kernels against the PyTorch ops between them, the
     top 10 of those by time), the peak device memory with and without
     graphs, and a line with the split counts K2 ran with, per layer kind
     and step shape.  Phases 3b-3d serve the same way (3b with the
     profile, 3c and 3d without).
  3e. the serve CLI (`repro_torch.launch.serve`) at published widths in
     w8a8 with an int8 KV pool, 4 requests: its engine captures its steps
     and serves them with no cold compile.
  3b. the same run in the int8 deployment precision (w8a8 weights, int8 KV
     pool): the w8a8 GeMM as one launch per GeMM (the row quantization
     inside it) at M <= 16, i.e. 183 per decode step, and for the 182
     projections of every longer prefill chunk the row quantization then
     the dequant GeMM; the int8 decode branch 26 times per step; the float
     GeMM never.
  3c. the same run in calibrated w8a8 (static activation scales) with an
     int8 KV pool: warmup calibrates through the unpaged forward (flash
     attention 26 x 2 batches, the float GeMM 7 x 26 x 2); serving runs the
     w8a8 GeMMs as 3b, with the static scales.
  3d. phase 3's float run under the pipelined GeMM backend (depth 3): K6
     183 times per step, K1 never; its first decode step's logits near the
     tiled backend's.
  4. the same weights at full width, depth cut to 6 layers (5 local + 1
     global), float32, on the card (kernels) and on the CPU (plain
     versions): greedy tokens identical in float, in w8a8 with an int8 KV
     pool, in calibrated w8a8 and under the pipelined backend; w8a8 logits
     near the float logits; `forward` logits and the calibration table
     equal across devices.
  6. quality: `quant.quality_delta` at full width, bf16, on 2 batches of
     (2, 1024) tokens: float, w8a8 and calibrated w8a8 NLLs and the worst
     layers of the weight-error table.
  5. each kernel timed at its main-path shapes with CUDA events (L2 cold),
     beside its bound, its plain version and the library call; K6 at each
     ring depth beside K1 (the paper's Fig. 5 depth sweep); the float GeMMs
     per decode step (M = 8) and per prefill chunk (the projections at
     M = 64, the tied head at M = 1, as prefill_chunk runs it); the w8a8
     GeMM at M = 1, 8 and 64 beside the two-launch row quantization + dequant
     GeMM, torch._int_mm and its bound, per w8a8 and calibrated decode step
     and per prefill chunk; K2 per decode
     step and per prefill chunk at its rule's split count (also as eager
     calls), at 1 and at 4 splits; K5 per shape and per forward; K5 at
     whisper's encoder shape (8 x 1500 over 1500) and its Sq = 1 cross
     shape beside SDPA; K1 at M = 12000 and 2048 beside torch.matmul.
  8a. qwen3-14b at published widths (40 layers, d 5120, 40 q heads over 8
     kv heads, head_dim 128, d_ff 17408, untied 151936 vocab, qk-norm),
     bf16, random weights (seed 0), served as phase 3 serves gemma3-1b (8
     slots, 8 requests, prompts 256-1024 tokens, 32 new tokens each, chunk
     64, block 16), graphed against eager in lockstep on the same weights:
     tokens identical, paired step medians, one replay's device time,
     capture, memory, launches per replayed decode step (281 GeMMs, 40
     decode-attention launches), a profile of one replayed decode step.
  8b. the same in w8a8 with an int8 KV pool (the eager engine on the
     graphed one's int8-resident weights).
  8. the kernels per qwen3-14b decode step (L2 cold): K1, K6 (depth 3) and
     the w8a8 GeMM at M = 8 on every projection and the head, K2 over float
     and int8 pools, and K5 per forward over (2, 1024) tokens (40 q heads
     over 8 kv heads, D 128), beside torch.matmul / torch._int_mm / SDPA
     and the bounds.
  8c. qwen3-14b, qwen2.5-14b, mistral-nemo-12b, bert-base and vit-b-16 at
     published widths, depth cut to 2 layers (printed as `reduced`),
     float32, on the card and on the CPU: `forward` logits and the logits of
     a prompt's last prefill chunk and first decode step within phase 4's
     bar, the engine's greedy tokens equal; no GeMM operand re-laid on the
     card (bert-base's 30522-wide head is stored with aligned rows).
  9a. speculative decoding at full width: gemma3-1b (26 layers, bf16,
     random weights from seed 0), 8 slots, block 16, chunk 64, k = 4.  The
     graphed engine captures `verify2`, `verify3` and `verify5` at warmup
     beside decode, the 7 chunk buckets and the reset; each verify graph
     launches 183 GeMMs and 26 K2.  Two traces: a regeneration storm (16
     requests over 4 prompts of 256-1024 tokens, 64 new tokens each) and 8
     random prompts; tokens identical to a non-speculative graphed engine
     on the same weights, no cold compile, every step a replay.  Prints
     the acceptance rate, tokens per decode tick and decode tok/s with
     speculation on and off per trace, the median wall ms of a tick by the
     verify width it ran, and the device time of one replay of each verify
     graph beside the decode graph's.
  9b. 9a in w8a8 with an int8 KV pool: tokens identical to non-speculative
     w8a8; per verify graph the w8a8 GeMM as one launch at M <= FUSED_ROWS
     (verify2, M = 16), else the row quantization then the dequant GeMM
     (183 each), and 26 int8 K2.
  9c. sampling: 4 sampled (T 0.8, top-k 50, top-p 0.95, seeds 1000-1003)
     and 4 greedy requests in the same batches; graphed and eager engines in
     lockstep give identical tokens, a second seeded graphed run replays
     them, the greedy rows equal a greedy-only run's; with speculation on
     the traffic finishes (its acceptance printed) and the greedy rows are
     unchanged; 4096 draws of `sample_tokens` (seeds 0-4095) from one
     fixed 262144-wide logits row lie within total variation 0.05 of
     softmax(`_adjusted_logits`).
  9d. KV-swap preemption and the prefix cache: 4 interactive arrivals over
     8 decoding batch requests preempt 4 of them (preemptions, blocks and
     swap ms printed), and every batch request's tokens equal an
     unpreempted run's; 16 requests sharing a 512-token prefix with the
     prefix cache (hit rate and prefill tokens saved printed) give the
     tokens of a run without it.
  10. the recurrent, hybrid and MoE families (no new kernel; the Mamba
     scan, the mLSTM / sLSTM recurrences and the MoE dispatch are plain
     PyTorch, the experts' products K1 with f32 output).  10: K1 (f32 out
     within the f32 bar, bf16 out within one bf16 ulp) and the w8a8 GeMM
     (bit for bit) at M = 1, 8, 64 on the shapes the dense family never
     ran: xlstm-1.3b's projections, its narrow mLSTM gates (4096 x 4, rows
     padded to 16 bytes; no operand re-laid), its head; dbrx's f32 router
     (N = 16) and one expert's gate / down; jamba's router (N = 4),
     in-projection and x / dt projections (K = 512); K2 over float and int8
     pools at jamba's 64 / 8 and dbrx's 48 / 8 heads, D 128, Sq 1 and 64;
     the norms' mean (`layers.row_mean`) equal for a row at 1-40 rows.
     10a-10c serve at published widths on random weights (seed 0), bf16,
     8 slots, chunk 64, block 16, a graphed engine and an eager one in
     lockstep (tokens identical; launches per captured graph and of the
     whole run, counted from the replays and by the eager wrappers, equal
     `family_plan`; paired step medians, one replay's device time, capture
     seconds, graph pool / recurrent state / weight bytes, a profile of
     one replayed decode step):
     10a. xlstm-1.3b (d 2048, 4 heads, vocab 50304, untied), `reduced`
     to 16 of its 48 layers (14 mLSTM + 2 sLSTM) for the time limit, 8
     requests of 256-512 tokens, 32 new each, float then w8a8; then, whole
     (48 layers, 7.41 GB), speculative greedy decoding (k = 4,
     8 slots: 28.2 GB of per-position states in verify5) on a regeneration
     storm (16 requests over 4 prompts), tokens equal to a non-speculative
     graphed engine; then the serve CLI at published widths.
     10b. dbrx-132b, `reduced` to one group of 4 layers (28.5 GB), 8
     requests of 256-1024 tokens, float then w8a8 with an int8 KV pool.
     10c. jamba-1.5-large-398b, `reduced` to one group of 8 layers (7
     Mamba + 1 attention, MoE on layers 2/4/6/8) and 4 of its 16 experts
     (32.5 GB), the same traffic, float; then the serve CLI refuses jamba
     at published widths (797 GB), naming the bytes.
     10d. the four family archs' smoke configs in float32 (head_dim 64
     where the stack has attention) on the card and on the CPU: the logits
     after a prompt's prefill and three decode steps within phase 4's bar,
     argmax equal, and the engine's greedy tokens equal.
     10a's speculation also serves its storm again with the verify graphs
     captured narrowest first (the order of the one run whose speculative
     tokens differed, ROADMAP C.2), tokens equal to the non-speculative run.
  11. the encoder-decoder and VLM families through the reference's
     unpaged entry points (no new kernel; the dense-cache decode attention
     and paligemma's prefix-LM attention are plain PyTorch).
     11a. whisper-medium at published widths (24 encoder + 24 decoder
     layers, d 1024, 16 / 16 heads, D 64, untied 51865 vocab; 1.62 GB),
     bf16, random weights (seed 0): 8 requests of 1500 random frames and
     16-token prompts through `prefill`, then 47 greedy `decode_step`s,
     one state replayed from the step's CUDA graph and one eager, in
     lockstep: tokens identical; the encoder's, prefill's and the step's
     times, one replay's device time and profile, the cross caches'
     bytes, launches per replay as planned (193 K1, 24 K5).
     11b. paligemma-3b at published widths (18 layers, d 2048, MQA 8 / 1,
     D 256, tied 257216 vocab; 5.02 GB): 256 random patches (width 1152)
     and a 16-token prompt a request, 31 decode steps, the same checks
     (127 K1 a replay).
     11c. both smoke configs, head_dim 64, f32, card against CPU: forward
     logits, prefill and 6 decode steps within phase 4's bar, argmax
     equal.
     11d. `serve --arch gemma3-1b --widths published --compare-prefill`:
     the token-by-token prefill (the unpaged step's graph) against the
     engine's chunked prefill, both times printed.
  7. one line per phase 3-3d and 8a-8b: the decode step and prefill chunk,
     graphed and eager, and the device time of one replay of each; one per
     phase 9a-9b: acceptance, tokens per tick and decode tok/s per trace
     with speculation on and off, one replay of each verify graph and of
     the decode graph, launches per verify replay; one per phase 10a-10c
     run.

The line before the card line is the kernels' JSON summary; the last line
is {"ok": true, "device": {...}}.  Exits non-zero, printing no result,
without a CUDA device or without the port package beside this script.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (dense): HBM bytes/s and bf16 / f32 FLOP/s, int8 OP/s.
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
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
# flash attention: f32 sums reordered; in bf16 p and out round to bf16 in
# both versions at other tiles, so one bf16 ulp of the rounded output.
FLASH_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2 ** -7, 2 ** -8)}
# pipelined GeMM: f32 out of weights scaled K^-0.5 within 1e-5 (reordered
# sums); bf16 out within one bf16 ulp, as K1; int8 -> int32 bit for bit.
PIPE_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2 ** -7, 1e-3)}
DEPTHS = (2, 3, 4)
# int8 kernels: exact int32 sums and a fixed epilogue order, so bit for bit.
# The int8 decode branch dequantizes as code * scale in f32 exactly as its
# plain versions do, so it takes the float branch's tolerances.
INT8_QUANT_SHAPES = [(m, k) for m in (1, 8, 64, 300) for k in (1024, 1152, 6912)]
# K of each activation the row quantization runs on in one 64-token prefill
# chunk in w8a8 (the 182 projections at M = 64; the head at M = 1 quantizes
# inside the w8a8 GeMM): q, k, v, gate and up read d = 1152, o 1024, down 6912.
QUANT_PER_CHUNK = {1152: 5 * 26, 1024: 26, 6912: 26}


def phase_kernels(torch, gemm, fd, kvc):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    worst = {"gemm": 0.0, "flash_decode": 0.0}
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        for M in (1, 8, 64):
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
                wants = {"walk": fd.ref_paged_decode(q, cache, tables, idx, window=window)}
                for splits in SPLIT_CASES:
                    _check_decode(torch, fd, f"flash_decode {dname}", q, cache, tables, idx,
                                  window, splits, wants, DECODE_TOL[dname], worst,
                                  "flash_decode")
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


def _lived_in_pool_int8(torch, kvc, dev, g, B, Hkv, D, bs, max_seq, lengths):
    """The same lived-in pool, int8: every token quantized with its scale
    as `write_kv` quantizes on write."""
    cache, tables = _lived_in_pool(torch, kvc, dev, g, torch.float32, B, Hkv, D,
                                   bs, max_seq, lengths)
    kq, ks = kvc.quantize_kv_tokens(cache.k)
    vq, vs = kvc.quantize_kv_tokens(cache.v)
    return kvc.PagedKVCache(k=kq, v=vq, k_scale=ks, v_scale=vs), tables


# K2 split counts checked in phase 2: 1, 4, the rule's (None), and one split
# per table column ("all"): the 64-token slot's 4 live columns leave 71 of
# its 75 splits dead, and the window empties the first splits of the long
# slots.
SPLIT_CASES = (1, 4, None, "all")


def _check_decode(torch, fd, label, q, cache, tables, idx, window, splits, wants, tol,
                  worst, key):
    """K2 at one split count against the plain versions in `wants` and, at
    the rule's count and the dead-split count, the plain split version at
    that count too (the second oracle)."""
    spec = None if splits is None else fd.FlashDecodeSpec(
        num_splits=tables.shape[1] if splits == "all" else splits)
    n = fd.launch_splits(q, tables, cache.k.shape[2], spec)
    got = fd.flash_decode_attention(q, cache, tables, idx, window=window, spec=spec)
    if splits in (None, "all"):
        wants = dict(wants, split=fd.split_decode_plain(q, cache, tables, idx, n,
                                                        window=window))
    name = {None: f"rule={n}", "all": f"{n} (one per column)"}.get(splits, splits)
    for oracle, want in wants.items():
        abs_e, rel_e, ok = close(got, want, *tol)
        worst[key] = max(worst[key], abs_e)
        print(f"  {label} Sq={q.shape[1]} window={window} splits={name} vs {oracle}: "
              f"max_abs={abs_e:.3e} max_rel={rel_e:.3e} tol=(rtol {tol[0]:g}, atol "
              f"{tol[1]:g}) {'ok' if ok else 'FAIL'}")
        check(ok, f"{label} Sq={q.shape[1]} window={window} splits={name} vs {oracle}")


def phase_kernels_int8(torch, gemm8, kq, fd, kvc):
    """The int8 slice's kernels against their plain versions: the dequant
    GeMM (bf16 and f32 out) and K1's int mode at every GEMM_SHAPES entry
    for M = 1, 8 and 64 with the weight in its serving layout (an (N, K)
    store read through a .t() view), bit for bit; the row quantization
    bit for bit; the int8 decode branch against both plain versions."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    worst = {"dequant_gemm": 0.0, "gemm_int": 0.0, "quantize_rows": 0.0,
             "flash_decode_int8": 0.0}
    i8 = dict(generator=g, device=dev, dtype=torch.int8)
    for M in (1, 8, 64):
        for name, K, N, _ in GEMM_SHAPES:
            a = torch.randint(-127, 128, (M, K), **i8)
            b = torch.randint(-127, 128, (N, K), **i8).t()
            sa = torch.rand((M, 1), generator=g, device=dev) * 0.1 + 1e-3
            sb = torch.rand((1, N), generator=g, device=dev) * 0.1 + 1e-3
            for out in (torch.bfloat16, torch.float32):
                got = gemm8.dequant_gemm(a, b, sa, sb, out_dtype=out)
                want = gemm8.dequant_gemm_plain(a, b, sa, sb, out)
                err = float((got.float() - want.float()).abs().max())
                worst["dequant_gemm"] = max(worst["dequant_gemm"], err)
                ok = torch.equal(got, want)
                print(f"  dequant_gemm {str(out)[6:]} M={M} {name} {K}x{N}: "
                      f"max_abs={err:.3e} {'bitwise equal' if ok else 'FAIL'}")
                check(ok, f"dequant_gemm {out} M={M} {name} bit for bit")
            got, want = gemm8.gemm_int(a, b), gemm8.gemm_int_plain(a, b)
            err = float((got - want).abs().max())
            worst["gemm_int"] = max(worst["gemm_int"], err)
            ok = got.dtype == torch.int32 and torch.equal(got, want)
            print(f"  gemm int8->int32 M={M} {name}: max_abs={err:.0f} "
                  f"{'bitwise equal' if ok else 'FAIL'}")
            check(ok, f"gemm int mode M={M} {name} bit for bit")
            del a, b, got, want
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        bad = []
        for M, K in INT8_QUANT_SHAPES:
            x = (torch.randn((M, K), generator=g, device=dev) * 3).to(dt)
            if M > 1:
                x[1] = 0                                   # the 1e-8 scale floor
            act = (x.float().abs().max() / 127 * 0.8).reshape(())   # some codes clip
            for scale in (None, act):
                q, s_ = kq.quantize_rows(x, scale)
                qp, sp = kq.quantize_rows_plain(x, scale)
                err = float((q.int() - qp.int()).abs().max())
                worst["quantize_rows"] = max(worst["quantize_rows"], err)
                if not (torch.equal(q, qp) and torch.equal(s_, sp)):
                    bad.append((M, K, "static" if scale is not None else "per row"))
        print(f"  quantize_rows {dname} at M x K in {{1,8,64,300}} x {{1024,1152,6912}}, per-row "
              f"and static scales: "
              f"{'codes and scales bitwise equal' if not bad else f'FAIL at {bad}'}")
        check(not bad, f"quantize_rows {dname} bit for bit")
    B, Hkv, G, D, bs, max_seq = 8, 1, 4, 256, 16, 1200
    lengths = [1100, 1024, 950, 700, 513, 260, 128, 64]
    cache, tables = _lived_in_pool_int8(torch, kvc, dev, g, B, Hkv, D, bs, max_seq,
                                        lengths)
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        rtol, atol = DECODE_TOL[dname]
        for sq in (1, 64):
            q = torch.randn((B, sq, Hkv * G, D), generator=g, device=dev).to(dt)
            idx = torch.tensor([n - sq for n in lengths], dtype=torch.int32, device=dev)
            for window in (None, 512):
                wants = {"walk": fd.ref_paged_decode(q, cache, tables, idx, window=window),
                         "gather": fd.gather_decode(q, cache, tables, idx, window=window)}
                for splits in SPLIT_CASES:
                    _check_decode(torch, fd, f"flash_decode int8 pool, q {dname}", q, cache,
                                  tables, idx, window, splits, wants, (rtol, atol), worst,
                                  "flash_decode_int8")
    del cache, tables
    torch.cuda.synchronize()
    return worst


W8A8_ROWS = (1, 8, 64, 300)


def phase_kernels_w8a8(torch, gemm8):
    """The w8a8 GeMM against its plain composition, bit for bit, at every
    GEMM_SHAPES entry for M in W8A8_ROWS: as its plan runs it (one launch
    at M <= gemm_int8.FUSED_ROWS, the row quantization then the dequant
    GeMM above) and as one launch at every M; per-row and static scales,
    bf16 and f32 activations, bf16 and f32 out, the weight in its serving
    layout, one row all zero (the 1e-8 floor) and, with the static scale,
    rows that clip at +-127."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)
    worst = 0.0
    for M in W8A8_ROWS:
        for name, K, N, _ in GEMM_SHAPES:
            w = torch.randint(-127, 128, (N, K), generator=g, device=dev,
                              dtype=torch.int8).t()
            sb = torch.rand((1, N), generator=g, device=dev) * 0.1 + 1e-3
            x32 = torch.randn((M, K), generator=g, device=dev) * 3
            if M > 1:
                x32[M // 2] = 0
            act = (x32.abs().max() / 127 * 0.8).reshape(())   # 0-d, on the card
            n_ok = 0
            for xdt in (torch.bfloat16, torch.float32):
                x = x32.to(xdt)
                for scale in (None, act):
                    for out in (torch.bfloat16, torch.float32):
                        want = gemm8.gemm_w8a8_plain(x, w, sb, scale, out)
                        for path, got in (
                                ("plan", gemm8.gemm_w8a8(x, w, sb, scale, out_dtype=out)),
                                ("one launch", gemm8._w8a8_fused(x, w, sb, scale, out))):
                            worst = max(worst, float((got.float() - want.float()).abs().max()))
                            ok = got.dtype == out and torch.equal(got, want)
                            check(ok, f"gemm_w8a8 ({path}) M={M} {name} x {xdt} "
                                      f"{'static' if scale is not None else 'dynamic'} "
                                      f"out {out} bit for bit")
                            n_ok += 1
            plan = "one launch" if M <= gemm8.FUSED_ROWS else "quantize_rows + dequant_gemm"
            print(f"  gemm_w8a8 M={M} {name} {K}x{N}: dynamic and static scales x bf16/f32 "
                  f"in x bf16/f32 out, as planned ({plan}) and as one launch ({n_ok} calls): "
                  f"bitwise equal")
            del w, x32, x, got, want
    torch.cuda.synchronize()
    return {"gemm_w8a8": worst}


FLASH_SHAPES = [  # (B, S, Hq, Hkv, D, causal, window)
    (1, 128, 2, 2, 64, True, None), (2, 256, 4, 2, 64, True, None),
    (1, 192, 4, 1, 128, True, None), (1, 128, 2, 2, 64, False, None),
    (1, 256, 2, 1, 64, True, 64),                       # tests/test_flash_attention.py
    (2, 1024, 4, 1, 256, True, None), (2, 1024, 4, 1, 256, True, 512),   # gemma3-1b
    (2, 1000, 4, 1, 256, True, 512),                    # S not a multiple of the tile
    (2, 32, 4, 1, 256, True, None), (2, 32, 4, 1, 256, True, 512),  # the calibration batches
] + [  # each head dim of the tensor-core body, S short, ragged and long
    (1, S, 4, 1, D, True, None if S < 1000 else 512)
    for D in (64, 128, 256) for S in (32, 100, 1000)]


def phase_kernels_slice3(torch, fa, gp):
    """Slice 3's kernels against their plain versions: flash attention at
    the reference's test shapes and gemma3-1b's, bf16 and f32; the
    pipelined GeMM at every depth on GEMM_SHAPES for M = 1, 8 and 64 (B as the
    model holds it: (K, N), the head a .t() view) in f32 and bf16, and in
    int8 with B in the serving layout, bit for bit."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    worst = {"flash_attention": 0.0, "gemm_pipelined": 0.0}
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        rtol, atol = FLASH_TOL[dname]
        for B, S, Hq, Hkv, D, causal, window in FLASH_SHAPES:
            q, k, v = (torch.randn((B, S, h, D), generator=g, device=dev).to(dt)
                       for h in (Hq, Hkv, Hkv))
            got = fa.flash_attention(q, k, v, causal=causal, window=window)
            want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
            abs_e, rel_e, ok = close(got, want, rtol, atol)
            worst["flash_attention"] = max(worst["flash_attention"], abs_e)
            print(f"  flash_attention {dname} B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} "
                  f"causal={causal} window={window}: max_abs={abs_e:.3e} "
                  f"max_rel={rel_e:.3e} tol=(rtol {rtol:g}, atol {atol:g}) "
                  f"{'ok' if ok else 'FAIL'}")
            check(ok, f"flash_attention {dname} {(B, S, Hq, Hkv, D, causal, window)}")
    for dname in ("bfloat16", "float32", "int8"):
        for M in (1, 8, 64):
            for name, K, N, transposed in GEMM_SHAPES:
                shape_b = (N, K) if transposed or dname == "int8" else (K, N)
                if dname == "int8":
                    a = torch.randint(-127, 128, (M, K), generator=g, device=dev,
                                      dtype=torch.int8)
                    b = torch.randint(-127, 128, shape_b, generator=g, device=dev,
                                      dtype=torch.int8).t()
                    want = gp.gemm_plain(a, b)
                else:
                    dt = getattr(torch, dname)
                    a = torch.randn((M, K), generator=g, device=dev).to(dt)
                    b = (torch.randn(shape_b, generator=g, device=dev) * K ** -0.5).to(dt)
                    b = b.t() if transposed else b
                    want = gp.gemm_plain(a, b, dt)
                errs = []
                for depth in DEPTHS:
                    if dname == "int8":
                        got = gp.gemm(a, b, depth=depth)
                        err = float((got - want).abs().max())
                        ok = got.dtype == torch.int32 and torch.equal(got, want)
                    else:
                        got = gp.gemm(a, b, depth=depth, out_dtype=dt)
                        err, _, ok = close(got, want, *PIPE_TOL[dname])
                    worst["gemm_pipelined"] = max(worst["gemm_pipelined"], err)
                    errs.append(f"{err:.3e}")
                    check(ok, f"gemm_pipelined {dname} M={M} {name} depth={depth}")
                tol = "bit for bit" if dname == "int8" else \
                    "tol=(rtol {:g}, atol {:g})".format(*PIPE_TOL[dname])
                print(f"  gemm_pipelined {dname} M={M} {name} {K}x{N} depths {DEPTHS}: "
                      f"max_abs={'/'.join(errs)} {tol} ok")
                del a, b, got, want
    torch.cuda.synchronize()
    return worst


QWEN3_SHAPES = [  # (name, K, N, transposed B view) of one qwen3-14b layer + untied head
    ("q", 5120, 5120, False), ("k", 5120, 1024, False), ("v", 5120, 1024, False),
    ("o", 5120, 5120, False), ("gate", 5120, 17408, False), ("up", 5120, 17408, False),
    ("down", 17408, 5120, False), ("head", 5120, 151936, False),
]
# Lengths of the 8 slots K2 is checked and timed at for the dense family's
# head layouts: from phase 8's longest prompt after its 32 new tokens (1056)
# down to a short slot (64).
QWEN3_LENGTHS = [1056, 1000, 900, 777, 640, 513, 288, 64]
DENSE_DECODE = [  # (arch, Hq, Hkv, D): K2 and K5 at the dense family's new head layouts
    ("qwen3-14b", 40, 8, 128), ("bert-base", 12, 12, 64)]


def phase_kernels_dense(torch, gemm, gemm8, fd, fa, kvc):
    """The kernels at the shapes the dense family's archs give them and
    gemma3-1b never did: K1 (bf16) and the w8a8 GeMM (bit for bit) on
    qwen3-14b's projections and its untied, N-contiguous head at M = 1, 8
    and 64; K2 over float and int8 pools at 40 q heads over 8 kv heads (5
    per kv head: the 16-row tile), D 128, and at 12 / 12, D 64, Sq 1 and 64
    at 1 split, the rule's and one per column; K5 at the same head layouts,
    S 1024 and a ragged 100 (and (2, 32), the calibration batches)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)
    worst = {"gemm": 0.0, "gemm_w8a8": 0.0, "flash_decode": 0.0, "flash_decode_int8": 0.0,
             "flash_attention": 0.0}
    rtol, atol = GEMM_TOL["bfloat16"]
    for name, K, N, _ in QWEN3_SHAPES:
        w = (torch.randn((K, N), generator=g, device=dev) * K ** -0.5).to(torch.bfloat16)
        w_q = torch.randint(-127, 128, (N, K), generator=g, device=dev, dtype=torch.int8).t()
        sb = torch.rand((1, N), generator=g, device=dev) * 0.1 + 1e-3
        for M in (1, 8, 64):
            a = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
            abs_e, rel_e, ok = close(gemm.gemm(a, w, out_dtype=torch.bfloat16),
                                     gemm.gemm_plain(a, w, torch.bfloat16), rtol, atol)
            worst["gemm"] = max(worst["gemm"], abs_e)
            check(ok, f"gemm bf16 M={M} qwen3-14b {name}")
            got = gemm8.gemm_w8a8(a, w_q, sb, out_dtype=torch.bfloat16)
            want = gemm8.gemm_w8a8_plain(a, w_q, sb, None, torch.bfloat16)
            worst["gemm_w8a8"] = max(worst["gemm_w8a8"],
                                     float((got.float() - want.float()).abs().max()))
            check(torch.equal(got, want), f"gemm_w8a8 M={M} qwen3-14b {name} bit for bit")
            print(f"  qwen3-14b {name} {K}x{N} M={M}: gemm bf16 max_abs={abs_e:.3e} "
                  f"max_rel={rel_e:.3e} tol=(rtol {rtol:g}, atol {atol:g}) ok; gemm_w8a8 "
                  f"bitwise equal")
            del a, got, want
        del w, w_q, sb
        torch.cuda.empty_cache()
    bs, max_seq = 16, 1200
    for arch, Hq, Hkv, D in DENSE_DECODE:
        G, B = Hq // Hkv, len(QWEN3_LENGTHS)
        for dname in ("bfloat16", "float32"):
            dt = getattr(torch, dname)
            pools = {"float": _lived_in_pool(torch, kvc, dev, g, dt, B, Hkv, D, bs, max_seq,
                                             QWEN3_LENGTHS),
                     "int8": _lived_in_pool_int8(torch, kvc, dev, g, B, Hkv, D, bs, max_seq,
                                                 QWEN3_LENGTHS)}
            for pool, (cache, tables) in pools.items():
                key = "flash_decode_int8" if pool == "int8" else "flash_decode"
                for sq in (1, 64):
                    q = torch.randn((B, sq, Hq, D), generator=g, device=dev).to(dt)
                    idx = torch.tensor([n - sq for n in QWEN3_LENGTHS], dtype=torch.int32,
                                       device=dev)
                    wants = {"walk": fd.ref_paged_decode(q, cache, tables, idx)}
                    for splits in (1, None, "all"):
                        _check_decode(torch, fd, f"{arch} ({Hq}/{Hkv}, D {D}) flash_decode "
                                      f"{pool} pool, q {dname}", q, cache, tables, idx, None,
                                      splits, wants, DECODE_TOL[dname], worst, key)
            del pools
        for dname in ("bfloat16", "float32"):
            dt = getattr(torch, dname)
            for B, S in ((1, 1024), (2, 100), (2, 32)):
                q, k, v = (torch.randn((B, S, h, D), generator=g, device=dev).to(dt)
                           for h in (Hq, Hkv, Hkv))
                abs_e, rel_e, ok = close(fa.flash_attention(q, k, v),
                                         fa.flash_attention_plain(q, k, v), *FLASH_TOL[dname])
                worst["flash_attention"] = max(worst["flash_attention"], abs_e)
                print(f"  {arch} flash_attention {dname} B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} "
                      f"causal: max_abs={abs_e:.3e} max_rel={rel_e:.3e} "
                      f"{'ok' if ok else 'FAIL'}")
                check(ok, f"{arch} flash_attention {dname} {(B, S, Hq, Hkv, D)}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return worst


# The verify steps' shapes (slots 8 x widths verify_buckets(4) = 2, 3, 5):
# the GeMMs at M = 16, 24 and 40, K2 at B = 8 with Sq = 2, 3 and 5.  Slot
# lengths spread across block boundaries (16-token blocks) and past the
# 512-token window.
VERIFY_ROWS = (16, 24, 40)
VERIFY_WIDTHS = (2, 3, 5)
VERIFY_LENGTHS = [1100, 700, 513, 511, 257, 100, 33, 17]
VERIFY_DECODE = [  # (label, Hq, Hkv, D, windows)
    ("gemma3-1b", 4, 1, 256, (None, 512)), ("qwen3-14b", 40, 8, 128, (None,))]


def phase_kernels_verify(torch, gemm, gemm8, fd, kvc):
    """The kernels at the verify steps' shapes: K1 (bf16, within one bf16
    ulp) and the w8a8 GeMM (bit for bit, as planned) at M = 16, 24 and 40
    on gemma3-1b's and qwen3-14b's projections and heads; K2 over float and
    int8 pools with several slots at several positions each (B = 8, Sq = 2,
    3, 5) at 4 / 1 heads, D 256 (global and window 512) and 40 / 8, D 128,
    at the rule's split count (also against the plain split version)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(19)
    worst = {"gemm": 0.0, "gemm_w8a8": 0.0, "flash_decode": 0.0, "flash_decode_int8": 0.0}
    rtol, atol = GEMM_TOL["bfloat16"]
    for arch, shapes in (("gemma3-1b", GEMM_SHAPES), ("qwen3-14b", QWEN3_SHAPES)):
        for name, K, N, transposed in shapes:
            w = (torch.randn((N, K) if transposed else (K, N), generator=g, device=dev)
                 * K ** -0.5).to(torch.bfloat16)
            w = w.t() if transposed else w
            w_q = torch.randint(-127, 128, (N, K), generator=g, device=dev,
                                dtype=torch.int8).t()
            sb = torch.rand((1, N), generator=g, device=dev) * 0.1 + 1e-3
            errs = []
            for M in VERIFY_ROWS:
                a = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
                abs_e, _, ok = close(gemm.gemm(a, w, out_dtype=torch.bfloat16),
                                     gemm.gemm_plain(a, w, torch.bfloat16), rtol, atol)
                worst["gemm"] = max(worst["gemm"], abs_e)
                check(ok, f"gemm bf16 M={M} {arch} {name}")
                got = gemm8.gemm_w8a8(a, w_q, sb, out_dtype=torch.bfloat16)
                want = gemm8.gemm_w8a8_plain(a, w_q, sb, None, torch.bfloat16)
                worst["gemm_w8a8"] = max(worst["gemm_w8a8"],
                                         float((got.float() - want.float()).abs().max()))
                check(torch.equal(got, want), f"gemm_w8a8 M={M} {arch} {name} bit for bit")
                errs.append(f"M={M} {abs_e:.3e}")
                del a, got, want
            print(f"  verify rows, {arch} {name} {K}x{N}: gemm bf16 max_abs " + ", ".join(errs)
                  + f" (tol rtol {rtol:g}, atol {atol:g}) ok; gemm_w8a8 bitwise equal at "
                  f"M = {', '.join(map(str, VERIFY_ROWS))}")
            del w, w_q, sb
        torch.cuda.empty_cache()
    bs, max_seq, B = 16, 1200, len(VERIFY_LENGTHS)
    for arch, Hq, Hkv, D, windows in VERIFY_DECODE:
        for dname in ("bfloat16", "float32"):
            dt = getattr(torch, dname)
            pools = {"float": _lived_in_pool(torch, kvc, dev, g, dt, B, Hkv, D, bs, max_seq,
                                             VERIFY_LENGTHS),
                     "int8": _lived_in_pool_int8(torch, kvc, dev, g, B, Hkv, D, bs, max_seq,
                                                 VERIFY_LENGTHS)}
            for pool, (cache, tables) in pools.items():
                key = "flash_decode_int8" if pool == "int8" else "flash_decode"
                for sq in VERIFY_WIDTHS:
                    q = torch.randn((B, sq, Hq, D), generator=g, device=dev).to(dt)
                    idx = torch.tensor([n - sq for n in VERIFY_LENGTHS], dtype=torch.int32,
                                       device=dev)
                    for window in windows:
                        wants = {"walk": fd.ref_paged_decode(q, cache, tables, idx,
                                                             window=window)}
                        _check_decode(torch, fd, f"verify {arch} ({Hq}/{Hkv}, D {D}) "
                                      f"flash_decode {pool} pool, q {dname}, B={B}", q, cache,
                                      tables, idx, window, None, wants, DECODE_TOL[dname],
                                      worst, key)
            del pools
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return worst


# Launches per step (prefill chunk or decode step), by precision: one GeMM
# per projection (q, k, v, o and the MLP's gate, up, down, or up, down for
# the GELU MLP) of every layer, plus the head (gemma3-1b: 26 x 7 + 1 = 183;
# qwen3-14b: 40 x 7 + 1 = 281), and one decode-attention launch per layer;
# the pipelined backend swaps K1 for K6.  In both w8a8 modes a GeMM of M <=
# gemm_int8.FUSED_ROWS rows is one launch of the w8a8 GeMM (its activations
# quantized, per row or with the static scales, inside it): every decode
# step (M = 8), the head of every prefill chunk (M = 1, the last position)
# and the projections of chunks of <= 16 tokens.  A longer chunk's
# projections each run the row quantization, then the dequant GeMM
# (`w8a8_launches`).
def gemms_per_step(cfg) -> int:
    return (4 + (3 if cfg.mlp_variant == "swiglu" else 2)) * cfg.n_layers + 1


def per_step_plan(cfg, precision, kv_precision, backend):
    g, L = gemms_per_step(cfg), cfg.n_layers
    gemm = "gemm_w8a8" if precision != "float" else \
        ("gemm_pipelined" if backend == "pipelined" else "gemm")
    return {gemm: g, "flash_decode_int8" if kv_precision == "int8" else "flash_decode": L}


def w8a8_launches(chunks, decode_steps: int, fused_rows: int, per_step: int):
    """The w8a8 GeMMs' launches of a run in a w8a8 mode: `chunks` the prefill
    chunk sizes, `per_step` GeMMs a step (the head's last), one launch per
    GeMM at M <= fused_rows, else two for each projection."""
    long_ = sum(c > fused_rows for c in chunks)
    return {"gemm_w8a8": per_step * (decode_steps + len(chunks)) - (per_step - 1) * long_,
            "quantize_rows": (per_step - 1) * long_, "dequant_gemm": (per_step - 1) * long_}


def reset_counts(mods) -> None:
    """Zero the wrappers' launch counters (kernels/launches.py)."""
    mods["counters"].reset()


def read_counts(mods):
    """The wrappers' launch counters, by name: eager calls only; the
    engine counts its graphs' replays itself (`Engine.replayed_launches`)."""
    return mods["counters"].counts()


def rel_l2(torch, got, want) -> float:
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))


def graph_pool_bytes(torch, eng) -> int:
    """Bytes the allocator holds in the engine's graph memory pool: its
    segments in the allocator's snapshot."""
    pool = tuple(eng.graph_pool)
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) == pool)


def _median(v):
    v = sorted(v)
    return v[len(v) // 2]


def gemma_traffic(np):
    """Phase 3's requests: 12 prompts of 200-1100 tokens (three past the
    512 window), 32-64 new tokens each; the generator then draws the
    prompts."""
    rng = np.random.default_rng(0)
    plens = rng.integers(200, 1101, size=12)
    plens[:3] = (1100, 800, 513)
    return plens, rng.integers(32, 65, size=12), rng


def phase_engine(torch, np, configs, M, kvc, Engine, RequestSpec, mods, quant, ops,
                 precision="float", kv_precision="float", backend="tiled",
                 profile=False, arch="gemma3-1b", n_layers=26, traffic=gemma_traffic):
    """A model at published widths (phase 3: gemma3-1b; phase 8: qwen3-14b)
    served twice on the same weights (seed 0): by the engine as it runs on
    the card, every step a replay of a CUDA graph captured at warmup, and by
    an eager engine (graphs=False) on the same weight tensors (calibrated
    w8a8: on weights made again from the seed, since each engine
    calibrates and quantizes its own).
    The two run in lockstep, one tick each in turns (the graphed engine
    first on even ticks), so each step of one pairs with the same step of
    the other on the same state.  Checks: every request's tokens equal
    across the two, launches per step as `per_step_plan` says (the graphed
    engine's counted from its replays, the eager one's by the wrappers),
    no cold compile.  Prints the capture, the graph pool, the paired step
    times, the device time of a replayed decode step and 64-token chunk,
    and with `profile` the kernels of one replayed decode step."""
    from repro_torch.serving.prefill import chunk_buckets, plan_chunks

    cfg = configs.get(arch)
    check(cfg.dtype == "bfloat16" and cfg.n_layers == n_layers, f"{arch} full config")
    plan = per_step_plan(cfg, precision, kv_precision, backend)
    per = gemms_per_step(cfg)
    fused = mods["gemm8"].FUSED_ROWS
    t0 = time.monotonic()
    params = M.init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"  init_model: {time.monotonic() - t0:.1f}s, {cfg.param_count() / 1e9:.3f}B "
          f"matrix params ({cfg.param_count() * 2 / 1e9:.2f} GB bf16)")
    rng = np.random.default_rng(0)
    probe = rng.integers(0, cfg.vocab, size=300)
    if precision != "float" or backend != "tiled":   # the tiled float logits, for comparison
        float_logits = _prompt_logits(torch, M, kvc, quant, cfg, params, probe, "cuda")
    kw = dict(slots=8, max_seq=1200, block_size=16, max_chunk=64, precision=precision,
              kv_precision=kv_precision, device="cuda")
    ops.set_default_backend(backend)
    try:
        engines = {}
        for graphs in (True, False):
            if params is None:           # calibrated: made again from the seed
                params = M.init_model(cfg, seed=0, device="cuda")
            eng = Engine(cfg, params, graphs=graphs, **kw)
            # The eager engine takes the graphed one's weights: float as they
            # are, w8a8 already int8-resident (its warmup's quantization
            # keeps QuantTensors as they are); calibrated w8a8 calibrates
            # again on float weights.
            params = None if precision == "w8a8-calibrated" else eng.params
            reset_counts(mods)
            t0 = time.monotonic()
            eng.warmup()
            torch.cuda.synchronize()
            warm = read_counts(mods)
            m = eng.metrics
            print(f"  {'graphed' if graphs else 'eager'} engine warmup: "
                  f"{time.monotonic() - t0:.2f}s ({m.aot_steps} step shapes"
                  + (f" captured as CUDA graphs in {m.capture_time_s:.2f}s, graph pool "
                     f"{graph_pool_bytes(torch, eng) / 1e6:.1f} MB" if graphs else " run")
                  + (f", {m.calib_sites} activation sites calibrated"
                     if precision == "w8a8-calibrated" else "") + ")")
            check(eng.graphs == graphs, f"the engine runs with graphs={graphs}")
            if graphs:
                check(m.aot_steps == len(chunk_buckets(eng.max_chunk)) + 2,
                      f"decode, every chunk bucket and the reset captured: {m.aot_steps}")
            if graphs and precision == "w8a8":
                params = eng.params              # quantized at warmup
            if precision == "w8a8-calibrated":
                print("  warmup launches: " + " ".join(f"{k}={v}" for k, v in warm.items()))
                L = cfg.n_layers
                n_calib = 2 * L                            # 2 synthetic batches x L layers
                check(m.calib_sites == per, "every projection and the head calibrated")
                check(warm["flash_attention"] == n_calib,
                      f"calibration ran flash attention {L} x 2 times: {warm['flash_attention']}")
                check(warm["gemm"] == (per - 1) * 2,
                      f"calibration ran K1 {per - 1} x 2 times: {warm['gemm']}")
            if precision != "float":
                # warmup runs the decode step and each chunk bucket once (the
                # calibration's forwards run in float), and the graphed
                # engine's captures call each wrapper once more
                n = 2 if graphs else 1
                want_w = w8a8_launches(chunk_buckets(eng.max_chunk) * n, n, fused, per)
                check({k: warm[k] for k in want_w} == want_w,
                      f"warmup's w8a8 GeMMs: got {warm}, want {want_w}")
            engines[graphs] = eng
        del params
        graphed, eager = engines[True], engines[False]
        plens, max_new, rng = traffic(np)
        n_req = len(plens)
        for n, m_ in zip(plens, max_new):
            prompt = rng.integers(0, cfg.vocab, size=int(n))
            for eng in (graphed, eager):
                eng.submit(RequestSpec(prompt=prompt, max_new=int(m_)))
        check(sum(graphed.replayed_launches().values()) == 0, "no replay before the run")
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(mods)
        pairs, t_run = _run_paired(torch, graphed, eager)
        run_peak = torch.cuda.max_memory_allocated() - resident
        launches = graphed.replayed_launches()
        eager_launches = read_counts(mods)
        m, me = graphed.metrics, eager.metrics
        steps = m.prefill_chunks + m.decode_steps
        results = graphed.results
        print(f"  served the {n_req} requests on both engines in lockstep in {t_run:.2f}s: "
              f"{m.prefill_chunks} prefill chunks ({m.prefill_tokens} tok), "
              f"{m.decode_steps} decode steps ({m.decode_tokens} tok) each")
        for name, x in (("graphed", m), ("eager", me)):
            print(f"  {name}: prefill step {x.prefill_time_s / x.prefill_chunks * 1e3:.3f} ms/chunk, "
                  f"decode step {x.decode_time_s / x.decode_steps * 1e3:.3f} ms/step, "
                  f"decode {x.throughput_tok_s:.1f} tok/s, prefill "
                  f"{x.prefill_tokens / x.prefill_time_s:.1f} tok/s, cold_compiles={x.cold_compiles}")
        paired = _paired_medians(pairs)
        wb = m.weight_bytes or quant.weight_bytes(graphed.params)
        pool = graph_pool_bytes(torch, graphed)
        print(f"  resident weights {wb / 1e9:.3f} GB"
              + (f" (float {m.weight_bytes_float / 1e9:.3f} GB)" if m.weight_bytes_float else "")
              + f", kv pool {m.kv_pool_bytes / 1e9:.3f} GB {kv_precision} "
              f"({m.kv_pool_blocks} blocks) per engine; graph pool {pool / 1e9:.3f} GB; the "
              f"run's peak above both engines' resident memory {run_peak / 1e9:.3f} GB (the "
              f"eager steps' activations: replays allocate nothing); so one engine's peak "
              f"device memory: graphed {(wb + m.kv_pool_bytes + pool) / 1e9:.3f} GB, eager "
              f"{(wb + m.kv_pool_bytes + run_peak) / 1e9:.3f} GB")
        print("  launches (graphed, counted from its replays): "
              + " ".join(f"{k}={v}" for k, v in launches.items())
              + f" (steps={steps}, {per} x steps = {per * steps}); per replayed decode "
              f"step: " + " ".join(f"{k}={v}" for k, v in graphed._graph_launches["decode"].items()))
        check(sorted(results) == list(range(n_req)), "every request finished")
        for rid, toks in results.items():
            check(len(toks) == int(max_new[rid]), f"request {rid} got its full budget")
            check(bool(((toks >= 0) & (toks < cfg.vocab)).all()), f"request {rid} tokens in vocab")
            check(np.array_equal(toks, eager.results[rid]),
                  f"request {rid}: graphed tokens equal the eager engine's")
        print(f"  the {n_req} requests' tokens ({sum(map(len, results.values()))}) are identical "
              f"graphed and eager")
        want = {k: plan.get(k, 0) * steps for k in launches}
        if precision != "float":
            chunks = [c for n in plens for c in plan_chunks(int(n), graphed.max_chunk)]
            check(len(chunks) == m.prefill_chunks, "prefill chunks as plan_chunks plans them")
            want.update(w8a8_launches(chunks, m.decode_steps, fused, per))
            print(f"  w8a8 GeMM plan: {per * m.decode_steps} one-launch GeMMs in "
                  f"{m.decode_steps} decode steps; {len(chunks)} prefill chunks, "
                  f"{sum(c > fused for c in chunks)} of them longer than "
                  f"{fused} tokens (row quantization + dequant GeMM)")
        check(launches == want, f"launches per step, from replays: got {launches}, want {want}")
        check(eager_launches == want,
              f"launches per step, eager engine: got {eager_launches}, want {want}")
        check(m.cold_compiles == 0 and me.cold_compiles == 0, "warmup covered every step shape")
        if precision == "float" and backend == "tiled":
            _print_splits(torch, mods["fd"], graphed, cfg)
        replay = _replayed_step_ms(torch, np, graphed, [int(n) + 32 for n in plens[:8]])
        print(f"  device time of one replay (CUDA events, median of 10; 8 slots live at "
              f"{[int(n) + 32 for n in plens[:8]]} tokens): decode step "
              f"{replay['decode']:.3f} ms, 64-token prefill chunk (slot 0) "
              f"{replay['chunk64']:.3f} ms")
        if profile:
            summary_profile = _profile_decode(torch, graphed, [int(n) + 32 for n in plens[:8]])
        ops_ = _count_decode_ops(torch, M, eager, mods, quant)
        print(f"  one eager decode step dispatches {ops_['ops']} PyTorch ops ({ops_['views']} "
              f"views, {ops_['empty']} allocations) beside {ops_['kernels']} hand-kernel "
              f"launches; a graphed step is one replay")
        summary = {"decode_ms": m.decode_time_s / m.decode_steps * 1e3,
                   "prefill_ms": m.prefill_time_s / m.prefill_chunks * 1e3,
                   "eager_decode_ms": me.decode_time_s / me.decode_steps * 1e3,
                   "eager_prefill_ms": me.prefill_time_s / me.prefill_chunks * 1e3,
                   "decode_tok_s": m.throughput_tok_s, "launches": launches,
                   "paired": paired, "replay_ms": replay, "graph_pool_bytes": pool,
                   "capture_s": m.capture_time_s, "graphs": m.aot_steps,
                   "decode_graph_launches": dict(graphed._graph_launches["decode"]),
                   "weight_bytes": wb, "kv_pool_bytes": m.kv_pool_bytes, "run_peak": run_peak}
        if profile:
            summary["profile"] = summary_profile
        if backend != "tiled":
            summary["paired_backends"] = _paired_backends(torch, M, eager, ops, quant, mods)
        if precision != "float" or backend != "tiled":
            # The decode step takes the float run's greedy token: over the
            # vocab's near-flat logits a run's own argmax may differ, and the step's
            # logits would then answer another token.
            got = _prompt_logits(torch, M, kvc, quant, cfg, graphed.params, probe, "cuda",
                                 precision=precision, kv_precision=kv_precision,
                                 next_token=int(float_logits[0].argmax()))
            err = rel_l2(torch, got[1], float_logits[1])
            if backend != "tiled":
                print(f"  relative L2 of the first decode step's logits, {backend} vs tiled "
                      f"backend: {err:.3e} (bar 1e-2)")
                check(err < 1e-2, f"{backend} logits within 1e-2 relative L2 of tiled")
            else:
                print(f"  {cfg.n_layers}-layer bf16 fidelity (not checked): relative L2 of the logits, "
                      f"{precision} + {kv_precision} KV vs float: last prefill chunk "
                      f"{rel_l2(torch, got[0], float_logits[0]):.4f}, first decode step "
                      f"(on the float run's token) {err:.4f}")
    finally:
        ops.set_default_backend("tiled")
    del engines, graphed, eager, eng
    torch.cuda.empty_cache()
    return summary


def _run_paired(torch, graphed, eager):
    """Tick a graphed and an eager engine holding the same requests in
    lockstep, one tick each in turns (the graphed engine first on even
    ticks), so each step of one pairs with the same step of the other on
    the same state: ({"decode": [(graphed s, eager s)], "prefill": [...]
    (64-token chunks)}, wall seconds of the run)."""
    pairs = {"decode": [], "prefill": []}
    t0 = time.monotonic()
    tick = 0
    while graphed.scheduler.has_work:
        took = {}
        for eng in ((graphed, eager) if tick % 2 == 0 else (eager, graphed)):
            m = eng.metrics
            before = (m.decode_time_s, m.prefill_time_s, m.prefill_tokens)
            check(eng.tick(), "a tick with work ran an action")
            took[eng.graphs] = (m.decode_time_s - before[0], m.prefill_time_s - before[1],
                                m.prefill_tokens - before[2])
        g, e = took[True], took[False]
        check(g[2] == e[2] and (g[0] > 0) == (e[0] > 0), "both engines took the same step")
        if g[0] > 0:
            pairs["decode"].append((g[0], e[0]))
        elif g[2] == 64:
            pairs["prefill"].append((g[1], e[1]))
        tick += 1
    torch.cuda.synchronize()
    check(not eager.scheduler.has_work, "the eager engine drained with the graphed one")
    return pairs, time.monotonic() - t0


def _paired_medians(pairs, min_pairs: int = 10):
    """Medians of `_run_paired`'s pairs (ms) and the pairs the graphed
    step won, printed; at least `min_pairs` of each step kind."""
    paired = {}
    for label, v in pairs.items():
        g_ms, e_ms = [a * 1e3 for a, _ in v], [b * 1e3 for _, b in v]
        paired[label] = {"pairs": len(v), "graphed_ms": _median(g_ms),
                         "eager_ms": _median(e_ms),
                         "graphed_faster": sum(a < b for a, b in v)}
        check(len(v) >= min_pairs, f"at least {min_pairs} paired {label} steps: {len(v)}")
    print("  paired steps (the same step on the same state, one engine after the other, "
          "medians): " + "; ".join(
              f"{'decode step' if k == 'decode' else '64-token prefill chunk'} "
              f"{p['pairs']} pairs, graphed {p['graphed_ms']:.3f} ms, eager "
              f"{p['eager_ms']:.3f} ms, graphed faster in {p['graphed_faster']}"
              for k, p in paired.items()))
    return paired


def qwen3_traffic(np):
    """Phase 8's requests: 8 prompts of 256-1024 tokens (both ends drawn),
    32 new tokens each; the generator then draws the prompts."""
    rng = np.random.default_rng(8)
    plens = rng.integers(256, 1025, size=8)
    plens[:2] = (1024, 256)
    return plens, np.full(8, 32), rng


DENSE_ARCHS = ("qwen3-14b", "qwen2.5-14b", "mistral-nemo-12b", "bert-base", "vit-b-16")


def _tree_cpu(torch, tree):
    if isinstance(tree, dict):
        return {k: _tree_cpu(torch, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_cpu(torch, v) for v in tree]
    return tree.cpu()


def phase_parity_dense(torch, np, configs, M, kvc, Engine, RequestSpec, quant, mods):
    """Each arch of the dense family at its published widths, depth cut to 2
    layers, float32 (seed 1), on the card (kernels) and on the CPU (plain
    versions): `forward` logits over 80 tokens, the logits of a 70-token
    prompt's last prefill chunk and first decode step (phase 4's bar:
    max_abs_diff <= 1e-4 x max|logit|, top-8 equal), and the engine's
    greedy tokens for two prompts, equal.  Also counts the operands the
    GeMM wrapper re-laid on the card (`gemm.relaid`): none, bert-base's
    30522-wide head included."""
    gemm = mods["gemm"]
    for arch in DENSE_ARCHS:
        full = configs.get(arch)
        cfg = dataclasses.replace(full, n_layers=2, group_size=1, dtype="float32")
        reduced = {"n_layers": [full.n_layers, 2], "group_size": [full.group_size, 1],
                   "dtype": [full.dtype, "float32"]}
        t0 = time.monotonic()
        gemm.relaid = 0
        params = M.init_model(cfg, seed=1, device="cuda")
        cpu_params = _tree_cpu(torch, params)
        rng = np.random.default_rng(2)
        prompts = [rng.integers(0, cfg.vocab, size=n) for n in (70, 37)]
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab, size=(1, 80)))
        lines = []
        with torch.no_grad():
            got = M.forward(params, cfg, {"tokens": tokens.cuda()}).float().cpu()
            want = M.forward(cpu_params, cfg, {"tokens": tokens})
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        top_eq = got[0, -1].topk(8).indices.tolist() == want[0, -1].topk(8).indices.tolist()
        lines.append(f"forward (1 x 80): max_abs_diff={err:.3e} (max |logit| {scale:.3e}), "
                     f"top-8 {'equal' if top_eq else 'DIFFER'}")
        check(err <= 1e-4 * scale and top_eq, f"{arch}: forward logits CUDA vs CPU")
        del got, want
        got = _prompt_logits(torch, M, kvc, quant, cfg, params, prompts[0], "cuda")
        want = _prompt_logits(torch, M, kvc, quant, cfg, cpu_params, prompts[0], "cpu")
        for what, g_, w_ in zip(("last prefill chunk", "first decode step"), got, want):
            err, scale = float((g_ - w_).abs().max()), float(w_.abs().max())
            top_eq = g_.topk(8).indices.tolist() == w_.topk(8).indices.tolist()
            lines.append(f"{what}: max_abs_diff={err:.3e} (max |logit| {scale:.3e}), "
                         f"top-8 {'equal' if top_eq else 'DIFFER'}")
            check(err <= 1e-4 * scale and top_eq, f"{arch}: {what} logits CUDA vs CPU")
        out = {}
        for dev, p in (("cuda", params), ("cpu", cpu_params)):
            eng = Engine(cfg, p, slots=2, max_seq=96, block_size=16, max_chunk=32, device=dev)
            eng.warmup()
            for pr in prompts:
                eng.submit(RequestSpec(prompt=pr, max_new=6))
            out[dev] = eng.run()
            check(eng.metrics.cold_compiles == 0, f"{arch} {dev}: no cold step")
            del eng
        for rid in out["cpu"]:
            check(np.array_equal(out["cuda"][rid], out["cpu"][rid]),
                  f"{arch} request {rid}: CUDA tokens equal the CPU plain-version tokens")
        torch.cuda.synchronize()
        relaid = gemm.relaid
        print(f"  {arch} reduced {json.dumps(reduced)}: " + "; ".join(lines)
              + f"; engine tokens equal on card and CPU "
              f"{[out['cuda'][r].tolist() for r in sorted(out['cuda'])]}; GeMM operands "
              f"re-laid on the card: {relaid}; {time.monotonic() - t0:.1f}s")
        check(relaid == 0, f"{arch}: the GeMM re-laid {relaid} operands on the card path")
        del params, cpu_params
        torch.cuda.empty_cache()


def phase_serve_cli(np, arch="gemma3-1b", extra=("--precision", "w8a8", "--kv-precision",
                                                  "int8")):
    """`repro_torch.launch.serve.main` on the card at published widths: 4
    requests' tokens of the right shape, in vocab, served through the
    graphs its warmup captured, with no cold compile."""
    import contextlib
    import io

    from repro_torch import configs
    from repro_torch.launch import serve

    out = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out):
        gen = serve.main(["--arch", arch, "--widths", "published", "--requests", "4",
                          *extra])
    text = out.getvalue()
    for line in text.splitlines():
        if line.startswith(("warmup", "arch=", "engine")):
            print(f"  {line}")
    vocab = configs.get(arch).vocab
    check(gen.shape == (4, 16) and bool(((gen >= 0) & (gen < vocab)).all()),
          f"the CLI's tokens: shape {gen.shape}")
    check("captured as CUDA graphs" in text and "cold_compiles=0" in text,
          "the CLI served through the graphs its warmup captured")
    print(f"  {time.monotonic() - t0:.1f}s, tokens of the 4 requests in vocab")


def _live_slots(torch, eng, lengths):
    """Give the idle slots of `eng` (after its run) tables for their
    lengths plus a 64-token chunk, and those lengths, as a served batch
    holds them; returns the lengths on the device."""
    for slot, n in enumerate(lengths):
        eng.tables.ensure(slot, n + 64, eng.alloc)
    eng.tables.copy_to(eng.state.block_tables)
    base = torch.tensor(lengths, dtype=torch.int32, device=eng.device)
    eng.state.lengths.copy_(base)
    return base


def _free_slots(eng):
    for slot in range(eng.slots):
        eng.tables.release(slot, eng.alloc)
    eng.tables.copy_to(eng.state.block_tables)
    eng.state.lengths.zero_()


def _replayed_step_ms(torch, np, eng, lengths, reps: int = 10):
    """Device ms of one replay of the decode graph (every slot active) and
    of the 64-token chunk graph (into slot 0), from CUDA events around the
    replay, median of `reps` after one untimed; the lengths are restored
    before each replay, so each runs the same work."""
    base = _live_slots(torch, eng, lengths)
    eng.step_decode(np.zeros(eng.slots, np.int64), np.ones(eng.slots, bool))   # fills the inputs
    eng.step_prefill(np.zeros(64, np.int64), 0)
    out = {}
    for key in ("decode", "chunk64"):
        graph, _ = eng.step_graphs[key]
        times = []
        for i in range(reps + 1):
            eng.state.lengths.copy_(base)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            graph.replay()
            end.record()
            torch.cuda.synchronize()
            if i:
                times.append(start.elapsed_time(end))
        out[key] = _median(times)
    _free_slots(eng)
    return out


# Name fragments of the hand kernels in csrc/ (everything else a step runs
# is a plain PyTorch op between them).
HAND_KERNELS = ("gemm_kernel", "s8_kernel", "pipelined_kernel", "decode_split_kernel",
                "decode_combine_kernel", "quant_rows_kernel", "flash_kernel", "mma_kernel")


def _profile_decode(torch, eng, lengths, reps: int = 3):
    """torch.profiler over `reps` replays of the decode graph (8 slots live
    at `lengths`): `_profile_replays`."""
    _live_slots(torch, eng, lengths)
    graph, _ = eng.step_graphs["decode"]
    graph.replay()
    torch.cuda.synchronize()
    out = _profile_replays(torch, graph.replay, reps)
    _free_slots(eng)
    return out


def _profile_replays(torch, replay, reps: int = 3):
    """torch.profiler over `reps` calls of `replay` (a decode step's graph
    replay): device time per step split between the hand kernels and the
    plain PyTorch ops between them, and the top 10 kernels by time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(reps):
            replay()
        end.record()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3 / reps, e.count // reps)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(t for _, t, _ in rows)
    hand = sum(t for k, t, _ in rows if any(h in k for h in HAND_KERNELS))
    n_hand = sum(c for k, _, c in rows if any(h in k for h in HAND_KERNELS))
    n_all = sum(c for _, _, c in rows)
    span = start.elapsed_time(end) / reps
    print(f"  profile of one replayed decode step (torch.profiler, {reps} replays): "
          f"{n_all} kernels, {total:.3f} ms of kernel time in a {span:.3f} ms replay "
          f"({100 * (1 - total / span):.1f} % of it between kernels); hand kernels "
          f"{n_hand} launches {hand:.3f} ms ({100 * hand / max(total, 1e-9):.1f} %), "
          f"PyTorch ops {n_all - n_hand} kernels {total - hand:.3f} ms "
          f"({100 * (total - hand) / max(total, 1e-9):.1f} %)")
    check(total > 0, "the profiler saw the replayed kernels")
    top = sorted((r for r in rows if not any(h in r[0] for h in HAND_KERNELS)),
                 key=lambda r: -r[1])[:10]
    print("  the 10 PyTorch-op kernels that take the most time in the step:")
    for k, t, c in top:
        print(f"    {t:8.4f} ms {c:5d}x {k[:120]}")
    hand_top = collections.Counter()
    for k, t, n in rows:
        for h in HAND_KERNELS:
            if h in k:
                hand_top[h, "ms"] += t
                hand_top[h, "n"] += n
    return {"kernel_ms": total, "replay_ms": span, "hand_ms": hand, "glue_ms": total - hand,
            "kernels": n_all, "hand_kernels": n_hand,
            "top": [(k[:110], t, c) for k, t, c in top],
            "hand": sorted(((h, hand_top[h, "ms"], hand_top[h, "n"]) for h, f in hand_top
                            if f == "ms"), key=lambda r: -r[1])}


def _print_splits(torch, fd, eng, cfg):
    """The K2 split count the run launched with (the wrapper's own rule) per
    layer kind, for the decode step and each prefill chunk bucket."""
    from repro_torch.serving.prefill import chunk_buckets

    tables = eng.state.block_tables
    hkv, hq, d = cfg.n_kv_heads, cfg.n_heads, cfg.resolved_head_dim
    kinds = sorted(set(cfg.layer_kinds()))
    shapes = [("decode step", eng.slots, 1)] + [
        (f"prefill chunk {c}", 1, c) for c in chunk_buckets(eng.max_chunk)]
    parts = []
    for label, b, sq in shapes:
        q = torch.empty((b, sq, hq, d), device=eng.device, dtype=torch.bfloat16)
        n = fd.launch_splits(q, tables[:b], hkv)
        parts.append(f"{label} (B={b}, Sq={sq}, {tables.shape[1]} columns): "
                     + ", ".join(f"{k} {n}" for k in kinds))
    print(f"  K2 splits by the rule on {torch.cuda.get_device_properties(0).multi_processor_count}"
          " SMs: " + "; ".join(parts))


def _paired_backends(torch, M, eng, ops, quant, mods, reps: int = 20, calls: int = 1000):
    """The float decode step of `eng` (all slots active, the state not
    advanced) under each GeMM backend, in the order tiled, pipelined,
    pipelined, tiled: wall ms of a synced step and host ms until the step
    returns (its enqueue time), medians over `reps` steps after 2 untimed.
    Then the host us per eager call at a small bf16 shape (8 x 256 @ 256 x
    256: kernels of a few us, so the host sets the pace): `ops.linear` under
    each backend, and the two wrappers called directly."""
    gemm, gp = mods["gemm"], mods["gp"]
    prev = ops.get_default_backend()
    order = ("tiled", "pipelined", "pipelined", "tiled")
    tokens = torch.zeros((eng.slots, 1), dtype=torch.int64, device=eng.device)
    active = torch.ones((eng.slots,), dtype=torch.bool, device=eng.device)
    wall = {b: [] for b in order}
    host = {b: [] for b in order}
    with torch.no_grad(), quant.precision(eng.precision):
        for backend in order:
            ops.set_default_backend(backend)
            for i in range(reps + 2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                M.paged_decode_step(eng.params, eng.cfg, eng.state, tokens, active)
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                if i >= 2:
                    wall[backend].append((time.perf_counter() - t0) * 1e3)
                    host[backend].append((t1 - t0) * 1e3)
        x = torch.randn((8, 256), device=eng.device).to(torch.bfloat16)
        w = (torch.randn((256, 256), device=eng.device) / 16).to(torch.bfloat16)
        fns = {"ops.linear tiled": ("tiled", lambda: ops.linear(x, w)),
               "ops.linear pipelined": ("pipelined", lambda: ops.linear(x, w)),
               "gemm.gemm": ("tiled", lambda: gemm.gemm(x, w, out_dtype=torch.bfloat16)),
               "gemm_pipelined.gemm": ("tiled",
                                       lambda: gp.gemm(x, w, out_dtype=torch.bfloat16))}
        call_us = {k: [] for k in fns}
        for _ in range(2):
            for name, (backend, fn) in fns.items():
                ops.set_default_backend(backend)
                fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn()
                call_us[name].append((time.perf_counter() - t0) / calls * 1e6)
                torch.cuda.synchronize()
    ops.set_default_backend(prev)
    med = lambda v: sorted(v)[len(v) // 2]
    res = {"wall_ms": {b: med(v) for b, v in wall.items()},
           "host_ms": {b: med(v) for b, v in host.items()},
           "call_us": {k: min(v) for k, v in call_us.items()}}
    print("  paired decode steps (tiled, pipelined, pipelined, tiled; median of "
          f"{reps} x 2): " + ", ".join(
              f"{b} wall {res['wall_ms'][b]:.2f} ms host {res['host_ms'][b]:.2f} ms"
              for b in ("tiled", "pipelined")))
    print(f"  host us per eager call, 8x256 @ 256x256 bf16 (best of 2 x {calls}): "
          + ", ".join(f"{k} {v:.2f}" for k, v in res["call_us"].items()))
    return res


def _count_decode_ops(torch, M, eng, mods, quant):
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

    k0 = sum(read_counts(mods).values())
    tokens = torch.zeros((eng.slots, 1), dtype=torch.int64, device=eng.device)
    active = torch.ones((eng.slots,), dtype=torch.bool, device=eng.device)
    with torch.no_grad(), quant.precision(eng.precision), Count() as c:
        M.paged_decode_step(eng.params, eng.cfg, eng.state, tokens, active)
    torch.cuda.synchronize()
    return {"ops": c.ops, "views": c.views, "empty": c.empty,
            "kernels": sum(read_counts(mods).values()) - k0}


def phase_parity(torch, np, configs, M, kvc, Engine, RequestSpec, quant, ops):
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

    # The unpaged forward (K5 + K1 on the card) at the float bar, S = 520
    # > the 512 window, every position's logits.
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, size=(1, 520)))
    with torch.no_grad():
        got = M.forward(params, cfg, {"tokens": tokens.cuda()}).float().cpu()
        want = M.forward(cpu_params, cfg, {"tokens": tokens})
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    top_eq = got[0, -1].topk(8).indices.tolist() == want[0, -1].topk(8).indices.tolist()
    print(f"  forward logits (1 x 520 tokens), CUDA vs CPU: max_abs_diff={err:.3e} "
          f"(max |logit| {scale:.3e}), last position top-8 "
          f"{'equal' if top_eq else 'DIFFER'}; bar 1e-4 x max|logit|, top-8 equal")
    check(err <= 1e-4 * scale and top_eq, "forward logits CUDA vs CPU")
    del got, want
    # The calibration table, replayed through forward on each device.
    batches = quant.synthetic_batches(cfg, n=2, batch=2, seq=32, seed=0)
    t_cuda = quant.collect_scales(params, cfg, batches)
    t_cpu = quant.collect_scales(cpu_params, cfg, batches)
    worst = max(abs(t_cuda.scales[k] / v - 1) for k, v in t_cpu.scales.items()) \
        if sorted(t_cuda.scales) == sorted(t_cpu.scales) else float("inf")
    print(f"  calibration table CUDA vs CPU: {len(t_cuda)} sites, same keys: "
          f"{sorted(t_cuda.scales) == sorted(t_cpu.scales)}, max relative difference "
          f"{worst:.3e} (bar 1e-4)")
    check(worst <= 1e-4, "calibration table CUDA vs CPU")

    def serve(dev, p, precision, kv_precision):
        eng = Engine(cfg, p, slots=2, max_seq=640, block_size=16, max_chunk=64,
                     precision=precision, kv_precision=kv_precision, device=dev)
        eng.warmup()
        for pr in prompts:
            eng.submit(RequestSpec(prompt=pr, max_new=8))
        return eng.run()

    # Tokens only: calibrated w8a8, and the float engine under the pipelined
    # backend (K6 on the card, the same plain GeMM on the CPU).
    for precision, kv_precision, backend in (("w8a8-calibrated", "int8", "tiled"),
                                             ("float", "float", "pipelined")):
        out = {}
        ops.set_default_backend(backend)
        try:
            for dev, p in (("cuda", params), ("cpu", cpu_params)):
                t0 = time.monotonic()
                out[dev] = serve(dev, p, precision, kv_precision)
                print(f"  precision={precision}, kv={kv_precision}, backend={backend}, "
                      f"{dev}: {time.monotonic() - t0:.1f}s, tokens "
                      f"{[out[dev][r].tolist() for r in sorted(out[dev])]}")
        finally:
            ops.set_default_backend("tiled")
        for rid in out["cpu"]:
            check(np.array_equal(out["cuda"][rid], out["cpu"][rid]),
                  f"request {rid}: CUDA tokens equal the CPU plain-version tokens "
                  f"({precision}, {kv_precision} KV, {backend})")
    first_step = {}
    # f32 on both sides, sums in another order.  In float the logits agree
    # within 1e-4 x max|logit| with the same top-8.  In w8a8 a reordered sum
    # moves an activation across a rounding edge of its int8 code now and
    # then, and 6 layers at full width amplify that: a relative perturbation
    # of 1e-6 in the embedding table moves the logits by a few percent and
    # can reorder the top-8.  So the w8a8 bar is that noise floor, measured
    # here: CUDA vs CPU must differ by no more than twice the largest change
    # that three such perturbations make on the card, in relative L2, with
    # the same argmax.
    for precision, kv_precision, tol in (("float", "float", 1e-4), ("w8a8", "int8", None)):
        print(f"  precision={precision}, kv={kv_precision}:")
        out = {}
        for dev, p in (("cuda", params), ("cpu", cpu_params)):
            t0 = time.monotonic()
            out[dev] = serve(dev, p, precision, kv_precision)
            print(f"    {dev}: {time.monotonic() - t0:.1f}s, tokens "
                  f"{[out[dev][r].tolist() for r in sorted(out[dev])]}")
        for rid in out["cpu"]:
            check(np.array_equal(out["cuda"][rid], out["cpu"][rid]),
                  f"request {rid}: CUDA tokens equal the CPU plain-version tokens "
                  f"({precision}, {kv_precision} KV)")
        # Greedy tokens of random weights can be few and repetitive; the
        # logits of the long prompt's last prefill chunk and first decode
        # step must agree too.
        got = _prompt_logits(torch, M, kvc, quant, cfg, params, prompts[0], "cuda",
                             precision=precision, kv_precision=kv_precision)
        want = _prompt_logits(torch, M, kvc, quant, cfg, cpu_params, prompts[0], "cpu",
                              precision=precision, kv_precision=kv_precision)
        if tol is None:
            floor = [0.0, 0.0]
            for seed in range(3):
                noisy = _prompt_logits(torch, M, kvc, quant, cfg, _perturbed(torch, params, seed),
                                       prompts[0], "cuda", precision=precision,
                                       kv_precision=kv_precision)
                floor = [max(f, rel_l2(torch, n_, g_)) for f, n_, g_ in zip(floor, noisy, got)]
        for i, (what, g_, w_) in enumerate(zip(("last prefill chunk", "first decode step"),
                                               got, want)):
            scale = float(w_.abs().max())
            err = float((g_ - w_).abs().max())
            top_g, top_w = g_.topk(8).indices.tolist(), w_.topk(8).indices.tolist()
            line = (f"    logits after the {what}: max_abs_diff={err:.3e} "
                    f"(max |logit| {scale:.3e}), relative L2 {rel_l2(torch, g_, w_):.3e}, "
                    f"top-8 {'equal' if top_g == top_w else 'DIFFER'}, "
                    f"argmax {'equal' if top_g[0] == top_w[0] else 'DIFFERS'}")
            if tol is None:
                ok = rel_l2(torch, g_, w_) <= 2 * floor[i] and top_g[0] == top_w[0]
                line += f"; bar: relative L2 <= 2 x {floor[i]:.3e} (noise floor), argmax equal"
            else:
                ok = err <= tol * scale and top_g == top_w
                line += f"; bar: max_abs_diff <= {tol:g} x max|logit|, top-8 equal"
            print(line)
            check(ok, f"CUDA vs CPU logits, {what} ({precision}, {kv_precision} KV)")
        first_step[precision] = got[1]
    err = rel_l2(torch, first_step["w8a8"], first_step["float"])
    print(f"  w8a8 + int8 KV vs float on the card: relative L2 of the first decode "
          f"step's logits {err:.4f} (bar 0.15)")
    check(err < 0.15, "w8a8 logits within 0.15 relative L2 of the float logits")
    del params, cpu_params
    torch.cuda.empty_cache()


def phase_quality(torch, np, configs, M, quant, mods):
    """`quant.quality_delta` at full width, bf16: float, w8a8 and calibrated
    w8a8 NLLs of `forward` on 2 batches of (2, 1024) tokens.  Random weights
    make the NLLs a consistency check only: finite, calibrated within 0.5
    nats of float."""
    cfg = configs.get("gemma3-1b")
    params = M.init_model(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(6)
    toks = [rng.integers(0, cfg.vocab, size=(2, 1025)) for _ in range(2)]
    batches = [{"tokens": t[:, :-1], "labels": t[:, 1:]} for t in toks]
    reset_counts(mods)
    t0 = time.monotonic()
    table = quant.collect_scales(params, cfg, quant.synthetic_batches(cfg))
    q_dyn = quant.quantize_params(params, cfg=cfg)
    q_cal = quant.quantize_params(params, cfg=cfg, scales=table)
    torch.cuda.synchronize()
    calib = read_counts(mods)
    reset_counts(mods)
    d8 = quant.quality_delta(params, q_dyn, cfg, batches, mode="w8a8")
    cal = quant.eval_nll(q_cal, cfg, batches, mode="w8a8-calibrated")
    torch.cuda.synchronize()
    launches = read_counts(mods)
    print(f"  {time.monotonic() - t0:.1f}s: NLL float {d8['float_nll']:.4f}, w8a8 "
          f"{d8['quant_nll']:.4f} (delta {d8['delta_nll']:+.4f}), w8a8-calibrated "
          f"{cal:.4f} (delta {cal - d8['float_nll']:+.4f}); {len(table)} sites calibrated")
    print("  calibration launches: " + " ".join(f"{k}={v}" for k, v in calib.items() if v))
    print("  (2, 1024) forward launches: "
          + " ".join(f"{k}={v}" for k, v in launches.items() if v))
    check(calib["flash_attention"] == 26 * 2,
          f"calibration ran flash attention 26 x 2 times: {calib['flash_attention']}")
    want_fa = 26 * 3 * len(batches)              # 3 modes x batches
    check(launches["flash_attention"] == want_fa,
          f"the forwards ran flash attention 26 x 3 x 2 times: {launches['flash_attention']}")
    nlls = (d8["float_nll"], d8["quant_nll"], cal)
    check(all(math.isfinite(x) for x in nlls), "finite NLLs")
    check(abs(cal - d8["float_nll"]) < 0.5, "calibrated NLL within 0.5 nats of float")
    rows = quant.layer_error_rows(params, q_cal)
    print("  " + quant.format_error_table(rows, top=5).replace("\n", "\n  "))
    del params, q_dyn, q_cal
    torch.cuda.empty_cache()
    return {"launches": launches, "nll": nlls}


def _perturbed(torch, params, seed: int):
    """`params` with the embedding table scaled by 1 + 1e-6 x N(0, 1) per
    element: a change of the size f32 rounding makes."""
    g = torch.Generator(device=params["embed"].device).manual_seed(seed)
    noise = torch.randn(params["embed"].shape, generator=g, device=params["embed"].device)
    return dict(params, embed=params["embed"] * (1 + 1e-6 * noise))


def _prompt_logits(torch, M, kvc, quant, cfg, params, prompt, dev, *,
                   precision="float", kv_precision="float", next_token=None):
    """Last-position logits of `prompt` prefilled in 64-token chunks, then
    of one decode step on `next_token` (default: this run's greedy token),
    through the model functions on `dev`; in w8a8 the weights are made
    int8-resident first, as the engine does."""
    from repro_torch.serving.prefill import plan_chunks

    if precision != "float" and not quant.quantized_leaf_count(params):
        params = quant.quantize_params(params, cfg=cfg)
    bs = 16
    max_blocks = kvc.blocks_for(len(prompt) + 1, bs)
    state = M.init_paged_decode_state(cfg, 1, num_blocks=1 + max_blocks,
                                      block_size=bs, max_blocks_per_slot=max_blocks,
                                      device=dev, kv_precision=kv_precision)
    tables = kvc.BlockTables(1, max_blocks)
    tables.ensure(0, len(prompt) + 1, kvc.BlockAllocator(1 + max_blocks, bs))
    state.block_tables = tables.array(dev)
    pos = 0
    with torch.no_grad(), quant.precision(precision):
        for c in plan_chunks(len(prompt), 64):
            chunk = torch.as_tensor(prompt[None, pos:pos + c], device=dev)
            logits, state = M.prefill_chunk(params, cfg, state, chunk, 0)
            pos += c
        tok = logits[:, -1].argmax(-1)[:, None] if next_token is None else \
            torch.tensor([[next_token]], device=dev)
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


def _time_gemm(torch, gemm, g, M, name, K, N, transposed, rows, label=""):
    """K1 in bf16 at (M, K) x (K, N) over L2-cold copies of B (graph
    replay and eager call), its plain version, torch.matmul and the bound,
    into rows[("gemm", M, name)]; returns (a, the copies of B, iters)."""
    dev, dt = torch.device("cuda"), torch.bfloat16
    copies = max(1, min(128, math.ceil(2 * L2_BYTES / (K * N * 2))))
    a = torch.randn((M, K), generator=g, device=dev).to(dt)
    bs_ = []
    for _ in range(copies):
        b = torch.randn((N, K) if transposed else (K, N), generator=g, device=dev).to(dt)
        bs_.append(b.t() if transposed else b)
    iters = max(20, min(400, 4 * copies))
    kcalls = [lambda b=b: gemm.gemm(a, b, out_dtype=dt) for b in bs_]
    t_k = _time_ms(torch, kcalls, iters)
    t_e = _time_ms(torch, kcalls, iters, graph=False)
    t_p = _time_ms(torch, [lambda b=b: gemm.gemm_plain(a, b, dt) for b in bs_[:4]],
                   max(4, iters // 10), graph=False)
    t_l = _time_ms(torch, [lambda b=b: torch.matmul(a, b) for b in bs_], iters)
    bound, by = _bound((M * K + K * N + M * N) * 2, 2 * M * K * N, PEAK_FLOPS["bfloat16"])
    rows[("gemm", M, name)] = (t_k, t_p, t_l, bound)
    print(f"  {label}gemm bf16 M={M} {name} {K}x{N}: kernel {t_k * 1e3:.1f} us "
          f"(eager call {t_e * 1e3:.1f} us), plain {t_p * 1e3:.1f} us, torch.matmul "
          f"{t_l * 1e3:.1f} us, bound {bound * 1e3:.2f} us ({by}), {bound / t_k:.1%} of bound")
    return a, bs_, iters


def phase_times(torch, gemm, gp, fd, kvc):
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(2)
    dt = torch.bfloat16
    rows = {}
    # Every shape at M = 8 (decode) and 64 (prefill projections); the head
    # also at M = 1 (prefill_chunk runs it on the last position only).
    shapes = [(M, s) for M in (8, 64) for s in GEMM_SHAPES] + \
        [(1, s) for s in GEMM_SHAPES if s[0] == "head"]
    for M, (name, K, N, transposed) in shapes:
        a, bs_, iters = _time_gemm(torch, gemm, g, M, name, K, N, transposed, rows)
        t_k, t_p, t_l, bound = rows[("gemm", M, name)]
        # K6 on the same L2-cold copies at each ring depth (Fig. 5 sweep);
        # its plain version is K1's (the same function).
        t_d = {}
        for d in DEPTHS:
            t_d[d] = _time_ms(torch, [lambda b=b, d=d: gp.gemm(a, b, depth=d, out_dtype=dt)
                                      for b in bs_], iters)
            rows[("gemm_pipelined", M, name, d)] = (t_d[d], t_p, t_l, bound)
        print(f"  gemm_pipelined bf16 M={M} {name} {K}x{N}: depth "
              + " / ".join(f"{d}: {t_d[d] * 1e3:.1f}" for d in DEPTHS)
              + f" us (K1 {t_k * 1e3:.1f} us, bound {bound * 1e3:.2f} us)")
        del a, bs_

    _time_split_rules(torch, gemm, g)
    B, Hkv, G, D, bs, max_seq = 8, 1, 4, 256, 16, 1200
    lengths = [1100, 1024, 950, 700, 513, 260, 128, 64]
    pools = [_lived_in_pool(torch, kvc, dev, g, dt, B, Hkv, D, bs, max_seq, lengths)
             for _ in range(12)]                   # ~120 MB: the pool is L2-cold
    _time_decode(torch, fd, kvc, pools, g, lengths, G, bs, max_seq, rows, "flash_decode")
    del pools
    torch.cuda.empty_cache()
    return rows


def phase_times_dense(torch, gemm, gemm8, fd, kvc, gp, fa):
    """The kernels per qwen3-14b decode step (8 slots, bf16, L2 cold): K1 and
    K6 (depth 3) at M = 8 on each projection and the untied head (40 x (q,
    k, v, o, gate, up, down) + head), beside torch.matmul and the bound;
    K5 per forward over (2, 1024) tokens (40 global layers, 40 q heads over
    8 kv heads, D 128) beside SDPA and the bound; the w8a8 GeMM
    (one launch, per-row scales) at the same shapes beside torch._int_mm
    and its bound; K2 over float and int8 pools at 40 q heads over 8 kv
    heads, D 128, 8 slots at QWEN3_LENGTHS (40 global layers), beside SDPA
    and the bound."""
    dev, dt = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(10)
    rows = {}
    for name, K, N, transposed in QWEN3_SHAPES:
        a, bs_, iters = _time_gemm(torch, gemm, g, 8, name, K, N, transposed, rows,
                                   "qwen3-14b ")
        t_k6 = _time_ms(torch, [lambda b=b: gp.gemm(a, b, depth=3, out_dtype=dt)
                                for b in bs_], iters)
        rows[("gemm_pipelined", 8, name)] = (t_k6,) + rows[("gemm", 8, name)][1:]
        print(f"  qwen3-14b gemm_pipelined (depth 3) bf16 M=8 {name} {K}x{N}: kernel "
              f"{t_k6 * 1e3:.1f} us, {rows[('gemm', 8, name)][3] / t_k6:.1%} of bound")
        del bs_
        ws = [(torch.randint(-127, 128, (N, K), generator=g, device=dev,
                             dtype=torch.int8).t(),
               torch.rand((1, N), generator=g, device=dev) * 0.1)
              for _ in range(max(1, min(128, math.ceil(2 * L2_BYTES / (K * N)))))]
        t_f = _time_ms(torch, [lambda b=b, sb=sb: gemm8._w8a8_fused(a, b, sb, None, dt)
                               for b, sb in ws], iters)
        t_fp = _time_ms(torch, [lambda b=b, sb=sb: gemm8.gemm_w8a8_plain(a, b, sb, None, dt)
                                for b, sb in ws[:2]], 4, graph=False)
        a_lib = torch.zeros((32, K), device=dev, dtype=torch.int8)   # cuBLASLt takes M > 16
        t_l = _time_ms(torch, [lambda b=b: torch._int_mm(a_lib, b) for b, _ in ws], iters)
        bound, by = _bound(2 * 8 * K + K * N + 4 * N + 2 * 8 * N, 2 * 8 * K * N,
                           PEAK_FLOPS["int8"])
        rows[("gemm_w8a8", 8, name)] = (t_f, t_fp, t_l, bound)
        print(f"  qwen3-14b gemm_w8a8 bf16 -> bf16 M=8 {name} {K}x{N}: one launch "
              f"{t_f * 1e3:.1f} us, plain {t_fp * 1e3:.1f} us, torch._int_mm (M padded to "
              f"32) {t_l * 1e3:.1f} us, bound {bound * 1e3:.2f} us ({by}), "
              f"{bound / t_f:.1%} of bound")
        del a, ws, a_lib
        torch.cuda.empty_cache()
    L, B, Hkv, G, D, bs, max_seq = 40, 8, 8, 5, 128, 16, 1200
    # ~39 MB a pool (601 blocks of 16 tokens x 8 kv heads x D 128, K and V,
    # bf16): four pools exceed the L2 three times over.
    for key in ("flash_decode", "flash_decode_int8"):
        pools = [_lived_in_pool_int8(torch, kvc, dev, g, B, Hkv, D, bs, max_seq,
                                     QWEN3_LENGTHS) if key == "flash_decode_int8" else
                 _lived_in_pool(torch, kvc, dev, g, dt, B, Hkv, D, bs, max_seq, QWEN3_LENGTHS)
                 for _ in range(4)]
        _time_decode(torch, fd, kvc, pools, g, QWEN3_LENGTHS, G, bs, max_seq, rows, key,
                     windows=(None,), label="qwen3-14b ")
        del pools
        torch.cuda.empty_cache()
    rows[("flash_attention", 1024, None)] = _time_flash_qwen3(torch, fa, g)
    out = {}
    for key, per in [(k, [((k, 8, n), L if n != "head" else 1) for n, *_ in QWEN3_SHAPES])
                     for k in ("gemm", "gemm_pipelined", "gemm_w8a8")] + \
            [(k, [((k, "decode", None), L)]) for k in ("flash_decode", "flash_decode_int8")] + \
            [("flash_attention", [(("flash_attention", 1024, None), L)])]:
        out[key] = [sum(n * rows[k][i] for k, n in per) for i in range(4)]
    lib = {"gemm": "torch.matmul", "gemm_pipelined": "torch.matmul",
           "gemm_w8a8": "torch._int_mm", "flash_decode": "sdpa", "flash_decode_int8": "sdpa",
           "flash_attention": "sdpa"}
    print("[8] one qwen3-14b decode step (8 slots, L2 cold; the GeMMs 40 x 7 projections + "
          "head at M=8, K6 at depth 3, K2 40 layers) and, for flash_attention, one forward "
          "over (2, 1024) tokens (40 layers): " + "; ".join(
              f"{k} {t[0]:.3f} ms ({lib[k]} {t[2]:.3f} ms, plain {t[1]:.3f} ms, bound "
              f"{t[3]:.4f} ms)" for k, t in out.items()))
    return out


def _time_flash_qwen3(torch, fa, g):
    """K5 on one qwen3-14b layer of a (2, 1024) forward (40 q heads over 8
    kv heads, D 128, causal, bf16, L2 cold), beside its plain version, SDPA
    over K/V repeated to the q heads beforehand (untimed) and the bound."""
    import torch.nn.functional as F

    dev, dt = torch.device("cuda"), torch.bfloat16
    B, S, Hq, Hkv, D = 2, 1024, 40, 8, 128
    set_bytes = 2 * B * S * D * (2 * Hq + 2 * Hkv)
    sets = [tuple(torch.randn((B, S, h, D), generator=g, device=dev).to(dt)
                  for h in (Hq, Hkv, Hkv))
            for _ in range(max(2, math.ceil(2 * L2_BYTES / set_bytes)))]
    t_k = _time_ms(torch, [lambda q=q, k=k, v=v: fa.flash_attention(q, k, v)
                           for q, k, v in sets], 40)
    t_p = _time_ms(torch, [lambda q=q, k=k, v=v: fa.flash_attention_plain(q, k, v)
                           for q, k, v in sets[:2]], 4, graph=False)
    lib = [(q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3).repeat_interleave(Hq // Hkv, 1),
            v.permute(0, 2, 1, 3).repeat_interleave(Hq // Hkv, 1)) for q, k, v in sets]
    t_l = _time_ms(torch, [lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
        q, k, v, is_causal=True) for q, k, v in lib], 40)
    bound, by = _bound(set_bytes, 4 * B * Hq * D * (S * (S + 1) // 2), PEAK_FLOPS["bfloat16"])
    print(f"  qwen3-14b flash_attention bf16 B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} causal: "
          f"kernel {t_k * 1e3:.1f} us, plain {t_p * 1e3:.1f} us, sdpa {t_l * 1e3:.1f} us, "
          f"bound {bound * 1e3:.2f} us ({by}), {bound / t_k:.1%} of bound")
    del sets, lib
    torch.cuda.empty_cache()
    return (t_k, t_p, t_l, bound)


def _time_split_rules(torch, gemm, g):
    """K1 at M = 8 on the projection shapes where the two rules differ (L2
    cold): at the split count of its rule (one block per SM, at most 16
    splits) and at the count a rule of two blocks per SM (at most 32) gives,
    launched through the kernel's C entry with the forced plan: the
    evidence for the rule.  Timing only; nothing is counted."""
    dev, dt, M = torch.device("cuda"), torch.bfloat16, 8
    sms = gemm.sm_count(dev)
    ws, counters = gemm.splitk_scratch(dev)

    def launch(a, b, out, plan):
        err = gemm._lib()(a.data_ptr(), b.data_ptr(), out.data_ptr(), ws.data_ptr(),
                          counters.data_ptr(), M, b.shape[1], a.shape[1], a.stride(0),
                          b.stride(0), 1, 1, 1, plan.swap, plan.kmajor, plan.kps, plan.splits,
                          torch.cuda.current_stream(dev).cuda_stream)
        check(err == 0, f"gemm launch with a forced plan: cudaError_t {err}")

    for name, K, N, _ in [s for s in GEMM_SHAPES if s[0] in ("gate", "down")]:
        a = torch.randn((M, K), generator=g, device=dev).to(dt)
        bs_ = [torch.randn((K, N), generator=g, device=dev).to(dt)
               for _ in range(max(1, math.ceil(2 * L2_BYTES / (K * N * 2))))]
        out = torch.empty((M, N), dtype=dt, device=dev)
        tiles, k_tiles = -(-N // gemm.TILE_N), -(-K // 64)
        times = {}
        for label, target, cap in (("one block per SM (the rule)", sms, gemm.MAX_SPLITS[True]),
                                   ("two blocks per SM", 2 * sms, 32)):
            plan = gemm.gemm_plan(M, N, K, False, sms, 2, max(1, min(
                -(-target // tiles), k_tiles // gemm.MIN_K_TILES, cap)))
            check(plan.ws_elems <= ws.numel(), "forced plan fits the workspace")
            times[label] = (plan.splits, _time_ms(torch, [
                lambda b=b, plan=plan: launch(a, b, out, plan) for b in bs_], 200))
        print(f"  gemm bf16 M={M} {name} {K}x{N} split rule: " + ", ".join(
            f"{label} {n} splits {t * 1e3:.1f} us" for label, (n, t) in times.items()))
        del a, bs_


def _time_decode(torch, fd, kvc, pools, g, lengths, G, bs, max_seq, rows, key,
                 windows=(None, 512), label=""):
    """K2 over L2-cold copies of a lived-in pool (float or int8), bf16 q, at
    the decode step (8 slots, Sq 1) and a prefill chunk (the 1100-token
    slot, Sq 64), global and window 512: the wrapper's rule (graph replay
    and eager call), num_splits 1 and 4, the plain walk, SDPA over K/V
    gathered (and dequantized) beforehand, and the bound."""
    import torch.nn.functional as F

    dev, dt = torch.device("cuda"), torch.bfloat16
    int8 = key == "flash_decode_int8"
    Hkv, D = pools[0][0].k.shape[2], pools[0][0].k.shape[3]
    for what, b_, sq in (("decode", len(lengths), 1), ("prefill", 1, 64)):
        lens = lengths[:b_]
        q = torch.randn((b_, sq, Hkv * G, D), generator=g, device=dev).to(dt)
        idx = torch.tensor([n - sq for n in lens], dtype=torch.int32, device=dev)
        sel = [(c, t[:b_].contiguous()) for c, t in pools]
        n_rule = fd.launch_splits(q, sel[0][1], Hkv)
        for window in windows:
            def kcalls(spec=None):
                return [lambda c=c, t=t: fd.flash_decode_attention(
                    q, c, t, idx, window=window, spec=spec) for c, t in sel]
            t_k = _time_ms(torch, kcalls(), 120)
            t_e = _time_ms(torch, kcalls(), 120, graph=False)
            t_s = {n: _time_ms(torch, kcalls(fd.FlashDecodeSpec(num_splits=n)), 120)
                   for n in (1, 4)}
            t_p = _time_ms(torch, [lambda c=c, t=t: fd.ref_paged_decode(
                q, c, t, idx, window=window) for c, t in sel[:4]], 8, graph=False)
            qpos = idx[:, None].long() + torch.arange(sq, device=dev)[None]
            kpos = torch.arange(sel[0][1].shape[1] * bs, device=dev)
            mask = kpos[None, None, :] <= qpos[..., None]
            if window is not None:
                mask &= (qpos[..., None] - kpos[None, None, :]) < window
            lib_in = []
            for c, t in sel[:4]:
                k, v = kvc.gather_kv(c, t)            # int8: dequantized, f32
                lib_in.append((k.to(dt).permute(0, 2, 1, 3).repeat_interleave(G, 1),
                               v.to(dt).permute(0, 2, 1, 3).repeat_interleave(G, 1)))
            qs = q.permute(0, 2, 1, 3)
            t_l = _time_ms(torch, [lambda k=k, v=v: F.scaled_dot_product_attention(
                qs, k, v, attn_mask=mask[:, None]) for k, v in lib_in], 120)
            keys, flops = 0, 0
            for i0 in idx.tolist():
                lo = 0 if window is None else max(0, i0 - window + 1)
                keys += (i0 + sq) - lo
                for t in range(sq):
                    qp = i0 + t
                    flops += 4 * G * D * (qp + 1 - (0 if window is None
                                                     else max(0, qp - window + 1)))
            row_bytes = Hkv * (D + 4) if int8 else Hkv * D * 2
            nbytes = (2 * keys * row_bytes + 2 * 2 * q.numel() + 4 * idx.numel()
                      + 4 * b_ * (max_seq // bs))
            bound, by = _bound(nbytes, flops, PEAK_FLOPS["bfloat16"])
            rows[(key, what, window)] = (t_k, t_p, t_l, bound, by, t_s[1], t_s[4], t_e)
            pool = "int8 pool, q bf16" if int8 else "bf16"
            print(f"  {label}{key} {pool} {what} B={b_} Sq={sq} window={window}: kernel "
                  f"{t_k * 1e3:.1f} us at the rule's {n_rule} splits (eager call "
                  f"{t_e * 1e3:.1f} us), num_splits=1 {t_s[1] * 1e3:.1f} us, num_splits=4 "
                  f"{t_s[4] * 1e3:.1f} us, plain {t_p * 1e3:.1f} us, sdpa "
                  f"{t_l * 1e3:.1f} us, bound {bound * 1e3:.2f} us ({by}), "
                  f"{bound / t_k:.1%} of bound")
            del lib_in


def phase_times_flash(torch, fa):
    """K5 at (B 2, Hq 4, Hkv 1, D 256), S 1024 and 4096, causal global and
    window 512, bf16, beside SDPA over the same q and K/V repeated to the
    q heads beforehand (untimed), and the operations bound."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    dt, B, Hq, Hkv, D = torch.bfloat16, 2, 4, 1, 256
    rows = {}
    for S in (1024, 4096):
        set_bytes = 2 * B * S * D * (2 * Hq + 2 * Hkv)
        sets = [tuple(torch.randn((B, S, h, D), generator=g, device=dev).to(dt)
                      for h in (Hq, Hkv, Hkv))
                for _ in range(max(2, math.ceil(2 * L2_BYTES / set_bytes)))]
        pos = torch.arange(S, device=dev)
        for window in (None, 512):
            kcalls = [lambda q=q, k=k, v=v: fa.flash_attention(q, k, v, window=window)
                      for q, k, v in sets]
            t_k = _time_ms(torch, kcalls, 40)
            t_e = _time_ms(torch, kcalls, 40, graph=False)
            t_p = _time_ms(torch, [lambda q=q, k=k, v=v: fa.flash_attention_plain(
                q, k, v, window=window) for q, k, v in sets[:2]], 4, graph=False)
            lib = [(q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3).repeat_interleave(Hq // Hkv, 1),
                    v.permute(0, 2, 1, 3).repeat_interleave(Hq // Hkv, 1)) for q, k, v in sets]
            if window is None:
                lcalls = [lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True) for q, k, v in lib]
            else:
                mask = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < window)
                lcalls = [lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask) for q, k, v in lib]
            t_l = _time_ms(torch, lcalls, 40)
            pairs = S * (S + 1) // 2 if window is None else \
                sum(min(i + 1, window) for i in range(S))
            bound, by = _bound(2 * B * S * D * (2 * Hq + 2 * Hkv), 4 * B * Hq * D * pairs,
                               PEAK_FLOPS["bfloat16"])
            rows[("flash_attention", S, window)] = (t_k, t_p, t_l, bound, by)
            print(f"  flash_attention bf16 B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} causal "
                  f"window={window}: kernel {t_k * 1e3:.1f} us (eager call {t_e * 1e3:.1f} us), "
                  f"plain {t_p * 1e3:.1f} us, sdpa {t_l * 1e3:.1f} us, bound "
                  f"{bound * 1e3:.2f} us ({by}), {bound / t_k:.1%} of bound")
            del lib, kcalls, lcalls
        del sets
    torch.cuda.empty_cache()
    return rows


def _bound(nbytes: float, ops: float, peak: float):
    """(bound in ms, what bounds it) for `nbytes` moved and `ops` done."""
    t_b, t_o = nbytes / HBM_BPS, ops / peak
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def phase_times_int8(torch, gemm8, kq, fd, kvc):
    """The int8 slice's kernels at their main-path shapes (bf16 out, weights
    in the serving layout, L2 cold): at M = 1, 8 and 64 the w8a8 GeMM as one
    launch with per-row scales (graph replay and eager call) and with a
    static scale, its two launches (the row quantization, then the dequant
    GeMM), the dequant GeMM alone on quantized rows, their plain versions
    and torch._int_mm; the row quantization at M = 8 and 64; the int8
    decode branch beside SDPA over K/V gathered and dequantized
    beforehand."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    i8 = dict(generator=g, device=dev, dtype=torch.int8)
    bf = torch.bfloat16
    rows = {}
    for M in (1, 8, 64):
        for name, K, N, _ in GEMM_SHAPES:
            copies = max(1, min(128, math.ceil(2 * L2_BYTES / (K * N))))
            x = torch.randn((M, K), generator=g, device=dev).to(bf)
            act = (x.float().abs().max() / 127).reshape(())
            a, sa = kq.quantize_rows(x)
            ws = [(torch.randint(-127, 128, (N, K), **i8).t(),
                   torch.rand((1, N), generator=g, device=dev) * 0.1)
                  for _ in range(copies)]
            iters = max(20, min(400, 4 * copies))
            n_plain = max(4, iters // 10)
            kcalls = [lambda b=b, sb=sb: gemm8.dequant_gemm(a, b, sa, sb, out_dtype=bf)
                      for b, sb in ws]
            t_k = _time_ms(torch, kcalls, iters)
            t_e = _time_ms(torch, kcalls, iters, graph=False)
            t_p = _time_ms(torch, [lambda b=b, sb=sb: gemm8.dequant_gemm_plain(
                a, b, sa, sb, bf) for b, sb in ws[:4]], n_plain, graph=False)
            # cuBLASLt's int8 -> int32 product takes M > 16: A padded to 32 rows
            a_lib = torch.zeros((max(M, 32), K), device=dev, dtype=torch.int8)
            a_lib[:M] = a
            t_l = _time_ms(torch, [lambda b=b: torch._int_mm(a_lib, b) for b, _ in ws],
                           iters)
            bound, by = _bound(M * K + K * N + 4 * (M + N) + 2 * M * N, 2 * M * K * N,
                               PEAK_FLOPS["int8"])
            rows[("dequant_gemm", M, name)] = (t_k, t_p, t_l, bound, by)
            fcalls = [lambda b=b, sb=sb: gemm8._w8a8_fused(x, b, sb, None, bf)
                      for b, sb in ws]
            t_f = _time_ms(torch, fcalls, iters)
            t_fe = _time_ms(torch, fcalls, iters, graph=False)
            t_fs = _time_ms(torch, [lambda b=b, sb=sb: gemm8._w8a8_fused(
                x, b, sb, act, bf) for b, sb in ws], iters)
            def two_launches(b, sb):
                x_q, sx = kq.quantize_rows(x)
                return gemm8.dequant_gemm(x_q, b, sx, sb, out_dtype=bf)

            t_two = _time_ms(torch, [lambda b=b, sb=sb: two_launches(b, sb) for b, sb in ws],
                             iters)
            t_fp = _time_ms(torch, [lambda b=b, sb=sb: gemm8.gemm_w8a8_plain(
                x, b, sb, None, bf) for b, sb in ws[:4]], n_plain, graph=False)
            bound_f, by_f = _bound(2 * M * K + K * N + 4 * N + 2 * M * N, 2 * M * K * N,
                                   PEAK_FLOPS["int8"])
            rows[("gemm_w8a8", M, name)] = (t_f, t_fp, t_l, bound_f, by_f, t_fs, t_two, t_fe)
            print(f"  gemm_w8a8 bf16 -> bf16 M={M} {name} {K}x{N}: one launch {t_f * 1e3:.1f} us "
                  f"(eager call {t_fe * 1e3:.1f} us), static scale {t_fs * 1e3:.1f} us, "
                  f"two launches (quantize_rows + dequant_gemm) {t_two * 1e3:.1f} us "
                  f"(the plan: {'one' if M <= gemm8.FUSED_ROWS else 'two'}), plain "
                  f"{t_fp * 1e3:.1f} us, torch._int_mm (M padded to {max(M, 32)}) "
                  f"{t_l * 1e3:.1f} us, bound {bound_f * 1e3:.2f} us ({by_f}), "
                  f"{bound_f / t_f:.1%} of bound")
            print(f"  dequant_gemm int8 -> bf16 M={M} {name} {K}x{N}: kernel "
                  f"{t_k * 1e3:.1f} us (eager call {t_e * 1e3:.1f} us), plain "
                  f"{t_p * 1e3:.1f} us, bound {bound * 1e3:.2f} us ({by}), "
                  f"{bound / t_k:.1%} of bound")
            del a, x, ws, a_lib
    for M, K in [(M, K) for M in (8, 64) for K in sorted(QUANT_PER_CHUNK)]:
        xs = [torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
              for _ in range(64)]
        kcalls = [lambda x=x: kq.quantize_rows(x) for x in xs]
        t_k = _time_ms(torch, kcalls, 256)
        t_e = _time_ms(torch, kcalls, 256, graph=False)
        t_p = _time_ms(torch, [lambda x=x: kq.quantize_rows_plain(x) for x in xs],
                       64, graph=False)
        bound, by = _bound(M * K * 2 + M * K + 4 * M, 3 * M * K, PEAK_FLOPS["float32"])
        rows[("quantize_rows", M, K)] = (t_k, t_p, None, bound, by)
        print(f"  quantize_rows bf16 M={M} K={K}: kernel {t_k * 1e3:.2f} us (eager call "
              f"{t_e * 1e3:.1f} us), plain {t_p * 1e3:.1f} us, library: none, bound "
              f"{bound * 1e3:.4f} us ({by}), {bound / t_k:.2%} of bound")

    B, Hkv, G, D, bs, max_seq = 8, 1, 4, 256, 16, 1200
    lengths = [1100, 1024, 950, 700, 513, 260, 128, 64]
    pools = [_lived_in_pool_int8(torch, kvc, dev, g, B, Hkv, D, bs, max_seq, lengths)
             for _ in range(24)]                   # ~120 MB of codes: the pool is L2-cold
    _time_decode(torch, fd, kvc, pools, g, lengths, G, bs, max_seq, rows, "flash_decode_int8")
    del pools
    torch.cuda.empty_cache()
    return rows


def per_step_w8a8(rows, fused_rows: int, n_layers: int = 26):
    """The w8a8 GeMM's per-shape times summed over one gemma3-1b decode step
    (183 GeMMs at M = 8) and one 64-token prefill chunk (26 x the
    projections at M = 64, the head at M = 1), in ms: as one launch with
    per-row (w8a8) and static (calibrated) scales, as two launches, as the
    plan runs it (one launch at M <= fused_rows), the plain composition,
    torch._int_mm and the bound."""
    layer = ("q", "k", "v", "o", "gate", "up", "down")
    names = {"kernel": 0, "plain": 1, "int_mm": 2, "bound": 3, "static": 5,
             "two_launch": 6, "eager": 7}

    def plan(M, s):
        r = rows[("gemm_w8a8", M, s)]
        return r[0] if M <= fused_rows else r[6]

    out = {}
    for label, mp, mh in (("decode", 8, 8), ("prefill", 64, 1)):
        out[label] = {name: sum(n_layers * rows[("gemm_w8a8", mp, s)][i] for s in layer)
                      + rows[("gemm_w8a8", mh, "head")][i] for name, i in names.items()}
        out[label]["plan"] = sum(n_layers * plan(mp, s) for s in layer) + plan(mh, "head")
    return out


def per_step_int8(rows, n_layers: int = 26, n_global: int = 4):
    """Aggregate the int8 kernels' per-shape times where the w8a8 + int8 KV
    path of gemma3-1b runs them: the dequant GeMM and the row quantization
    over one 64-token prefill chunk's 182 projections (M = 64, the w8a8
    GeMM's two launches), the int8 decode branch over one decode step:
    [kernel, plain, library, bound, bound_by]."""
    layer = ("q", "k", "v", "o", "gate", "up", "down")

    def total(terms, i):
        return None if any(r[i] is None for r, _ in terms) else sum(n * r[i] for r, n in terms)

    terms = {
        "dequant_gemm": [(rows[("dequant_gemm", 64, s)], n_layers) for s in layer],
        "quantize_rows": [(rows[("quantize_rows", 64, k)], n)
                          for k, n in QUANT_PER_CHUNK.items()],
        "flash_decode_int8": [(rows[("flash_decode_int8", "decode", None)], n_global),
                              (rows[("flash_decode_int8", "decode", 512)],
                               n_layers - n_global)],
    }
    return {name: [total(t, i) for i in range(4)] + [t[0][0][4]]
            for name, t in terms.items()}


def per_step_slice3(rows, n_layers: int = 26, n_global: int = 4, depth: int = 3):
    """K6 at `depth` over one decode step's GeMMs (M = 8), as K1's; K5 over
    one forward of (2, 1024) tokens: 4 global + 22 window-512 layers."""
    layer = ("q", "k", "v", "o", "gate", "up", "down")
    pipe = [sum(n_layers * rows[("gemm_pipelined", 8, s, depth)][i] for s in layer)
            + rows[("gemm_pipelined", 8, "head", depth)][i] for i in range(4)]
    flash = [n_global * rows[("flash_attention", 1024, None)][i]
             + (n_layers - n_global) * rows[("flash_attention", 1024, 512)][i]
             for i in range(4)]
    return {"gemm_pipelined": pipe + ["bytes"],
            "flash_attention": flash + [rows[("flash_attention", 1024, None)][4]]}


def per_step_decode(rows, key, n_layers: int = 26, n_global: int = 4):
    """K2's times summed over one gemma3-1b step (4 global + 22 window-512
    layers) for the decode step and a prefill chunk of the 1100-token slot:
    the rule (graph replay), num_splits 1 and 4, the eager call, SDPA and
    the bound, in ms."""
    names = {"rule": 0, "sdpa": 2, "bound": 3, "splits=1": 5, "splits=4": 6, "eager": 7}
    return {label: {name: n_global * rows[(key, label, None)][i]
                    + (n_layers - n_global) * rows[(key, label, 512)][i]
                    for name, i in names.items()}
            for label in ("decode", "prefill")}


def per_prefill_chunk(rows, n_layers: int = 26, depth: int = 3):
    """The float GeMMs over one 64-token prefill chunk of gemma3-1b: 26 x
    the projections at M = 64 and the tied head at M = 1 (prefill_chunk
    runs it on the last position only): {kernel: [kernel, plain, library,
    bound]} for K1 and K6 at `depth`."""
    layer = ("q", "k", "v", "o", "gate", "up", "down")
    keys = {"gemm": lambda M, s: ("gemm", M, s),
            "gemm_pipelined": lambda M, s: ("gemm_pipelined", M, s, depth)}
    return {name: [sum(n_layers * rows[key(64, s)][i] for s in layer) + rows[key(1, "head")][i]
                   for i in range(4)]
            for name, key in keys.items()}


# Phase 9: this slice's paths on gemma3-1b at published widths (26 layers,
# bf16, random weights from seed 0), 8 slots, block 16, chunk 64, k = 4.
PHASE9_KW = dict(slots=8, max_seq=1200, block_size=16, max_chunk=64)
DRAFT_K = 4
PHASE9_DEVICE = "cuda"


def storm_traffic(np, vocab):
    """A regeneration storm: 16 requests over 4 distinct prompts of
    256-1024 tokens, 64 new tokens each; repeats admitted after a copy
    finished find its stream in the drafter's corpus."""
    rng = np.random.default_rng(9)
    plens = rng.integers(256, 1025, size=4)
    plens[:2] = (1024, 256)
    prompts = [rng.integers(0, vocab, size=int(n)) for n in plens]
    return [(prompts[i % 4], 64) for i in range(16)]


def random_traffic(np, vocab):
    """8 i.i.d. random prompts of 256-1024 tokens, 64 new tokens each."""
    rng = np.random.default_rng(10)
    return [(rng.integers(0, vocab, size=int(n)), 64) for n in rng.integers(256, 1025, size=8)]


def _serve_ticks(eng, specs):
    """Submit `specs`, tick until drained; return (tokens per request, the
    wall ms of each decode tick by the step shape it replayed) and the
    deltas of the engine's decode metrics."""
    m = eng.metrics
    fields = ("decode_tokens", "decode_time_s", "decode_steps", "spec_ticks",
              "spec_draft_tokens", "spec_accepted_tokens", "prefill_tokens",
              "sampled_tokens")
    before = {f: getattr(m, f) for f in fields}
    reqs = [eng.submit(s) for s in specs]
    times = {}
    while eng.scheduler.has_work:
        t, steps, replays = m.decode_time_s, m.decode_steps, dict(eng._replays)
        check(eng.tick(), "a tick with work ran an action")
        if m.decode_steps > steps:
            ran = [k for k, n in eng._replays.items() if n > replays.get(k, 0)] or ["eager"]
            times.setdefault(ran[0], []).append((m.decode_time_s - t) * 1e3)
    delta = {f: getattr(m, f) - before[f] for f in fields}
    delta["tok_s"] = delta["decode_tokens"] / delta["decode_time_s"]
    delta["accept"] = delta["spec_accepted_tokens"] / max(1, delta["spec_draft_tokens"])
    delta["tok_per_tick"] = delta["decode_tokens"] / max(1, delta["decode_steps"])
    return [eng.results[r.rid] for r in reqs], times, delta


def _replayed_verify_ms(torch, np, eng, lengths, reps: int = 10):
    """Device ms of one replay of the decode graph and of each verify graph,
    8 slots live at `lengths` (CUDA events, median of `reps` after one
    untimed; lengths restored before each replay)."""
    base = _live_slots(torch, eng, lengths)
    from repro_torch.serving.speculative import verify_buckets

    n = eng.slots
    eng.step_decode(np.zeros(n, np.int64), np.ones(n, bool))
    widths = verify_buckets(eng.spec.k)
    for w in widths:
        eng.step_verify(np.zeros((n, w), np.int64), np.ones(n, bool), np.full(n, w, np.int32),
                        np.full(n, -1, np.int32))
    out = {}
    for key in ["decode"] + [f"verify{w}" for w in widths]:
        graph, _ = eng.step_graphs[key]
        times = []
        for i in range(reps + 1):
            eng.state.lengths.copy_(base)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            graph.replay()
            end.record()
            torch.cuda.synchronize()
            if i:
                times.append(start.elapsed_time(end))
        out[key] = _median(times)
    _free_slots(eng)
    return out


def verify_plan(cfg, precision, kv_precision, width, slots, fused_rows):
    """Launches one replay of verify graph `width` holds: one GeMM per
    projection and the head at M = slots x width (in w8a8 one launch at M <=
    fused_rows, else the row quantization and the dequant GeMM each), one K2
    per layer."""
    per, L = gemms_per_step(cfg), cfg.n_layers
    kd = "flash_decode_int8" if kv_precision == "int8" else "flash_decode"
    if precision == "float":
        return {"gemm": per, kd: L}
    if slots * width <= fused_rows:
        return {"gemm_w8a8": per, kd: L}
    return {"quantize_rows": per, "dequant_gemm": per, kd: L}


def phase_speculative(torch, np, configs, M, Engine, RequestSpec, mods, precision="float",
                      kv_precision="float"):
    """9a / 9b: speculative greedy decoding served by the graphed engine on
    the regeneration storm and on random prompts, against a non-speculative
    graphed engine on the same weights: tokens identical; acceptance, tokens
    per decode tick, decode tok/s on and off, the median wall time of a
    verify step by width, one replay of each verify graph and of the decode
    graph on the device, launches per verify graph (183 GeMMs, 26 K2), no
    cold compile."""
    from repro_torch.serving.speculative import verify_buckets

    cfg = configs.get("gemma3-1b")
    fused = mods["gemm8"].FUSED_ROWS
    params = M.init_model(cfg, seed=0, device=PHASE9_DEVICE)
    kw = dict(PHASE9_KW, precision=precision, kv_precision=kv_precision, device=PHASE9_DEVICE)
    t0 = time.monotonic()
    spec = Engine(cfg, params, speculative=DRAFT_K, **kw)
    spec.warmup()
    plain = Engine(cfg, spec.params, **kw)     # a w8a8 warmup left them int8-resident
    plain.warmup()
    del params
    torch.cuda.synchronize()
    widths = verify_buckets(DRAFT_K)
    m = spec.metrics
    print(f"  warmup of both engines {time.monotonic() - t0:.1f}s; speculative engine: "
          f"{m.aot_steps} step shapes captured in {m.capture_time_s:.2f}s "
          f"(verify widths {widths}), graph pool {graph_pool_bytes(torch, spec) / 1e6:.1f} MB")
    check(m.aot_steps == 1 + 7 + len(widths) + 1, f"decode, 7 chunks, verify {widths}, reset")
    for w in widths:
        got = spec._graph_launches[f"verify{w}"]
        want = verify_plan(cfg, precision, kv_precision, w, spec.slots, fused)
        print(f"  launches per replay of verify{w} (M = {spec.slots * w}): "
              + " ".join(f"{k}={v}" for k, v in got.items()))
        check(got == want, f"verify{w} launches: got {got}, want {want}")
    out = {"launches": {w: spec._graph_launches[f"verify{w}"] for w in widths}}
    for trace, traffic in (("storm", storm_traffic), ("random", random_traffic)):
        specs = [RequestSpec(prompt=p, max_new=n) for p, n in traffic(np, cfg.vocab)]
        reset_counts(mods)
        replays0 = spec.replayed_launches()
        got, times, d = _serve_ticks(spec, specs)
        eager_calls = read_counts(mods)
        replays = {k: v - replays0[k] for k, v in spec.replayed_launches().items() if v != replays0[k]}
        want, ptimes, pd = _serve_ticks(plain, specs)
        check(sum(eager_calls.values()) == 0, f"every step a replay: eager calls {eager_calls}")
        for rid, (a, b) in enumerate(zip(got, want)):
            check(np.array_equal(a, b), f"{trace} request {rid}: speculative tokens equal "
                                        f"non-speculative")
            check(len(a) == 64, f"{trace} request {rid} got its budget")
        verify_ms = {k: _median(v) for k, v in sorted(times.items()) if k.startswith("verify")}
        print(f"  {trace}: {len(specs)} requests, {d['decode_tokens']} decode tokens identical "
              f"with speculation on and off; acceptance {d['accept']:.3f} "
              f"({d['spec_accepted_tokens']}/{d['spec_draft_tokens']} drafts), "
              f"{d['spec_ticks']} of {d['decode_steps']} decode ticks verified "
              f"({d['spec_draft_tokens'] / max(1, d['spec_ticks']):.2f} drafts a verify tick), "
              f"{d['tok_per_tick']:.2f} tok/tick (off: {pd['tok_per_tick']:.2f}); decode "
              f"{d['tok_s']:.1f} tok/s on, {pd['tok_s']:.1f} off "
              f"({d['tok_s'] / pd['tok_s']:.2f}x); median wall ms per tick: "
              + ", ".join(f"{k} {v:.3f} ({len(times[k])})" for k, v in verify_ms.items())
              + f", decode {_median(times.get('decode', [0.0])):.3f} "
              f"({len(times.get('decode', []))}) on, {_median(ptimes['decode']):.3f} off; "
              f"replayed launches " + " ".join(f"{k}={v}" for k, v in replays.items()))
        if trace == "storm":
            check(d["spec_ticks"] > 0 and d["spec_accepted_tokens"] > 0,
                  "the storm ran verify steps that accepted drafts")
        out[trace] = dict(d, plain_tok_s=pd["tok_s"], plain_tok_per_tick=pd["tok_per_tick"],
                          verify_ms=verify_ms,
                          decode_ms=_median(ptimes["decode"]))
    check(m.cold_compiles == 0 and plain.metrics.cold_compiles == 0, "no cold compile")
    lengths = [1024 + 64, 1000, 900, 800, 700, 600, 513, 300]
    replay = _replayed_verify_ms(torch, np, spec, lengths)
    print(f"  device time of one replay (CUDA events, median of 10; 8 slots live at {lengths}"
          f" tokens): " + ", ".join(f"{k} {v:.3f} ms" for k, v in replay.items()))
    out["replay_ms"] = replay
    del spec, plain
    torch.cuda.empty_cache()
    return out


def _lockstep(engines):
    """Tick the engines in turns until the first drains; all must drain
    together."""
    while engines[0].scheduler.has_work:
        for eng in engines:
            check(eng.tick(), "a tick with work ran an action")
    check(not any(e.scheduler.has_work for e in engines), "the engines drained together")


def phase_sampling(torch, np, configs, M, Engine, RequestSpec, mods):
    """9c: 4 sampled (T 0.8, top-k 50, top-p 0.95, seeds 1000-1003) and 4
    greedy requests in the same batches: graphed and eager engines in
    lockstep give the same tokens, a second graphed run replays them, the
    greedy rows equal a greedy-only run's, and the same traffic with
    speculation on finishes (greedy rows again equal); then 4096 draws of
    `sample_tokens` from one fixed vocab-wide logits row against
    softmax(_adjusted_logits), total-variation distance below 0.05."""
    from repro_torch.serving.request import GREEDY, SamplingParams

    cfg = configs.get("gemma3-1b")
    params = M.init_model(cfg, seed=0, device=PHASE9_DEVICE)
    kw = dict(PHASE9_KW, device=PHASE9_DEVICE)
    rng = np.random.default_rng(11)
    sampled = SamplingParams(temperature=0.8, top_k=50, top_p=0.95)
    specs = [RequestSpec(prompt=rng.integers(0, cfg.vocab, size=int(n)), max_new=32,
                         sampling=dataclasses.replace(sampled, seed=1000 + i // 2)
                         if i % 2 == 0 else GREEDY)
             for i, n in enumerate(rng.integers(256, 513, size=8))]
    greedy_rows = [i for i, s in enumerate(specs) if s.sampling.is_greedy]
    engines = [Engine(cfg, params, sampling=True, graphs=g, **kw) for g in (True, False)]
    for eng in engines:
        eng.warmup()
    g_eng = engines[0]
    print(f"  sampling engine: {g_eng.metrics.aot_steps} step shapes captured "
          f"({g_eng.metrics.capture_time_s:.2f}s), graph pool "
          f"{graph_pool_bytes(torch, g_eng) / 1e6:.1f} MB")
    reqs = [[e.submit(s) for s in specs] for e in engines]
    _lockstep(engines)
    runs = [[e.results[r.rid] for r in rs] for e, rs in zip(engines, reqs)]
    for i, (a, b) in enumerate(zip(*runs)):
        check(np.array_equal(a, b), f"request {i}: graphed tokens equal eager (sampled and greedy)")
    check(all(e.metrics.cold_compiles == 0 for e in engines), "no cold compile")
    sampled_n = g_eng.metrics.sampled_tokens
    del engines
    again = Engine(cfg, params, sampling=True, **kw)
    again.warmup()
    second, _, _ = _serve_ticks(again, specs)
    del again
    for i, (a, b) in enumerate(zip(runs[0], second)):
        check(np.array_equal(a, b), f"request {i}: a second seeded graphed run replays")
    solo = Engine(cfg, params, **kw)
    solo.warmup()
    greedy_only, _, _ = _serve_ticks(solo, [specs[i] for i in greedy_rows])
    del solo
    for i, toks in zip(greedy_rows, greedy_only):
        check(np.array_equal(runs[0][i], toks), f"greedy request {i} equals a greedy-only run")
    spec_eng = Engine(cfg, params, sampling=True, speculative=DRAFT_K, **kw)
    spec_eng.warmup()
    pool_mb = graph_pool_bytes(torch, spec_eng) / 1e6
    with_spec, _, d = _serve_ticks(spec_eng, specs)
    check(spec_eng.metrics.cold_compiles == 0, "no cold compile with speculation")
    for i in range(len(specs)):
        check(len(with_spec[i]) == 32, f"request {i} finished under speculation")
    for i in greedy_rows:
        check(np.array_equal(with_spec[i], runs[0][i]),
              f"greedy request {i} unchanged in a sampled speculative batch")
    print(f"  8 requests (4 sampled, 4 greedy, 256 tokens): graphed and eager tokens identical "
          f"in lockstep ({sampled_n} tokens from the sampling head), a second seeded run "
          f"identical, greedy rows equal a greedy-only run; with speculation "
          f"({spec_eng.metrics.aot_steps} graphs, pool {pool_mb:.1f} MB): finished, greedy rows "
          f"unchanged, acceptance {d['accept']:.3f} ({d['spec_accepted_tokens']}/"
          f"{d['spec_draft_tokens']}), {d['tok_per_tick']:.2f} tok/tick")
    del spec_eng, params
    torch.cuda.empty_cache()
    tv = sampling_law(torch, np, M, cfg.vocab, PHASE9_DEVICE)
    return {"tv": tv, "accept": d["accept"]}


def sampling_law(torch, np, M, V, dev):
    """4096 draws (seeds 0-4095) of `sample_tokens` from one fixed V-wide
    logits row (seeded normals x 6: top-p then keeps 29 of the top 50, and
    the distance 4096 draws leave by chance alone, ~0.024, is half the
    bar) at T 0.8, top-k 50, top-p 0.95, in chunks of 512 rows, against
    softmax(_adjusted_logits): the total-variation distance must be below
    0.05.  Also compares the first 256 draws with the CPU's."""
    N, chunk = 4096, 512
    row = torch.from_numpy(np.random.default_rng(12).normal(size=V).astype(np.float32) * 6)
    knobs = (0.8, 50, 0.95)

    def draw(lo, n, device):
        t = lambda v, dt: torch.full((n,), v, dtype=dt, device=device)
        return M.sample_tokens(row.to(device).expand(n, V),
                               torch.arange(lo, lo + n, device=device), t(0, torch.int64),
                               t(knobs[0], torch.float32), t(knobs[1], torch.int64),
                               t(knobs[2], torch.float32)).cpu()

    with torch.no_grad():
        adj = M._adjusted_logits(row.to(dev)[None], *knobs)[0]
        probs = torch.softmax(adj, -1).double().cpu().numpy()
        draws = torch.cat([draw(lo, min(chunk, N - lo), dev)
                           for lo in range(0, N, chunk)]).numpy()
        cpu = draw(0, 256, "cpu").numpy()
    emp = np.bincount(draws, minlength=V) / N
    tv = 0.5 * float(np.abs(emp - probs).sum())
    support = int((probs > 0).sum())
    floor = 0.5 * math.sqrt(2 / (math.pi * N)) * float(np.sqrt(probs * (1 - probs)).sum())
    print(f"  sample_tokens law: {N} draws (seeds 0-{N - 1}) from one {V}-wide logits row at "
          f"T {knobs[0]}, top-k {knobs[1]}, top-p {knobs[2]} (support {support} tokens): "
          f"total-variation distance to softmax(_adjusted_logits) {tv:.4f} (bar 0.05; "
          f"expected from {N} draws alone {floor:.4f}); the first 256 draws on the CPU equal "
          f"these in {int((cpu == draws[:256]).sum())} of 256")
    check(tv < 0.05, f"sampled tokens within TV 0.05 of softmax(adjusted): {tv:.4f}")
    return tv


def phase_preempt_prefix(torch, np, configs, M, Engine, RequestSpec, mods):
    """9d: 8 batch-class requests (128 new tokens each) decode, then 4
    interactive ones arrive:
    preemptions, swapped blocks and swap ms; every batch request's tokens
    equal an unpreempted run's.  Then 16 requests sharing a 512-token
    prefix with the prefix cache: hit rate and prefill tokens saved, tokens
    equal a run without the cache."""
    cfg = configs.get("gemma3-1b")
    params = M.init_model(cfg, seed=0, device=PHASE9_DEVICE)
    kw = dict(PHASE9_KW, device=PHASE9_DEVICE)
    rng = np.random.default_rng(13)
    batch = [RequestSpec(prompt=rng.integers(0, cfg.vocab, size=int(n)), max_new=128,
                         priority="batch") for n in rng.integers(256, 513, size=8)]
    inter = [RequestSpec(prompt=rng.integers(0, cfg.vocab, size=int(n)), max_new=16)
             for n in rng.integers(64, 129, size=4)]
    eng = Engine(cfg, params, preempt=True, **kw)
    eng.warmup()
    reqs = [eng.submit(s) for s in batch]
    for _ in range(400):
        if all(len(r.out_tokens) >= 8 for r in reqs):
            break
        eng.tick()
    check(all(len(r.out_tokens) >= 8 and r.slot >= 0 for r in reqs),
          "the 8 batch requests are decoding")
    reqs += [eng.submit(s) for s in inter]
    eng.run()
    eng.alloc.check()
    m = eng.metrics
    base = Engine(cfg, params, **kw)
    base.warmup()
    want, _, _ = _serve_ticks(base, batch)
    del base
    victims = [r.rid for r in reqs[:8] if r.preemptions]
    for i, r in enumerate(reqs[:8]):
        check(np.array_equal(eng.results[r.rid], want[i]),
              f"batch request {i} (preempted {r.preemptions}x) equals an unpreempted run")
    for r in reqs[8:]:
        check(len(eng.results[r.rid]) == 16, "interactive requests finished")
    check(m.preemptions >= len(inter) and m.swap_out_blocks == m.swap_in_blocks > 0,
          f"each interactive arrival preempted a batch request: {m.preemptions}")
    check(m.cold_compiles == 0, "no cold compile")
    print(f"  preemption: 4 interactive arrivals over 8 decoding batch requests: "
          f"{m.preemptions} preemptions (victims {victims}), {m.swap_out_blocks} blocks "
          f"swapped out and {m.swap_in_blocks} in "
          f"({m.swap_out_blocks * m.kv_bytes_per_block / 1e6:.1f} MB each way), swap "
          f"{m.swap_time_s * 1e3:.1f} ms in all; the 8 batch requests' tokens equal an "
          f"unpreempted run's")
    del eng
    shared = rng.integers(0, cfg.vocab, size=512)
    specs = [RequestSpec(prompt=np.concatenate([shared, rng.integers(0, cfg.vocab, size=int(n))]),
                         max_new=16) for n in rng.integers(16, 65, size=16)]
    outs = {}
    for cache in (True, False):
        e = Engine(cfg, params, prefix_cache=cache, **kw)
        e.warmup()
        outs[cache] = _serve_ticks(e, specs)
        if cache:
            pm = e.metrics
            cached = e.prefix_cache.cached_blocks
        check(e.metrics.cold_compiles == 0, "no cold compile")
        del e
    for i, (a, b) in enumerate(zip(outs[True][0], outs[False][0])):
        check(np.array_equal(a, b), f"prefix request {i}: tokens equal without the cache")
    check(pm.prefix_hits > 0, "the prefix cache hit")
    print(f"  prefix cache: 16 requests sharing a 512-token prefix: {pm.prefix_hits}/"
          f"{pm.prefix_lookups} admissions hit (rate {pm.prefix_hit_rate:.3f}), "
          f"{pm.prefix_hit_tokens} prefill tokens saved ({outs[True][2]['prefill_tokens']} "
          f"prefilled against {outs[False][2]['prefill_tokens']} without), {cached} blocks "
          f"cached at the end; tokens equal a run without the cache")
    del params
    torch.cuda.empty_cache()
    return {"preemptions": m.preemptions, "hit_rate": pm.prefix_hit_rate}


def sass_count(lib: Path, op: str):
    """Instructions of mnemonic `op` (HMMA, IMMA: the tensor cores') in
    the SASS of `lib`, or None where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump")
    if not Path(tool).exists():
        return None
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                         timeout=300)
    check(out.returncode == 0, f"cuobjdump -sass {lib.name}: {out.stderr.strip()[:200]}")
    return sum(op in line for line in out.stdout.splitlines())


# ---------------------------------------------------------------------------
# Phase 10: the recurrent, hybrid and MoE families at published widths
# ---------------------------------------------------------------------------

PHASE10_KW = dict(slots=8, block_size=16, max_chunk=64)
FAMILY_ARCHS = ("xlstm-1.3b", "jamba-1.5-large-398b", "dbrx-132b", "arctic-480b")
# The projections of each mixer kind, and the leaves w8a8 makes
# int8-resident (QUANT_KEYS); the rest (the recurrences' gate, dt and x
# projections, quant="none") run the float GeMM in every mode.
MIXER_GEMMS = {"attn": ("wq", "wk", "wv", "wo"), "attn_local": ("wq", "wk", "wv", "wo"),
               "mamba": ("w_in", "w_x", "w_dt", "w_out"),
               "mlstm": ("w_up", "w_q", "w_k", "w_v", "w_i", "w_f", "w_down"),
               "slstm": ("w_i", "w_z", "w_f", "w_o", "w_ff_up", "w_ff_down")}
W8A8_LEAVES = frozenset({"wq", "wk", "wv", "wo", "w_in", "w_out", "w_up", "w_q", "w_k",
                         "w_v", "w_down", "w_ff_up", "w_ff_down"})


def family_cfg(configs, arch):
    """`arch` at its published widths, cut only as far as one card forces:
    (config, the cuts as {field: [published, run]})."""
    full = configs.get(arch)
    if arch == "dbrx-132b":            # 263 GB of bf16 weights: one group of 4 layers
        return dataclasses.replace(full, n_layers=full.group_size), {"n_layers": [40, 4]}
    if arch == "jamba-1.5-large-398b":  # 797 GB: one group of 8 layers, 4 of 16 experts
        return (dataclasses.replace(full, n_layers=full.group_size,
                                    moe=dataclasses.replace(full.moe, num_experts=4)),
                {"n_layers": [72, 8], "num_experts": [16, 4]})
    return full, {}


def mamba_scan_chunks(seq: int, chunk: int = 16) -> int:
    """The chunks Mamba's selective scan cuts `seq` tokens into (its x / dt
    projections run once a chunk), as models/ssm.py cuts them."""
    if seq == 1:
        return 1
    chunk = min(chunk, seq)
    while seq % chunk:
        chunk //= 2
    return seq // chunk


def family_plan(cfg, precision, kv_precision, rows, head_rows, fused, seq):
    """Hand-kernel launches of one step of `seq` tokens a slot whose
    projections run at `rows` rows and the head at `head_rows`.  Float: K1 per projection, the f32
    router, each expert's gate / up / down (the experts stay float in every
    mode), the head.  w8a8: an int8-resident leaf is one w8a8 GeMM at
    <= `fused` rows, else the row quantization and the dequant GeMM; a
    float weight without quant="none" (the router, arctic's dense
    residual) is quantized on the fly (K4 then K3); quant="none" leaves
    stay K1 (Mamba's x / dt projections once per scan chunk).  One K2 per
    attention layer."""
    w8 = precision != "float"
    out = collections.Counter()

    def gemm(quantized, m):
        if not (w8 and quantized):
            out["gemm"] += 1
        elif m <= fused:
            out["gemm_w8a8"] += 1
        else:
            out["quantize_rows"] += 1
            out["dequant_gemm"] += 1

    def mode_default():
        if w8:
            out["quantize_rows"] += 1
            out["dequant_gemm"] += 1
        else:
            out["gemm"] += 1

    for layer, kind in enumerate(cfg.all_layer_kinds()):
        for name in MIXER_GEMMS[kind]:
            for _ in range(mamba_scan_chunks(seq) if name in ("w_x", "w_dt") else 1):
                gemm(name in W8A8_LEAVES, rows)
        if kind in ("attn", "attn_local"):
            out["flash_decode_int8" if kv_precision == "int8" else "flash_decode"] += 1
        if kind in ("mlstm", "slstm") or not (cfg.d_ff or cfg.moe):
            continue
        if cfg.moe and (layer % cfg.group_size + 1) % cfg.moe_every == 0:
            mode_default()                               # the router
            out["gemm"] += 3 * cfg.moe.num_experts       # the experts
            for _ in range(3 if cfg.moe.dense_residual else 0):
                mode_default()
        else:
            for _ in range(3 if cfg.mlp_variant == "swiglu" else 2):
                gemm(True, rows)
    gemm(True, head_rows)
    return dict(out)


def step_plan(cfg, key, slots, precision, kv_precision, fused):
    """`family_plan` of the engine's step shape `key`."""
    if key == "reset":
        return {}
    if key == "decode":
        seq, rows, head = 1, slots, slots
    elif key.startswith("chunk"):
        seq = int(key[len("chunk"):])
        rows, head = seq, 1
    else:
        seq = int(key[len("verify"):])
        rows = head = slots * seq
    return family_plan(cfg, precision, kv_precision, rows, head, fused, seq)


def family_traffic(seed, lo, hi, n=8, new=32):
    def traffic(np):
        """`n` prompts of `lo`-`hi` tokens (both ends drawn), `new` new
        tokens each; the generator then draws the prompts."""
        rng = np.random.default_rng(seed)
        plens = rng.integers(lo, hi + 1, size=n)
        plens[:2] = (hi, lo)
        return plens, np.full(n, new), rng
    return traffic


def phase_family(torch, np, M, Engine, RequestSpec, mods, quant, cfg, reduced, traffic, *,
                 precision="float", kv_precision="float", params=None):
    """One family model served by a graphed engine and, in lockstep on the
    same weights, an eager one (8 slots, chunk 64, block 16): tokens
    identical; launches per captured graph as `step_plan` says, and the
    run's, counted from the replays and by the eager wrappers, as the plan
    summed over the steps run; paired step medians, one replay's device
    time, capture seconds, graph pool / state / weight bytes, and a profile
    of one replayed decode step."""
    fused = mods["gemm8"].FUSED_ROWS
    plens, max_new, rng = traffic(np)
    # headroom for the replay timing's 64-token chunk past the longest slot
    kw = dict(PHASE10_KW, max_seq=int(max(plens)) + int(max(max_new)) + 65,
              precision=precision, kv_precision=kv_precision, device="cuda")
    if params is None:
        t0 = time.monotonic()
        params = M.init_model(cfg, seed=0, device="cuda")
        torch.cuda.synchronize()
        print(f"  init_model: {time.monotonic() - t0:.1f}s, {cfg.n_layers} layers "
              f"{cfg.all_layer_kinds()[:cfg.group_size]}..., weights "
              f"{quant.weight_bytes(params) / 1e9:.3f} GB (bf16 matrices, float32 biases, "
              f"A_log, D, router)" + (f"; reduced {json.dumps(reduced)}" if reduced else ""))
    engines = {}
    for graphs in (True, False):
        eng = Engine(cfg, params, graphs=graphs, **kw)
        t0 = time.monotonic()
        eng.warmup()
        torch.cuda.synchronize()
        m = eng.metrics
        print(f"  {'graphed' if graphs else 'eager'} engine warmup: "
              f"{time.monotonic() - t0:.2f}s ({m.aot_steps} step shapes"
              + (f" captured as CUDA graphs in {m.capture_time_s:.2f}s, graph pool "
                 f"{graph_pool_bytes(torch, eng) / 1e9:.3f} GB" if graphs else " run") + ")")
        check(eng.graphs == graphs, f"the engine runs with graphs={graphs}")
        if graphs and precision != "float":
            params = eng.params                 # the eager engine takes the int8 weights
        engines[graphs] = eng
    del params
    graphed, eager = engines[True], engines[False]
    plan = {key: step_plan(cfg, key, graphed.slots, precision, kv_precision, fused)
            for key in graphed.step_graphs}
    for key, want in plan.items():
        got = graphed._graph_launches[key]
        check(got == want, f"{cfg.name} {key} graph launches: got {got}, want {want}")
    print("  launches per replay (as planned): " + "; ".join(
        f"{key}: " + " ".join(f"{k}={v}" for k, v in plan[key].items())
        for key in ("decode", "chunk64", "chunk1")))
    for n, m_ in zip(plens, max_new):
        prompt = rng.integers(0, cfg.vocab, size=int(n))
        for eng in (graphed, eager):
            eng.submit(RequestSpec(prompt=prompt, max_new=int(m_)))
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(mods)
    pairs, t_run = _run_paired(torch, graphed, eager)
    run_peak = torch.cuda.max_memory_allocated() - resident
    launches, eager_launches = graphed.replayed_launches(), read_counts(mods)
    want = dict.fromkeys(launches, 0)
    for key, n in graphed._replays.items():
        for k, v in plan[key].items():
            want[k] += n * v
    m, me = graphed.metrics, eager.metrics
    print(f"  served the {len(plens)} requests (prompts {int(min(plens))}-{int(max(plens))} "
          f"tokens, {int(max_new[0])} new each) on both engines in lockstep in {t_run:.2f}s: "
          f"{m.prefill_chunks} prefill chunks, {m.decode_steps} decode steps each")
    for rid, toks in graphed.results.items():
        check(len(toks) == int(max_new[rid]), f"request {rid} got its full budget")
        check(bool(((toks >= 0) & (toks < cfg.vocab)).all()), f"request {rid} tokens in vocab")
        check(np.array_equal(toks, eager.results[rid]),
              f"{cfg.name} request {rid}: graphed tokens equal the eager engine's")
    check(sorted(graphed.results) == list(range(len(plens))), "every request finished")
    print(f"  the {len(plens)} requests' tokens ({sum(map(len, graphed.results.values()))}) "
          f"are identical graphed and eager")
    check(launches == want, f"launches from replays: got {launches}, want {want}")
    check(eager_launches == want, f"launches, eager engine: got {eager_launches}, want {want}")
    check(m.cold_compiles == 0 and me.cold_compiles == 0, "warmup covered every step shape")
    print("  launches of the run (graphed from its replays = eager = the plan): "
          + " ".join(f"{k}={v}" for k, v in launches.items() if v))
    paired = _paired_medians(pairs)
    pool = graph_pool_bytes(torch, graphed)
    wb = m.weight_bytes or quant.weight_bytes(graphed.params)
    print(f"  resident weights {wb / 1e9:.3f} GB, recurrent state {m.state_bytes / 1e9:.3f} GB "
          f"(8 slots), kv pool {m.kv_pool_bytes / 1e9:.3f} GB {kv_precision} per engine; "
          f"graph pool {pool / 1e9:.3f} GB ({m.aot_steps} graphs, captured in "
          f"{m.capture_time_s:.2f}s); the eager steps' peak above both engines' resident "
          f"memory {run_peak / 1e9:.3f} GB")
    lengths = [int(n) + 32 for n in plens[:8]]
    replay = _replayed_step_ms(torch, np, graphed, lengths)
    print(f"  device time of one replay (CUDA events, median of 10; 8 slots live at {lengths} "
          f"tokens): decode step {replay['decode']:.3f} ms, 64-token prefill chunk (slot 0) "
          f"{replay['chunk64']:.3f} ms")
    prof = _profile_decode(torch, graphed, lengths)
    summary = {"decode_ms": m.decode_time_s / m.decode_steps * 1e3,
               "prefill_ms": m.prefill_time_s / m.prefill_chunks * 1e3,
               "paired": paired, "replay_ms": replay, "graph_pool_bytes": pool,
               "capture_s": m.capture_time_s, "graphs": m.aot_steps, "launches": launches,
               "decode_graph_launches": dict(graphed._graph_launches["decode"]),
               "weight_bytes": wb, "state_bytes": m.state_bytes,
               "kv_pool_bytes": m.kv_pool_bytes, "profile": prof, "results": graphed.results}
    del engines, graphed, eager, eng
    torch.cuda.empty_cache()
    return summary


def family_storm(np, vocab, lo=256, hi=512):
    """A regeneration storm: 16 requests over 4 distinct prompts of `lo`-`hi`
    tokens, 32 new tokens each; repeats admitted after a copy finished find
    its stream in the drafter's corpus."""
    rng = np.random.default_rng(11)
    plens = rng.integers(lo, hi + 1, size=4)
    prompts = [rng.integers(0, vocab, size=int(n)) for n in plens]
    return [(prompts[i % 4], 32) for i in range(16)]


def per_position_bytes(cfg, slots, width):
    """Bytes of the per-position recurrent states one verify step of
    `width` holds until its commit (every recurrent layer's state per slot
    and position)."""
    from repro_torch.models import ssm

    return sum(ssm.state_bytes(ssm.init_state_for_kind(cfg, kind, 1, "meta")) * slots * width
               for kind in cfg.all_layer_kinds() if kind not in ("attn", "attn_local"))


def _recapture_narrow_first(torch, eng):
    """Drop `eng`'s graphs and capture them again with the verify graphs
    narrowest first, where the warmup captures them widest first (so that
    the narrower ones reuse the widest one's pool memory); returns the
    order."""
    keys = list(eng.step_graphs)
    verify = sorted((k for k in keys if re.fullmatch(r"verify\d+", k)), key=lambda k: int(k[6:]))
    order = []
    for key in keys:
        if key in verify:
            order += [v for v in verify if v not in order]
        else:
            order.append(key)
    eng.step_graphs.clear()
    eng.graph_pool = None
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with torch.no_grad(), eng._precision_ctx():
        for key in order:
            eng._capture(key)
    torch.cuda.synchronize()
    return order


def phase_family_spec(torch, np, M, Engine, RequestSpec, mods, cfg, k, slots):
    """Speculative greedy decoding on a recurrent stack, graphed: the verify
    graphs collect per-position states and commit each slot's at its
    accepted position; the tokens equal a non-speculative graphed engine's
    on the same weights, also with the verify graphs captured again
    narrowest first (ROADMAP C.2); launches per verify replay as
    planned."""
    from repro_torch.serving.speculative import verify_buckets

    fused = mods["gemm8"].FUSED_ROWS
    widths = verify_buckets(k)
    kw = dict(PHASE10_KW, slots=slots, max_seq=512 + 32 + 65, device="cuda")
    params = M.init_model(cfg, seed=0, device="cuda")
    t0 = time.monotonic()
    spec = Engine(cfg, params, speculative=k, **kw)
    spec.warmup()
    plain = Engine(cfg, params, **kw)
    plain.warmup()
    del params
    torch.cuda.synchronize()
    m = spec.metrics
    per_pos = per_position_bytes(cfg, slots, max(widths))
    print(f"  warmup of both engines {time.monotonic() - t0:.1f}s; speculative engine: "
          f"{m.aot_steps} step shapes captured in {m.capture_time_s:.2f}s (verify widths "
          f"{widths}), graph pool {graph_pool_bytes(torch, spec) / 1e9:.3f} GB; per-position "
          f"states of verify{max(widths)} at {slots} slots: {per_pos / 1e9:.2f} GB")
    for w in widths:
        got = spec._graph_launches[f"verify{w}"]
        want = step_plan(cfg, f"verify{w}", slots, "float", "float", fused)
        check(got == want, f"verify{w} launches: got {got}, want {want}")
    print("  launches per verify replay (as planned): " + "; ".join(
        f"verify{w}: " + " ".join(f"{k_}={v}" for k_, v in spec._graph_launches[f"verify{w}"]
                                  .items()) for w in widths))
    specs = [RequestSpec(prompt=p, max_new=n) for p, n in family_storm(np, cfg.vocab)]
    reset_counts(mods)
    got, times, d = _serve_ticks(spec, specs)
    want, ptimes, pd = _serve_ticks(plain, specs)
    check(sum(read_counts(mods).values()) == 0, "every step a replay")
    for rid, (a, b) in enumerate(zip(got, want)):
        check(np.array_equal(a, b), f"request {rid}: speculative tokens equal non-speculative")
        check(len(a) == 32, f"request {rid} got its budget")
    check(d["spec_ticks"] > 0 and d["spec_accepted_tokens"] > 0,
          "the storm ran verify steps that accepted drafts")
    check(m.cold_compiles == 0 and plain.metrics.cold_compiles == 0, "no cold compile")
    # ROADMAP C.2: the one run whose speculative tokens differed captured
    # the verify graphs narrowest first; serve the storm again in that
    # order.
    order = _recapture_narrow_first(torch, spec)
    pool_narrow = graph_pool_bytes(torch, spec)
    got2, _, d2 = _serve_ticks(spec, specs)
    for rid, (a, b) in enumerate(zip(got2, want)):
        check(np.array_equal(a, b), f"request {rid}: speculative tokens with the verify graphs "
                                    f"captured narrowest first equal non-speculative")
    print(f"  C.2: graphs captured again in the order {order} (graph pool "
          f"{pool_narrow / 1e9:.3f} GB): the storm's {d2['decode_tokens']} decode tokens equal "
          f"the non-speculative run's; acceptance {d2['accept']:.3f}, {d2['spec_ticks']} "
          f"verified ticks")
    verify_ms = {key: _median(v) for key, v in sorted(times.items()) if key.startswith("verify")}
    print(f"  storm: {len(specs)} requests, {d['decode_tokens']} decode tokens identical with "
          f"speculation on and off; acceptance {d['accept']:.3f} "
          f"({d['spec_accepted_tokens']}/{d['spec_draft_tokens']} drafts), {d['spec_ticks']} of "
          f"{d['decode_steps']} decode ticks verified, {d['tok_per_tick']:.2f} tok/tick (off: "
          f"{pd['tok_per_tick']:.2f}); decode {d['tok_s']:.1f} tok/s on, {pd['tok_s']:.1f} off; "
          f"median wall ms per tick: " + ", ".join(f"{key} {v:.3f}" for key, v in verify_ms.items())
          + f", decode {_median(ptimes['decode']):.3f} off")
    replay = _replayed_verify_ms(torch, np, spec, [544, 500, 450, 400, 350, 300, 280, 260][:slots])
    print(f"  device time of one replay (CUDA events, median of 10): "
          + ", ".join(f"{key} {v:.3f} ms" for key, v in replay.items()))
    out = dict(d, plain_tok_s=pd["tok_s"], plain_tok_per_tick=pd["tok_per_tick"],
               replay_ms=replay, per_position_bytes=per_pos, slots=slots, k=k,
               launches={w: spec._graph_launches[f"verify{w}"] for w in widths})
    del spec, plain
    torch.cuda.empty_cache()
    return out


# Where the family archs have attention, K2 at their head layouts: jamba's
# 64 q heads over 8 kv heads and dbrx's 48 over 8, D 128.
FAMILY_DECODE = [("jamba-1.5-large-398b", 64, 8, 128), ("dbrx-132b", 48, 8, 128)]


def family_gemm_shapes(configs):
    """(label, K, N, dtype, w8a8) of the family archs' GeMMs the dense
    family never ran: the narrow mLSTM gates (N = 4, rows padded to 16
    bytes), the f32 routers (N = 16; 4 in the reduced jamba), one expert's
    gate / down (bf16 operands, f32 out), Mamba's x / dt projections (K =
    512), and the int8-resident projections under w8a8."""
    xl, jb, db = (configs.get(a) for a in ("xlstm-1.3b", "jamba-1.5-large-398b", "dbrx-132b"))
    d, di = xl.d_model, 2 * xl.d_model
    ff = int(8 / 3 * d) // 8 * 8
    mdi, dtr = jb.mamba.expand * jb.d_model, jb.mamba.resolved_dt_rank(jb.d_model)
    return [("xlstm w_up", d, 2 * di, "bfloat16", True), ("xlstm w_q", di, di, "bfloat16", True),
            ("xlstm w_i", di, xl.n_heads, "bfloat16", False),
            ("xlstm w_down", di, d, "bfloat16", True),
            ("xlstm w_ff_up", d, 2 * ff, "bfloat16", True),
            ("xlstm w_ff_down", ff, d, "bfloat16", True),
            ("xlstm head", d, xl.vocab, "bfloat16", True),
            ("dbrx router", db.d_model, db.moe.num_experts, "float32", False),
            ("dbrx expert w_gate", db.d_model, db.moe.d_ff_expert, "bfloat16", False),
            ("dbrx expert w_down", db.moe.d_ff_expert, db.d_model, "bfloat16", False),
            ("jamba router", jb.d_model, 4, "float32", False),
            ("jamba w_in", jb.d_model, 2 * mdi, "bfloat16", True),
            ("jamba w_x", mdi, dtr + 2 * jb.mamba.d_state, "bfloat16", False),
            ("jamba w_dt", dtr, mdi, "bfloat16", False)]


def phase_kernels_family(torch, configs, gemm, gemm8, fd, kvc):
    """K1 (f32 out: the experts' and the router's products, held within the
    f32 bar of reordered sums; bf16 out within one bf16 ulp) and the w8a8
    GeMM (bit for bit) at the family archs' new shapes, M = 1, 8 and 64;
    the norms' mean row-invariant (`layers.row_mean`; `torch.mean`
    printed beside it); K2 over float and int8 pools at jamba's and dbrx's
    head layouts, Sq 1 and 64."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(29)
    worst = {"gemm": 0.0, "gemm_w8a8": 0.0, "flash_decode": 0.0, "flash_decode_int8": 0.0}
    relaid = gemm.relaid
    for label, K, N, dname, w8 in family_gemm_shapes(configs):
        dt = getattr(torch, dname)
        w = gemm.aligned_rows((torch.randn((K, N), generator=g, device=dev)
                               * K ** -0.5).to(dt))
        w_q = torch.randint(-127, 128, (N, K), generator=g, device=dev, dtype=torch.int8).t()
        sb = torch.rand((1, N), generator=g, device=dev) * 0.1 + 1e-3
        errs = []
        for M in (1, 8, 64):
            a = torch.randn((M, K), generator=g, device=dev).to(dt)
            for out_dt in ((torch.float32,) if dname == "float32" or "expert" in label
                           else (torch.bfloat16, torch.float32)):
                tol = GEMM_TOL["float32" if out_dt == torch.float32 else "bfloat16"]
                abs_e, _, ok = close(gemm.gemm(a, w, out_dtype=out_dt),
                                     gemm.gemm_plain(a, w, out_dt), *tol)
                worst["gemm"] = max(worst["gemm"], abs_e)
                check(ok, f"gemm {dname} -> {out_dt} M={M} {label}")
                errs.append(f"M={M} {str(out_dt)[6:]} {abs_e:.2e}")
            if w8:
                got = gemm8.gemm_w8a8(a, w_q, sb, out_dtype=torch.bfloat16)
                want = gemm8.gemm_w8a8_plain(a, w_q, sb, None, torch.bfloat16)
                worst["gemm_w8a8"] = max(worst["gemm_w8a8"],
                                         float((got.float() - want.float()).abs().max()))
                check(torch.equal(got, want), f"gemm_w8a8 M={M} {label} bit for bit")
            del a
        print(f"  {label} {K}x{N} {dname}: gemm max_abs " + ", ".join(errs) + " ok"
              + ("; gemm_w8a8 bitwise equal at M = 1, 8, 64" if w8 else ""))
        del w, w_q, sb
    check(gemm.relaid == relaid, "no GeMM operand re-laid (the narrow gates' rows are padded)")
    torch.cuda.empty_cache()
    # The norms' mean must sum a row in the same order at any row count, so
    # a verify step's rows (slots x S) equal a decode step's (slots).
    from repro_torch.models import layers

    means = {"row_mean": layers.row_mean,
             "torch.mean": lambda v: torch.mean(v, dim=-1, keepdim=True)}
    invariant = {name: [] for name in means}
    for d in (1152, 2048, 4096, 5120, 6144, 8192):
        x = torch.randn((40, d), generator=g, device=dev)
        for name, fn in means.items():
            full = fn(x)
            if all(torch.equal(fn(x[:m]), full[:m]) for m in (1, 8, 16, 24)):
                invariant[name].append(d)
    print("  the norms' mean: rows of 1, 8, 16 and 24 equal the same rows of 40 at widths "
          + "; ".join(f"{name} {v}" for name, v in invariant.items())
          + " (of 1152, 2048, 4096, 5120, 6144, 8192)")
    check(len(invariant["row_mean"]) == 6, "layers.row_mean is row-invariant at every width")
    bs, max_seq = 16, 1200
    for arch, Hq, Hkv, D in FAMILY_DECODE:
        B = len(QWEN3_LENGTHS)
        pools = {"float": _lived_in_pool(torch, kvc, dev, g, torch.bfloat16, B, Hkv, D, bs,
                                         max_seq, QWEN3_LENGTHS),
                 "int8": _lived_in_pool_int8(torch, kvc, dev, g, B, Hkv, D, bs, max_seq,
                                             QWEN3_LENGTHS)}
        for pool, (cache, tables) in pools.items():
            key = "flash_decode_int8" if pool == "int8" else "flash_decode"
            for sq in (1, 64):
                q = torch.randn((B, sq, Hq, D), generator=g, device=dev).to(torch.bfloat16)
                idx = torch.tensor([n - sq for n in QWEN3_LENGTHS], dtype=torch.int32,
                                   device=dev)
                wants = {"walk": fd.ref_paged_decode(q, cache, tables, idx)}
                _check_decode(torch, fd, f"{arch} ({Hq}/{Hkv}, D {D}) flash_decode {pool} "
                              f"pool, q bfloat16", q, cache, tables, idx, None, None, wants,
                              DECODE_TOL["bfloat16"], worst, key)
        del pools
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return worst


def _family_logits(torch, M, kvc, cfg, params, prompt, dev, tokens=None, steps=3):
    """Last-position logits of `prompt` prefilled in chunks of at most 16
    tokens into slot 1 of 2, then of `steps` decode steps (slot 0 idle)
    fed with `tokens`, or with this run's greedy tokens when None, through
    the model functions on `dev`: (logits, the tokens fed)."""
    from repro_torch.serving.prefill import plan_chunks

    bs = 16
    max_blocks = kvc.blocks_for(len(prompt) + steps + 1, bs)
    state = M.init_paged_decode_state(cfg, 2, num_blocks=1 + 2 * max_blocks, block_size=bs,
                                      max_blocks_per_slot=max_blocks, device=dev)
    tables = kvc.BlockTables(2, max_blocks)
    alloc = kvc.BlockAllocator(1 + 2 * max_blocks, bs)
    for s in range(2):
        tables.ensure(s, max_blocks * bs, alloc)
    state.block_tables = tables.array(dev)
    out, pos, fed = [], 0, []
    active = torch.tensor([False, True], device=dev)
    with torch.no_grad():
        for c in plan_chunks(len(prompt), 16):
            chunk = torch.as_tensor(prompt[None, pos:pos + c], device=dev)
            logits, state = M.prefill_chunk(params, cfg, state, chunk,
                                            torch.tensor([1], device=dev))
            pos += c
        out.append(logits[0, -1].float().cpu())
        for i in range(steps):
            t = int(out[-1].argmax()) if tokens is None else tokens[i]
            fed.append(t)
            step, new = M.paged_decode_step(params, cfg, state,
                                            torch.tensor([[0], [t]], device=dev), active)
            state.lengths = new.lengths
            out.append(step[1, -1].float().cpu())
    return out, fed


def phase_family_parity(torch, np, configs, M, kvc, Engine, RequestSpec):
    """The four family archs' smoke configs (float32; head_dim raised to 64,
    K2's smallest instantiation, where the stack has attention) on the card
    (kernels) and on the CPU (plain versions): the logits after a 37-token
    prompt's prefill chunks and after each of three decode steps within
    phase 4's bar (max_abs_diff <= 1e-4 x max|logit|, argmax equal), and the
    engine's greedy tokens for three prompts over two slots (a refill),
    equal."""
    for arch in FAMILY_ARCHS:
        smoke = configs.get_smoke(arch)
        cfg, reduced = smoke, {"widths": "smoke config", "dtype": "float32"}
        if any(k in ("attn", "attn_local") for k in smoke.layer_kinds()):
            cfg = dataclasses.replace(smoke, head_dim=64)
            reduced["head_dim"] = [smoke.resolved_head_dim, 64]
        t0 = time.monotonic()
        params = M.init_model(cfg, seed=1, device="cuda")
        cpu_params = _tree_cpu(torch, params)
        rng = np.random.default_rng(3)
        prompt = rng.integers(0, cfg.vocab, size=37)
        want, toks = _family_logits(torch, M, kvc, cfg, cpu_params, prompt, "cpu")
        got, _ = _family_logits(torch, M, kvc, cfg, params, prompt, "cuda", toks)
        errs = []
        for i, (g_, w_) in enumerate(zip(got, want)):
            err, scale = float((g_ - w_).abs().max()), float(w_.abs().max())
            errs.append(f"{err:.2e}")
            check(err <= 1e-4 * scale and int(g_.argmax()) == int(w_.argmax()),
                  f"{arch}: step {i} logits card vs CPU ({err:.3e}, scale {scale:.3e})")
        out = {}
        prompts = [rng.integers(0, cfg.vocab, size=n) for n in (37, 20, 9)]
        for dev, p in (("cuda", params), ("cpu", cpu_params)):
            eng = Engine(cfg, p, slots=2, max_seq=64, block_size=16, max_chunk=16, device=dev)
            eng.warmup()
            for pr in prompts:
                eng.submit(RequestSpec(prompt=pr, max_new=6))
            out[dev] = eng.run()
            check(eng.metrics.cold_compiles == 0, f"{arch} {dev}: no cold step")
            del eng
        for rid in out["cpu"]:
            check(np.array_equal(out["cuda"][rid], out["cpu"][rid]),
                  f"{arch} request {rid}: card tokens equal the CPU plain-version tokens")
        print(f"  {arch} reduced {json.dumps(reduced)}: logits max_abs_diff card vs CPU after "
              f"the prefill and 3 decode steps {', '.join(errs)} (bar 1e-4 x max|logit|), "
              f"argmax equal; engine tokens equal on card and CPU "
              f"{[out['cuda'][r].tolist() for r in sorted(out['cuda'])]}; "
              f"{time.monotonic() - t0:.1f}s")
        del params, cpu_params
        torch.cuda.empty_cache()


def phase_family_refusal(np):
    """The serve CLI sizes jamba at its published widths on the meta device
    and refuses before allocating, naming the bytes."""
    from repro_torch.launch import serve

    free = None
    try:
        serve.main(["--arch", "jamba-1.5-large-398b", "--widths", "published"])
    except SystemExit as e:
        free = str(e)
    check(free is not None and "bytes" in free, "the CLI refused jamba at published widths")
    print(f"  serve --arch jamba-1.5-large-398b --widths published: refused: {free}")


def phase10(torch, np, configs, M, kvc, Engine, RequestSpec, mods, quant, worst):
    """Phases 10-10d, and a `[7]` line per run of 10a-10c."""
    print("[10] kernels vs plain versions at the family archs' new shapes")
    for k, v in phase_kernels_family(torch, configs, mods["gemm"], mods["gemm8"], mods["fd"],
                                     kvc).items():
        worst[k] = max(worst[k], v)
    args = (torch, np, M, Engine, RequestSpec, mods, quant)
    out = {}
    cfg, reduced = family_cfg(configs, "xlstm-1.3b")
    xl_traffic = family_traffic(20, 256, 512)
    # The float and w8a8 runs are cut to 2 of the 6 groups to keep the whole
    # script inside its time limit: their eager 64-token chunks (64
    # sequential mLSTM steps a layer) were a fifth of it.  The speculative
    # run and the CLI keep all 48 layers.
    cut = dataclasses.replace(cfg, n_layers=2 * cfg.group_size)
    cut_reduced = {"n_layers": [cfg.n_layers, cut.n_layers]}
    print("[10a] xlstm-1.3b at published widths (d 2048, 4 heads, vocab 50304, untied; "
          "bf16), 16 of its 48 layers (14 mLSTM, 2 sLSTM), float")
    out["10a float"] = phase_family(*args, cut, cut_reduced, xl_traffic)
    print("[10a] the same in w8a8 (no attention layer: no KV pool)")
    out["10a w8a8"] = phase_family(*args, cut, cut_reduced, xl_traffic, precision="w8a8")
    print(f"[10a] speculative greedy decoding, k = {DRAFT_K}, 8 slots")
    out["10a spec"] = phase_family_spec(torch, np, M, Engine, RequestSpec, mods, cfg,
                                        DRAFT_K, 8)
    print("[10a] the serve CLI: --arch xlstm-1.3b --widths published")
    phase_serve_cli(np, arch="xlstm-1.3b", extra=())
    big_traffic = family_traffic(21, 256, 1024)
    cfg, reduced = family_cfg(configs, "dbrx-132b")
    print("[10b] dbrx-132b at published widths (d 6144, 48 / 8 heads, 16 experts top-4, "
          "d_ff 10752; bf16), one group of 4 layers, float")
    out["10b float"] = phase_family(*args, cfg, reduced, big_traffic)
    print("[10b] the same in w8a8 with an int8 KV pool")
    out["10b w8a8"] = phase_family(*args, cfg, reduced, big_traffic, precision="w8a8",
                                   kv_precision="int8")
    cfg, reduced = family_cfg(configs, "jamba-1.5-large-398b")
    print("[10c] jamba-1.5-large-398b at published widths (d 8192, 64 / 8 heads, Mamba "
          "d_state 16, MoE top-2 on alternate layers, d_ff 24576; bf16), one group of 8 "
          "layers (7 Mamba + 1 attention), 4 of 16 experts, float")
    out["10c float"] = phase_family(*args, cfg, reduced, big_traffic)
    phase_family_refusal(np)
    print("[10d] the four family archs' smoke configs, f32: CUDA kernels vs CPU plain versions")
    phase_family_parity(torch, np, configs, M, kvc, Engine, RequestSpec)
    for label, x in out.items():
        if label.endswith("spec"):
            r = x["replay_ms"]
            print(f"[7] {label} ({x['slots']} slots, k = {x['k']}): acceptance "
                  f"{x['accept']:.3f}, {x['tok_per_tick']:.2f} tok/tick (off "
                  f"{x['plain_tok_per_tick']:.2f}), decode {x['tok_s']:.1f} tok/s (off "
                  f"{x['plain_tok_s']:.1f}); one replay " + ", ".join(
                      f"{k} {v:.3f} ms" for k, v in r.items())
                  + f"; per-position states {x['per_position_bytes'] / 1e9:.2f} GB")
            continue
        p = x["profile"]
        print(f"[7] {label}: decode step graphed {x['paired']['decode']['graphed_ms']:.3f} ms, "
              f"eager {x['paired']['decode']['eager_ms']:.3f} ms (paired medians; one replay "
              f"{x['replay_ms']['decode']:.3f} ms on the device); 64-token chunk graphed "
              f"{x['paired']['prefill']['graphed_ms']:.3f} ms, eager "
              f"{x['paired']['prefill']['eager_ms']:.3f} ms (one replay "
              f"{x['replay_ms']['chunk64']:.3f} ms); {x['graphs']} graphs captured in "
              f"{x['capture_s']:.2f}s, pool {x['graph_pool_bytes'] / 1e9:.3f} GB; weights "
              f"{x['weight_bytes'] / 1e9:.3f} GB, state {x['state_bytes'] / 1e9:.3f} GB, kv "
              f"pool {x['kv_pool_bytes'] / 1e9:.3f} GB; decode replay kernels: hand "
              f"{p['hand_ms']:.3f} ms ({p['hand_kernels']} launches), PyTorch ops "
              f"{p['glue_ms']:.3f} ms ({p['kernels'] - p['hand_kernels']}); per replayed "
              f"decode step " + " ".join(f"{k}={v}" for k, v in
                                         x["decode_graph_launches"].items()))


# ---------------------------------------------------------------------------
# Phase 11: the encoder-decoder and VLM families through the unpaged decode
# path (whisper-medium, paligemma-3b), and K5 on a serving path
# ---------------------------------------------------------------------------

# K5 at whisper's cross-attention (non-causal, Sq != Skv: 1 | 64 queries over
# 1500 frames) and its encoder (1500 over 1500), 16 / 16 heads, D 64.
ENCDEC_FLASH = [(8, 1, 1500), (8, 64, 1500), (8, 1500, 1500)]   # (B, Sq, Skv)
ENCDEC_GEMMS = [  # (label, M, K, N): K1 far above the M <= 64 its plan was set for
    ("whisper cross wk / wv, 8 x 1500 frames", 12000, 1024, 1024),
    ("paligemma projector, 8 x 256 patches", 2048, 1152, 2048)]
UNPAGED_ARCHS = ("whisper-medium", "paligemma-3b")
UNPAGED_SLOTS, UNPAGED_PROMPT = 8, 16


def phase_kernels_encdec(torch, gemm, fa):
    """K5 at Sq != Skv, non-causal (whisper's cross-attention and encoder,
    16 / 16 heads, D 64), bf16 and f32 at FLASH_TOL; K1 at M = 12000 (the
    cross K / V projections of 8 requests' frames) and 2048 (paligemma's
    projector), bf16 out within one bf16 ulp."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(31)
    worst = {"flash_attention": 0.0, "gemm": 0.0}
    H, D = 16, 64
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        for B, Sq, Skv in ENCDEC_FLASH:
            q = torch.randn((B, Sq, H, D), generator=g, device=dev).to(dt)
            k, v = (torch.randn((B, Skv, H, D), generator=g, device=dev).to(dt)
                    for _ in range(2))
            abs_e, rel_e, ok = close(fa.flash_attention(q, k, v, causal=False),
                                     fa.flash_attention_plain(q, k, v, causal=False),
                                     *FLASH_TOL[dname])
            worst["flash_attention"] = max(worst["flash_attention"], abs_e)
            print(f"  whisper flash_attention {dname} B={B} Sq={Sq} Skv={Skv} Hq=Hkv={H} D={D} "
                  f"non-causal: max_abs={abs_e:.3e} max_rel={rel_e:.3e} "
                  f"{'ok' if ok else 'FAIL'}")
            check(ok, f"flash_attention {dname} non-causal {(B, Sq, Skv)}")
            del q, k, v
    rtol, atol = GEMM_TOL["bfloat16"]
    for label, M_, K, N in ENCDEC_GEMMS:
        a = torch.randn((M_, K), generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn((K, N), generator=g, device=dev) * K ** -0.5).to(torch.bfloat16)
        abs_e, rel_e, ok = close(gemm.gemm(a, w, out_dtype=torch.bfloat16),
                                 gemm.gemm_plain(a, w, torch.bfloat16), rtol, atol)
        worst["gemm"] = max(worst["gemm"], abs_e)
        print(f"  {label}: gemm bf16 M={M_} {K}x{N} max_abs={abs_e:.3e} max_rel={rel_e:.3e} "
              f"tol=(rtol {rtol:g}, atol {atol:g}) {'ok' if ok else 'FAIL'}")
        check(ok, f"gemm bf16 M={M_} {label}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return worst


def phase_times_encdec(torch, gemm, fa):
    """K5 at whisper's encoder shape (8 x 1500 over 1500, non-causal) and
    its Sq = 1 cross shape (8 x 1 over 1500), bf16, L2 cold, beside SDPA
    (MHA: no K/V repeat) and the bound; K1 at the cross-K/V (M = 12000) and
    projector (M = 2048) shapes beside torch.matmul."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(37)
    dt, H, D = torch.bfloat16, 16, 64
    rows = {}
    for key, (B, Sq, Skv) in (("whisper encoder", ENCDEC_FLASH[2]),
                              ("whisper cross Sq=1", ENCDEC_FLASH[0])):
        set_bytes = 2 * B * H * D * (2 * Sq + 2 * Skv)
        sets = [(torch.randn((B, Sq, H, D), generator=g, device=dev).to(dt),
                 torch.randn((B, Skv, H, D), generator=g, device=dev).to(dt),
                 torch.randn((B, Skv, H, D), generator=g, device=dev).to(dt))
                for _ in range(max(2, math.ceil(2 * L2_BYTES / set_bytes)))]
        kcalls = [lambda q=q, k=k, v=v: fa.flash_attention(q, k, v, causal=False)
                  for q, k, v in sets]
        t_k = _time_ms(torch, kcalls, 40)
        t_e = _time_ms(torch, kcalls, 40, graph=False)
        t_p = _time_ms(torch, [lambda q=q, k=k, v=v: fa.flash_attention_plain(
            q, k, v, causal=False) for q, k, v in sets[:2]], 4, graph=False)
        lib = [tuple(t.permute(0, 2, 1, 3) for t in s) for s in sets]
        t_l = _time_ms(torch, [lambda q=q, k=k, v=v: F.scaled_dot_product_attention(q, k, v)
                               for q, k, v in lib], 40)
        bound, by = _bound(set_bytes, 4 * B * H * Sq * Skv * D, PEAK_FLOPS["bfloat16"])
        rows[("flash_attention", key)] = (t_k, t_p, t_l, bound, by)
        print(f"  flash_attention bf16 {key}: B={B} Sq={Sq} Skv={Skv} Hq=Hkv={H} D={D} "
              f"non-causal: kernel {t_k * 1e3:.1f} us (eager call {t_e * 1e3:.1f} us), plain "
              f"{t_p * 1e3:.1f} us, sdpa {t_l * 1e3:.1f} us, bound {bound * 1e3:.2f} us ({by}), "
              f"{bound / t_k:.1%} of bound")
        del sets, lib, kcalls
    for label, M_, K, N in ENCDEC_GEMMS:
        _time_gemm(torch, gemm, g, M_, label, K, N, False, rows, label="")
        t_k, t_p, t_l, bound = rows[("gemm", M_, label)]
        rows[("gemm", M_, label)] = (t_k, t_p, t_l, bound,
                                     _bound((M_ * K + K * N + M_ * N) * 2, 2 * M_ * K * N,
                                            PEAK_FLOPS["bfloat16"])[1])
    torch.cuda.empty_cache()
    return rows


def unpaged_plan(cfg):
    """Hand-kernel launches of one unpaged decode step: a K1 launch per
    projection (self q, k, v, o; whisper's cross q and o, its K / V read
    from the cross caches; the MLP's gate, up, down or up, down) and the
    head; one K5 launch per whisper cross-attention (Sq = 1 over the
    frames).  Self-attention over the dense cache is plain PyTorch."""
    per_layer = 4 + (2 if cfg.family == "encdec" else 0) + \
        (3 if cfg.mlp_variant == "swiglu" else 2)
    plan = {"gemm": cfg.n_layers * per_layer + 1}
    if cfg.family == "encdec":
        plan["flash_attention"] = cfg.n_layers
    return plan


def _unpaged_batch(torch, np, cfg, dev, B, P, seed):
    """B random prompts of P tokens, and whisper's frames (B, 1500, d) or
    paligemma's patches (B, 256, 1152), from a seeded numpy generator."""
    from repro_torch.models import model as M

    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, size=(B, P))).to(dev)}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model), dtype=np.float32)).to(dev)
    if cfg.family == "vlm":
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.prefix_len, M.VISION_DIM), dtype=np.float32)).to(dev)
    return batch


def phase_unpaged(torch, np, configs, M, mods, quant, arch, n_new):
    """One arch at published widths (random weights, seed 0; bf16) through
    the reference's unpaged entry points: 8 requests (prompts of 16 tokens
    and the arch's frames or patches) go through `prefill`, then greedy
    `decode_step`s, one state served by the step's CUDA graph and one
    eager, in lockstep; tokens equal; launches per replay as planned."""
    from repro_torch.launch import steps

    cfg = configs.get(arch)
    dev = torch.device("cuda")
    B, P = UNPAGED_SLOTS, UNPAGED_PROMPT
    max_seq = P + n_new
    params = M.init_model(cfg, seed=0, device=dev)
    batch = _unpaged_batch(torch, np, cfg, dev, B, P, seed=41)
    reset_counts(mods)
    t_run = time.monotonic()
    with torch.no_grad():
        prefill_ms = []
        states = []
        for _ in range(2):          # the eager state, then the graphed one
            torch.cuda.synchronize()
            t0 = time.monotonic()
            states.append(M.prefill(params, cfg, batch, max_seq))
            torch.cuda.synchronize()
            prefill_ms.append((time.monotonic() - t0) * 1e3)
        (logits_e, st_e), (logits_g, st_g) = states
        check(torch.equal(logits_e, logits_g), f"{arch}: the two prefills agree bit for bit")
        t0 = time.monotonic()
        step_g = steps.GraphedServeStep(cfg, params, st_g, B)
        capture_s = time.monotonic() - t0
        plan = unpaged_plan(cfg)
        check(step_g.launches == plan,
              f"{arch}: launches per replay {step_g.launches}, planned {plan}")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        toks_e, toks_g = [logits_e[:, -1].argmax(-1)], [logits_g[:, -1].argmax(-1)]
        eager_ms, graphed_ms, replay_ms = [], [], []
        for _ in range(n_new - 1):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            logits_e, st_e = M.decode_step(params, cfg, st_e, toks_e[-1][:, None])
            toks_e.append(logits_e[:, -1].argmax(-1))
            torch.cuda.synchronize()
            eager_ms.append((time.monotonic() - t0) * 1e3)
            t0 = time.monotonic()
            start.record()
            logits_g, _ = step_g(params, st_g, toks_g[-1][:, None])
            end.record()
            toks_g.append(logits_g[:, -1].argmax(-1))
            torch.cuda.synchronize()
            graphed_ms.append((time.monotonic() - t0) * 1e3)
            replay_ms.append(start.elapsed_time(end))
        got, want = torch.stack(toks_g, 1).cpu(), torch.stack(toks_e, 1).cpu()
        check(torch.equal(got, want), f"{arch}: graphed tokens equal eager tokens")
        check(int(st_g.index) == int(st_e.index) == max_seq - 1, f"{arch}: indices advanced")
        # The index is at max_seq - 1: later replays overwrite the last
        # position (the write clamps, as the reference's does), no token is
        # read from them.
        prof = _profile_replays(torch, lambda: step_g(params, st_g, toks_g[-1][:, None]))
        print("  hand kernels in the replay: " + ", ".join(
            f"{k} {t:.3f} ms ({n}x)" for k, t, n in prof["hand"]))
        enc_ms = None
        if cfg.family == "encdec":
            enc_ms = _median([_time_ms(torch, [lambda: M._run_encoder(batch["frames"], params,
                                                                      cfg)], 1, graph=False)
                              for _ in range(3)])
    run_s = time.monotonic() - t_run
    replays = n_new - 1
    counts = read_counts(mods)
    # The capture called each wrapper once and launched nothing.
    launched = {k: counts.get(k, 0) + (replays - 1) * step_g.launches.get(k, 0)
                for k in set(counts) | set(step_g.launches)}
    launched = {k: v for k, v in launched.items() if v}
    for k in plan:
        check(launched.get(k, 0) > 0, f"{arch}: {k} launched on the path")
    cross_bytes = sum(t.numel() * t.element_size() for c in (st_g.cross_caches or [])
                      for t in c)
    self_bytes = sum(t.numel() * t.element_size() for c in st_g.caches for t in c)
    wbytes = quant.weight_bytes(params)
    out = dict(arch=arch, prefill_ms=prefill_ms, encoder_ms=enc_ms, capture_s=capture_s,
               eager_ms=_median(eager_ms), graphed_ms=_median(graphed_ms),
               replay_ms=_median(replay_ms), per_replay=step_g.launches, launches=launched,
               cross_bytes=cross_bytes, self_bytes=self_bytes, weight_bytes=wbytes,
               tokens=got.shape[1], profile=prof)
    print(f"  weights {wbytes / 1e9:.3f} GB; {B} requests x {P}-token prompts"
          + (f" x {cfg.encoder_seq} frames" if cfg.family == "encdec" else "")
          + (f" x {cfg.prefix_len} patches" if cfg.family == "vlm" else "")
          + f", {n_new} new tokens each; the {B * n_new} tokens are identical graphed and eager")
    if enc_ms is not None:
        print(f"  encoder ({cfg.encoder_layers} layers over {B} x {cfg.encoder_seq} frames): "
              f"{enc_ms:.3f} ms")
    print(f"  prefill (forward, then the caches through {P} decode steps"
          + (", the encoder run twice" if cfg.family == "encdec" else "")
          + f"): {prefill_ms[0]:.2f} ms, then {prefill_ms[1]:.2f} ms")
    print(f"  decode step (paired medians over {replays} steps): graphed {out['graphed_ms']:.3f} ms,"
          f" eager {out['eager_ms']:.3f} ms; device time of one replay {out['replay_ms']:.3f} ms;"
          f" captured in {capture_s:.2f}s")
    print(f"  cross caches {cross_bytes / 1e9:.3f} GB, self-attention caches "
          f"{self_bytes / 1e9:.4f} GB; launches per replay (as planned) "
          + " ".join(f"{k}={v}" for k, v in sorted(step_g.launches.items()))
          + "; launches of the run " + " ".join(f"{k}={v}" for k, v in sorted(launched.items()))
          + f"; {run_s:.1f}s")
    del params, batch, states, st_e, st_g, step_g, logits_e, logits_g
    torch.cuda.empty_cache()
    return out


def phase_unpaged_parity(torch, np, configs, M):
    """Both smoke configs, head_dim raised to 64 (K5's smallest), f32, on
    the card (kernels) and on the CPU (plain versions): forward logits, and
    prefill then 6 decode steps fed the CPU's greedy tokens, within phase
    4's bar (max_abs_diff <= 1e-4 x max|logit|) with argmax equal."""
    for arch in UNPAGED_ARCHS:
        smoke = configs.get_smoke(arch)
        cfg = dataclasses.replace(smoke, head_dim=64)
        reduced = {"widths": "smoke config", "dtype": "float32",
                   "head_dim": [smoke.resolved_head_dim, 64]}
        t0 = time.monotonic()
        params = M.init_model(cfg, seed=1, device="cuda")
        cpu_params = _tree_cpu(torch, params)
        logits = {}
        with torch.no_grad():
            for dev in ("cpu", "cuda"):
                p = cpu_params if dev == "cpu" else params
                batch = _unpaged_batch(torch, np, cfg, dev, 2, 12, seed=43)
                out = [M.forward(p, cfg, batch).float().cpu()]
                lg, st = M.prefill(p, cfg, batch, 12 + 6)
                out.append(lg[:, -1].float().cpu())
                for i in range(6):     # the card is fed the CPU's greedy tokens
                    tok = logits["cpu"][i + 1].argmax(-1) if dev == "cuda" else \
                        out[-1].argmax(-1)
                    lg, st = M.decode_step(p, cfg, st, tok[:, None].to(dev))
                    out.append(lg[:, -1].float().cpu())
                logits[dev] = out
        errs = []
        for i, (g_, w_) in enumerate(zip(logits["cuda"], logits["cpu"])):
            err, scale = float((g_ - w_).abs().max()), float(w_.abs().max())
            errs.append(f"{err:.2e}")
            check(err <= 1e-4 * scale and torch.equal(g_.argmax(-1), w_.argmax(-1)),
                  f"{arch}: {'forward' if i == 0 else f'step {i}'} logits card vs CPU "
                  f"({err:.3e}, scale {scale:.3e})")
        print(f"  {arch} reduced {json.dumps(reduced)}: logits max_abs_diff card vs CPU, "
              f"forward then prefill and 6 decode steps: {', '.join(errs)} (bar 1e-4 x "
              f"max|logit|), argmax equal; {time.monotonic() - t0:.1f}s")
        del params, cpu_params
        torch.cuda.empty_cache()


def phase_compare_prefill(np):
    """`python -m repro_torch.launch.serve --arch gemma3-1b --widths
    published --compare-prefill`, through its `main`: the engine serves 4
    requests through its graphs, then the token-by-token prefill (the
    unpaged decode step, one CUDA-graph replay a position) and the engine's
    chunked prefill are timed on the same prompts."""
    import contextlib
    import io

    from repro_torch.launch import serve

    out = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out):
        gen = serve.main(["--arch", "gemma3-1b", "--widths", "published", "--compare-prefill"])
    text = out.getvalue()
    line = [ln for ln in text.splitlines() if ln.startswith("prefill:")]
    for ln in text.splitlines():
        if ln.startswith(("warmup", "arch=", "prefill:")):
            print(f"  {ln}")
    check(gen.shape == (4, 16) and "cold_compiles=0" in text, "the CLI served")
    check(len(line) == 1, "the CLI printed the prefill comparison")
    m = re.search(r"token-by-token ([\d.]+)ms vs chunked ([\d.]+)ms", line[0])
    check(m is not None and float(m.group(1)) > 0 and float(m.group(2)) > 0,
          "both prefill times measured")
    print(f"  {time.monotonic() - t0:.1f}s")
    return float(m.group(1)), float(m.group(2))


def phase11(torch, np, configs, M, mods, quant):
    """Phases 11a-11d; returns the runs' summaries."""
    out = {}
    print("[11a] whisper-medium at published widths (24 encoder + 24 decoder layers, d 1024, "
          "16 / 16 heads, D 64, vocab 51865, untied; bf16): prefill -> decode_step, graphed "
          "and eager")
    out["whisper"] = phase_unpaged(torch, np, configs, M, mods, quant, "whisper-medium", 48)
    print("[11b] paligemma-3b at published widths (18 layers, d 2048, MQA 8 / 1, D 256, vocab "
          "257216, tied; bf16): 256 patches + 16 tokens, prefill -> decode_step")
    out["paligemma"] = phase_unpaged(torch, np, configs, M, mods, quant, "paligemma-3b", 32)
    print("[11c] both smoke configs, f32: CUDA kernels vs CPU plain versions")
    phase_unpaged_parity(torch, np, configs, M)
    print("[11d] serve --arch gemma3-1b --widths published --compare-prefill")
    out["compare_prefill"] = phase_compare_prefill(np)
    return out


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
    from repro_torch import configs, quant
    from repro_torch.kernels import _build, flash_decode as fd, gemm, gemm_int8 as gemm8
    from repro_torch.kernels import flash_attention as fa, gemm_pipelined as gp, ops
    from repro_torch.kernels import launches, quant as kq
    from repro_torch.models import model as M
    from repro_torch.serving import kv_cache as kvc
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import RequestSpec

    mods = {"gemm": gemm, "fd": fd, "gemm8": gemm8, "kq": kq, "fa": fa, "gp": gp,
            "counters": launches}

    t_start = time.monotonic()
    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.monotonic()
    logs = _build.build()
    print(f"[1] kernels built in {time.monotonic() - t0:.1f}s")
    for name, log in logs.items():
        regs, spills, n = 0, 0, 0
        for line in log.splitlines():
            if name in ("flash_decode", "flash_attention") and "Compiling entry" in line:
                print(f"    {name}: {line.strip()}")
            if "registers" in line or "spill" in line:
                print(f"    {name}: {line.strip()}")
            m = re.search(r"Used (\d+) registers", line)
            if m:
                regs, n = max(regs, int(m.group(1))), n + 1
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                spills += int(m.group(1)) + int(m.group(2))
        print(f"[1] {name}.cu: {n} kernels, at most {regs} registers a thread, "
              f"{spills} bytes of spill stores and loads in all")
        if name in ("gemm", "gemm_pipelined", "gemm_int8"):
            check(spills == 0, f"{name}.cu: no spills in the GeMMs")
    for name, op in (("gemm", "HMMA"), ("gemm_pipelined", "HMMA"), ("gemm_int8", "IMMA")):
        n = sass_count(_build._lib_path(name), op)
        print(f"[1] lib{name}.so: " + (f"{op} not counted (no cuobjdump)" if n is None
                                      else f"{n} {op} (tensor-core) instructions"))
        check(n is None or n > 0, f"lib{name}.so runs its products on the tensor cores")

    print("[2] kernels vs plain versions on the card")
    worst = phase_kernels(torch, gemm, fd, kvc)
    worst.update(phase_kernels_int8(torch, gemm8, kq, fd, kvc))
    worst.update(phase_kernels_w8a8(torch, gemm8))
    worst.update(phase_kernels_slice3(torch, fa, gp))
    for k, v in phase_kernels_dense(torch, gemm, gemm8, fd, fa, kvc).items():
        worst[k] = max(worst[k], v)
    for k, v in phase_kernels_verify(torch, gemm, gemm8, fd, kvc).items():
        worst[k] = max(worst[k], v)
    worst_encdec = phase_kernels_encdec(torch, gemm, fa)
    for k, v in worst_encdec.items():
        worst[k] = max(worst[k], v)
    engine_args = (torch, np, configs, M, kvc, Engine, RequestSpec, mods, quant, ops)
    print("[3] full-width gemma3-1b engine run (26 layers, bf16)")
    summary = phase_engine(*engine_args, profile=True)
    print("[3b] the same run in w8a8 with an int8 KV pool")
    summary8 = phase_engine(*engine_args, precision="w8a8", kv_precision="int8", profile=True)
    print("[3c] the same run in calibrated w8a8 with an int8 KV pool")
    summary_cal = phase_engine(*engine_args, precision="w8a8-calibrated", kv_precision="int8")
    print("[3d] phase 3's float run under the pipelined GeMM backend (depth 3)")
    summary_pipe = phase_engine(*engine_args, backend="pipelined")
    print("[3e] the serve CLI at published widths, w8a8 + int8 KV")
    phase_serve_cli(np)
    print("[4] 6-layer full-width f32: CUDA kernels vs CPU plain versions")
    phase_parity(torch, np, configs, M, kvc, Engine, RequestSpec, quant, ops)
    print("[6] quality: forward NLL in float, w8a8 and calibrated w8a8 (26 layers, bf16)")
    summary_q = phase_quality(torch, np, configs, M, quant, mods)
    print("[5] kernel times at main-path shapes (bf16, CUDA events, L2 cold)")
    rows = phase_times(torch, gemm, gp, fd, kvc)
    agg = per_step(rows)
    agg.update(per_step_slice3({**rows, **phase_times_flash(torch, fa)}))
    rows8 = phase_times_int8(torch, gemm8, kq, fd, kvc)
    agg.update(per_step_int8(rows8))
    w8 = per_step_w8a8(rows8, gemm8.FUSED_ROWS)
    agg["gemm_w8a8"] = [w8["decode"][k] for k in ("kernel", "plain", "int_mm", "bound")] \
        + ["bytes"]
    print(f"[5] one float decode step: gemm {agg['gemm'][0]:.3f} ms (torch.matmul "
          f"{agg['gemm'][2]:.3f}, bound {agg['gemm'][3]:.3f}), flash_decode "
          f"{agg['flash_decode'][0]:.3f} ms (bound {agg['flash_decode'][3]:.3f}); engine "
          f"decode step {summary['decode_ms']:.2f} ms")
    chunk = per_prefill_chunk(rows)
    print(f"[5] one float prefill chunk (26 x projections at M=64, head at M=1): gemm "
          f"{chunk['gemm'][0]:.3f} ms, gemm_pipelined (depth 3) "
          f"{chunk['gemm_pipelined'][0]:.3f} ms, torch.matmul {chunk['gemm'][2]:.3f} ms, "
          f"bound {chunk['gemm'][3]:.3f} ms; engine prefill chunk "
          f"{summary['prefill_ms']:.2f} ms")
    for label, what in (("decode", "decode step (183 GeMMs at M=8)"),
                        ("prefill", "prefill chunk (26 x projections at M=64, head at M=1)")):
        t = w8[label]
        print(f"[5] one w8a8 {what}: as planned {t['plan']:.3f} ms; as one launch each "
              f"{t['kernel']:.3f} ms (eager calls {t['eager']:.3f}), static scales "
              f"{t['static']:.3f} ms; as two launches (quantize_rows + dequant_gemm) "
              f"{t['two_launch']:.3f} ms; torch._int_mm {t['int_mm']:.3f} ms, bound "
              f"{t['bound']:.3f} ms")
    print(f"[5] one w8a8 + int8 KV decode step: gemm_w8a8 {agg['gemm_w8a8'][0]:.3f} ms "
          f"(bound {agg['gemm_w8a8'][3]:.3f}), flash_decode_int8 "
          f"{agg['flash_decode_int8'][0]:.3f} ms (bound {agg['flash_decode_int8'][3]:.3f}); "
          f"engine decode step {summary8['decode_ms']:.2f} ms; one prefill chunk's 182 "
          f"projections at M=64: dequant_gemm {agg['dequant_gemm'][0]:.3f} ms + "
          f"quantize_rows {agg['quantize_rows'][0]:.3f} ms (bound "
          f"{agg['quantize_rows'][3]:.4f}); engine prefill chunk {summary8['prefill_ms']:.2f} ms")
    print(f"[5] one decode step under the pipelined backend: gemm_pipelined (depth 3) "
          f"{agg['gemm_pipelined'][0]:.3f} ms (torch.matmul {agg['gemm_pipelined'][2]:.3f}, "
          f"bound {agg['gemm_pipelined'][3]:.3f}); "
          f"engine decode step {summary_pipe['decode_ms']:.2f} ms; calibrated w8a8 "
          f"engine decode step {summary_cal['decode_ms']:.2f} ms")
    for key in ("flash_decode", "flash_decode_int8"):
        for label, t in per_step_decode({**rows, **rows8}, key).items():
            what = "decode step (8 slots)" if label == "decode" else \
                "prefill chunk (64 tokens of the 1100-token slot)"
            print(f"[5] {key} per {what}: rule {t['rule']:.3f} ms (eager calls "
                  f"{t['eager']:.3f}), num_splits=1 {t['splits=1']:.3f} ms, num_splits=4 "
                  f"{t['splits=4']:.3f} ms, sdpa {t['sdpa']:.3f} ms, bound {t['bound']:.4f} ms")
    print(f"[5] one forward over (2, 1024) tokens: flash_attention "
          f"{agg['flash_attention'][0]:.3f} ms (bound {agg['flash_attention'][3]:.3f}, "
          f"sdpa {agg['flash_attention'][2]:.3f})")
    print("[5] whisper-medium's K5 shapes and the encdec / vlm K1 shapes")
    rows_ed = phase_times_encdec(torch, gemm, fa)
    print("[8a] qwen3-14b at published widths (40 layers, bf16), float")
    summary_qf = phase_engine(*engine_args, arch="qwen3-14b", n_layers=40,
                              traffic=qwen3_traffic, profile=True)
    print("[8b] qwen3-14b at published widths, w8a8 with an int8 KV pool")
    summary_q8 = phase_engine(*engine_args, precision="w8a8", kv_precision="int8",
                              arch="qwen3-14b", n_layers=40, traffic=qwen3_traffic)
    print("[8] qwen3-14b kernel times per decode step (bf16, CUDA events, L2 cold)")
    phase_times_dense(torch, gemm, gemm8, fd, kvc, gp, fa)
    print("[8c] the dense family at published widths, 2 layers, f32: CUDA kernels vs CPU "
          "plain versions")
    phase_parity_dense(torch, np, configs, M, kvc, Engine, RequestSpec, quant, mods)
    args9 = (torch, np, configs, M, Engine, RequestSpec, mods)
    print(f"[9a] speculative greedy decoding, gemma3-1b at published widths (26 layers, "
          f"bf16), k = {DRAFT_K}, float")
    summary_9a = phase_speculative(*args9)
    print("[9b] the same in w8a8 with an int8 KV pool")
    summary_9b = phase_speculative(*args9, precision="w8a8", kv_precision="int8")
    print("[9c] sampling: temperature / top-k / top-p with seeded streams")
    phase_sampling(*args9)
    print("[9d] KV-swap preemption and the prefix cache")
    phase_preempt_prefix(*args9)
    phase10(torch, np, configs, M, kvc, Engine, RequestSpec, mods, quant, worst)
    summary11 = phase11(torch, np, configs, M, mods, quant)
    step = "one gemma3-1b decode step"
    # name, source, TPU kernel replaced, what one entry's times cover, launches
    # on its path (the run's window; K5's are phase 6's six (2, 1024) forwards)
    entries = [
        ("gemm", "gemm.cu", "src/repro/kernels/gemm.py:33",
         f"{step}: 26 x (q,k,v,o,gate,up,down) + tied head, M=8, bf16",
         summary["launches"]),
        ("flash_decode", "flash_decode.cu", "src/repro/kernels/flash_decode.py:107",
         f"{step}: 4 global + 22 window-512 layers, B=8, Sq=1, bf16", summary["launches"]),
        ("gemm_w8a8", "gemm_int8.cu",
         "src/repro/kernels/gemm.py:54 with src/repro/kernels/quant.py:25 "
         "(composed in make_w8a8_gemm, src/repro/kernels/quant.py:63)",
         f"{step} in w8a8: 26 x (q,k,v,o,gate,up,down) + tied head, M=8, bf16 -> bf16, "
         f"rows quantized in the prologue", summary8["launches"]),
        ("dequant_gemm", "gemm_int8.cu", "src/repro/kernels/gemm.py:54",
         "one 64-token gemma3-1b prefill chunk in w8a8: 26 x (q,k,v,o,gate,up,down) at "
         "M=64, int8 -> bf16 (the w8a8 GeMM's second launch above 16 rows)",
         summary8["launches"]),
        ("quantize_rows", "quant.cu", "src/repro/kernels/quant.py:25",
         "one 64-token gemma3-1b prefill chunk in w8a8: 182 bf16 rows (64, K), K = 1152 x "
         "130, 1024 x 26, 6912 x 26 (the w8a8 GeMM's first launch above 16 rows)",
         summary8["launches"]),
        ("flash_decode_int8", "flash_decode.cu",
         "src/repro/kernels/flash_decode.py:107 (quantized branch :113-132)",
         f"{step} with an int8 pool: 4 global + 22 window-512 layers, B=8, Sq=1, q bf16",
         summary8["launches"]),
        ("flash_attention", "flash_attention.cu", "src/repro/kernels/flash_attention.py:28",
         "one gemma3-1b forward over (2, 1024) tokens: 4 global + 22 window-512 layers, "
         "Hq=4, Hkv=1, D=256, bf16 (launches: phase 6's 6 such forwards)",
         summary_q["launches"]),
        ("gemm_pipelined", "gemm_pipelined.cu", "src/repro/kernels/gemm_pipelined.py:28",
         f"{step} under the pipelined backend: 26 x (q,k,v,o,gate,up,down) + tied head, "
         f"M=8, bf16, depth 3", summary_pipe["launches"]),
    ]
    kernels = []
    for name, src, replaces, per, launches in entries:
        t_k, t_p, t_l, bound = agg[name][:4]
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "per": per, "launches": launches[name],
            "max_abs_err": worst[name], "ms": t_k, "plain_ms": t_p, "bound_ms": bound,
            "bound_by": agg[name][4] if len(agg[name]) > 4 else "bytes",
            "library_ms": t_l})
    # This slice's shapes of K5 and K1 (launches: each kernel's in phase 11a's
    # run, graph replays included; 11b's for the projector).
    for name, kernel, key, per, run in (
            ("flash_attention:whisper_encoder", "flash_attention",
             ("flash_attention", "whisper encoder"),
             "one whisper-medium encoder layer's attention: B=8, 1500 frames over 1500, "
             "Hq=Hkv=16, D=64, non-causal, bf16", summary11["whisper"]),
            ("flash_attention:whisper_cross_decode", "flash_attention",
             ("flash_attention", "whisper cross Sq=1"),
             "one whisper-medium cross-attention at decode: B=8, Sq=1 over 1500 frames, "
             "Hq=Hkv=16, D=64, non-causal, bf16", summary11["whisper"]),
            ("gemm:whisper_cross_kv", "gemm", ("gemm",) + ENCDEC_GEMMS[0][1:2]
             + ENCDEC_GEMMS[0][:1], "one whisper-medium cross K or V projection of 8 x "
             "1500 frames: M=12000, K=N=1024, bf16", summary11["whisper"]),
            ("gemm:paligemma_projector", "gemm", ("gemm",) + ENCDEC_GEMMS[1][1:2]
             + ENCDEC_GEMMS[1][:1], "paligemma-3b's projector over 8 x 256 patches: "
             "M=2048, K=1152, N=2048, bf16", summary11["paligemma"])):
        t_k, t_p, t_l, bound, by = rows_ed[key]
        src, replaces = {"flash_attention": ("flash_attention.cu",
                                             "src/repro/kernels/flash_attention.py:28"),
                         "gemm": ("gemm.cu", "src/repro/kernels/gemm.py:33")}[kernel]
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "per": per, "launches": run["launches"].get(kernel, 0),
            "max_abs_err": worst_encdec[kernel], "ms": t_k, "plain_ms": t_p,
            "bound_ms": bound, "bound_by": by, "library_ms": t_l})
    print("kernels " + " ".join(
        f"{k['name']}: launches={k['launches']} max_abs_err={k['max_abs_err']:.3e} "
        f"ms={k['ms']:.3f} plain_ms={k['plain_ms']:.3f} bound_ms={k['bound_ms']:.4f} "
        f"library_ms={k['library_ms']};" for k in kernels))
    for label, x in (("3 float", summary), ("3b w8a8 + int8 KV", summary8),
                     ("3c calibrated w8a8 + int8 KV", summary_cal),
                     ("3d float, pipelined", summary_pipe), ("8a qwen3-14b float", summary_qf),
                     ("8b qwen3-14b w8a8 + int8 KV", summary_q8)):
        print(f"[7] {label}: decode step graphed {x['decode_ms']:.3f} ms (one replay "
              f"{x['replay_ms']['decode']:.3f} ms on the device), eager "
              f"{x['eager_decode_ms']:.3f} ms; prefill chunk graphed {x['prefill_ms']:.3f} ms "
              f"(64 tokens, one replay {x['replay_ms']['chunk64']:.3f} ms), eager "
              f"{x['eager_prefill_ms']:.3f} ms; {x['graphs']} graphs captured in "
              f"{x['capture_s']:.2f}s, pool {x['graph_pool_bytes'] / 1e6:.1f} MB; weights "
              f"{x['weight_bytes'] / 1e9:.3f} GB, kv pool {x['kv_pool_bytes'] / 1e9:.3f} GB; "
              f"per replayed decode step " + " ".join(
                  f"{k}={v}" for k, v in x["decode_graph_launches"].items()))
    for label, x in (("9a speculative, float", summary_9a),
                     ("9b speculative, w8a8 + int8 KV", summary_9b)):
        r = x["replay_ms"]
        print(f"[7] {label}: " + "; ".join(
            f"{t} acceptance {x[t]['accept']:.3f}, {x[t]['tok_per_tick']:.2f} tok/tick "
            f"(off {x[t]['plain_tok_per_tick']:.2f}), decode {x[t]['tok_s']:.1f} tok/s "
            f"(off {x[t]['plain_tok_s']:.1f})" for t in ("storm", "random"))
              + "; one replay " + ", ".join(f"{k} {v:.3f} ms" for k, v in r.items())
              + "; launches per verify replay " + "; ".join(
                  f"verify{w}: " + " ".join(f"{k}={v}" for k, v in per.items())
                  for w, per in x["launches"].items()))
    print(f"total {time.monotonic() - t_start:.0f}s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
