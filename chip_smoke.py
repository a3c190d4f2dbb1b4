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
  3. the main path at full width: gemma3-1b, 26 layers (its repeats in
     other modes, phases 3b-3d, 9, 12 and 13, run 6 of them since phase 18
     joined the script: the time limit), bf16, random weights
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
     tiled backend's.  3b, 3c and 3d serve phase 3's first 6 requests
     (the 1100-, 800- and 513-token prompts among them), `reduced` for the
     time limit.
  4. the same weights at full width, depth cut to 6 layers (5 local + 1
     global), float32, on the card (kernels) and on the CPU (plain
     versions): greedy tokens identical in float, in w8a8 with an int8 KV
     pool, in calibrated w8a8 and under the pipelined backend (against the
     float run's CPU tokens: the same plain GeMM); w8a8 logits near the
     float logits; `forward` logits and the calibration table equal across
     devices.  Two prompts of 600 and 72 tokens, 4 new tokens each
     (`reduced` for the time limit).
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
  8a. qwen3-14b at published widths (cut to 20 of its 40 layers since
     phase 18 joined the script: the time limit; d 5120, 40 q heads over 8
     kv heads, head_dim 128, d_ff 17408, untied 151936 vocab, qk-norm),
     bf16, random weights (seed 0), served as phase 3 serves gemma3-1b (8
     slots, 8 requests, prompts 256-1024 tokens, 16 new tokens each (32
     before the training phase joined the script: the time limit), chunk
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
  9a. speculative decoding at full width: gemma3-1b (6 layers, bf16,
     random weights from seed 0), 8 slots, block 16, chunk 64, k = 4.  The
     graphed engine captures `verify2`, `verify3` and `verify5` at warmup
     beside decode, the 7 chunk buckets and the reset; each verify graph
     launches 183 GeMMs and 26 K2.  Two traces: a regeneration storm (16
     requests over 4 prompts of 256-1024 tokens, 32 new tokens each; 64
     before the training phase, cut for the time limit) and 8
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
     to 8 of its 48 layers (one group: 7 mLSTM + 1 sLSTM; 16 before
     phase 18) for the time limit, 8
     requests of 100-192 tokens, 16 new each (cut from 128-256 and
     32 for the time limit), float then w8a8; then, at 16 layers (two
     groups; whole, 48 layers, before phase 18), speculative greedy
     decoding (k = 4, 8 slots) on a regeneration
     storm (16 requests over 4 prompts, 16 new tokens each: 32 before the
     training phase, cut for the time limit), tokens equal to a non-speculative
     graphed engine; then the serve CLI at published widths.
     10b. dbrx-132b, `reduced` to one group of 4 layers (28.5 GB), 8
     requests of 160-320 tokens, 16 new each (cut from 256-1024 and 32 for
     the time limit, and from 256-512 to make room for phase 15), float
     then w8a8 with an int8 KV pool.
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
  12. the tile autotuner and the engine's observability (no kernel
     changed; the tuner picks their launch plans).
     12a. gemma3-1b at published widths, bf16, 8 slots: an untuned graphed
     engine; `Engine(autotune=True, tune_mode="wallclock", trace=True)`,
     whose warmup times every candidate plan of each GeMM shape (K1's split
     count and tile, by CUDA events over a captured graph, L2 cold) and
     K2's split count on the card before it captures its graphs (per shape:
     the winner, its time, the rule's, the candidates, the seconds; every
     winner legal and within the margin of the rule); a second, eager
     engine on the same cache file, which resolves every plan from it with
     no timing launch; the tuned engine untraced.  8 requests of 100-600
     tokens: tokens graphed == eager under the tuned plans; trace on == off
     (tokens, replayed launches, allocator counters); token agreement tuned
     vs untuned, with the logit margin where they diverge; one prefill
     chunk's and one decode step's logits tuned vs untuned within phase 3d's
     bar; one decode / chunk replay's device time tuned vs untuned, in turns.
     12b. the same in w8a8 with an int8 KV pool (the w8a8 GeMM's split count
     and one launch or two, K2's int8 branch), without the untraced engine.
     12c. bit identity under the tuned plans: K1's and the w8a8 GeMM's rows
     at M = 8 equal those at M = 40, K1's two tiles, K6's depths and the
     w8a8 GeMM's one launch or two give the same bits, K2 at Sq = 1 equals
     each position of Sq = 5 (float and int8 pools, global and window).
     12d. the tuner's wall-clock sweep of K6's ring depth 2 / 3 / 4 at
     qwen3-14b's up / gate (5120 x 17408) and down (17408 x 5120) shapes at
     M = 8 and 64, kernels only (Fig. 5's axis): the best time per depth.
     12e. the serve CLI at published widths with `--autotune --tune-mode
     wallclock --trace-out --metrics-json --slo --incident-dir`: the trace
     is Chrome-trace JSON with one flow chain per request, the metrics hold
     per-phase utilization and MFU on the H100's peaks, a breach bundle is
     written; the tracer's cost (per-event time x 14 events) under 2 % of
     the card's decode tick.
  13. the cluster layer (repro_torch.cluster: replica pool, router,
     traffic, cluster metrics) at gemma3-1b's published widths, bf16, on
     one card; every replica an engine with its own thread, CUDA stream,
     graphs and split-K scratch, 8 slots, block 16, chunk 64 (no kernel
     changed; the kernels' launches on this path join the kernels line as
     `cluster_launches`, counted as replays x each graph's launches, with
     the wrappers' counters held at 0 through every served run).
     13a. a bare graphed engine serves `mixed_traffic(n=16, max_prompt=512,
     max_new=(16, 32))` (`reduced` from 768 and (16, 48)); a one-replica
     pool on the same weights under its plans (`share_steps_from`), a
     synchronous router and `run_sync` gives every request the bare
     engine's tokens.
     13b. two replicas, threaded, least-loaded, the same 16 requests: the
     two streams and the two split-K workspaces and counter arrays differ;
     then the one-replica pool and the two-replica pool, each threaded
     behind the async router, serve the trace in turns (one, two;
     one, and one run each under torch.profiler): every request's tokens
     equal the bare engine's in every run, both replicas serve, counters
     back at 0, allocators clean, no cold shape.
     13c. two replicas with the prefix cache, prefix-affinity,
     `shared_system_prompt(n=16, prefix_len=512, suffix=(16, 64),
     max_new=(16, 32))`: tokens equal a bare engine's without the cache,
     prefix hits above 0.
     13d. two replicas in w8a8 with an int8 KV pool on 13a's trace: tokens
     equal a bare w8a8 + int8 KV engine's.
     13e. `serve --widths published --replicas 2 --router-policy
     prefix-affinity --max-pending 4 --tenants 2 --requests 16` with every
     observability flag: sheds, a shed bundle, a trace with two replica
     lanes and the router's where each accepted request's flow chain starts
     on the router's lane and ends on a replica's under its router id, a
     metrics file with `cluster` and two `replicas`.
     13f. printed, not checked: 13b's runs of one replica against two
     (wall clock, generated and decode tok/s, decode step ms per replica,
     TTFT p50 / p95, replays per replica, launches as replays x per-graph
     launches; in the profiled runs the card's busy share and the kernels
     running at once), and the ratio of the unprofiled runs' means.
  14. the training path: gemma3-1b at published widths (26 layers, bf16,
     ~1.0 B parameters, f32 AdamW moments, remat on) trained through the
     train CLI (`repro_torch.launch.train.main`, B 4 x S 1024, 4 steps; 6
     before phase 18): a
     clean run (one checkpoint, at its end), then the same run with a
     checkpoint every 2 steps and `--fail-at 3`, restored from the step-2
     checkpoint, whose losses must equal the
     clean run's bit for bit at every step it ran (step 4 twice).  Each
     step's launches, read after the step and zeroed, must be the plan's
     (`train_plan`: K1 736 = 4 x (26 x 7 + 2 head chunks), K5 52, K5b 26,
     nothing else): every backward GeMM and attention backward went
     through a hand kernel.  Per-step loss and ms, the median step after
     step 1, tokens/s and peak memory; one more step under torch.profiler
     (hand kernels against PyTorch ops).  14b: a 2-layer full-width f32
     step (one window-512 layer, one global, `reduced`) at B 1 x S 768:
     loss and every gradient leaf on the card against the CPU.
     Phase 2 adds K5b (`flash_attention_bwd`) against
     `flash_attention_bwd_plain` at gemma3-1b's training shapes and at
     each head dim, S 32 / 100 / 1000, and at the wgmma body's edges (GQA
     8 / 1, 10 / 2, 16 / 1, 12 / 1, a window of 16, D 64 and 128 at S
     1024), bf16 and f32 (two runs bitwise equal), the forward's lse (and
     its output unchanged by asking), and K1's dX / dW at the training
     shapes; phase 1 counts K5b's HGMMA (wgmma) instructions; phase 5 times
     K5b per train step beside SDPA's backward (its kernels' device time
     from a profile, its backend named, an eager call's time apart) and its
     operations bound, split by K5b's three kernels in a profile, with the
     host cost of its TMA tensor maps, K5's forward with the lse per train
     step beside SDPA's forward, and K1's forward / dX / dW per train step
     beside torch.matmul.  To make room, phase 4's
     first prompt is cut to 520 tokens, 3b serves 6 of its 12 requests,
     10a's float / w8a8 traffic to 100-192 tokens and 16 new, its storm to
     16 new, 10b / 10c's to 256-512 and 16 new, and
     13's trace to prompts of at most 512 tokens and 16-32 new (`reduced`).
  15. the analysis layer (repro_torch.launch: dryrun, step_cost,
     roofline, diagnose; no new kernel), in a process of its own
     (`chip_smoke.py --analysis`, as phase 5 profiles): gemma3-1b at
     published widths, bf16.  15a: one train step at phase 14's shape (B 4
     x S 1024, f32 moments): torch.cuda.max_memory_allocated beside the
     dry run's traced peak of the same step on the meta device, within 25
     %; its hand-kernel launches, and an eager decode step's (8 slots),
     equal to the meta trace's.  15b: a profile of each step split by
     source (`diagnose.attribute`, top 15 rows), at least 95 % of each
     step's kernel time in a named row (a hand kernel or a frame of
     src/repro_torch).  15c: each step's `Roofline.row()` and MFU on the
     989 TFLOP/s bf16 peak; a measured step faster than its roofline
     fails.  To make room, 10b / 10c's prompts are cut to 160-320 tokens.
  16. the families train, in a process of its own (`chip_smoke.py
     --families`), bf16, random weights (seed 0), `SyntheticLMData`, 3
     steps each (xlstm-1.3b 2 since phase 18d, `reduced`).  16a:
     xlstm-1.3b (B 1 x S 512; S 1024 before phase 18),
     whisper-medium (B 4 x S
     448, 1500 stub frames) and paligemma-3b (B 2 x S 1024, 256 patches)
     whole through `repro_torch.launch.train.main` (on_step ends each run
     after its last step, before the final checkpoint: phase 14 holds
     checkpoints), then dbrx-132b at one layer (`reduced` n_layers 40 -> 1,
     group_size 4 -> 1; all 16 experts, the whole arch's bf16 moments)
     through `make_train_step`: each step's loss (finite), ms, hand-kernel
     launches; the median of steps 2-3, tokens/s, peak memory beside the
     meta device's traced peak.  Each step's launches must equal
     `step_cost.analyze`'s count of the same step on the meta device
     (`chip_smoke.py --families-meta`, a CPU process beside the card
     runs); xlstm's whole step traces too slowly for the phase (458 s on a
     CPU), so one 8-layer group is counted at S 64 and scaled by the group
     count, the head's loss chunks at the real S (the formula is
     printed).  16b: xlstm-1.3b, jamba, dbrx-132b, whisper-medium and
     paligemma-3b at 2 layers holding every layer kind of the family
     (`reduced`; jamba 2 of 16 experts, dbrx 4 of 16, for the host's
     memory), published widths, f32, B 1 x S 64 (128 before phase 18):
     the loss within 1e-5
     and every gradient leaf within 1e-4 of max(its largest element, 1e-4
     x the tree's largest) on the card against the CPU.  Phase 2 adds K5b
     at whisper's encoder (1500 frames, non-causal) and cross-attention
     (448 over 1500), dbrx's 48 / 8 and arctic's 56 / 8 heads (clusters
     of 6 and 7 blocks) and 12 / 12 at D 64.  To make room, phase 4's
     w8a8 and calibrated w8a8 token comparisons serve its 72-token prompt
     alone.  To make room, 10a's speculative storm is cut to prompts of
     128-256 tokens, and since phase 18d the profile of one paligemma-3b
     step by source (its prefix's plain attention took 16.3 % of the
     step's kernel time in every run from phase 16 to 18d) no longer runs.
  17. data parallelism and ZeRO-3 through a process group (no new
     kernel).  17b, in this process: `--model-parallel 2` over a world of
     1 raises; dbrx-132b's CLI plan at a data axis of 2 is refused
     (`parallel.fsdp.check_plan`) before any weight is made.  17a, in a
     process that torchrun starts at world size 1 (`python -m
     torch.distributed.run --standalone --nproc-per-node 1 chip_smoke.py
     --parallel`): gemma3-1b at published widths, B 4 x S 1024, bf16,
     PARALLEL_STEPS steps, seed 0, three runs: phase 14's unsharded
     `make_train_step`; the train CLI, which joins an NCCL group from
     torchrun's environment and trains the dp plan (every leaf
     replicated, every gradient all-reduced); `make_sharded_train_step`
     under the ZeRO-3 plan in a world-1 NCCL group of its own (parameters
     and moments in pieces, the whole parameters gathered, the gradients
     reduce-scattered).  Per run: ms a step (median of steps 2-3),
     tokens/s, peak GB, the collectives a step by kind (calls and bytes,
     as planned: one all-reduce a replicated leaf, a gather and a
     reduce-scatter a sharded one, three scalars); each step's loss equal
     to the unsharded run's bit for bit and its K1 / K5 / K5b launches
     equal.
  18. tensor parallelism of the dense decoders, head-parallel and with
     sequence-parallel attention (attn_seq): qwen3-14b at published widths (d 5120, 40 / 8 heads, head
     dim 128, d_ff 17408, vocab 151936) cut to 2 layers, B 2 x S 1024,
     bf16, f32 moments, TP_STEPS steps a run, seed 0.  18a, in a process of
     its own (`chip_smoke.py --tp`): `make_train_step` unsharded, then
     `make_sharded_train_step` under the tp plan forced over (data 1,
     model 1) in a world-1 NCCL group (the operators of
     `parallel/tensor.py` and their collectives at a model axis of 1):
     every step's loss within 1e-5 relative of the unsharded run's, and
     the norm of each leaf of step 1's gradient (made whole by the clip's
     `Layout.norm_reduce`), the K1 / K5 / K5b launches equal, the
     collectives a step by kind; then under the plan with sequence-parallel
     attention forced over (1, 1) (the sequence operators' gathers and
     reduce-scatters over one rank, attention at q offset 0): every step's
     loss equal to the unsharded run's bit for bit.  18b,
     two processes on the one card in a gloo group (`chip_smoke.py
     --tp-gloo RANK STORE`) at (1, 2) without ZeRO-3: each rank holds 20
     q / 4 kv heads, half the MLP and half the vocabulary; every step's
     loss within 5e-4 relative of 18a's unsharded run's and the norm of
     each leaf of step 1's gradient within 5e-3, each rank's
     launches equal to the meta trace of its own step (`step_cost.analyze`
     of `make_sharded_train_step(rank=)`, traced in this process while the
     ranks run), each rank's peak.  18d, in 18b's two processes after its
     steps: the plan with sequence-parallel attention forced at (1, 2):
     each rank holds all 40 q / 8 kv heads and the attention projections
     whole, half the MLP and half the vocabulary, and runs the residual
     stream, the norms and attention on its 512 positions (q offset 0 and
     512) over the whole sequence's K / V; held to 18b's bars against 18a's
     unsharded run, each rank's launches and collectives (the sequence
     gathers and reduce-scatters among them) equal to its meta trace, whose
     K5 / K5b count the later chunk's larger causal share.  gloo takes the
     CUDA tensors of the 1-D all-gather and reduce-scatter (torch 2.11)
     and moves them through the host, as it does all-reduce's.  18c, in
     phase 2: K5 (with its lse) and K5b at a head-parallel rank's shape (B
     2, S 1024, 20 / 4 heads, D 128, causal and a 512 window) and K1's
     forward, dX and dW at a rank's gate, down and head shapes, against
     their plain versions; K5 and K5b at a sequence-parallel rank's q
     offsets (512 queries over 1024 keys at offsets 0 and 512, 40 / 8 heads
     and gemma3-1b's 4 / 1 at D 256, causal and with a 512 window, and 100
     queries at offset 37), bf16 and f32, with the dK / dV of the keys no
     query sees exactly 0.  To make room, 10a's float and w8a8 runs hold
     one group of xlstm-1.3b (8 of 48 layers) and its speculative run two
     (16 layers).
  7. one line per phase 3-3d and 8a-8b: the decode step and prefill chunk,
     graphed and eager, and the device time of one replay of each; one per
     phase 9a-9b: acceptance, tokens per tick and decode tok/s per trace
     with speculation on and off, one replay of each verify graph and of
     the decode graph, launches per verify replay; one per phase 10a-10c
     run; one for phase 14's train step; one for each of phase 17's dp and
     ZeRO-3 steps; one for each of phase 18's runs.

Every phase header carries the seconds since the script started.  The
line before the card line is the kernels' JSON summary (with each kernel's
launches by phase 12's tuner and on phase 13's cluster path apart from its
serving launches; K5b's, K5's and K1's train-step entries count phase 14's
clean run, their `:parallel` entries phase 17a's dp and ZeRO-3 runs,
their `:tp` entries phase 18's head-parallel runs and their `:sp` entries
its sequence-parallel ones); the
last line
is {"ok": true, "device": {...}}.  Exits non-zero, printing no result,
without a CUDA device or without the port package beside this script.
"""

from __future__ import annotations

import collections
import contextlib
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

try:       # the H100's published peaks and every kernel's cost, held once in the port
    from repro_torch.core import hw
    from repro_torch.kernels import cost as kcost
except ImportError:        # no port beside this script (or no torch): main() fails
    hw = kcost = None
GEMM_SHAPES = [  # (name, K, N, transposed B view) of one gemma3-1b layer + head
    ("q", 1152, 1024, False), ("k", 1152, 256, False), ("v", 1152, 256, False),
    ("o", 1024, 1152, False), ("gate", 1152, 6912, False),
    ("up", 1152, 6912, False), ("down", 6912, 1152, False),
    ("head", 1152, 262144, True),
]
_START = time.monotonic()


def stamp() -> str:
    """Seconds since the script started, for the phase headers."""
    return f"(t+{time.monotonic() - _START:.0f}s)"


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


# Phase 3 serves gemma3-1b whole.  Its repeats in other modes (3b-3d, 9, 12,
# 13) run 6 of its 26 layers, one group of 5 window-512 layers and a global
# one (phase 4's cut), since phase 18 joined the script: the time limit, on
# hosts up to 1.5x slower than others.
GEMMA_SERVE = {"n_layers": 6, "group_size": 6}
GEMMA_GLOBALS = 1          # global layers of the cut (4 in the whole 26)
GEMMA_CUT = {"n_layers": [26, 6], "group_size": [13, 6]}


def gemma_serve_cfg(configs):
    """gemma3-1b at published widths cut to GEMMA_SERVE, its cut printed."""
    full = configs.get("gemma3-1b")
    check(full.dtype == "bfloat16" and full.n_layers == 26, "gemma3-1b full config")
    print(f"  reduced {json.dumps(GEMMA_CUT)}")
    return dataclasses.replace(full, **GEMMA_SERVE)


def phase_engine(torch, np, configs, M, kvc, Engine, RequestSpec, mods, quant, ops,
                 precision="float", kv_precision="float", backend="tiled",
                 profile=False, arch="gemma3-1b", n_layers=26, traffic=gemma_traffic,
                 reduced=None, replay_traffic=None, cut=None):
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
    and with `profile` the kernels of one replayed decode step.  The replays
    are timed with the 8 slots at `replay_traffic`'s (default `traffic`'s)
    first 8 prompt lengths plus 32."""
    from repro_torch.serving.prefill import chunk_buckets, plan_chunks

    cfg = configs.get(arch)
    check(cfg.dtype == "bfloat16" and cfg.n_layers == n_layers, f"{arch} full config")
    if cut is not None:
        cfg = dataclasses.replace(cfg, **cut)
    if reduced:
        print(f"  reduced {json.dumps(reduced)}")
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
        lens = [int(n) + 32 for n in (replay_traffic or traffic)(np)[0][:8]]
        replay = _replayed_step_ms(torch, np, graphed, lens)
        print(f"  device time of one replay (CUDA events, median of 10; 8 slots live at "
              f"{lens} tokens): decode step "
              f"{replay['decode']:.3f} ms, 64-token prefill chunk (slot 0) "
              f"{replay['chunk64']:.3f} ms")
        if profile:
            summary_profile = _profile_decode(torch, graphed, lens)
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


def gemma_traffic_cut(np):
    """Phase 3's first 6 requests (the 1100-, 800- and 513-token prompts
    among them): phases 3b, 3c and 3d, cut for the time limit."""
    plens, max_new, rng = gemma_traffic(np)
    return plens[:6], max_new[:6], rng


CUT_3CD = {"requests": [12, 6]}


def qwen3_traffic(np):
    """Phase 8's requests: 8 prompts of 256-1024 tokens (both ends drawn),
    16 new tokens each (32 before the training phase: the time limit); the
    generator then draws the prompts."""
    rng = np.random.default_rng(8)
    plens = rng.integers(256, 1025, size=8)
    plens[:2] = (1024, 256)
    return plens, np.full(8, 16), rng


CUT_8 = {"new tokens": [32, 16], "n_layers": [40, 20]}
QWEN3_LAYERS = 20          # of 40 (since phase 18: the time limit)


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
                "decode_combine_kernel", "quant_rows_kernel", "flash_kernel", "mma_kernel",
                "delta_kernel", "dkdv_wgmma", "dq_wgmma", "dkdv_simt", "dq_simt")


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


def _profile_replays(torch, replay, reps: int = 3, label: str = "replayed decode step"):
    """torch.profiler over `reps` calls of `replay` (a decode step's graph
    replay, or what `label` names): device time per step split between the
    hand kernels and the plain PyTorch ops between them, and the top 10
    kernels by time."""
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
    print(f"  profile of one {label} (torch.profiler, {reps} runs): "
          f"{n_all} kernels, {total:.3f} ms of kernel time in a {span:.3f} ms run "
          f"({100 * (1 - total / span):.1f} % of it between kernels); hand kernels "
          f"{n_hand} launches {hand:.3f} ms ({100 * hand / max(total, 1e-9):.1f} %), "
          f"PyTorch ops {n_all - n_hand} kernels {total - hand:.3f} ms "
          f"({100 * (total - hand) / max(total, 1e-9):.1f} %)")
    check(total > 0, "the profiler saw the replayed kernels")
    top = sorted((r for r in rows if not any(h in r[0] for h in HAND_KERNELS)),
                 key=lambda r: -r[1])[:10]
    print(f"  the 10 PyTorch-op kernels that take the most time in the {label}:")
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
    # Cut for the time limit: the first prompt to 520 tokens (still past the
    # 512 window), the second to 72 (two chunks), 4 new tokens a request,
    # and the pipelined backend's CPU run (the same plain GeMM as the float
    # run's) is the float run's.
    prompts[0], prompts[1] = prompts[0][:520], prompts[1][:72]
    max_new = 4
    print('  reduced {"prompt tokens": [[600, 300], [520, 72]], "new tokens": [8, 4], '
          '"CPU runs": ["float, pipelined: its own", "the float run\'s"], '
          '"w8a8 and calibrated w8a8 prompts served": [2, 1]}')

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

    def serve(dev, p, precision, kv_precision, served=None):
        eng = Engine(cfg, p, slots=2, max_seq=640, block_size=16, max_chunk=64,
                     precision=precision, kv_precision=kv_precision, device=dev)
        eng.warmup()
        for pr in prompts if served is None else served:
            eng.submit(RequestSpec(prompt=pr, max_new=max_new))
        return eng.run()

    first_step, cpu_tokens = {}, {}
    # f32 on both sides, sums in another order.  In float the logits agree
    # within 1e-4 x max|logit| with the same top-8.  In w8a8 a reordered sum
    # moves an activation across a rounding edge of its int8 code now and
    # then, and 6 layers at full width amplify that: a relative perturbation
    # of 1e-6 in the embedding table moves the logits by a few percent and
    # can reorder the top-8.  So the w8a8 bar is that noise floor, measured
    # here: CUDA vs CPU must differ by no more than twice the largest change
    # that three such perturbations make on the card, in relative L2, with
    # the same argmax.
    # The w8a8 tokens are served for the 72-token prompt alone (its CPU run
    # of the 520-token one cut for the time limit when phase 16 joined the
    # script); its logits below still run the 520-token prompt.
    for precision, kv_precision, tol, served in (("float", "float", 1e-4, None),
                                                 ("w8a8", "int8", None, prompts[1:])):
        print(f"  precision={precision}, kv={kv_precision}:")
        out = {}
        for dev, p in (("cuda", params), ("cpu", cpu_params)):
            t0 = time.monotonic()
            out[dev] = serve(dev, p, precision, kv_precision, served)
            print(f"    {dev}: {time.monotonic() - t0:.1f}s, tokens "
                  f"{[out[dev][r].tolist() for r in sorted(out[dev])]}")
        for rid in out["cpu"]:
            check(np.array_equal(out["cuda"][rid], out["cpu"][rid]),
                  f"request {rid}: CUDA tokens equal the CPU plain-version tokens "
                  f"({precision}, {kv_precision} KV)")
        cpu_tokens[precision] = out["cpu"]
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
    # Tokens only: calibrated w8a8 (the 72-token prompt alone, as w8a8's),
    # and the float engine under the pipelined backend (K6 on the card; on
    # the CPU the float run's plain GeMM).
    for precision, kv_precision, backend, served in (
            ("w8a8-calibrated", "int8", "tiled", prompts[1:]),
            ("float", "float", "pipelined", None)):
        out = {}
        ops.set_default_backend(backend)
        try:
            runs = [("cuda", params)] + ([("cpu", cpu_params)] if backend == "tiled" else [])
            for dev, p in runs:
                t0 = time.monotonic()
                out[dev] = serve(dev, p, precision, kv_precision, served)
                print(f"  precision={precision}, kv={kv_precision}, backend={backend}, "
                      f"{dev}: {time.monotonic() - t0:.1f}s, tokens "
                      f"{[out[dev][r].tolist() for r in sorted(out[dev])]}")
        finally:
            ops.set_default_backend("tiled")
        want = out.get("cpu", cpu_tokens.get(precision))
        for rid in want:
            check(np.array_equal(out["cuda"][rid], want[rid]),
                  f"request {rid}: CUDA tokens equal the CPU plain-version tokens "
                  f"({precision}, {kv_precision} KV, {backend})")
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
    copies = max(1, min(128, math.ceil(2 * hw.L2_BYTES / (K * N * 2))))
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
    bound, by = _bound(kcost.gemm(M, K, N))
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
              for _ in range(max(1, min(128, math.ceil(2 * hw.L2_BYTES / (K * N)))))]
        t_f = _time_ms(torch, [lambda b=b, sb=sb: gemm8._w8a8_fused(a, b, sb, None, dt)
                               for b, sb in ws], iters)
        t_fp = _time_ms(torch, [lambda b=b, sb=sb: gemm8.gemm_w8a8_plain(a, b, sb, None, dt)
                                for b, sb in ws[:2]], 4, graph=False)
        a_lib = torch.zeros((32, K), device=dev, dtype=torch.int8)   # cuBLASLt takes M > 16
        t_l = _time_ms(torch, [lambda b=b: torch._int_mm(a_lib, b) for b, _ in ws], iters)
        bound, by = _bound(kcost.gemm_w8a8(8, K, N))
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
            for _ in range(max(2, math.ceil(2 * hw.L2_BYTES / set_bytes)))]
    t_k = _time_ms(torch, [lambda q=q, k=k, v=v: fa.flash_attention(q, k, v)
                           for q, k, v in sets], 40)
    t_p = _time_ms(torch, [lambda q=q, k=k, v=v: fa.flash_attention_plain(q, k, v)
                           for q, k, v in sets[:2]], 4, graph=False)
    lib = [(q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3).repeat_interleave(Hq // Hkv, 1),
            v.permute(0, 2, 1, 3).repeat_interleave(Hq // Hkv, 1)) for q, k, v in sets]
    t_l = _time_ms(torch, [lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
        q, k, v, is_causal=True) for q, k, v in lib], 40)
    bound, by = _bound(kcost.flash_attention(B, S, S, Hq, Hkv, D,
                                             pairs=kcost.attention_pairs(S, S)))
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
               for _ in range(max(1, math.ceil(2 * hw.L2_BYTES / (K * N * 2))))]
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
            keys, visible = kcost.decode_work(idx.tolist(), sq, window)
            bound, by = _bound(kcost.flash_decode(
                b_, sq, Hkv * G, Hkv, D, keys=keys, visible=visible,
                table_entries=b_ * (max_seq // bs), pool_int8=int8))
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
                for _ in range(max(2, math.ceil(2 * hw.L2_BYTES / set_bytes)))]
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
            pairs = kcost.attention_pairs(S, S, True, window)
            bound, by = _bound(kcost.flash_attention(B, S, S, Hq, Hkv, D, pairs=pairs))
            rows[("flash_attention", S, window)] = (t_k, t_p, t_l, bound, by)
            print(f"  flash_attention bf16 B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} causal "
                  f"window={window}: kernel {t_k * 1e3:.1f} us (eager call {t_e * 1e3:.1f} us), "
                  f"plain {t_p * 1e3:.1f} us, sdpa {t_l * 1e3:.1f} us, bound "
                  f"{bound * 1e3:.2f} us ({by}), {bound / t_k:.1%} of bound")
            del lib, kcalls, lcalls
        del sets
    torch.cuda.empty_cache()
    return rows


def _bound(c):
    """(bound in ms, what bounds it) of a kernel's cost (kcost: the cost
    functions the kernels' meta routes report to launch/step_cost.py)."""
    return c.bound_s * 1e3, c.bound_by


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
            copies = max(1, min(128, math.ceil(2 * hw.L2_BYTES / (K * N))))
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
            bound, by = _bound(kcost.dequant_gemm(M, K, N))
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
            bound_f, by_f = _bound(kcost.gemm_w8a8(M, K, N))
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
        bound, by = _bound(kcost.quantize_rows(M, K))
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
        "quantize_rows": [(rows[("quantize_rows", 64, k)], n * n_layers // 26)
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


# Phase 9: this slice's paths on gemma3-1b at published widths (GEMMA_SERVE's
# 6 layers, bf16, random weights from seed 0), 8 slots, block 16, chunk 64, k = 4.
PHASE9_KW = dict(slots=8, max_seq=1200, block_size=16, max_chunk=64)
DRAFT_K = 4
PHASE9_DEVICE = "cuda"


def storm_traffic(np, vocab):
    """A regeneration storm: 16 requests over 4 distinct prompts of
    256-1024 tokens, 32 new tokens each (64 before the training phase: the
    time limit); repeats admitted after a copy finished find its stream in
    the drafter's corpus."""
    rng = np.random.default_rng(9)
    plens = rng.integers(256, 1025, size=4)
    plens[:2] = (1024, 256)
    prompts = [rng.integers(0, vocab, size=int(n)) for n in plens]
    return [(prompts[i % 4], 32) for i in range(16)]


def random_traffic(np, vocab):
    """8 i.i.d. random prompts of 256-1024 tokens, 32 new tokens each (64
    before the training phase: the time limit)."""
    rng = np.random.default_rng(10)
    return [(rng.integers(0, vocab, size=int(n)), 32) for n in rng.integers(256, 1025, size=8)]


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
    graph on the device, launches per verify graph (7 GeMMs a layer and
    the head, one K2 a layer), no cold compile."""
    from repro_torch.serving.speculative import verify_buckets

    cfg = gemma_serve_cfg(configs)
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
            check(len(a) == specs[rid].max_new, f"{trace} request {rid} got its budget")
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

    cfg = gemma_serve_cfg(configs)
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
    cfg = gemma_serve_cfg(configs)
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


def family_storm(np, vocab, lo=256, hi=512, new=16):
    """A regeneration storm: 16 requests over 4 distinct prompts of `lo`-`hi`
    tokens, `new` new tokens each (16; 32 before the training phase joined
    the script: the time limit); repeats admitted after a copy finished
    find its stream in the drafter's corpus."""
    rng = np.random.default_rng(11)
    plens = rng.integers(lo, hi + 1, size=4)
    prompts = [rng.integers(0, vocab, size=int(n)) for n in plens]
    return [(prompts[i % 4], new) for i in range(16)]


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
    with torch.no_grad(), eng._step_ctx():
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
    # The storm's prompts are cut to 128-256 tokens (from 256-512) for the
    # time limit when phase 16 joined the script (`reduced`).
    print('  reduced {"storm prompt tokens": [[256, 512], [128, 256]]}')
    specs = [RequestSpec(prompt=p, max_new=n)
             for p, n in family_storm(np, cfg.vocab, lo=128, hi=256)]
    reset_counts(mods)
    got, times, d = _serve_ticks(spec, specs)
    want, ptimes, pd = _serve_ticks(plain, specs)
    check(sum(read_counts(mods).values()) == 0, "every step a replay")
    for rid, (a, b) in enumerate(zip(got, want)):
        check(np.array_equal(a, b), f"request {rid}: speculative tokens equal non-speculative")
        check(len(a) == specs[rid].max_new, f"request {rid} got its budget")
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
    xl_traffic = family_traffic(20, 100, 192, new=16)
    # The float and w8a8 runs are cut to 2 of the 6 groups, their prompts to
    # 100-192 tokens (13 full 64-token chunks, above the 10 paired chunks
    # the medians need) and 16 new tokens each, to keep the whole script inside
    # its time limit: their eager 64-token chunks (64 sequential mLSTM steps
    # a layer, ~0.6 s each) were a fifth of it.  A recurrent step's work
    # does not grow with the context, so the step times stay comparable.
    # Phase 18 cut them to one group, and the speculative run from all 48
    # layers to two groups; the CLI keeps all 48.
    cut = dataclasses.replace(cfg, n_layers=cfg.group_size)
    cut_reduced = {"n_layers": [cfg.n_layers, cut.n_layers]}
    print("[10a] xlstm-1.3b at published widths (d 2048, 4 heads, vocab 50304, untied; "
          "bf16), 8 of its 48 layers (7 mLSTM, 1 sLSTM), float")
    out["10a float"] = phase_family(*args, cut, cut_reduced, xl_traffic)
    print("[10a] the same in w8a8 (no attention layer: no KV pool)")
    out["10a w8a8"] = phase_family(*args, cut, cut_reduced, xl_traffic, precision="w8a8")
    spec_cfg = dataclasses.replace(cfg, n_layers=2 * cfg.group_size)
    print(f"[10a] speculative greedy decoding, k = {DRAFT_K}, 8 slots, 16 of the 48 layers "
          f"(14 mLSTM, 2 sLSTM); reduced {json.dumps({'n_layers': [cfg.n_layers, 16]})}")
    out["10a spec"] = phase_family_spec(torch, np, M, Engine, RequestSpec, mods, spec_cfg,
                                        DRAFT_K, 8)
    print("[10a] the serve CLI: --arch xlstm-1.3b --widths published")
    phase_serve_cli(np, arch="xlstm-1.3b", extra=())
    # dbrx and jamba: prompts of 160-320 tokens, 16 new each (time limit:
    # cut from 256-512 to make room for phase 15; 4-5 chunks a prompt keep
    # the paired chunk medians above their 10 pairs).
    big_traffic = family_traffic(21, 160, 320, new=16)
    traffic_cut = {"prompt tokens": [[256, 1024], [160, 320]], "new tokens": [32, 16]}
    cfg, reduced = family_cfg(configs, "dbrx-132b")
    reduced = {**reduced, **traffic_cut}
    print("[10b] dbrx-132b at published widths (d 6144, 48 / 8 heads, 16 experts top-4, "
          "d_ff 10752; bf16), one group of 4 layers, float")
    out["10b float"] = phase_family(*args, cfg, reduced, big_traffic)
    print("[10b] the same in w8a8 with an int8 KV pool")
    out["10b w8a8"] = phase_family(*args, cfg, reduced, big_traffic, precision="w8a8",
                                   kv_precision="int8")
    cfg, reduced = family_cfg(configs, "jamba-1.5-large-398b")
    reduced = {**reduced, **traffic_cut}
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
                for _ in range(max(2, math.ceil(2 * hw.L2_BYTES / set_bytes)))]
        kcalls = [lambda q=q, k=k, v=v: fa.flash_attention(q, k, v, causal=False)
                  for q, k, v in sets]
        t_k = _time_ms(torch, kcalls, 40)
        t_e = _time_ms(torch, kcalls, 40, graph=False)
        t_p = _time_ms(torch, [lambda q=q, k=k, v=v: fa.flash_attention_plain(
            q, k, v, causal=False) for q, k, v in sets[:2]], 4, graph=False)
        lib = [tuple(t.permute(0, 2, 1, 3) for t in s) for s in sets]
        t_l = _time_ms(torch, [lambda q=q, k=k, v=v: F.scaled_dot_product_attention(q, k, v)
                               for q, k, v in lib], 40)
        bound, by = _bound(kcost.flash_attention(
            B, Sq, Skv, H, H, D, pairs=kcost.attention_pairs(Sq, Skv, False)))
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
                                     _bound(kcost.gemm(M_, K, N))[1])
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


# ---------------------------------------------------------------------------
# Phase 12: the tile autotuner and the engine's observability
# ---------------------------------------------------------------------------

# Phase 12's traffic: 8 requests of 100-600 tokens (two past the 512
# window), 24-32 new tokens each, fewer than phase 3's to keep the phase
# within its share of the time limit.
def tune_traffic(np):
    rng = np.random.default_rng(12)
    plens = rng.integers(100, 601, size=8)
    plens[:2] = (600, 513)
    return plens, rng.integers(24, 33, size=8), rng


QWEN3_DEPTH_SHAPES = [("up / gate", 5120, 17408), ("down", 17408, 5120)]


def _tuned_plans(tuning, eng, label):
    """Print one line per tuned GeMM plan of `eng` (its winner, time, the
    rule's time, candidates, seconds) and its K2 plan; check each winner is
    a legal candidate no slower than the rule beyond the margin."""
    t = eng.tuner
    w8a8 = eng.precision != "float"
    dtype, backend = ("int8", "w8a8") if w8a8 else (eng.cfg.dtype, "tiled")
    for shape, r in eng.tune_results:
        kmajor = eng.cfg.tie_embeddings and shape.N == eng.cfg.vocab and not w8a8
        legal = tuning.enumerate_tiles(shape, dtype, backend=backend, sms=t.sms,
                                       kmajor=kmajor)
        check(r.spec in legal, f"{label} {shape}: winner {r.spec} is a legal candidate")
        check(r.score <= r.rule_score * (1 + tuning.autotuner.MARGIN),
              f"{label} {shape}: winner within the margin of the rule")
        p = r.spec
        plan = (f"splits={p.splits} tile={16 if p.swap else 64}"
                + (f" {'one launch' if p.fused else 'two launches'}" if w8a8 else ""))
        rule = r.rule_spec
        print(f"  {label} {shape.M}x{shape.K}x{shape.N}: {plan} "
              f"{'(the rule)' if p == rule else f'(rule splits={rule.splits})'} "
              f"{r.score * 1e6:.2f} us, rule {r.rule_score * 1e6:.2f} us "
              f"({r.score / r.rule_score - 1:+.1%}), {r.candidates} candidates, "
              f"{r.seconds:.2f}s [{'cache' if r.from_cache else r.source}]")
    d = eng.decode_tune_result
    print(f"  {label} K2 ({eng.kv_precision} pool, Sq=1, {eng.max_blocks_per_slot} columns, "
          f"windows {[(w, n) for w, n in tuning.serving_decode_shape(eng.cfg, slots=eng.slots, block_size=eng.block_size, max_blocks=eng.max_blocks_per_slot).windows]}): "
          f"splits={d.spec.num_splits} (rule {d.rule_spec.num_splits}) "
          f"{d.score * 1e6:.2f} us a step, rule {d.rule_score * 1e6:.2f} us "
          f"({d.score / d.rule_score - 1:+.1%}), {d.candidates} candidates, {d.seconds:.2f}s")
    check(d.score <= d.rule_score * (1 + tuning.autotuner.MARGIN),
          f"{label} K2 within the margin")
    print(f"  {label} tuning: {t.tuning_s:.2f}s, timing launches (apart from serving) "
          + " ".join(f"{k}={v}" for k, v in sorted(t.timing_launches.items())))


def _replay_pairs(torch, np, a, b, lengths, rounds: int = 2):
    """Device ms of one decode replay and one 64-token chunk replay of
    engines a and b in turns (a, b, b, a per round), medians."""
    got = {id(a): {"decode": [], "chunk64": []}, id(b): {"decode": [], "chunk64": []}}
    for _ in range(rounds):
        for eng in (a, b, b, a):
            r = _replayed_step_ms(torch, np, eng, lengths, reps=5)
            for k in r:
                got[id(eng)][k].append(r[k])
    return ({k: _median(v) for k, v in got[id(a)].items()},
            {k: _median(v) for k, v in got[id(b)].items()})


def _first_divergence(torch, np, M, kvc, quant, cfg, params, tuned, untuned, prompt, ut,
                      tt, precision, kv_precision):
    """At the first token where the tuned and untuned runs differ: the
    untuned logits' top-2 margin and the largest logit change the tuned
    plans make there (the prompt and the shared tokens prefilled again)."""
    from repro_torch import tuning

    i = int(np.argmax(ut != tt))
    ctx = np.concatenate([prompt, ut[:i]])
    out = []
    for eng in (untuned, tuned):
        with tuning.scope(eng.tuner, eng.decode_spec):
            out.append(_prompt_logits(torch, M, kvc, quant, cfg, params, ctx, "cuda",
                                      precision=precision, kv_precision=kv_precision)[0])
    top = out[0].topk(2).values
    return i, float(top[0] - top[1]), float((out[1] - out[0]).abs().max())


def phase12_serve(torch, np, configs, M, kvc, Engine, RequestSpec, mods, quant, tdir,
                  precision="float", kv_precision="float"):
    """12a / 12b: gemma3-1b at published widths served by an untuned graphed
    engine, a wall-clock-tuned traced graphed engine, the same tuned plans
    eager (a second engine on the same cache file) and, in float, the
    tuned graphed engine untraced.  Checks: winners legal and within the
    margin, the second engine tunes nothing, tuned tokens graphed == eager,
    trace on == off, tuned vs untuned logits at phase 4's configuration and
    bar (`phase12_logits`)."""
    from repro_torch import tuning

    label = "12a" if precision == "float" else "12b"
    cfg = gemma_serve_cfg(configs)
    params = M.init_model(cfg, seed=0, device="cuda")
    kw = dict(slots=8, max_seq=1200, block_size=16, max_chunk=64, precision=precision,
              kv_precision=kv_precision, device="cuda")
    os.environ["REPRO_TUNE_CACHE"] = str(Path(tdir) / "tunecache.json")
    engines = {}
    t0 = time.monotonic()
    untuned = Engine(cfg, params, **kw)
    untuned.warmup()
    params = untuned.params                  # int8-resident in w8a8
    engines["untuned"] = untuned
    reset_counts(mods)
    tuned = Engine(cfg, params, autotune=True, tune_mode="wallclock", trace=True, **kw)
    t1 = time.monotonic()
    tuned.warmup()
    warm_s = time.monotonic() - t1
    engines["tuned"] = tuned
    check(all(r.source == "wallclock" and not r.from_cache for _, r in tuned.tune_results),
          "every plan timed on the card")
    _tuned_plans(tuning, tuned, label)
    print(f"  {label} tuned warmup {warm_s:.2f}s (tuning {tuned.tuner.tuning_s:.2f}s, then "
          f"{tuned.metrics.aot_steps} graphs in {tuned.metrics.capture_time_s:.2f}s); graph "
          f"pool tuned {graph_pool_bytes(torch, tuned) / 1e6:.1f} MB, untuned "
          f"{graph_pool_bytes(torch, untuned) / 1e6:.1f} MB")
    # K2's split workspace, allocated in the pool, follows the split count;
    # the tuner's operand copies (up to 100 MB) must not land there.
    check(graph_pool_bytes(torch, tuned) <= graph_pool_bytes(torch, untuned) + 16e6,
          "the tuner's graphs and operands stayed out of the engine's graph pool")
    eager = Engine(cfg, params, autotune=True, tune_mode="wallclock", graphs=False, **kw)
    eager.warmup()
    check(all(r.from_cache for _, r in eager.tune_results)
          and eager.decode_tune_result.from_cache and not eager.tuner.timing_launches,
          "a second engine on the same cache file resolves every plan from it, no timing launch")
    engines["eager"] = eager
    if precision == "float":
        plain = Engine(cfg, params, autotune=True, tune_mode="wallclock", **kw)
        plain.warmup()
        engines["untraced"] = plain
    print(f"  {label} {len(engines)} engines warm in {time.monotonic() - t0:.1f}s; the second "
          f"engine resolved {len(eager.tune_results)} GeMM plans and K2's from the cache")
    plens, max_new, rng = tune_traffic(np)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)) for n in plens]
    for p, n in zip(prompts, max_new):
        for eng in engines.values():
            eng.submit(RequestSpec(prompt=p, max_new=int(n)))
    reset_counts(mods)
    _, t_run = _run_paired(torch, tuned, eager)
    for name in ("untuned", "untraced"):
        if name in engines:
            engines[name].run()
    torch.cuda.synchronize()
    m = tuned.metrics
    for rid, toks in tuned.results.items():
        check(np.array_equal(toks, eager.results[rid]),
              f"{label} request {rid}: tuned tokens graphed == eager")
    print(f"  {label} tuned graphed and eager in lockstep {t_run:.1f}s: the {len(prompts)} "
          f"requests' tokens ({sum(map(len, tuned.results.values()))}) are identical graphed "
          f"and eager; {m.prefill_chunks} chunks, {m.decode_steps} decode steps")
    if "untraced" in engines:
        plain = engines["untraced"]
        check(all(np.array_equal(t, plain.results[r]) for r, t in tuned.results.items()),
              "trace on == off: tokens")
        check(tuned.replayed_launches() == plain.replayed_launches(),
              "trace on == off: replayed launches")
        check(tuned.alloc.stats() == plain.alloc.stats(), "trace on == off: allocator")
        print(f"  {label} trace on vs off: identical tokens, replayed launches "
              + " ".join(f"{k}={v}" for k, v in tuned.replayed_launches().items() if v)
              + f", allocator {tuned.alloc.stats()}")
    diverged = {r: int(np.argmax(t != untuned.results[r])) for r, t in tuned.results.items()
                if not np.array_equal(t, untuned.results[r])}
    n_tok = sum(map(len, tuned.results.values()))
    agree = sum(int((untuned.results[r] == t).sum()) for r, t in tuned.results.items())
    print(f"  {label} tokens tuned vs untuned: {agree} of {n_tok} equal; {len(diverged)} of "
          f"{len(prompts)} requests diverge (request: first differing token {diverged})")
    for rid in list(diverged)[:2]:
        i, margin, delta = _first_divergence(
            torch, np, M, kvc, quant, cfg, params, tuned, untuned, prompts[rid],
            untuned.results[rid], tuned.results[rid], precision, kv_precision)
        print(f"  {label} request {rid} diverges at token {i}: untuned top-2 margin "
              f"{margin:.3e}, largest logit change under the tuned plans {delta:.3e}")
    probe = np.random.default_rng(0).integers(0, cfg.vocab, size=300)
    logits = {}
    for name in ("untuned", "tuned"):
        eng = engines[name]
        with tuning.scope(eng.tuner, eng.decode_spec):
            logits[name] = _prompt_logits(torch, M, kvc, quant, cfg, params, probe, "cuda",
                                          precision=precision, kv_precision=kv_precision,
                                          next_token=int(probe[-1]))
    print(f"  {label} {cfg.n_layers}-layer bf16 fidelity (not checked; phase 4 holds the plans "
          f"to its "
          f"bar below): relative L2 of the logits tuned vs untuned, last prefill chunk "
          f"{rel_l2(torch, logits['tuned'][0], logits['untuned'][0]):.3e}, decode step "
          f"{rel_l2(torch, logits['tuned'][1], logits['untuned'][1]):.3e}")
    phase12_logits(torch, np, configs, M, kvc, quant, tdir, label, precision, kv_precision)
    lengths = [int(n) + 24 for n in plens]
    rt, ru = _replay_pairs(torch, np, tuned, untuned, lengths)
    print(f"  {label} device time of one replay, tuned vs untuned (CUDA events, in turns, "
          f"medians): decode {rt['decode']:.3f} vs {ru['decode']:.3f} ms "
          f"({rt['decode'] / ru['decode'] - 1:+.1%}); 64-token chunk {rt['chunk64']:.3f} vs "
          f"{ru['chunk64']:.3f} ms ({rt['chunk64'] / ru['chunk64'] - 1:+.1%})")
    out = {"decode_spec": tuned.decode_spec,
           "timing_launches": dict(tuned.tuner.timing_launches),
           "decode_tick_s": m.decode_time_s / m.decode_steps, "mfu": m.as_dict()["mfu"]}
    del engines, tuned, untuned, eager, params
    torch.cuda.empty_cache()
    return out


def phase12_logits(torch, np, configs, M, kvc, quant, tdir, label, precision,
                   kv_precision):
    """Tuned against untuned logits at phase 4's configuration and bar:
    gemma3-1b's widths cut to 6 layers (5 local + 1 global), float32, one
    prefill chunk's and one decode step's logits; the plans tuned by wall
    clock for this precision (f32 GeMM shapes, or the w8a8 GeMM's) and K2's.
    Float: max_abs_diff <= 1e-4 x max|logit|, top-8 equal (f32 sums in
    another order); w8a8: relative L2 <= 2 x the noise floor of three 1e-6
    perturbations of the embedding, argmax equal."""
    from repro_torch import tuning
    from repro_torch.serving.engine import autotune_for_serving
    from repro_torch.serving.prefill import chunk_buckets

    cfg = dataclasses.replace(configs.get("gemma3-1b"), n_layers=6, group_size=6,
                              dtype="float32")
    params = M.init_model(cfg, seed=1, device="cuda")    # w8a8: quantized per run
    tuner = tuning.Autotuner(cache=tuning.TuneCache(path=str(Path(tdir) / "tunecache.json")),
                             mode="wallclock")
    with tuning.scope(None):
        autotune_for_serving(cfg, slots=8, mode="wallclock", chunks=chunk_buckets(64),
                             tuner=tuner, verbose=False,
                             dtype="int8" if precision != "float" else "float32",
                             backend="w8a8" if precision != "float" else "tiled")
        dspec = tuning.tune_decode_for_serving(cfg, slots=8, block_size=16, max_blocks=75,
                                               tuner=tuner, kv_precision=kv_precision).spec
    probe = np.random.default_rng(1).integers(0, cfg.vocab, size=600)

    def logits(p, tuned):
        with tuning.scope(tuner if tuned else None, dspec if tuned else None):
            return _prompt_logits(torch, M, kvc, quant, cfg, p, probe, "cuda",
                                  precision=precision, kv_precision=kv_precision,
                                  next_token=int(probe[-1]))

    got, want = logits(params, True), logits(params, False)
    floor = [0.0, 0.0]
    if precision != "float":
        for seed in range(3):
            noisy = logits(_perturbed(torch, params, seed), False)
            floor = [max(f, rel_l2(torch, n_, w_)) for f, n_, w_ in zip(floor, noisy, want)]
    for i, what in enumerate(("last prefill chunk", "first decode step")):
        g_, w_ = got[i], want[i]
        scale, err = float(w_.abs().max()), float((g_ - w_).abs().max())
        top_g, top_w = g_.topk(8).indices.tolist(), w_.topk(8).indices.tolist()
        if precision == "float":
            ok = err <= 1e-4 * scale and top_g == top_w
            bar = "max_abs_diff <= 1e-4 x max|logit|, top-8 equal"
        else:
            ok = rel_l2(torch, g_, w_) <= 2 * floor[i] and top_g[0] == top_w[0]
            bar = f"relative L2 <= 2 x {floor[i]:.3e} (noise floor), argmax equal"
        print(f"  {label} 6-layer f32 ({precision}, {kv_precision} KV) logits after the {what}, "
              f"tuned vs untuned plans: max_abs_diff={err:.3e} (max |logit| {scale:.3e}), "
              f"relative L2 {rel_l2(torch, g_, w_):.3e}, top-8 "
              f"{'equal' if top_g == top_w else 'DIFFER'}; phase 4's bar: {bar}")
        check(ok, f"{label} tuned vs untuned logits, {what}")
    del params
    torch.cuda.empty_cache()


def phase12_identity(torch, tuning, gemm, gemm8, gp, fd, kvc, decode_specs):
    """12c: bit identity under the tuned plans: K1's and the w8a8 GeMM's rows
    at M = 8 equal their rows at M = 40; K1's swapped and 64-row tiles, K6's
    depths and the w8a8 GeMM's one launch or two give the same bits; K2 at
    Sq = 1 equals each position of Sq = 5, float and int8 pools."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(12)
    t = tuning.get_tuner()
    dt = torch.bfloat16
    for name, K, N, transposed in GEMM_SHAPES[:1] + GEMM_SHAPES[2:5] + GEMM_SHAPES[6:]:
        shape = tuning.GemmShape(8, K, N)
        r, r8 = (t.tune(shape, "bfloat16", backend="tiled", kmajor=transposed),
                 t.tune(shape, "int8", backend="w8a8"))
        check(r.from_cache and r8.from_cache, f"12c {name}: the plans 12a / 12b tuned")
        spec, spec8 = r.spec, r8.spec
        w = (torch.randn((N, K) if transposed else (K, N), generator=g, device=dev)
             * K ** -0.5).to(dt)
        w = w.t() if transposed else w
        w_q = torch.randint(-127, 128, (N, K), generator=g, device=dev, dtype=torch.int8).t()
        sb = torch.rand((1, N), generator=g, device=dev) * 0.1 + 1e-3
        a = torch.randn((40, K), generator=g, device=dev).to(dt)
        one = gemm.gemm(a[:8], w, out_dtype=dt, spec=spec)
        check(torch.equal(gemm.gemm(a, w, out_dtype=dt, spec=spec)[:8], one),
              f"12c {name}: K1 rows at M=8 == M=40")
        other = gemm.GemmLaunchSpec(splits=spec.splits, swap=not spec.swap)
        check(torch.equal(gemm.gemm(a[:8], w, out_dtype=dt, spec=other), one),
              f"12c {name}: K1 swapped and 64-row tiles give the same bits")
        deep = [gp.gemm(a[:8], w, depth=d, out_dtype=dt, spec=spec) for d in (2, 3, 4)]
        check(all(torch.equal(x, deep[0]) for x in deep), f"12c {name}: K6 depths")
        q8 = gemm8.gemm_w8a8(a[:8], w_q, sb, out_dtype=dt, spec=spec8)
        check(torch.equal(gemm8.gemm_w8a8(a, w_q, sb, out_dtype=dt, spec=spec8)[:8], q8),
              f"12c {name}: w8a8 rows at M=8 == M=40")
        flip = gemm.GemmLaunchSpec(splits=spec8.splits, fused=not spec8.fused)
        check(torch.equal(gemm8.gemm_w8a8(a[:8], w_q, sb, out_dtype=dt, spec=flip), q8),
              f"12c {name}: w8a8 one launch == two launches")
        print(f"  12c {name} {K}x{N}: K1 at {spec} rows M=8 == M=40, both tiles, K6 depths "
              f"2/3/4 equal; w8a8 at {spec8} rows M=8 == M=40, one launch == two: bitwise")
        del w, w_q, a
    lengths = [1100, 700, 600, 513, 300, 200, 100, 40]
    for pool, dspec in decode_specs.items():
        if pool == "int8":
            cache, tables = _lived_in_pool_int8(torch, kvc, dev, g, 8, 1, 256, 16, 1200, lengths)
        else:
            cache, tables = _lived_in_pool(torch, kvc, dev, g, dt, 8, 1, 256, 16, 1200, lengths)
        q = torch.randn((8, 5, 4, 256), generator=g, device=dev).to(dt)
        idx = torch.tensor([n - 5 for n in lengths], dtype=torch.int32, device=dev)
        with tuning.scope(None, dspec):
            for window in (None, 512):
                full = fd.paged_decode_attention(q, cache, tables, idx, window=window)
                for j in range(5):
                    one = fd.paged_decode_attention(q[:, j:j + 1].contiguous(), cache, tables,
                                                    idx + j, window=window)
                    check(torch.equal(one[:, 0], full[:, j]),
                          f"12c K2 {pool} pool window={window}: Sq=1 == position {j} of Sq=5")
        print(f"  12c K2 {pool} pool at the tuned splits={dspec.num_splits}: Sq=1 equals each "
              f"position of Sq=5, global and window 512: bitwise")
        del cache, tables
    torch.cuda.empty_cache()


def phase12_depths(torch, tuning):
    """12d: the tuner's wall-clock sweep of K6's ring depth 2 / 3 / 4 at
    qwen3-14b's decode and chunk shapes (Fig. 5's axis), kernels only;
    returns the sweep's timing launches."""
    t = tuning.Autotuner(cache=tuning.TuneCache(persistent=False), mode="wallclock")
    for name, K, N in QWEN3_DEPTH_SHAPES:
        for M_ in (8, 64):
            r = t.tune(tuning.GemmShape(M_, K, N), "bfloat16", backend="pipelined", force=True)
            best = {d: min(s for p, s in r.timings if p.depth == d) for d in (2, 3, 4)}
            order = sorted(best, key=best.get)
            print(f"  12d K6 {name} {K}x{N} M={M_}: best per depth "
                  + ", ".join(f"{d}: {best[d] * 1e6:.1f} us" for d in (2, 3, 4))
                  + f" (order {' < '.join(map(str, order))}, spread "
                  f"{best[order[-1]] / best[order[0]] - 1:.1%}); winner {r.spec}, "
                  f"{r.candidates} candidates, {r.seconds:.1f}s")
    return dict(t.timing_launches)


def phase12_cli(np, tdir):
    """12e: the serve CLI at published widths with --autotune --tune-mode
    wallclock and every observability flag: the trace is Chrome-trace JSON
    with one flow chain per request, the metrics carry per-phase
    utilization and MFU on the H100's peaks, the SLO and recorder run."""
    import contextlib
    import io

    from repro_torch.launch import serve

    d = Path(tdir)
    trace, metrics, inc = d / "trace.json", d / "metrics.json", d / "incidents"
    out = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out):
        gen = serve.main(["--widths", "published", "--requests", "4", "--autotune",
                          "--tune-mode", "wallclock", "--trace-out", str(trace),
                          "--metrics-json", str(metrics), "--slo",
                          "ttft_p95=1e-6,latency_p95=10", "--incident-dir", str(inc)])
    text = out.getvalue()
    for line in text.splitlines():
        if line.startswith(("autotune", "warmup", "arch=", "slo", "incidents", "trace",
                            "metrics")):
            print(f"  {line[:200]}")
    check(gen.shape == (4, 16), "12e the CLI's tokens")
    doc = json.loads(trace.read_text())
    evs = doc["traceEvents"]
    flows = {}
    for e in evs:
        if e.get("cat") == "flow":
            flows.setdefault(e["id"], []).append(e["ph"])
    check(len(flows) == 4 and all(c[0] == "s" and c[-1] == "f" for c in flows.values()),
          "12e one flow chain s..f per request")
    m = json.loads(metrics.read_text())
    phases = m["mfu"]["phases"]
    check(m["mfu"]["peak_flops"] == hw.PEAK_FLOPS_BF16 and {"prefill", "decode"} <= set(phases)
          and all(p["utilization"] > 0 and p["mfu"] > 0 for p in phases.values()),
          "12e per-phase utilization and MFU on the H100's peaks")
    check("slo: slo=breach" in text and any(inc.iterdir()), "12e SLO breach bundle written")
    print(f"  12e {time.monotonic() - t0:.1f}s: {len(evs)} trace events, {len(flows)} flow "
          f"chains; metrics: " + "; ".join(
              f"{k} utilization {v['utilization']:.2%} MFU {v['mfu']:.3%}"
              for k, v in phases.items()))


def phase12(torch, np, configs, M, kvc, Engine, RequestSpec, mods, quant):
    """Phases 12a-12e; returns their summaries."""
    import tempfile

    from repro_torch import tuning
    from repro_torch.obs import Tracer

    t0 = time.monotonic()
    out = {}
    with tempfile.TemporaryDirectory() as tdir:
        print("[12a] gemma3-1b at published widths, float: wall-clock-tuned, traced engine "
              "beside an untuned one")
        out["float"] = phase12_serve(torch, np, configs, M, kvc, Engine, RequestSpec, mods,
                                     quant, tdir)
        print("[12b] the same in w8a8 with an int8 KV pool")
        out["w8a8"] = phase12_serve(torch, np, configs, M, kvc, Engine, RequestSpec, mods,
                                    quant, tdir, precision="w8a8", kv_precision="int8")
        print("[12c] bit identity under the tuned plans (kernels)")
        cache = tuning.TuneCache(path=str(Path(tdir) / "tunecache.json"))
        specs = {"float": out["float"]["decode_spec"], "int8": out["w8a8"]["decode_spec"]}
        with tuning.scope(tuning.Autotuner(cache=cache, mode="wallclock")):
            phase12_identity(torch, tuning, mods["gemm"], mods["gemm8"], mods["gp"],
                             mods["fd"], kvc, specs)
        print("[12d] K6's ring depth by wall clock at qwen3-14b's shapes (Fig. 5)")
        out["depth_launches"] = phase12_depths(torch, tuning)
        print("[12e] observability: the serve CLI with every flag, and the tracer's cost")
        phase12_cli(np, tdir)
    tr = Tracer(capacity=1 << 14)
    code = tr.intern("bench")
    best = float("inf")
    for _ in range(3):
        s = time.perf_counter_ns()
        for _ in range(5000):
            tr.begin(code)
            tr.end(code)
        best = min(best, (time.perf_counter_ns() - s) / 10000)
    tick = out["float"]["decode_tick_s"]
    share = 14 * best * 1e-9 / tick
    print(f"  12e tracing overhead: {best:.0f} ns an event x 14 events a decode tick = "
          f"{share:.3%} of the card's {tick * 1e3:.3f} ms decode tick (bar 2 %)")
    check(share < 0.02, "12e tracing overhead under 2 % of a decode tick")
    print("  12e per-phase utilization / MFU of the tuned engine (H100 peaks: 989 TFLOP/s, "
          "3.35 TB/s): " + "; ".join(
              f"{prec} {p} util {v['utilization']:.2%} mfu {v['mfu']:.3%}"
              for prec in ("float", "w8a8") for p, v in out[prec]["mfu"]["phases"].items()))
    os.environ.pop("REPRO_TUNE_CACHE", None)
    print(f"[12] phase 12 took {time.monotonic() - t0:.1f}s")
    return out


# ---------------------------------------------------------------------------
# Phase 13: the cluster layer (replica pool, router, traffic, cluster metrics)
# ---------------------------------------------------------------------------

# gemma3-1b at published widths, 8 slots a replica; 832 positions hold
# 13a's longest request (768 + 48) and 13c's (512 + 64 + 32).
CLUSTER_KW = dict(slots=8, max_seq=832, block_size=16, max_chunk=64, device="cuda")


def _cluster_specs(np, RequestSpec, trace):
    return [RequestSpec(prompt=np.asarray(it.prompt, np.int32), max_new=it.max_new)
            for it in trace.items]


def _bare_tokens(Engine, cfg, params, specs, **kw):
    """A bare graphed engine's tokens for `specs`, and the engine."""
    eng = Engine(cfg, params, **dict(CLUSTER_KW, **kw))
    eng.warmup()
    reqs = [eng.submit(s) for s in specs]
    out = eng.run()
    check(eng.metrics.cold_compiles == 0, "the bare engine compiled no cold shape")
    eng.alloc.check()
    return [out[r.rid] for r in reqs], eng


def _pool_replays(pool):
    return [dict(e._replays) for e in pool.engines]


def _served_launches(pool, before):
    """Launches of the pool's replays since `before` (`_pool_replays`): each
    shape's new replays x the launches its graph captured, summed."""
    total = collections.Counter()
    for e, seen in zip(pool.engines, before):
        for key, n in e._replays.items():
            for name, per in e._graph_launches[key].items():
                total[name] += (n - seen.get(key, 0)) * per
    return total


def _cluster_run(torch, cluster, mods, pool, specs, policy, launches, profile=False):
    """Serve `specs` through the started pool behind the async router; the
    wrappers' counters must stay at 0 (every step a replay).  Returns the
    tokens per request and the run's figures (13f); with `profile`, also
    the card's busy share over the run (the union of its kernels' spans
    over the first kernel to the last, torch.profiler) and its mean
    concurrency (kernel time over that union)."""
    from repro_torch.obs import percentile

    reset_counts(mods)
    before = _pool_replays(pool)
    dec = [(e.metrics.decode_steps, e.metrics.decode_time_s, e.metrics.decode_tokens)
           for e in pool.engines]
    prof_ctx = contextlib.nullcontext()
    if profile:
        from torch.profiler import ProfilerActivity
        prof_ctx = torch.profiler.profile(activities=[ProfilerActivity.CUDA])
    pool.start()
    with prof_ctx as prof, cluster.Router(pool, policy=policy) as router:
        t0 = time.monotonic()
        handles = [router.submit(s) for s in specs]
        check(all(h is not None for h in handles), "no request shed")
        router.drain(timeout=600)
        wall = time.monotonic() - t0
    check(not any(read_counts(mods).values()),
          f"the served run launched nothing eagerly: {read_counts(mods)}")
    run = _served_launches(pool, before)
    launches.update(run)
    tokens = [h.result(timeout=0) for h in handles]
    ttfts = [h.ttft_s for h in handles]
    steps = [e.metrics.decode_steps - d[0] for e, d in zip(pool.engines, dec)]
    fig = {
        "wall_s": wall, "tok_s": sum(map(len, tokens)) / wall,
        "decode_tok_s": sum(e.metrics.decode_tokens - d[2]
                            for e, d in zip(pool.engines, dec)) / wall,
        "decode_step_ms": [(e.metrics.decode_time_s - d[1]) / max(1, n) * 1e3
                           for e, d, n in zip(pool.engines, dec, steps)],
        "ttft_p50_s": percentile(ttfts, 50), "ttft_p95_s": percentile(ttfts, 95),
        "per_replica": [[h.replica for h in handles].count(i) for i in range(len(pool))],
        "replays": [sum(e._replays.values()) - sum(b.values())
                    for e, b in zip(pool.engines, before)],
        "launches": dict(run)}
    if profile:
        fig.update(_busy_share(prof))
    return tokens, fig


def _busy_share(prof):
    """The card's busy time over a profiled run (the union of its kernels'
    and copies' spans), the window from the first to the last, and the
    device work at once (their summed time over the union); read from the
    profiler's raw events, which parse in seconds where `events()` takes
    minutes at ~700k kernels."""
    from torch.autograd import DeviceType

    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA)
    check(bool(spans), "the profiler saw the card's kernels")
    busy, cur_s, cur_e = 0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy += cur_e - cur_s
    window = max(b for _, b in spans) - spans[0][0]
    return {"busy_ms": busy / 1e6, "window_ms": window / 1e6, "kernels": len(spans),
            "concurrency": sum(b - a for a, b in spans) / busy}


def _splitk_of(torch, e):
    """The engine's split-K (workspace, counters) on its card, () if its
    steps never split K (the kernels key it by their tensors' device)."""
    return e.splitk._by_device.get(torch.empty(0, device=e.device).device, ())


def _check_pool(torch, pool, label):
    for e in pool.engines:
        e.alloc.check()
        check(e.metrics.cold_compiles == 0, f"{label}: no cold shape")
        scratch = _splitk_of(torch, e)
        if scratch:
            check(int(scratch[1].abs().sum()) == 0,
                  f"{label}: every split-K tile counter back at 0")


def _check_tokens(np, got, want, label):
    for i, (g, w) in enumerate(zip(got, want)):
        check(np.array_equal(g, w), f"{label}: request {i}'s tokens equal the bare engine's")


def phase13(torch, np, configs, M, Engine, RequestSpec, mods):
    """Phases 13a-13f; returns the launches on the cluster path and 13f's
    figures."""
    from repro_torch import cluster

    t_phase = time.monotonic()
    cfg = gemma_serve_cfg(configs)
    params = M.init_model(cfg, seed=0, device="cuda")
    # Prompts up to 512 tokens and 16-32 new (768 and 16-48 before phase 14
    # joined the script: the time limit).
    trace = cluster.mixed_traffic(cfg.vocab, n=16, seed=0, max_prompt=512, max_new=(16, 32))
    print('  reduced {"max_prompt": [768, 512], "max_new": [[16, 48], [16, 32]]}')
    specs = _cluster_specs(np, RequestSpec, trace)
    launches = collections.Counter()
    out = {}

    print(f"[13a] cluster of one against a bare engine {stamp()}")
    want, bare = _bare_tokens(Engine, cfg, params, specs)
    print(f"  bare engine: {len(specs)} requests ({trace.prompt_tokens} prompt tokens, "
          f"{trace.gen_tokens} new); {bare.metrics.decode_steps} decode steps, "
          f"{bare.metrics.prefill_chunks} prefill chunks")
    pool = cluster.ReplicaPool(cfg, 1, params=params, **CLUSTER_KW)
    pool.engines[0].share_steps_from(bare)
    pool.warmup()
    del bare
    reset_counts(mods)
    before = _pool_replays(pool)
    router = cluster.Router(pool, policy="round-robin", async_dispatch=False)
    handles = [router.submit(s) for s in specs]
    router.dispatch_sync()
    pool.run_sync(max_ticks=100_000)
    check(not any(read_counts(mods).values()), "13a run_sync launched nothing eagerly")
    launches.update(_served_launches(pool, before))
    _check_tokens(np, [h.result(timeout=0) for h in handles], want, "13a run_sync")
    check(router.shed == 0 and all(h.trace_id == h.crid for h in handles),
          "13a nothing shed, router-minted trace ids")
    _check_pool(torch, pool, "13a")
    print(f"  one replica, run_sync behind the synchronous router: the {len(specs)} "
          f"requests' tokens ({sum(map(len, want))}) equal the bare engine's; "
          f"cold_compiles=0, nothing launched eagerly")
    one = pool
    del router, handles

    print(f"[13b] two replicas, threaded, on one card, least-loaded {stamp()}")
    two = cluster.ReplicaPool(cfg, 2, params=params, **CLUSTER_KW)
    two.warmup(verbose=True)
    e0, e1 = two.engines
    check(e0.stream is not None and e0.stream != e1.stream,
          "13b each replica on its own stream")
    ptrs = [tuple(t.data_ptr() for t in _splitk_of(torch, e)) for e in two.engines]
    check(all(ptrs), "13b each replica allocated its own split-K scratch in its warmup")
    check(all(ptrs) and ptrs[0][0] != ptrs[1][0] and ptrs[0][1] != ptrs[1][1],
          "13b the replicas' graphs hold different split-K workspaces and counters")
    # Threaded runs behind the async router, one replica and two in turns
    # (one, two), then one profiled run of each (13f); the second unprofiled
    # pair (two, one) was cut to make room for phase 18.
    runs = {"one": [], "two": []}
    for label in ("one", "two", "one+profile", "two+profile"):
        name = label.split("+")[0]
        got, fig = _cluster_run(torch, cluster, mods, one if name == "one" else two, specs,
                                "least-loaded", launches, profile="profile" in label)
        _check_tokens(np, got, want, f"13{'a' if name == 'one' else 'b'} threaded {label}")
        check(all(n > 0 for n in fig["per_replica"]), f"13b {label}: every replica served")
        if name == "two" and runs["two"]:
            check(all(np.array_equal(a, b) for a, b in zip(got, runs["two"][0][0])),
                  f"13b {label}: the threaded runs agree")
        runs[name].append((got, fig))
    for pool in (one, two):
        _check_pool(torch, pool, "13b")
    out["runs"] = {k: [f for _, f in v] for k, v in runs.items()}
    print(f"  streams {e0.stream} / {e1.stream}; split-K (workspace, counters) "
          f"{[tuple(hex(p) for p in x) for x in ptrs]}; requests per replica "
          + ", ".join(str(f["per_replica"]) for _, f in runs["two"])
          + f"; {len(runs['two'])} threaded runs' tokens equal the bare engine's and each "
          f"other's (and {len(runs['one'])} threaded runs of one replica)")
    del one, two, pool, e0, e1

    print(f"[13c] two replicas with the prefix cache, prefix-affinity {stamp()}")
    shared = cluster.shared_system_prompt(cfg.vocab, n=16, prefix_len=512, suffix=(16, 64),
                                          max_new=(16, 32))
    sspecs = _cluster_specs(np, RequestSpec, shared)
    swant, bare = _bare_tokens(Engine, cfg, params, sspecs)
    del bare
    pool = cluster.ReplicaPool(cfg, 2, params=params, prefix_cache=True, **CLUSTER_KW)
    pool.warmup()
    got, fig = _cluster_run(torch, cluster, mods, pool, sspecs, "prefix-affinity", launches)
    _check_tokens(np, got, swant, "13c (bare engine without the cache)")
    _check_pool(torch, pool, "13c")
    hits = sum(e.metrics.prefix_hits for e in pool.engines)
    lookups = sum(e.metrics.prefix_lookups for e in pool.engines)
    saved = sum(e.metrics.prefix_hit_tokens for e in pool.engines)
    check(hits > 0, "13c the prefix cache hit")
    print(f"  {hits}/{lookups} admissions hit, {saved} prefill tokens saved; requests per "
          f"replica {fig['per_replica']}; tokens equal a bare engine's without the cache")
    del pool

    print(f"[13d] two replicas in w8a8 with an int8 KV pool on 13a's trace {stamp()}")
    q8 = dict(precision="w8a8", kv_precision="int8")
    want8, bare = _bare_tokens(Engine, cfg, params, specs, **q8)
    del bare
    pool = cluster.ReplicaPool(cfg, 2, params=params, **dict(CLUSTER_KW, **q8))
    pool.warmup()
    got, fig = _cluster_run(torch, cluster, mods, pool, specs, "least-loaded", launches)
    _check_tokens(np, got, want8, "13d w8a8 + int8 KV")
    _check_pool(torch, pool, "13d")
    check(all(n > 0 for n in fig["per_replica"]), "13d both replicas served")
    print(f"  the {len(specs)} requests' tokens equal a bare w8a8 + int8 KV engine's; "
          f"requests per replica {fig['per_replica']}; launches "
          + " ".join(f"{k}={v}" for k, v in sorted(fig["launches"].items())))
    del pool, params
    torch.cuda.empty_cache()

    print(f"[13e] the serve CLI with two replicas {stamp()}")
    phase13_cli()

    print("[13f] 13a's trace on one replica against two, threaded, in turns (one, two; "
          "then one profiled run each) (printed, not checked); reduced "
          '{"unprofiled runs of each": [2, 1]}')
    for name, figs in out["runs"].items():
        for k, f in enumerate(figs):
            prof = (f" | profiled (the profiler slows the run): the card busy "
                    f"{f['busy_ms']:.1f} ms of a {f['window_ms']:.1f} ms window "
                    f"({f['busy_ms'] / f['window_ms']:.1%}), {f['concurrency']:.2f} kernels "
                    f"at once on average while busy, {f['kernels']} device events"
                    if "busy_ms" in f else "")
            print(f"  {name} replica{'s' if name == 'two' else ''} #{k + 1}: wall "
                  f"{f['wall_s']:.3f} s, {f['tok_s']:.1f} generated tok/s, decode "
                  f"{f['decode_tok_s']:.1f} tok/s, decode step ms per replica "
                  f"{[round(x, 3) for x in f['decode_step_ms']]}, TTFT p50 "
                  f"{f['ttft_p50_s'] * 1e3:.1f} ms p95 {f['ttft_p95_s'] * 1e3:.1f} ms, requests "
                  f"{f['per_replica']}, replays {f['replays']}, launches (replays x "
                  f"per-graph) " + " ".join(f"{a}={b}" for a, b in sorted(f["launches"].items()))
                  + prof)
    timed = {k: [f for f in v if "busy_ms" not in f] for k, v in out["runs"].items()}
    w1, w2 = (sum(f["wall_s"] for f in timed[k]) / len(timed[k]) for k in ("one", "two"))
    print(f"  two against one (means of the unprofiled runs): wall x{w2 / w1:.3f}, generated "
          f"tok/s x{w1 / w2:.3f}")
    for name in ("gemm", "flash_decode", "gemm_w8a8", "flash_decode_int8", "dequant_gemm",
                 "quantize_rows"):
        check(launches[name] > 0, f"phase 13 launched {name} on the cluster path")
    print(f"[13] phase 13 took {time.monotonic() - t_phase:.1f}s; launches on the cluster "
          f"path (replays x per-graph launches): "
          + " ".join(f"{k}={v}" for k, v in sorted(launches.items())))
    return {"launches": launches, **out}


def phase13_cli():
    """13e: the serve CLI with two replicas, a tight in-flight window and
    every observability flag."""
    import contextlib
    import io
    import tempfile

    from repro_torch.launch import serve

    with tempfile.TemporaryDirectory() as tdir:
        d = Path(tdir)
        trace, metrics, inc = d / "trace.json", d / "metrics.json", d / "incidents"
        out = io.StringIO()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(out):
            m = serve.main(["--widths", "published", "--replicas", "2", "--router-policy",
                            "prefix-affinity", "--max-pending", "4", "--tenants", "2",
                            "--requests", "16", "--trace-out", str(trace), "--metrics-json",
                            str(metrics), "--slo", "shed_rate=0.01", "--incident-dir",
                            str(inc)])
        text = out.getvalue()
        for line in text.splitlines():
            if line.startswith(("warmup", "cluster", "  replica", "slo", "incidents",
                                "trace", "metrics")):
                print(f"  {line[:240]}")
        accepted = m.offered - m.shed
        check(m.offered == 16 and m.shed > 0 and m.requests == accepted,
              f"13e some requests shed: {m.shed} of {m.offered}")
        check(any(p.name.endswith("-shed.json") for p in inc.iterdir()),
              "13e a shed incident bundle written")
        evs = json.loads(trace.read_text())["traceEvents"]
        check({e["pid"] for e in evs} == {0, 1, 2}, "13e two replica lanes and the router's")
        flows = {}
        for e in evs:
            if e.get("cat") == "flow":
                flows.setdefault(e["id"], []).append(e)
        check(set(flows) == set(range(accepted)),
              "13e one flow chain per accepted request, under its router id (crid)")
        ends = set()
        for chain in flows.values():
            chain.sort(key=lambda e: e["ts"])
            check(chain[0]["ph"] == "s" and chain[0]["pid"] == 2
                  and chain[-1]["ph"] == "f" and chain[-1]["pid"] in (0, 1),
                  "13e each flow chain crosses from the router's lane into a replica's")
            ends.add(chain[-1]["pid"])
        doc = json.loads(metrics.read_text())
        check(doc["cluster"]["replicas"] == 2 and len(doc["replicas"]) == 2,
              "13e the metrics hold `cluster` and two `replicas`")
        check(all(r["cold_compiles"] == 0 for r in doc["replicas"]), "13e no cold shape")
        print(f"  13e {time.monotonic() - t0:.1f}s: {m.shed} of {m.offered} shed, "
              f"{len(flows)} flow chains router -> replicas {sorted(ends)}, "
              f"{len(list(inc.iterdir()))} incident bundles, {len(evs)} trace events")


# ---------------------------------------------------------------------------
# Phase 14: the training path (loss, backward through K1 and K5b, AdamW,
# checkpoints, the supervisor, the train CLI)
# ---------------------------------------------------------------------------

# K5b against its plain version: gemma3-1b's training shapes (B 4, S 1024,
# 4 q heads over 1, D 256, global and window 512), then each head dim at S
# 32 / 100 / 1000 (ragged, window 200 at 1000), GQA 4 / 2 and non-causal;
# then the bf16 body's edges: GQA 8 / 1 and 10 / 2 (one cluster of 8 and of
# 5 blocks), 16 / 1 and 12 / 1 (clusters of 8 and 6 blocks of 2 heads, past
# the cluster limit; the second non-causal under a window), a window of 16
# (shorter than a tile), D 64 and 128 at S 1024.
BWD_SHAPES = [  # (B, S, Hq, Hkv, D, causal, window[, Skv])
    (4, 1024, 4, 1, 256, True, None), (4, 1024, 4, 1, 256, True, 512),
] + [(2, S, 4, 2 if D == 128 else 1, D, True, None if S < 1000 else 200)
     for D in (64, 128, 256) for S in (32, 100, 1000)] + [(1, 100, 4, 4, 64, False, None)] + [
    (1, 300, 8, 1, 128, True, None), (2, 200, 10, 2, 128, True, None),
    (1, 130, 16, 1, 64, True, None), (1, 150, 12, 1, 64, False, 40),
    (2, 1000, 4, 1, 256, True, 16), (2, 1024, 4, 1, 64, True, None),
    (2, 1024, 4, 1, 128, True, 512)] + [
    # the families' training shapes (phase 16), with Skv apart from S where
    # it differs (the 8th field): whisper's encoder (1500 frames, not a
    # multiple of the 64-key tile) and its cross-attention (448 tokens over
    # them), non-causal; dbrx's and arctic's 48 / 8 and 56 / 8 heads
    # (clusters of 6 and 7 blocks); bert-base / vit-b-16's 12 / 12 at D 64.
    (1, 1500, 16, 16, 64, False, None), (1, 448, 16, 16, 64, False, None, 1500),
    (1, 1024, 48, 8, 128, True, None), (1, 1024, 56, 8, 128, True, None),
    (1, 1024, 12, 12, 64, True, None)]
# K5b vs plain, of each gradient's largest element: f32 sums reordered; in
# bf16 P and dS round to bf16 in both before their products, the sums in
# other orders, so one bf16 ulp at the largest element.
BWD_TOL = {"float32": 1e-5, "bfloat16": 2 ** -7}
# The train run: gemma3-1b whole, B 4 x S 1024 (the 22 local layers' window
# of 512 cuts), the restart run's checkpoint every 2 steps, the failure at
# step 3 (6, 3 and 4 before phase 18: the time limit).
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_CKPT, TRAIN_FAIL, TRAIN_LR = 4, 1024, 4, 2, 3, 3e-4
LOSS_CHUNK = 512          # model.loss_fn's default: 2 chunks of the tied head a step


def train_plan(cfg, S: int = TRAIN_S):
    """Launches per train step: each GeMM of the forward (26 x 7
    projections + the tied head per loss chunk) runs three times under
    remat (forward, recompute, and the forward's two backward launches
    count as two more: 4 in all); K5 twice a layer (forward, recompute),
    K5b once."""
    fwd = cfg.n_layers * 7 + S // LOSS_CHUNK
    return {"gemm": 4 * fwd, "flash_attention": 2 * cfg.n_layers,
            "flash_attention_bwd": cfg.n_layers}


def phase_kernels_train(torch, fa, gemm, ops):
    """K5b, the forward's lse and K1's backward products against their plain
    versions on the card."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(14)
    worst = {"flash_attention_bwd": 0.0, "gemm_bwd": 0.0}
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        for shape in BWD_SHAPES:
            B, S, Hq, Hkv, D, causal, window = shape[:7]
            Skv = shape[7] if len(shape) > 7 else S
            q, k, v, do = (torch.randn((B, s, h, D), generator=g, device=dev).to(dt)
                           for s, h in ((S, Hq), (Skv, Hkv), (Skv, Hkv), (S, Hq)))
            out, lse = fa._forward(q, k, v, causal, window, True)
            same = torch.equal(out, fa._forward(q, k, v, causal, window, False)[0])
            _, plse = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                               return_lse=True)
            lse_err = float((lse - plse).abs().max())
            got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal, window=window)
            again = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal, window=window)
            det = all(torch.equal(a, b) for a, b in zip(got, again))
            want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal,
                                                window=window)
            errs = []
            for name, a, w in zip(("dq", "dk", "dv"), got, want):
                scale = float(w.float().abs().max())
                err = float((a.float() - w.float()).abs().max())
                errs.append(f"{name} {err:.2e}/{scale:.2e}")
                worst["flash_attention_bwd"] = max(worst["flash_attention_bwd"], err)
                check(a.dtype == dt and bool(a.isfinite().all())
                      and err <= BWD_TOL[dname] * scale,
                      f"flash_attention_bwd {dname} {shape} {name}")
            check(same and det and lse_err <= 1e-5,
                  f"flash_attention lse / determinism {shape}")
            print(f"  flash_attention_bwd {dname} B={B} S={S}"
                  + (f" Skv={Skv}" if Skv != S else "") + f" Hq={Hq} Hkv={Hkv} D={D} "
                  f"causal={causal} window={window}: max_abs/max " + ", ".join(errs)
                  + f" (bar {BWD_TOL[dname]:g} x max); two runs bitwise equal; lse max_abs "
                  f"{lse_err:.1e} (bar 1e-5), out with lse bitwise equal to out without: ok")
            del q, k, v, do, out, lse, got, again, want
    # K1's backward products at the training shapes: dX = dY W^T, dW = X^T dY
    # through ops.linear's Function (M = 4096 a projection, 2048 the tied
    # head's loss chunk), bf16.
    rtol, atol = GEMM_TOL["bfloat16"]
    for name, K, N, transposed in GEMM_SHAPES:
        M = TRAIN_B * (LOSS_CHUNK if name == "head" else TRAIN_S)
        x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16).requires_grad_()
        w0 = (torch.randn((N, K) if transposed else (K, N), generator=g, device=dev)
              * K ** -0.5).to(torch.bfloat16).requires_grad_()
        w = w0.t() if transposed else w0
        dy = torch.randn((M, N), generator=g, device=dev).to(torch.bfloat16)
        before = gemm.launches
        dx, dw0 = torch.autograd.grad(ops.linear(x, w), (x, w0), dy)
        check(gemm.launches - before == 3, f"gemm {name}: forward, dX, dW: three launches")
        dw = dw0.t() if transposed else dw0
        ex, _, okx = close(dx, gemm.gemm_plain(dy, w.detach().t(), torch.bfloat16), rtol, atol)
        ew, _, okw = close(dw, gemm.gemm_plain(x.detach().t(), dy, torch.bfloat16), rtol, atol)
        worst["gemm_bwd"] = max(worst["gemm_bwd"], ex, ew)
        print(f"  gemm backward bf16 {name} M={M} {K}x{N}: dX max_abs={ex:.3e}, dW "
              f"max_abs={ew:.3e} tol=(rtol {rtol:g}, atol {atol:g}) "
              f"{'ok' if okx and okw else 'FAIL'}")
        check(okx and okw, f"gemm backward {name}")
        del x, w0, w, dy, dx, dw0, dw
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return worst


# K5b's three kernels by their names in a profile, and SDPA's backends by
# fragments of theirs.
K5B_KERNELS = ("delta_kernel", "dkdv_wgmma", "dq_wgmma")
SDPA_BACKENDS = (("cudnn", "cudnn"), ("flash", "flash"), ("fmha", "efficient"),
                 ("efficient", "efficient"))


def _profile_kernels(torch, call, reps: int = 5):
    """{kernel name: device ms per call} of `call`, from torch.profiler (as
    `_profile_replays` reads it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    got = {ev.key: ev.self_device_time_total / 1e3 / reps for ev in prof.key_averages()
           if ev.device_type == DeviceType.CUDA}
    check(sum(got.values()) > 0, "the profiler saw the kernels")
    return got


def _sdpa_backend(names) -> str:
    """The SDPA backend whose kernels a profile shows ("math" if none)."""
    for frag, backend in SDPA_BACKENDS:
        if any(frag in n.lower() for n in names):
            return backend
    return "math"


def _encode_us(q, k, v, do) -> float:
    """Host us to encode K5b's four TMA tensor maps (done on every call)."""
    import ctypes
    from repro_torch.kernels import _build

    fn = _build.load("flash_attention_bwd").flash_attention_bwd_encode
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
    fn.restype = ctypes.c_int
    B, S, Hq, D = q.shape
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), B, S, S, Hq, k.shape[2], D)
    check(fn(*args) == 0, "flash_attention_bwd: tensor maps encode")
    t0 = time.perf_counter()
    for _ in range(1000):
        fn(*args)
    return (time.perf_counter() - t0) * 1e3


PROFILE_FLAG = "--profile-train-attention"


def _attention_inputs(torch, fa, g, window, *, B=TRAIN_B, S=TRAIN_S, Hq=4, Hkv=1, D=256,
                      Skv=None, q_offset=0):
    """Phase 5's inputs at gemma3-1b's training shape (B 4, S 1024, 4 / 1,
    D 256, causal, `window`; phase 18 passes a rank's shape, S queries at
    `q_offset` over Skv keys for a sequence-parallel one): q, k, v, dO,
    K5's out and lse, and SDPA's (K/V repeated to the q heads beforehand,
    q-head-major, requiring grad), its mask and output.  SDPA's
    `is_causal` places queries and keys from 0, so a window or an offset
    takes a boolean mask of the same positions."""
    import torch.nn.functional as F

    dev, dt = torch.device("cuda"), torch.bfloat16
    Skv = S if Skv is None else Skv
    q, k, v, do = (torch.randn((B, n, h, D), generator=g, device=dev).to(dt)
                   for n, h in ((S, Hq), (Skv, Hkv), (Skv, Hkv), (S, Hq)))
    out, lse = fa._forward(q, k, v, True, window, True, q_offset)
    ql, kl, vl = (t.permute(0, 2, 1, 3).repeat_interleave(Hq // t.shape[2], 1)
                  .detach().requires_grad_() for t in (q, k, v))
    qpos, kpos = torch.arange(S, device=dev) + q_offset, torch.arange(Skv, device=dev)
    mask = None
    if window is not None or q_offset or Skv != S:
        mask = qpos[:, None] >= kpos[None, :]
        if window is not None:
            mask &= qpos[:, None] - kpos[None, :] < window
    o_l = F.scaled_dot_product_attention(ql, kl, vl, is_causal=mask is None, attn_mask=mask)
    return dict(q=q, k=k, v=v, do=do, out=out, lse=lse, ql=ql, kl=kl, vl=vl, mask=mask,
                o_l=o_l, do_l=do.permute(0, 2, 1, 3))


def _sdpa_calls(torch, x, window):
    """SDPA's backward (autograd over its retained graph) and forward (no
    grad) on phase 5's inputs."""
    import torch.nn.functional as F

    def fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(x["ql"], x["kl"], x["vl"],
                                                  is_causal=x["mask"] is None,
                                                  attn_mask=x["mask"])
    return (lambda: torch.autograd.grad(x["o_l"], (x["ql"], x["kl"], x["vl"]), x["do_l"],
                                        retain_graph=True)), fwd


def profile_train_attention(torch, fa):
    """{"global" / "512": {"k5b" / "sdpa_bwd" / "sdpa_fwd": {kernel: device
    ms per call}}}: torch.profiler over K5b and SDPA's backward and forward
    at the training shapes.  Run in a process of its own (`PROFILE_FLAG`):
    in the whole script's process, after the earlier phases, the profiler
    recorded no device events here in two runs (a fresh process's did in
    every run)."""
    g = torch.Generator(device=torch.device("cuda")).manual_seed(15)
    got = {}
    for window in (None, 512):
        x = _attention_inputs(torch, fa, g, window)
        bwd, fwd = _sdpa_calls(torch, x, window)
        got["global" if window is None else str(window)] = {
            "k5b": _profile_kernels(torch, lambda: fa.flash_attention_bwd(
                x["q"], x["k"], x["v"], x["out"], x["lse"], x["do"], window=window)),
            "sdpa_bwd": _profile_kernels(torch, bwd), "sdpa_fwd": _profile_kernels(torch, fwd)}
        del x, bwd, fwd
    return got


def phase_times_train(torch, fa, gemm):
    """One train step's K5b (4 global + 22 window-512 layers at (4, 1024, 4 /
    1, 256)) beside SDPA's backward (K/V repeated to the q heads
    beforehand, forward untimed; its kernels' device time, its backend named
    from them) and its operations bound, split by K5b's three kernels (the
    profiles in a process of their own); K5's forward with the lse at the
    same shapes beside SDPA's forward; K1's forward, dX and dW products at
    the training shapes beside torch.matmul, per step (x 26 layers, the
    head x 2 chunks)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(15)
    dt, B, S, Hq, Hkv, D = torch.bfloat16, TRAIN_B, TRAIN_S, 4, 1, 256
    child = subprocess.run([sys.executable, str(Path(__file__).resolve()), PROFILE_FLAG],
                           capture_output=True, text=True, timeout=600)
    check(child.returncode == 0, f"the profiles' process: {child.stdout[-500:]} "
                                 f"{child.stderr[-500:]}")
    profiles = json.loads(child.stdout.strip().splitlines()[-1])
    rows = {}
    for window in (None, 512):
        x = _attention_inputs(torch, fa, g, window)
        q, k, v, do, out, lse = (x[n] for n in ("q", "k", "v", "do", "out", "lse"))
        prof = profiles["global" if window is None else str(window)]
        if window is None:
            print(f"  K5b's four TMA tensor maps encoded on the host in "
                  f"{_encode_us(q, k, v, do):.2f} us a call")
        t_k = _time_ms(torch, [lambda: fa.flash_attention_bwd(q, k, v, out, lse, do,
                                                              window=window)], 20)
        parts = {name: sum(ms for key, ms in prof["k5b"].items() if name in key)
                 for name in K5B_KERNELS}
        t_p = _time_ms(torch, [lambda: fa.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                                                    window=window)], 3,
                       graph=False)
        # SDPA's backward as the yardstick: its kernels' device time from the
        # profile (K5b's time is a graph replay's, so device time too); an
        # eager autograd call's wall time, mostly the host's, is printed apart.
        sdpa_bwd, sdpa_fwd = _sdpa_calls(torch, x, window)
        t_le = _time_ms(torch, [sdpa_bwd], 10, graph=False)
        t_l = sum(prof["sdpa_bwd"].values())
        backend = _sdpa_backend(prof["sdpa_bwd"])
        print(f"  sdpa backward's kernels (window={window}): " + "; ".join(
            f"{name[:60]} {ms * 1e3:.1f} us" for name, ms in sorted(
                prof["sdpa_bwd"].items(), key=lambda kv: -kv[1])[:4])
              + f"; an eager call {t_le * 1e3:.1f} us")
        pairs = kcost.attention_pairs(S, S, True, window)
        bound, by = _bound(kcost.flash_attention_bwd(B, S, S, Hq, Hkv, D, pairs=pairs))
        rows[window] = (t_k, t_p, t_l, bound, by)
        rows[("split", window)] = parts
        rows[("sdpa_backend", window)] = backend
        print(f"  flash_attention_bwd bf16 B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} causal "
              f"window={window}: kernel {t_k * 1e3:.1f} us ("
              + ", ".join(f"{n} {ms * 1e3:.1f} us" for n, ms in parts.items())
              + f" in a profile), plain {t_p * 1e3:.1f} us, sdpa backward {t_l * 1e3:.1f} us "
              f"on the device ({backend} backend), bound {bound * 1e3:.2f} us ({by}), "
              f"{bound / t_k:.1%} of bound")
        # K5's forward with the lse, as the train step runs it (forward and
        # remat's recompute), beside SDPA's forward on the same inputs.
        t_f = _time_ms(torch, [lambda: fa._forward(q, k, v, True, window, True)], 20)
        t_fl = _time_ms(torch, [sdpa_fwd], 20)
        t_fp = _time_ms(torch, [lambda: fa.flash_attention_plain(
            q, k, v, window=window, return_lse=True)], 3, graph=False)
        fbound, fby = _bound(kcost.flash_attention(B, S, S, Hq, Hkv, D, pairs=pairs, lse=True))
        rows[("fwd", window)] = (t_f, t_fp, t_fl, fbound, fby)
        print(f"  flash_attention (with lse) bf16 B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} causal "
              f"window={window}: kernel {t_f * 1e3:.1f} us, plain {t_fp * 1e3:.1f} us, sdpa "
              f"{t_fl * 1e3:.1f} us ({_sdpa_backend(prof['sdpa_fwd'])} backend), bound "
              f"{fbound * 1e3:.2f} us ({fby}), {fbound / t_f:.1%} of bound")
        del x, q, k, v, do, out, lse, sdpa_bwd, sdpa_fwd
    step = [4 * rows[None][i] + 22 * rows[512][i] for i in range(4)]
    rows["step"] = (*step, "operations")
    split = {n: 4 * rows[("split", None)][n] + 22 * rows[("split", 512)][n] for n in K5B_KERNELS}
    print(f"[5] K5b per train step (4 global + 22 window-512 layers): kernel {step[0]:.3f} ms ("
          + ", ".join(f"{n} {ms:.3f} ms" for n, ms in split.items())
          + f" in a profile), plain {step[1]:.3f} ms, sdpa backward {step[2]:.3f} ms on the device "
          f"({rows[('sdpa_backend', None)]} backend global, {rows[('sdpa_backend', 512)]} "
          f"window), bound {step[3]:.3f} ms, {step[3] / step[0]:.1%} of bound")
    check(step[0] < step[2], "K5b per train step below SDPA's backward")
    fwd = [2 * (4 * rows[("fwd", None)][i] + 22 * rows[("fwd", 512)][i]) for i in range(4)]
    rows["fwd_step"] = (*fwd, "operations")
    print(f"[5] K5 with lse per train step (forward and recompute, 2 x (4 global + 22 "
          f"window-512)): kernel {fwd[0]:.3f} ms, plain {fwd[1]:.3f} ms, sdpa {fwd[2]:.3f} ms, "
          f"bound {fwd[3]:.3f} ms, {fwd[3] / fwd[0]:.1%} of bound")
    per = {"fwd": [0.0] * 4, "dX": [0.0] * 4, "dW": [0.0] * 4}
    for name, K, N, transposed in GEMM_SHAPES:
        M = B * (LOSS_CHUNK if name == "head" else S)
        times = 2 if name == "head" else 26
        x = torch.randn((M, K), generator=g, device=dev).to(dt)
        w = torch.randn((N, K) if transposed else (K, N), generator=g, device=dev).to(dt)
        w = w.t() if transposed else w
        dy = torch.randn((M, N), generator=g, device=dev).to(dt)
        xt, wt = x.t(), w.t()
        for label, a, b in (("fwd", x, w), ("dX", dy, wt), ("dW", xt, dy)):
            Mi, Ki, Ni = a.shape[0], a.shape[1], b.shape[1]
            t_k = _time_ms(torch, [lambda a=a, b=b: gemm.gemm(a, b, out_dtype=dt)], 10)
            t_l = _time_ms(torch, [lambda a=a, b=b: torch.matmul(a, b)], 10)
            t_p = _time_ms(torch, [lambda a=a, b=b: gemm.gemm_plain(a, b, dt)], 2, graph=False)
            bound, by = _bound(kcost.gemm(Mi, Ki, Ni))
            rows[("gemm", label, name)] = (t_k, t_p, t_l, bound, by)
            for i, t in enumerate((t_k, t_p, t_l, bound)):
                per[label][i] += times * t
            print(f"  gemm bf16 {label} {name} ({Mi}x{Ki})@({Ki}x{Ni}): kernel "
                  f"{t_k * 1e3:.1f} us, torch.matmul {t_l * 1e3:.1f} us, plain "
                  f"{t_p * 1e3:.1f} us, bound {bound * 1e3:.1f} us ({by}), "
                  f"{bound / t_k:.1%} of bound")
        del x, w, dy, xt, wt
    total = [2 * per["fwd"][i] + per["dX"][i] + per["dW"][i] for i in range(4)]
    rows["gemm_step"] = (*total, "operations")
    print(f"[5] K1 per train step (forward and remat's recompute at M = 4096, dX, dW; head "
          f"x 2 chunks at M = 2048): kernel {total[0]:.3f} ms (forward {per['fwd'][0]:.3f} x "
          f"2, dX {per['dX'][0]:.3f}, dW {per['dW'][0]:.3f}), torch.matmul {total[2]:.3f} ms, "
          f"plain {total[1]:.3f} ms, bound {total[3]:.3f} ms")
    torch.cuda.empty_cache()
    return rows


def _train_argv(ckpt_dir, ckpt_every, *extra):
    return ["--arch", "gemma3-1b", "--preset", "full", "--steps", str(TRAIN_STEPS),
            "--batch", str(TRAIN_B), "--seq", str(TRAIN_S), "--lr", str(TRAIN_LR),
            "--ckpt-every", str(ckpt_every), "--ckpt-dir", str(ckpt_dir), *extra]


def phase_train(torch, np, configs, M, mods):
    """Phase 14: gemma3-1b whole through `repro_torch.launch.train`: a clean
    run, then the same run with `--fail-at` (restored from the
    step-TRAIN_CKPT checkpoint): per-step losses bit for bit equal; launches per step as
    planned; per-step ms, tokens/s, peak memory; one profiled step."""
    import tempfile

    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train

    cfg = configs.get("gemma3-1b")
    plan = train_plan(cfg)
    counters = mods["counters"]
    summary = {}
    with tempfile.TemporaryDirectory() as tdir:
        # The clean run checkpoints at its end only (12 GB of state a save,
        # ~10 s); the restart run every TRAIN_CKPT steps.
        for label, every, extra in (("clean", TRAIN_STEPS, ()),
                                    ("restart", TRAIN_CKPT, ("--fail-at", str(TRAIN_FAIL)))):
            per_step = []

            def on_step(step, metrics, sec, per_step=per_step):
                per_step.append((step, float(metrics["loss"]), sec * 1e3, read_counts(mods)))
                counters.reset()

            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(mods)
            t0 = time.monotonic()
            out = train.main(_train_argv(Path(tdir) / label, every, *extra), on_step=on_step)
            wall = time.monotonic() - t0
            peak = torch.cuda.max_memory_allocated()
            ms = [s[2] for s in per_step]
            med = _median(ms[1:])
            print(f"  [{label}] {len(per_step)} steps in {wall:.1f}s (restarts "
                  f"{out['restarts']}); per step: " + "; ".join(
                      f"{s} loss {l:.6f} {t:.1f} ms " + " ".join(
                          f"{k}={n}" for k, n in c.items() if n)
                      for s, l, t, c in per_step))
            print(f"  [{label}] median step after step 1 {med:.1f} ms, "
                  f"{TRAIN_B * TRAIN_S / med * 1e3:.0f} tokens/s, peak memory "
                  f"{peak / 1e9:.2f} GB")
            for s, _, _, c in per_step:
                got = {k: c.get(k, 0) for k in plan}
                check(got == plan, f"{label} step {s}: launches {got}, planned {plan}")
                check(sum(c.values()) == sum(plan.values()),
                      f"{label} step {s}: no other hand kernel: {c}")
            summary[label] = {"steps": per_step, "median_ms": med, "peak": peak,
                              "wall": wall}
            if label == "clean":
                summary["launches"] = {k: sum(c.get(k, 0) for *_, c in per_step)
                                       for k in counters.COUNTERS}
                # One more step of the trained model under torch.profiler.
                step_fn = steps_lib.make_train_step(cfg, steps_lib.optimizer_config(cfg),
                                                    base_lr=TRAIN_LR, total_steps=TRAIN_STEPS)
                from repro_torch.data import SyntheticLMData, to_device
                batch = to_device(SyntheticLMData(cfg.vocab, TRAIN_B, TRAIN_S).batch_at(99),
                                  "cuda")
                state = [out["params"], out["opt_state"]]

                def one_step():
                    state[0], state[1], m = step_fn(state[0], state[1], batch)
                    float(m["loss"])

                one_step()
                summary["profile"] = _profile_replays(torch, one_step, 1,
                                                      label="train step")
                del state, one_step, step_fn, batch
            del out
            torch.cuda.empty_cache()
    clean = {s: l for s, l, _, _ in summary["clean"]["steps"]}
    restart = summary["restart"]["steps"]
    check(len(restart) == TRAIN_STEPS + (TRAIN_FAIL - TRAIN_CKPT),
          f"the restart replays steps {TRAIN_CKPT + 1}-{TRAIN_FAIL}")
    for s, l, _, _ in restart:
        check(l == clean[s], f"step {s}: restart loss {l!r} == clean {clean[s]!r}")
    print(f"  the restart (failure at step {TRAIN_FAIL}, restored from the step-{TRAIN_CKPT} "
          f"checkpoint) gives the clean run's losses bit for bit at all "
          f"{len(restart)} steps it ran: " + ", ".join(f"{s}: {l!r}" for s, l, _, _ in restart))
    return summary


def phase_train_parity(torch, np, configs, M):
    """A 2-layer full-width gemma3-1b (one window-512 and one global layer),
    f32: loss and every gradient leaf on the card (K1, K5, K5b) against the
    CPU (plain versions), B 1 x S 768 (past the window)."""
    from repro_torch import tree as tree_lib
    from repro_torch.data import SyntheticLMData, to_device

    full = configs.get("gemma3-1b")
    cfg = dataclasses.replace(full, n_layers=2, group_size=2, local_ratio=1, dtype="float32")
    reduced = {"n_layers": [full.n_layers, 2], "group_size": [full.group_size, 2],
               "local_ratio": [full.local_ratio, 1], "dtype": [full.dtype, "float32"]}
    batch = SyntheticLMData(cfg.vocab, 1, 768).batch_at(0)
    params = M.init_model(cfg, seed=0, device="cpu")
    res = {}
    for dev in ("cuda", "cpu"):
        p = tree_lib.map_tree(lambda t: t.to(dev).requires_grad_(True), params)
        leaves = tree_lib.leaves(p)
        t0 = time.monotonic()
        loss = M.loss_fn(p, cfg, to_device(batch, dev))
        grads = torch.autograd.grad(loss, leaves)
        res[dev] = (float(loss), [gr.detach().cpu() for gr in grads], time.monotonic() - t0)
        del p, leaves, loss, grads
    (lg, gg, tg), (lc, gc, tc) = res["cuda"], res["cpu"]
    worst = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for a, b in zip(gg, gc))
    print(f"  gemma3-1b reduced {json.dumps(reduced)}, B 1 x S 768: loss card {lg!r} vs CPU "
          f"{lc!r} (rel {abs(lg - lc) / abs(lc):.1e}, bar 1e-5); {len(gg)} gradient leaves, "
          f"worst max_abs / leaf max {worst:.2e} (bar 1e-4); card {tg:.1f}s, CPU {tc:.1f}s")
    check(abs(lg - lc) <= 1e-5 * abs(lc), "2-layer f32 loss, card vs CPU")
    check(worst <= 1e-4, "2-layer f32 gradients, card vs CPU")
    torch.cuda.empty_cache()


ANALYSIS_FLAG = "--analysis"
DECODE_LIVE = [1100, 1024, 950, 700, 513, 260, 128, 64]   # phase 5's eight live slots
MEMORY_BAR = 0.25          # traced peak against torch.cuda.max_memory_allocated
ATTRIBUTED_BAR = 0.95      # share of a profiled step's kernel time a source names


def _wall_ms(torch, fn, reps: int):
    """Median host ms of fn() (synchronized), after one untimed call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return _median(times)


def analysis_child(torch, np):
    """Phase 15 in a process of its own (torch.profiler saw no device
    events after the whole script's earlier phases, phase 5's finding):
    gemma3-1b at published widths, bf16, as phase 14 trains it (B 4 x S
    1024, f32 moments) and as phase 3 decodes (8 slots live at
    DECODE_LIVE, an eager engine).  For each step in turn: a profile
    first (`diagnose.profile_step`: each op under a record_function naming
    its source), split by `diagnose.attribute`; then its launches, its
    median time and, for the train step (before the engine allocates its
    pool), torch.cuda.max_memory_allocated.  Last, each step counted on the
    meta device (`dryrun.trace_cell`, `step_cost.analyze`): the launches
    against the card's, the dry run's traced peak, and each step's roofline
    (`launch/roofline.py`).  Returns the summary the parent checks."""
    from repro_torch import configs
    from repro_torch.kernels import launches
    from repro_torch.launch import diagnose, dryrun, roofline, step_cost, steps
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine

    t_start = time.monotonic()
    cfg, dev = configs.get("gemma3-1b"), torch.device("cuda")
    step, params, opt, data = diagnose._train_inputs(cfg, dev, TRAIN_B, TRAIN_S)
    out = {}
    prof = diagnose.profile_step(step, params, opt, data)
    out["train_attr"] = diagnose.attribute(prof, 15)
    del prof
    t_prof = time.monotonic() - t_start
    launches.reset()
    step(params, opt, data)
    torch.cuda.synchronize()
    out["train_launches"] = {k: v for k, v in launches.counts().items() if v}
    # the peak of the train step alone, before the engine holds its pool
    torch.cuda.reset_peak_memory_stats()
    out["train_ms"] = _wall_ms(torch, lambda: step(params, opt, data)[2]["loss"].item(), 3)
    out["measured_peak"] = torch.cuda.max_memory_allocated()

    t0 = time.monotonic()
    eng = Engine(cfg, params, slots=8, max_seq=1280, block_size=16, max_chunk=64,
                 graphs=False, device=dev)
    base = _live_slots(torch, eng, DECODE_LIVE)
    ids, live = np.zeros(eng.slots, np.int64), np.ones(eng.slots, bool)

    def decode():
        eng.state.lengths.copy_(base)
        return eng.step_decode(ids, live)

    prof = diagnose.profile_step(decode)
    out["decode_attr"] = diagnose.attribute(prof, 15)
    del prof
    t_prof += time.monotonic() - t0
    launches.reset()
    decode()
    out["decode_launches"] = {k: v for k, v in launches.counts().items() if v}
    out["decode_ms"] = _wall_ms(torch, decode, 10)

    t0 = time.monotonic()
    shape = dict(kind="train", seq_len=TRAIN_S, global_batch=TRAIN_B)
    cost_t, held = dryrun.trace_cell(cfg, shape)
    out["traced_peak"] = sum(held.values()) + cost_t.peak_live_bytes
    out["held"], out["activations"] = held, cost_t.peak_live_bytes
    out["traced_launches"] = dict(cost_t.launches)
    out["train_roof"] = roofline.analyze(
        arch=cfg.name, shape_name=f"train B{TRAIN_B} S{TRAIN_S}", shape=shape, cfg=cfg,
        cost=cost_t, peak_memory_bytes=out["traced_peak"],
        measured_s=out["train_ms"] / 1e3).row()
    p_meta = steps.params_struct(cfg)
    st = M.init_paged_decode_state(cfg, eng.slots, num_blocks=eng.num_blocks,
                                   block_size=16, max_blocks_per_slot=eng.max_blocks_per_slot,
                                   device="meta")
    tok = torch.zeros((eng.slots, 1), dtype=torch.long, device="meta")
    act = torch.ones((eng.slots,), dtype=torch.bool, device="meta")
    with torch.no_grad():
        cost_d = step_cost.analyze(M.paged_decode_step, p_meta, cfg, st, tok, act)
    out["traced_decode_launches"] = dict(cost_d.launches)
    out["decode_roof"] = roofline.analyze(
        arch=cfg.name, shape_name="paged decode, 8 slots",
        shape=dict(kind="decode", seq_len=eng.max_seq, global_batch=eng.slots), cfg=cfg,
        cost=cost_d, measured_s=out["decode_ms"] / 1e3).row()
    out["decode_count_bytes"] = {k: v for k, v in sorted(
        cost_d.bytes_by_source.items(), key=lambda kv: -kv[1])[:6]}
    out["trace_s"], out["profile_s"] = time.monotonic() - t0, t_prof
    for key in ("train_attr", "decode_attr"):
        a = out[key]
        print(f"[15b] {key.split('_')[0]} step's kernel time by source (top 15 of "
              f"{len(a.by_source)}; {a.kernels} kernels, {a.total:.3f} ms):")
        print(a.table())
        out[key] = {"total_ms": a.total, "unattributed": a.unattributed, "kernels": a.kernels,
                    "metric": a.metric, "rows": a.rows}
    out["seconds"] = time.monotonic() - t_start
    return out


def phase15(torch):
    """Phase 15, the analysis layer: `analysis_child` in a process of its
    own; its tables printed, its numbers checked (module docstring)."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    child = subprocess.run([sys.executable, str(Path(__file__).resolve()), ANALYSIS_FLAG],
                           capture_output=True, text=True, timeout=600)
    lines = child.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(line)
    check(child.returncode == 0 and lines, f"phase 15's process: {child.stdout[-1500:]} "
                                           f"{child.stderr[-2500:]}")
    x = json.loads(lines[-1])
    card = card_line()
    m, t = x["measured_peak"], x["traced_peak"]
    print(f"[15a] gemma3-1b train step (B {TRAIN_B} x S {TRAIN_S}, bf16, f32 moments) on {card}: "
          f"torch.cuda.max_memory_allocated {m / 1e9:.3f} GB; dry run's traced peak "
          f"{t / 1e9:.3f} GB (weights {x['held']['weights'] / 1e9:.3f}, optimizer state "
          f"{x['held']['opt_state'] / 1e9:.3f}, inputs {x['held']['inputs'] / 1e6:.3f} MB, "
          f"the step's own storages {x['activations'] / 1e9:.3f}); traced / measured "
          f"{t / m:.3f} (bar {1 - MEMORY_BAR:.2f}-{1 + MEMORY_BAR:.2f})")
    check(abs(t / m - 1) <= MEMORY_BAR, "the traced peak within 25 % of the measured peak")
    print(f"[15a] launches of one train step on the card {x['train_launches']}, counted on "
          f"the meta device {x['traced_launches']}; one eager decode step "
          f"{x['decode_launches']}, on the meta device {x['traced_decode_launches']}")
    check(x["train_launches"] == x["traced_launches"] and
          x["decode_launches"] == x["traced_decode_launches"],
          "the meta trace counts the hand kernels' launches the card made")
    for name in ("gemm", "flash_attention", "flash_attention_bwd"):
        check(x["train_launches"].get(name, 0) > 0, f"the train step launched {name}")
    for name in ("gemm", "flash_decode"):
        check(x["decode_launches"].get(name, 0) > 0, f"the decode step launched {name}")
    for key, what in (("train", f"train step (B {TRAIN_B} x S {TRAIN_S})"),
                      ("decode", "eager float decode step (8 slots)")):
        a = x[f"{key}_attr"]
        print(f"[15b] {what}: {a['kernels']} kernels, {a['total_ms']:.3f} ms of kernel time, "
              f"{1 - a['unattributed']:.2%} in a named row (bar {ATTRIBUTED_BAR:.0%}); {card}")
        check(a["metric"] == "device_ms" and a["kernels"] > 0,
              f"the {key} profile holds the card's kernels")
        check(1 - a["unattributed"] >= ATTRIBUTED_BAR,
              f"at least 95 % of the {key} step's kernel time attributed")
        r = x[f"{key}_roof"]
        print(f"[15c] {what} roofline on {card}: " + json.dumps(
            {k: (round(v, 6) if isinstance(v, float) else v) for k, v in r.items()}))
        print(f"[15c] {what}: measured {r['measured_s'] * 1e3:.3f} ms against the roofline's "
              f"{r['step_time_s'] * 1e3:.3f} ms ({r['bound']}-bound), MFU {r['measured_mfu']:.2%} "
              f"on the {hw.PEAK_FLOPS_BF16 / 1e12:.0f}-TFLOP/s bf16 peak (at the roofline "
              f"time {r['mfu']:.2%})")
        check(r["measured_s"] >= r["step_time_s"],
              f"the measured {key} step is no faster than its roofline")
    print(f"[15c] the decode step's counted bytes by source (GB): " + ", ".join(
        f"{k} {v / 1e9:.3f}" for k, v in x["decode_count_bytes"].items()))
    print(f"[15] phase 15 took {time.monotonic() - t0:.1f}s (child {x['seconds']:.1f}s: "
          f"profiles {x['profile_s']:.1f}s, meta traces {x['trace_s']:.1f}s)")
    return x


# -- phase 16: the families train --------------------------------------------------

FAMILIES_FLAG = "--families"
FAMILIES_META_FLAG = "--families-meta"
FAMILY_STEPS, FAMILY_LR = 3, 3e-4
# 16a's xlstm-1.3b stops after 2 of its FAMILY_STEPS steps (since phase 18d;
# the time limit: its third step took ~4.6 s), its schedule unchanged.
FAMILY_CUT_STEPS = {"xlstm-1.3b": 2}


def family_steps(arch: str) -> int:
    return FAMILY_CUT_STEPS.get(arch, FAMILY_STEPS)
# 16a: (arch, B, S) trained whole through the train CLI at published widths,
# then dbrx-132b cut to one layer (all 16 experts) through make_train_step
# with the whole arch's optimizer config (bf16 moments).
# xlstm's S was 1024 before phase 18 (the time limit: its step is host-bound,
# a Python loop a position).
FAMILY_CLI = (("xlstm-1.3b", 1, 512), ("whisper-medium", 4, 448), ("paligemma-3b", 2, 1024))
FAMILY_DBRX = ("dbrx-132b", 1, 1024)
# xlstm's whole step is counted on the meta device one 8-layer group at a
# short S (the GeMM count does not depend on S but through the loss's
# chunks), scaled by the group count, the head's chunks at the real S.
META_GROUP_S = 64
# 16b: f32 at published widths, card against CPU, B 1 x S 64; each arch at
# 2 layers holding every layer kind of its family.
PARITY_S = 64            # 128 before phase 18 (the time limit)
PARITY_FLOOR = 1e-4        # of the tree's largest |gradient element| (xlstm's b_i)
DEVICE_BYTES = 80e9


def dbrx_train_cfg(configs):
    full = configs.get(FAMILY_DBRX[0])
    cfg = dataclasses.replace(full, n_layers=1, group_size=1)
    return cfg, full, {"n_layers": [full.n_layers, 1], "group_size": [full.group_size, 1]}


def family_parity_cfg(configs, arch):
    """16b's 2-layer f32 config of `arch` and its cuts."""
    full = configs.get(arch)
    kw = dict(n_layers=2, group_size=2, dtype="float32")
    if arch == "xlstm-1.3b":
        kw["slstm_every"] = 2                       # mLSTM, then sLSTM
    if arch == "jamba-1.5-large-398b":
        kw.update(attn_every=2, moe_every=2,        # Mamba + MLP, attention + MoE
                  moe=dataclasses.replace(full.moe, num_experts=2))
    if arch == "dbrx-132b":
        kw["moe"] = dataclasses.replace(full.moe, num_experts=4)
    if arch == "whisper-medium":
        kw["encoder_layers"] = 2
    reduced = {k: [getattr(full, k), v] for k, v in kw.items() if k != "moe"}
    if "moe" in kw:
        reduced["num_experts"] = [full.moe.num_experts, kw["moe"].num_experts]
    return dataclasses.replace(full, **kw), reduced


PARITY_ARCHS = ("xlstm-1.3b", "jamba-1.5-large-398b", "dbrx-132b", "whisper-medium",
                "paligemma-3b")


def _family_extras(cfg, M):
    extras = {}
    if cfg.family == "encdec":
        extras["frames"] = (cfg.encoder_seq, cfg.d_model)
    if cfg.family == "vlm":
        extras["patches"] = (cfg.prefix_len, M.VISION_DIM)
    return extras


def families_meta(torch):
    """Phase 16's meta traces (a CPU process of its own, beside the card
    runs): each 16a step counted by `step_cost.analyze` on the meta device,
    with the resident bytes beside its traced peak; xlstm by one group."""
    from repro_torch import configs
    from repro_torch import tree as tree_lib
    from repro_torch.launch import dryrun, steps

    def count(cfg, opt_cfg, B, S):
        t0 = time.monotonic()
        c, held = dryrun.trace_cell(cfg, dict(kind="train", seq_len=S, global_batch=B), opt_cfg)
        return {"launches": dict(c.launches), "activations": c.peak_live_bytes,
                "weights": held["weights"], "opt_state": held["opt_state"],
                "trace_s": time.monotonic() - t0}

    t0, out = time.monotonic(), {}
    for arch, B, S in FAMILY_CLI:
        cfg = configs.get(arch)
        opt_cfg = steps.optimizer_config(cfg)
        if arch != "xlstm-1.3b":
            out[arch] = count(cfg, opt_cfg, B, S)
            continue
        group = count(dataclasses.replace(cfg, n_layers=cfg.group_size), opt_cfg, B, META_GROUP_S)
        head_s = count(dataclasses.replace(cfg, n_layers=0), opt_cfg, B, META_GROUP_S)
        head = count(dataclasses.replace(cfg, n_layers=0), opt_cfg, B, S)
        params = steps.params_struct(cfg)
        launches = {k: cfg.n_groups * (n - head_s["launches"].get(k, 0))
                    + head["launches"].get(k, 0) for k, n in group["launches"].items()}
        out[arch] = {"launches": launches, "activations": None,
                     "weights": dryrun.storage_bytes(tree_lib.leaves(params)),
                     "opt_state": dryrun.storage_bytes(tree_lib.leaves(
                         steps.opt_state_struct(cfg, params, opt_cfg))),
                     "trace_s": group["trace_s"] + head_s["trace_s"] + head["trace_s"],
                     "formula": " ".join(
                         f"{k} = {cfg.n_groups} groups x ({n} of one {cfg.group_size}-layer "
                         f"group at S {META_GROUP_S} - {head_s['launches'].get(k, 0)} of its "
                         f"head chunk) + {head['launches'].get(k, 0)} of the head's "
                         f"{S // LOSS_CHUNK} chunks at S {S} = {launches[k]};"
                         for k, n in group["launches"].items())}
    cfg, full, _ = dbrx_train_cfg(configs)
    out[FAMILY_DBRX[0]] = count(cfg, steps.optimizer_config(full), *FAMILY_DBRX[1:])
    return {"runs": out, "seconds": time.monotonic() - t0}


class _StopRun(Exception):
    """Raised from the train CLI's on_step after the last step: the run ends
    before the supervisor's final checkpoint (phase 14 holds checkpoints;
    xlstm's 37 GB of state would take longer to write than to train)."""


def _train_run(torch, launches, label, run, n_steps: int = FAMILY_STEPS):
    """Phase 16a's first `n_steps` steps of `run()` (which drives on_step):
    per step (loss, ms, launches), the peak memory."""
    import gc

    per_step = []

    def on_step(step, metrics, sec):
        per_step.append((step, float(metrics["loss"]), sec * 1e3,
                         {k: v for k, v in launches.counts().items() if v}))
        launches.reset()
        if step == n_steps:
            raise _StopRun

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    t0 = time.monotonic()
    try:
        run(on_step)
    except _StopRun:
        pass
    wall = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  [16a] {label}: {len(per_step)} steps in {wall:.1f}s; per step: " + "; ".join(
        f"{s} loss {l:.6f} {t:.1f} ms " + " ".join(f"{k}={n}" for k, n in c.items())
        for s, l, t, c in per_step), flush=True)
    return {"steps": per_step, "peak": peak, "wall": wall}


def _layer_inputs_and_tail(torch, M, blocks, cfg, batch):
    """(x_L of a decoder-only cfg's layer L from tokens, the loss of layers
    L.. and the head from a hidden state): `loss_fn`'s arithmetic split at
    a layer, without remat."""
    kinds = cfg.all_layer_kinds()

    def run_layers(p, x, lo, hi):
        pos = torch.arange(x.shape[1], device=x.device)
        for i in range(lo, hi):
            x, _ = blocks.apply_block(x, p["layers"][i], cfg, kinds[i], positions=pos)
        return x

    def x_at(p, L, dev):
        with torch.no_grad():
            tok = torch.as_tensor(batch["tokens"]).to(dev)
            return run_layers(p, M._embed_tokens(p, cfg, tok), 0, L)

    def tail_loss(p, L, x):
        h = blocks._norm(run_layers(p, x, L, cfg.n_layers), p["final_norm"], cfg)
        logp = torch.log_softmax(M._unembed(h, p, cfg).to(torch.float32), dim=-1)
        lab = torch.as_tensor(batch["labels"]).long().to(x.device)
        return -torch.gather(logp, -1, lab[..., None]).mean()

    return x_at, tail_loss


def _parity(torch, M, tree_lib, SyntheticLMData, to_device, cfg):
    """16b: loss and every gradient leaf of `cfg` on the card against the
    CPU, from the same seed-0 parameters (made on the card and copied to
    the host); the CPU's half runs in a thread beside the card's.

    A leaf over the bar is held two more ways, and passes by either: to its
    noise floor (the CPU's own answer again with every parameter moved by a
    relative 2^-23 x N(0, 1), f32 rounding's size; the card within twice
    that move: a gradient that cancels, xlstm's b_i), and, in a layer L >
    0 of a decoder-only arch, to the CPU fed the card's own input to layer
    L (the loss of layers L.. and the head from that hidden state, both
    devices, within 1e-4): xlstm's sLSTM gates answer its input's rounding
    (the mLSTM's output differs card vs CPU by ~3e-6) some 5000-fold."""
    import threading

    from repro_torch.models import blocks

    batch = SyntheticLMData(cfg.vocab, 1, PARITY_S, extras=_family_extras(cfg, M)).batch_at(0)
    params = M.init_model(cfg, seed=0, device="cuda")
    res = {}

    def run(key, dev, p, loss_of=None):
        p = tree_lib.map_tree(lambda t: t.detach().requires_grad_(True), p)
        leaves = tree_lib.leaves(p)
        t0 = time.monotonic()
        loss = M.loss_fn(p, cfg, to_device(batch, dev)) if loss_of is None else loss_of(p)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        res[key] = (float(loss.detach()), [None if g is None else g.detach() for g in grads],
                    time.monotonic() - t0)

    cpu_params = tree_lib.map_tree(lambda t: t.cpu(), params)
    worker = threading.Thread(target=run, args=("cpu", "cpu", cpu_params))
    worker.start()
    run("cuda", "cuda", params)
    worker.join()
    check("cpu" in res, f"16b {cfg.name}: the CPU's half ran")
    paths = ["/".join(map(str, path)) for path, _ in tree_lib.leaves_with_paths(params)]
    (lg, gg, tg), (lc, gc_, tc) = res["cuda"], res["cpu"]
    gc_ = [b.to("cuda") for b in gc_]          # compared on the card
    floor = PARITY_FLOOR * max(float(b.abs().max()) for b in gc_)
    scales = [max(float(b.abs().max()), floor, 1e-30) for b in gc_]
    errs = [float((a - b).abs().max()) / sc for a, b, sc in zip(gg, gc_, scales)]
    over = {i: {} for i, e in enumerate(errs) if e > 1e-4}
    if over:
        gen = torch.Generator().manual_seed(27)
        run("noise", "cpu", tree_lib.map_tree(
            lambda t: t * (1 + 2.0 ** -23 * torch.randn(t.shape, generator=gen)), cpu_params))
        for i in over:
            over[i]["noise"] = float((res["noise"][1][i].to("cuda") - gc_[i]).abs().max()) \
                / scales[i]
        layers = sorted({int(paths[i].split("/")[1]) for i in over
                         if paths[i].startswith("layers/") and paths[i].split("/")[1] != "0"})
        if cfg.family not in ("encdec", "vlm"):
            x_at, tail_loss = _layer_inputs_and_tail(torch, M, blocks, cfg, batch)
            for L in layers:
                xL = x_at(params, L, "cuda")
                run("tail_cuda", "cuda", params, lambda p: tail_loss(p, L, xL))
                run("tail_cpu", "cpu", cpu_params, lambda p: tail_loss(p, L, xL.cpu()))
                for i in over:
                    if paths[i].startswith(f"layers/{L}/"):
                        a, b = res["tail_cuda"][1][i], res["tail_cpu"][1][i].to("cuda")
                        over[i]["same_input"] = float((a - b).abs().max()) / max(
                            float(b.abs().max()), 1e-30)
    del cpu_params, params, res, gg, gc_
    worst = max(range(len(errs)), key=lambda i: errs[i])
    torch.cuda.empty_cache()
    return {"loss_card": lg, "loss_cpu": lc, "leaves": len(errs), "worst": errs[worst],
            "worst_leaf": paths[worst], "card_s": tg, "cpu_s": tc,
            "over": [dict(leaf=paths[i], err=errs[i], **v) for i, v in over.items()]}


def _family_kernel_times(torch, fa, gemm, configs):
    """The kernels line's phase-16 entries: K5b at whisper's cross-attention
    (B 4, 448 tokens over 1500 frames, 16 heads, D 64, non-causal), K5 with
    the lse at whisper's encoder (B 4, 1500 over 1500) and K1 at one dbrx
    expert's forward (M = its capacity at B 1 x S 1024), bf16, each beside
    its plain version, its library call (SDPA's backward and forward, eager
    calls timed by CUDA events; torch.matmul) and its bound."""
    import torch.nn.functional as F
    from repro_torch.models import moe as moe_lib

    dev, dt = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(16)
    rows = {}
    B, H, D = 4, 16, 64
    for key, Sq, Skv in (("cross_bwd", 448, 1500), ("encoder_fwd", 1500, 1500)):
        q, do = (torch.randn((B, Sq, H, D), generator=g, device=dev).to(dt) for _ in range(2))
        k, v = (torch.randn((B, Skv, H, D), generator=g, device=dev).to(dt) for _ in range(2))
        out, lse = fa._forward(q, k, v, False, None, True)
        ql, kl, vl = (t.permute(0, 2, 1, 3).detach().requires_grad_() for t in (q, k, v))
        o_l = F.scaled_dot_product_attention(ql, kl, vl)
        pairs = kcost.attention_pairs(Sq, Skv, False, None)
        if key == "cross_bwd":
            t_k = _time_ms(torch, [lambda: fa.flash_attention_bwd(q, k, v, out, lse, do,
                                                                  causal=False)], 20)
            t_p = _time_ms(torch, [lambda: fa.flash_attention_bwd_plain(
                q, k, v, out, lse, do, causal=False)], 2, graph=False)
            do_l = do.permute(0, 2, 1, 3)
            t_l = _time_ms(torch, [lambda: torch.autograd.grad(o_l, (ql, kl, vl), do_l,
                                                               retain_graph=True)], 10,
                           graph=False)
            bound, by = _bound(kcost.flash_attention_bwd(B, Sq, Skv, H, H, D, pairs=pairs))
            err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(
                fa.flash_attention_bwd(q, k, v, out, lse, do, causal=False),
                fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal=False)))
        else:
            t_k = _time_ms(torch, [lambda: fa._forward(q, k, v, False, None, True)], 20)
            t_p = _time_ms(torch, [lambda: fa.flash_attention_plain(
                q, k, v, causal=False, return_lse=True)], 2, graph=False)

            def sdpa():
                with torch.no_grad():
                    return F.scaled_dot_product_attention(ql, kl, vl)
            t_l = _time_ms(torch, [sdpa], 10, graph=False)
            bound, by = _bound(kcost.flash_attention(B, Sq, Skv, H, H, D, pairs=pairs, lse=True))
            err = float((out.float() - fa.flash_attention_plain(
                q, k, v, causal=False).float()).abs().max())
        rows[key] = (t_k, t_p, t_l, bound, by, err)
        print(f"  [16] {'flash_attention_bwd' if key == 'cross_bwd' else 'flash_attention (lse)'} "
              f"bf16 B={B} Sq={Sq} Skv={Skv} H={H} D={D} non-causal: kernel {t_k * 1e3:.1f} us, "
              f"plain {t_p * 1e3:.1f} us, sdpa {'backward' if key == 'cross_bwd' else 'forward'} "
              f"(eager) {t_l * 1e3:.1f} us, bound {bound * 1e3:.2f} us ({by}), "
              f"{bound / t_k:.1%} of bound; max_abs against the plain version {err:.3e}")
        del q, k, v, do, out, lse, ql, kl, vl, o_l
    cfg, _, _ = dbrx_train_cfg(configs)
    Mr, K, N = moe_lib._capacity(FAMILY_DBRX[1] * FAMILY_DBRX[2], cfg), cfg.d_model, \
        cfg.moe.d_ff_expert
    a = torch.randn((Mr, K), generator=g, device=dev).to(dt)
    w = (torch.randn((K, N), generator=g, device=dev) * K ** -0.5).to(dt)
    t_k = _time_ms(torch, [lambda: gemm.gemm(a, w, out_dtype=torch.float32)], 20)
    t_l = _time_ms(torch, [lambda: torch.matmul(a, w)], 20)
    t_p = _time_ms(torch, [lambda: gemm.gemm_plain(a, w, torch.float32)], 2, graph=False)
    bound, by = _bound(kcost.gemm(Mr, K, N))
    err = float((gemm.gemm(a, w, out_dtype=torch.float32)
                 - gemm.gemm_plain(a, w, torch.float32)).abs().max())
    rows["expert_gemm"] = (t_k, t_p, t_l, bound, by, err)
    print(f"  [16] gemm bf16 -> f32 dbrx expert w_gate ({Mr}x{K})@({K}x{N}): kernel "
          f"{t_k * 1e3:.1f} us, torch.matmul {t_l * 1e3:.1f} us, plain {t_p * 1e3:.1f} us, "
          f"bound {bound * 1e3:.1f} us ({by}), {bound / t_k:.1%} of bound; max_abs against "
          f"the plain version {err:.3e}")
    del a, w
    torch.cuda.empty_cache()
    return rows


def families_child(torch, np):
    """Phase 16 in a process of its own (`FAMILIES_FLAG`).  16a: each
    FAMILY_CLI arch whole through `repro_torch.launch.train.main` (on_step
    reads and zeroes the launch counters after each step and ends the run
    after step 3), then dbrx-132b at one layer through `make_train_step`,
    bf16; the meta traces run meanwhile in a CPU process of their own
    (`FAMILIES_META_FLAG`).  16b: `PARITY_ARCHS` at 2 layers, f32, card
    against CPU.  Last the kernel times of the kernels line's phase-16
    entries.  Returns the summary the parent checks."""
    from repro_torch import configs
    from repro_torch import tree as tree_lib
    from repro_torch.data import SyntheticLMData, to_device
    from repro_torch.kernels import flash_attention as fa, gemm, launches
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train
    from repro_torch.models import model as M
    from repro_torch.optim import adamw_init
    import tempfile

    t_start = time.monotonic()
    meta = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), FAMILIES_META_FLAG],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {"train": {}, "parity": {}}
    with tempfile.TemporaryDirectory() as tdir:
        for arch, B, S in FAMILY_CLI:
            argv = ["--arch", arch, "--preset", "full", "--steps", str(FAMILY_STEPS),
                    "--batch", str(B), "--seq", str(S), "--lr", str(FAMILY_LR),
                    "--ckpt-every", str(FAMILY_STEPS), "--ckpt-dir", str(Path(tdir) / arch)]
            out["train"][arch] = _train_run(
                torch, launches, f"{arch} whole, B {B} x S {S}, the train CLI",
                lambda on_step, argv=argv: train.main(argv, on_step=on_step),
                family_steps(arch))
    cfg, full, reduced = dbrx_train_cfg(configs)
    arch, B, S = FAMILY_DBRX

    def dbrx(on_step):
        opt_cfg = steps_lib.optimizer_config(full)
        params = M.init_model(cfg, seed=0, device="cuda")
        opt = adamw_init(params, opt_cfg)
        step = steps_lib.make_train_step(cfg, opt_cfg, base_lr=FAMILY_LR,
                                         total_steps=FAMILY_STEPS)
        data = SyntheticLMData(cfg.vocab, B, S)
        launches.reset()
        for i in range(FAMILY_STEPS):
            batch = to_device(data.batch_at(i), "cuda")
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            loss = float(m["loss"])
            on_step(i + 1, {"loss": loss}, time.perf_counter() - t0)

    out["train"][arch] = _train_run(
        torch, launches, f"{arch} reduced {json.dumps(reduced)}, 16 experts, AdamW "
        f"{steps_lib.optimizer_config(full).state_dtype} moments, B {B} x S {S}, "
        f"make_train_step", dbrx)
    out["dbrx_reduced"] = reduced
    out["train_s"] = time.monotonic() - t_start
    t0 = time.monotonic()
    for arch in PARITY_ARCHS:
        pcfg, preduced = family_parity_cfg(configs, arch)
        r = _parity(torch, M, tree_lib, SyntheticLMData, to_device, pcfg)
        r["reduced"] = preduced
        out["parity"][arch] = r
        print(f"  [16b] {arch} reduced {json.dumps(preduced)}, f32, B 1 x S {PARITY_S}: loss "
              f"card {r['loss_card']!r} vs CPU {r['loss_cpu']!r}; {r['leaves']} gradient leaves, "
              f"worst max_abs / max(leaf max, {PARITY_FLOOR:g} x tree max) {r['worst']:.2e} at "
              f"{r['worst_leaf']}; card {r['card_s']:.1f}s, CPU {r['cpu_s']:.1f}s", flush=True)
    out["parity_s"] = time.monotonic() - t0
    t0 = time.monotonic()
    out["times"] = _family_kernel_times(torch, fa, gemm, configs)
    out["times_s"] = time.monotonic() - t0
    stdout, stderr = meta.communicate(timeout=600)
    if meta.returncode != 0:
        raise RuntimeError(f"phase 16's meta traces: {stdout[-1000:]} {stderr[-2000:]}")
    out["meta"] = json.loads(stdout.strip().splitlines()[-1])
    out["seconds"] = time.monotonic() - t_start
    return out


def phase16(torch):
    """Phase 16, the families train: `families_child` in a process of its
    own; its numbers printed and checked (module docstring)."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    child = subprocess.run([sys.executable, str(Path(__file__).resolve()), FAMILIES_FLAG],
                           capture_output=True, text=True, timeout=900)
    lines = child.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(line)
    check(child.returncode == 0 and lines, f"phase 16's process: {child.stdout[-1500:]} "
                                           f"{child.stderr[-2500:]}")
    x = json.loads(lines[-1])
    card = card_line()
    totals = collections.Counter()
    for arch, run in x["train"].items():
        m = x["meta"]["runs"][arch]
        steps = run["steps"]
        ms = [s[2] for s in steps]
        med = _median(ms[1:])
        B, S = next((b, s) for a, b, s in FAMILY_CLI + (FAMILY_DBRX,) if a == arch)
        n = family_steps(arch)
        check(len(steps) == n, f"{arch}: {n} steps")
        check(all(math.isfinite(s[1]) for s in steps), f"{arch}: every loss finite")
        for s, _, _, c in steps:
            totals.update(c)
            check(c == m["launches"], f"{arch} step {s}: launches {c}, meta trace "
                                      f"{m['launches']}")
        held = m["weights"] + m["opt_state"]
        traced = "not traced whole (one group is: the launches' formula below)" \
            if m["activations"] is None else \
            f"{(held + m['activations']) / 1e9:.3f} GB traced (weights " \
            f"{m['weights'] / 1e9:.3f}, optimizer state {m['opt_state'] / 1e9:.3f}, the step's " \
            f"own storages {m['activations'] / 1e9:.3f}; traced / measured " \
            f"{(held + m['activations']) / run['peak']:.3f})"
        print(f"[16a] {arch} on {card}: median of steps 2-{n} {med:.1f} ms, "
              f"{B * S / med * 1e3:.0f} tokens/s; losses " + ", ".join(
                  f"{s[1]:.6f}" for s in steps) + f"; peak torch.cuda.max_memory_allocated "
              f"{run['peak'] / 1e9:.3f} GB beside {traced}; launches each step "
              + " ".join(f"{k}={n}" for k, n in steps[-1][3].items())
              + f", on the meta device {m['launches']} (traced in {m['trace_s']:.1f}s)")
        if m.get("formula"):
            print(f"[16a] {arch} whole on the meta device: {m['formula']}")
        check(run["peak"] < DEVICE_BYTES, f"{arch}: peak under 80 GB")
        for name in ("gemm",) + (("flash_attention", "flash_attention_bwd")
                                 if arch in ("whisper-medium", "dbrx-132b") else ()):
            check(steps[-1][3].get(name, 0) > 0, f"{arch}: the train step launched {name}")
    for arch, r in x["parity"].items():
        rel = abs(r["loss_card"] - r["loss_cpu"]) / abs(r["loss_cpu"])
        print(f"[16b] {arch} reduced {json.dumps(r['reduced'])}: loss rel {rel:.1e} (bar 1e-5), "
              f"{r['leaves']} leaves, worst {r['worst']:.2e} at {r['worst_leaf']} (bar 1e-4 of "
              f"max(the leaf's max, {PARITY_FLOOR:g} x the tree's max))")
        check(rel <= 1e-5, f"{arch}: 2-layer f32 loss, card vs CPU")
        for o in r["over"]:
            same = o.get("same_input")
            print(f"[16b] {arch} {o['leaf']}: {o['err']:.2e} over 1e-4; the CPU's own answer "
                  f"moves {o['noise']:.2e} under a 2^-23 relative move of the parameters (bar: "
                  f"twice that)" + ("" if same is None else
                                    f"; fed the card's input to its layer, card vs CPU "
                                    f"{same:.2e} of the leaf's max (bar 1e-4)"))
            check(o["err"] <= 2 * o["noise"] or (same is not None and same <= 1e-4),
                  f"{arch} {o['leaf']}: 2-layer f32 gradient within its noise floor or, "
                  f"from the same input to its layer, within 1e-4")
    x["totals"] = dict(totals)
    print(f"[16] phase 16 took {time.monotonic() - t0:.1f}s (child {x['seconds']:.1f}s: 16a "
          f"{x['train_s']:.1f}s, 16b {x['parity_s']:.1f}s, kernel times {x['times_s']:.1f}s, "
          f"meta traces "
          f"{x['meta']['seconds']:.1f}s beside them); launches of 16a's "
          f"{sum(len(r['steps']) for r in x['train'].values())} steps ("
          f"reduced {json.dumps({a: [FAMILY_STEPS, n] for a, n in FAMILY_CUT_STEPS.items()})}) "
          + " ".join(
              f"{k}={n}" for k, n in totals.items()))
    return x


PARALLEL_FLAG = "--parallel"
PARALLEL_STEPS = 3          # 17a: each run's steps, phase 14's shape and lr


def parallel_child(torch, np):
    """Phase 17a in a process of its own, started by torchrun at world size
    1 (`PARALLEL_FLAG`): gemma3-1b at published widths, B 4 x S 1024,
    bf16, f32 moments, seed 0, PARALLEL_STEPS steps each run: phase 14's
    unsharded step (`make_train_step`); the train CLI under torchrun's
    environment (it joins an NCCL group and trains the dp plan: every leaf
    replicated, every gradient all-reduced); `make_sharded_train_step`
    under the ZeRO-3 plan in a world-1 NCCL group of its own (a file://
    store).  Per step: loss, ms, hand-kernel launches, collectives (calls
    and bytes by kind); per run the peak memory."""
    import gc
    import tempfile

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch import tree as tree_lib
    from repro_torch.data import SyntheticLMData, rank_rows, to_device
    from repro_torch.kernels import launches
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train
    from repro_torch.launch.mesh import MeshShape, backend_for, make_local_mesh
    from repro_torch.models import model as M
    from repro_torch.optim import adamw_init
    from repro_torch.parallel.sharding import make_plan

    t_start = time.monotonic()
    cfg = configs.get("gemma3-1b")
    opt_cfg = steps_lib.optimizer_config(cfg)
    data = SyntheticLMData(cfg.vocab, TRAIN_B, TRAIN_S)
    out = {"torchrun": {k: os.environ.get(k) for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK")},
           "leaves": len(tree_lib.leaves(steps_lib.params_struct(cfg)))}

    def run(label, body):
        per_step = []

        def on_step(step, metrics, sec):
            per_step.append({"step": step, "loss": float(metrics["loss"]), "ms": sec * 1e3,
                             "launches": {k: v for k, v in launches.counts().items() if v},
                             "collectives": metrics.get("collectives", {}),
                             "collective_bytes": metrics.get("collective_bytes", {})})
            launches.reset()
            if step == PARALLEL_STEPS:
                raise _StopRun

        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        launches.reset()
        t0 = time.monotonic()
        try:
            body(on_step)
        except _StopRun:
            pass
        out[label] = {"steps": per_step, "peak": torch.cuda.max_memory_allocated(),
                      "wall": time.monotonic() - t0}
        print(f"  [17a] {label}: {len(per_step)} steps in {out[label]['wall']:.1f}s; " + "; ".join(
            f"{x['step']} loss {x['loss']!r} {x['ms']:.1f} ms" for x in per_step), flush=True)

    def loop(step_fn, params, opt, rows, on_step):
        # as the supervisor times a step: the batch on the card first
        for i in range(PARALLEL_STEPS):
            batch = to_device(rows(data.batch_at(i)), "cuda", non_blocking=True)
            t0 = time.perf_counter()
            params, opt, m = step_fn(params, opt, batch)
            float(m["loss"])
            on_step(i + 1, m, time.perf_counter() - t0)

    def unsharded(on_step):
        params = M.init_model(cfg, seed=0, device="cuda")
        step = steps_lib.make_train_step(cfg, opt_cfg, base_lr=TRAIN_LR,
                                         total_steps=PARALLEL_STEPS)
        loop(step, params, adamw_init(params, opt_cfg), lambda b: b, on_step)

    with tempfile.TemporaryDirectory() as tdir:
        def cli(on_step):
            train.main(["--arch", "gemma3-1b", "--preset", "full", "--steps", str(PARALLEL_STEPS),
                        "--batch", str(TRAIN_B), "--seq", str(TRAIN_S), "--lr", str(TRAIN_LR),
                        "--ckpt-every", str(PARALLEL_STEPS), "--ckpt-dir", str(Path(tdir) / "ck")],
                       on_step=on_step)

        def zero3(on_step):
            dist.init_process_group(backend_for("cuda"), init_method=f"file://{tdir}/store",
                                    rank=0, world_size=1)
            try:
                mesh = MeshShape.of(make_local_mesh(1, "cuda"))
                plan = make_plan(mesh, cfg.param_count(), force_fsdp=True)
                step = steps_lib.make_sharded_train_step(cfg, opt_cfg, mesh, plan,
                                                         base_lr=TRAIN_LR,
                                                         total_steps=PARALLEL_STEPS)
                out["zero3_group"] = {"backend": dist.get_backend(),
                                      "world": dist.get_world_size(),
                                      "plan": dataclasses.asdict(plan),
                                      "sharded": step.layout.sharded}
                params = step.layout.shard(M.init_model(cfg, seed=0, device="cuda"))
                loop(step, params, adamw_init(params, opt_cfg),
                     lambda b: rank_rows(b, mesh, plan, dist.get_rank()), on_step)
            finally:
                dist.destroy_process_group()

        run("unsharded", unsharded)
        run("dp", cli)
        run("zero3", zero3)
    dp_mesh = MeshShape(("data", "model"), (1, 1))
    out["dp_plan"] = dataclasses.asdict(make_plan(dp_mesh, cfg.param_count(), force_fsdp=False))
    out["backend"] = backend_for("cuda")
    out["seconds"] = time.monotonic() - t_start
    return out


def phase17(torch):
    """Phase 17, data parallelism and ZeRO-3 through a process group: 17b
    the refusals in this process (no group, no weight made); 17a
    `parallel_child` under torchrun at world size 1, its numbers printed
    and checked (module docstring)."""
    import gc

    from repro_torch import configs
    from repro_torch.launch import train
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.parallel import fsdp
    from repro_torch.parallel.sharding import make_plan

    t0 = time.monotonic()
    try:
        train.main(["--preset", "smoke", "--steps", "1", "--model-parallel", "2"])
        refused = None
    except ValueError as e:
        refused = str(e)
    print(f"[17b] --model-parallel 2 over a world of 1: {refused}")
    check(refused is not None, "--model-parallel 2 over a world of 1 raises")
    dbrx = configs.get("dbrx-132b")
    two = MeshShape(("data", "model"), (2, 1))
    before = torch.cuda.memory_allocated()
    try:
        fsdp.check_plan(dbrx, two, make_plan(two, dbrx.param_count(), force_fsdp=False))
        refused = None
    except NotImplementedError as e:
        refused = str(e)
    print(f"[17b] dbrx-132b's CLI plan at a data axis of 2: {refused}")
    check(refused is not None and "A.4c" in refused, "MoE over a data axis of 2 raises")
    check(torch.cuda.memory_allocated() == before, "the MoE refusal made no weight")
    gc.collect()
    torch.cuda.empty_cache()
    child = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1",
         str(Path(__file__).resolve()), PARALLEL_FLAG],
        capture_output=True, text=True, timeout=600)
    lines = child.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(line)
    check(child.returncode == 0 and lines, f"phase 17's process: {child.stdout[-1500:]} "
                                           f"{child.stderr[-2500:]}")
    x = json.loads(lines[-1])
    card = card_line()
    check(x["torchrun"]["WORLD_SIZE"] == "1", f"torchrun's world: {x['torchrun']}")
    n = x["leaves"]
    base = x["unsharded"]["steps"]
    check(len(base) == PARALLEL_STEPS, "the unsharded run's steps")
    want_calls = {"dp": {"all_reduce": n + 3}}
    k = x["zero3_group"]["sharded"]
    want_calls["zero3"] = {"all_reduce": n - k + 3, "all_gather": k, "reduce_scatter": k}
    print(f"[17a] backend {x['backend']}, world {x['zero3_group']['world']} "
          f"({x['zero3_group']['backend']} for ZeRO-3); plans: dp {x['dp_plan']}, ZeRO-3 "
          f"{x['zero3_group']['plan']} ({k} of {n} leaves sharded)")
    check(x["backend"] == x["zero3_group"]["backend"] == "nccl", "NCCL on the card")
    med = {}
    for label in ("unsharded", "dp", "zero3"):
        run = x[label]
        steps = run["steps"]
        check(len(steps) == PARALLEL_STEPS, f"{label}: {PARALLEL_STEPS} steps")
        med[label] = _median([s["ms"] for s in steps[1:]])
        line = (f"[17a] {label} on {card}: median of steps 2-{PARALLEL_STEPS} "
                f"{med[label]:.1f} ms, {TRAIN_B * TRAIN_S / med[label] * 1e3:.0f} tokens/s, "
                f"peak {run['peak'] / 1e9:.3f} GB")
        if label != "unsharded":
            calls, nbytes = steps[-1]["collectives"], steps[-1]["collective_bytes"]
            line += "; collectives a step " + ", ".join(
                f"{kind} {calls[kind]} ({nbytes[kind] / 1e9:.3f} GB)" for kind in sorted(calls))
            for s, b in zip(steps, base):
                check(s["loss"] == b["loss"], f"{label} step {s['step']}: loss {s['loss']!r} "
                                              f"== unsharded {b['loss']!r}")
                check(s["launches"] == b["launches"], f"{label} step {s['step']}: launches "
                                                      f"{s['launches']} == {b['launches']}")
                check(s["collectives"] == want_calls[label],
                      f"{label} step {s['step']}: collectives {s['collectives']}, "
                      f"planned {want_calls[label]}")
        print(line + "; per step " + "; ".join(
            f"{s['step']} loss {s['loss']!r} {s['ms']:.1f} ms " + " ".join(
                f"{kk}={v}" for kk, v in s["launches"].items()) for s in steps))
    print(f"[17a] the dp and ZeRO-3 runs' losses equal the unsharded run's bit for bit at all "
          f"{PARALLEL_STEPS} steps, their launches a step too: " + " ".join(
              f"{kk}={v}" for kk, v in base[-1]["launches"].items())
          + f"; dp {med['dp'] / med['unsharded'] - 1:+.2%}, ZeRO-3 "
          f"{med['zero3'] / med['unsharded'] - 1:+.2%} of the unsharded step; ZeRO-3's peak "
          f"{(x['zero3']['peak'] - x['unsharded']['peak']) / 1e9:+.3f} GB")
    totals = collections.Counter()
    for label in ("dp", "zero3"):
        for s in x[label]["steps"]:
            totals.update(s["launches"])
    x["totals"] = dict(totals)
    print(f"[17] phase 17 took {time.monotonic() - t0:.1f}s (child {x['seconds']:.1f}s); "
          f"launches of the dp and ZeRO-3 runs' {2 * PARALLEL_STEPS} steps " + " ".join(
              f"{kk}={v}" for kk, v in totals.items()))
    return x


TP_FLAG = "--tp"               # 18a's process
TP_GLOO_FLAG = "--tp-gloo"     # 18b / 18d's two processes: RANK STORE
TP_STEPS, TP_B, TP_S, TP_LR = 3, 2, 1024, 3e-4
# a step's loss against the unsharded run's (18b reads up to 6.2e-5)
TP_RTOL = {"18a": 1e-5, "18b": 5e-4}
# Step 1's gradient, whole leaf by leaf (the norm of each, relative to the
# unsharded run's): it depends on the trunk, where the loss at random
# weights barely does.  18b reads 1.7e-3 at its worst leaf (q_norm, bf16
# partial sums rounded before the all-reduce) and 1.5e-5 for the whole
# gradient.  A partial sum left unreduced moves a leaf far more (qwen3-14b's
# smoke config at (1, 2) on the CPU: no all-reduce after wo, 126 % at
# norm1; q_norm's partial gradients left unsummed, 40 % at q_norm, where
# the whole gradient's norm moves 3.4e-5).
TP_NORM_RTOL = {"18a": 1e-5, "18b": 5e-3}
TP_KERNELS = ("gemm", "flash_attention", "flash_attention_bwd")
# A rank's attention at (1, 2): 20 q heads, the GQA groups of its 4 kv heads.
TP_ATTENTION = (TP_B, TP_S, 20, 4, 128)
# (name, K, N) of a rank's K1 products at (1, 2): half the MLP's columns and
# rows, half the head's vocabulary columns.
TP_GEMMS = [("gate", 5120, 8704), ("down", 8704, 5120), ("head", 5120, 75968)]
# A sequence-parallel rank's attention at (1, 2): all 40 q / 8 kv heads,
# its 512 queries over the 1024 keys, rank r's at q offset 512 r.
SP_ATTENTION = (TP_B, TP_S // 2, TP_S, 40, 8, 128)
# (B, Sq, Skv, Hq, Hkv, D, window, q_offset) of 18c's offset checks: that
# rank's shape at offsets 0 and 512, causal and with a 512 window;
# gemma3-1b's 4 / 1 heads at D 256 with its window; an offset that is no
# multiple of a tile.
SP_OFFSET_SHAPES = [(*SP_ATTENTION, w, off) for w in (None, 512) for off in (0, 512)] + [
    (TP_B, TP_S // 2, TP_S, 4, 1, 256, 512, 512), (1, 100, 256, 4, 1, 64, None, 37)]


def tp_cfg(configs):
    """qwen3-14b at its published widths, cut to 2 layers (one remat group
    of 2): (config, the cuts as {field: [published, run]})."""
    full = configs.get("qwen3-14b")
    return (dataclasses.replace(full, n_layers=2, group_size=2),
            {"n_layers": [full.n_layers, 2], "group_size": [full.group_size, 2]})


def _tp_plan(sizes, attn_seq: bool = False):
    """The tp plan over (data, model) = `sizes`, forced (the 2-layer cut
    has 2.2 B parameters, under make_plan's 4e9 threshold), no ZeRO-3;
    head-parallel, or with sequence-parallel attention forced (qwen3-14b's
    8 kv heads divide a model axis of 1 or 2, where make_plan's rule keeps
    heads)."""
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.parallel.sharding import make_plan

    mesh = MeshShape(("data", "model"), sizes)
    plan = make_plan(mesh, 10**12, force_mode="tp", force_fsdp=False, force_attn_seq=attn_seq)
    check(plan.attn_seq == attn_seq, f"the plan's attn_seq over {sizes}")
    return mesh, plan


def _unsharded_norms(torch, cfg):
    """norms(params, batch): the norm of each leaf's gradient of the loss,
    in the parameters' leaf order."""
    from repro_torch import tree as tree_lib
    from repro_torch.models import model as M

    def norms(params, batch):
        leaves = tree_lib.leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            grads = torch.autograd.grad(M.loss_fn(params, cfg, batch), leaves,
                                        allow_unused=True)
        return [0.0 if g is None else float(torch.linalg.vector_norm(g.float()))
                for g in grads]
    return norms


def _sharded_norms(torch, step):
    """`_unsharded_norms` of a `ShardedTrainStep`: this rank's gradient
    pieces, their sums of squares made the whole leaves' by the clip's own
    `Layout.norm_reduce`."""
    def norms(params, batch):
        _, grads = step.gradients(params, batch)
        sq = torch.stack([torch.sum(torch.square(g.float())) for g in grads])
        return torch.sqrt(step.layout.norm_reduce(sq)).tolist()
    return norms


def _tp_run(torch, cfg, step, params, data, norms, rows=lambda b: b):
    """TP_STEPS steps of `step` from `params` with AdamW state made on them:
    per step the loss, ms (host clock to a synchronize), the hand kernels'
    launches and the collectives by kind; the peak memory of the steps;
    before them `norms` of step 1's batch (not counted in its launches)."""
    from repro_torch import tree as tree_lib
    from repro_torch.data import to_device
    from repro_torch.kernels import launches
    from repro_torch.launch import steps as steps_lib
    from repro_torch.optim import adamw_init

    grad_norms = norms(params, to_device(rows(data.batch_at(0)), "cuda"))
    leaves = ["/".join(map(str, p)) for p, _ in tree_lib.leaves_with_paths(params)]
    opt = adamw_init(params, steps_lib.optimizer_config(cfg))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = []
    for i in range(TP_STEPS):
        batch = to_device(rows(data.batch_at(i)), "cuda")
        launches.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        out.append({"loss": loss, "ms": (time.perf_counter() - t0) * 1e3,
                    "launches": {k: v for k, v in launches.counts().items() if v},
                    "collectives": m.get("collectives", {}),
                    "collective_bytes": m.get("collective_bytes", {})})
    return {"steps": out, "peak": torch.cuda.max_memory_allocated(),
            "grad_norms": dict(zip(leaves, grad_norms))}


def tp_child(torch, np):
    """Phase 18a in a process of its own (`TP_FLAG`): the unsharded
    `make_train_step`, then `make_sharded_train_step` under the tp plan
    over (1, 1) in a world-1 NCCL group (a file:// store), head-parallel,
    then with sequence-parallel attention, from the same seed-0 weights on
    the same batches."""
    import gc
    import tempfile

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.mesh import backend_for
    from repro_torch.models import model as M

    t0 = time.monotonic()
    cfg, _ = tp_cfg(configs)
    opt_cfg = steps_lib.optimizer_config(cfg)
    data = SyntheticLMData(cfg.vocab, TP_B, TP_S)
    step = steps_lib.make_train_step(cfg, opt_cfg, base_lr=TP_LR, total_steps=TP_STEPS)
    out = {"unsharded": _tp_run(torch, cfg, step, M.init_model(cfg, seed=0, device="cuda"),
                                data, _unsharded_norms(torch, cfg))}
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tdir:
        dist.init_process_group(backend_for("cuda"), init_method=f"file://{tdir}/store",
                                rank=0, world_size=1)
        try:
            mesh, plan = _tp_plan((1, 1))
            step = steps_lib.make_sharded_train_step(cfg, opt_cfg, mesh, plan, base_lr=TP_LR,
                                                     total_steps=TP_STEPS)
            params = step.layout.shard(M.init_model(cfg, seed=0, device="cuda"))
            gc.collect()
            out["tp"] = _tp_run(torch, cfg, step, params, data, _sharded_norms(torch, step))
            out["group"] = {"backend": dist.get_backend(), "world": dist.get_world_size(),
                            "plan": dataclasses.asdict(plan),
                            "model_sharded": step.layout.model_sharded}
            del params, step
            gc.collect()
            torch.cuda.empty_cache()
            mesh, plan = _tp_plan((1, 1), attn_seq=True)
            step = steps_lib.make_sharded_train_step(cfg, opt_cfg, mesh, plan, base_lr=TP_LR,
                                                     total_steps=TP_STEPS, seq_len=TP_S)
            params = step.layout.shard(M.init_model(cfg, seed=0, device="cuda"))
            gc.collect()
            out["sp"] = _tp_run(torch, cfg, step, params, data, _sharded_norms(torch, step))
            out["sp_group"] = {"plan": dataclasses.asdict(plan),
                               "model_sharded": step.layout.model_sharded}
        finally:
            dist.destroy_process_group()
    out["seconds"] = time.monotonic() - t0
    return out


def tp_gloo_child(torch, np, rank: int, store: str):
    """Phase 18b's rank `rank` of two on the one card (`TP_GLOO_FLAG`): a
    gloo group over CUDA tensors (a file:// store), the tp plan at (1, 2),
    this rank's pieces of the seed-0 weights, its rows (all of them: the
    data axis is 1); then, in the same group, 18d: the plan with
    sequence-parallel attention at (1, 2), from the same weights on the
    same batches."""
    import datetime
    import gc

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch import tree as tree_lib
    from repro_torch.data import SyntheticLMData, rank_rows
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import model as M

    t0 = time.monotonic()
    torch.cuda.set_device(0)
    cfg, _ = tp_cfg(configs)
    opt_cfg = steps_lib.optimizer_config(cfg)
    data = SyntheticLMData(cfg.vocab, TP_B, TP_S)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=600))

    def run(attn_seq: bool):
        mesh, plan = _tp_plan((1, 2), attn_seq)
        step = steps_lib.make_sharded_train_step(cfg, opt_cfg, mesh, plan, base_lr=TP_LR,
                                                 total_steps=TP_STEPS, seq_len=TP_S)
        params = step.layout.shard(M.init_model(cfg, seed=0, device="cuda"))
        gc.collect()
        torch.cuda.empty_cache()
        layer = params["layers"][0]
        got = _tp_run(torch, cfg, step, params, data, _sharded_norms(torch, step),
                      rows=lambda b: rank_rows(b, mesh, plan, rank))
        got.update(held={"q_heads": layer["mixer"]["wq"].shape[1] // cfg.resolved_head_dim,
                         "kv_heads": layer["mixer"]["wk"].shape[1] // cfg.resolved_head_dim,
                         "d_ff": layer["ffn"]["w_gate"].shape[1],
                         "vocab": params["head"].shape[1]},
                   weight_bytes=sum(x.numel() * x.element_size()
                                    for x in tree_lib.leaves(params)))
        return got

    try:
        out = run(False)
        gc.collect()
        torch.cuda.empty_cache()
        t_sp = time.monotonic()
        out["sp"] = run(True)
        out["sp"]["seconds"] = time.monotonic() - t_sp
        out.update(rank=rank, backend=dist.get_backend(), world=dist.get_world_size())
    finally:
        dist.destroy_process_group()
    out["seconds"] = time.monotonic() - t0
    return out


def _tp_meta(torch, cfg, rank: int, attn_seq: bool = False):
    """Rank `rank`'s 18b (or, with `attn_seq`, 18d) step traced on the
    meta device (`make_sharded_train_step(rank=)`, `step_cost.analyze`):
    its hand kernels' launches and its collectives, counted, not run, and
    the operations its K5 / K5b launches count (at its q offset)."""
    from repro_torch.launch import step_cost
    from repro_torch.launch import steps as steps_lib
    from repro_torch.optim import adamw_init

    mesh, plan = _tp_plan((1, 2), attn_seq)
    opt_cfg = steps_lib.optimizer_config(cfg)
    step = steps_lib.make_sharded_train_step(cfg, opt_cfg, mesh, plan, rank=rank)
    params = step.layout.shard(steps_lib.params_struct(cfg))
    batch = {k: torch.zeros((TP_B, TP_S), dtype=torch.int64, device="meta")
             for k in ("tokens", "labels")}
    ops = collections.Counter()
    with kcost.recording(lambda kernel, c: ops.update({kernel: c.ops})):
        cost = step_cost.analyze(step, params, adamw_init(params, opt_cfg), batch)
    return {"launches": {k: cost.launches.get(k, 0) for k in TP_KERNELS},
            "collectives": dict(step.layout.collectives),
            "attention_ops": {k: ops[k] for k in TP_KERNELS[1:]}}


def _norm_gap(run, base):
    """(the largest relative gap of `run`'s per-leaf gradient norms to
    `base`'s, its leaf, the total norms' relative gap)."""
    got, want = run["grad_norms"], base["grad_norms"]
    check(list(got) == list(want), "the same leaves")
    gaps = {k: abs(got[k] - want[k]) / want[k] for k in want}
    worst = max(gaps, key=gaps.get)
    total = [sum(x[k] ** 2 for k in want) ** 0.5 for x in (got, want)]
    return max(gaps[worst], abs(total[0] - total[1]) / total[1]), worst, \
        abs(total[0] - total[1]) / total[1]


def _norm_text(run, base):
    worst, leaf, total = _norm_gap(run, base)
    norms = run["grad_norms"]
    return (f"worst {worst:.2e} relative at {leaf} ({norms[leaf]:.6g} against "
            f"{base['grad_norms'][leaf]:.6g}), {len(norms)} leaves, the whole gradient's norm "
            f"{sum(v ** 2 for v in norms.values()) ** 0.5:.6g} ({total:.2e} relative)")


def _tp_launches(st):
    return {k: st["launches"].get(k, 0) for k in TP_KERNELS}


def _tp_line(label, run, card):
    steps = run["steps"]
    med = _median([s["ms"] for s in steps[1:]])
    calls, nbytes = steps[-1]["collectives"], steps[-1]["collective_bytes"]
    return (f"{label} on {card}: median of steps 2-{TP_STEPS} {med:.1f} ms, "
            f"{TP_B * TP_S / med * 1e3:.0f} tokens/s, peak {run['peak'] / 1e9:.3f} GB"
            + ("; collectives a step " + ", ".join(
                f"{k} {calls[k]} ({nbytes[k] / 1e9:.4f} GB)" for k in sorted(calls))
               if calls else "")
            + "; per step " + "; ".join(
                f"{s_i + 1} loss {s['loss']!r} {s['ms']:.1f} ms " + " ".join(
                    f"{k}={v}" for k, v in _tp_launches(s).items())
                for s_i, s in enumerate(steps)))


def phase18(torch, fa, gemm):
    """Phase 18, tensor parallelism (module docstring): the refusals that
    stand (A.4c) in this process, before any weight is made; 18a in a
    process of its own, 18b and 18d in two, each rank's meta traces in
    this process while they run; then the `:tp` and `:sp` entries' kernel
    times at a rank's shapes."""
    import gc
    import tempfile

    from repro_torch import configs
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.parallel.sharding import make_plan

    t0 = time.monotonic()
    card = card_line()
    before = torch.cuda.memory_allocated()
    for label, arch, sizes, kw, why in (
            ("qwen3-14b's 8 kv heads over a model axis of 16 (attn_seq) at S 1000", "qwen3-14b",
             (1, 16), {"n_kv_heads": 8}, "does not"),
            ("dbrx-132b under a model axis of 2", "dbrx-132b", (1, 2), {}, "A.4c"),
            ("xlstm-1.3b under a model axis of 2", "xlstm-1.3b", (1, 2), {}, "A.4c")):
        mesh = MeshShape(("data", "model"), sizes)
        try:
            steps_lib.make_sharded_train_step(configs.get(arch), None, mesh,
                                              make_plan(mesh, 10**12, force_mode="tp", **kw),
                                              seq_len=1000)
            refused = None
        except NotImplementedError as e:
            refused = str(e)
        print(f"[18] {label}: {refused}")
        check(refused is not None and why in refused, f"{label} is refused")
    check(torch.cuda.memory_allocated() == before, "the refusals made no weight")
    cfg, reduced = tp_cfg(configs)
    print(f"[18] reduced {json.dumps(reduced)}")
    gc.collect()
    torch.cuda.empty_cache()
    child = subprocess.run([sys.executable, str(Path(__file__).resolve()), TP_FLAG],
                           capture_output=True, text=True, timeout=600)
    lines = child.stdout.strip().splitlines()
    check(child.returncode == 0 and lines, f"phase 18a's process: {child.stdout[-1500:]} "
                                           f"{child.stderr[-2500:]}")
    a = json.loads(lines[-1])
    base, tp = a["unsharded"]["steps"], a["tp"]["steps"]
    print(f"[18a] NCCL group: backend {a['group']['backend']}, world {a['group']['world']}, "
          f"plan {a['group']['plan']} ({a['group']['model_sharded']} leaves held as model-axis "
          f"pieces); {a['seconds']:.1f}s")
    check(a["group"]["backend"] == "nccl" and a["group"]["world"] == 1, "18a: NCCL, world 1")
    print("[18a] " + _tp_line("unsharded", a["unsharded"], card))
    print("[18a] " + _tp_line("tp (1, 1)", a["tp"], card))
    print("[18a] " + _tp_line("attn_seq (1, 1)", a["sp"], card))
    check(len(base) == len(tp) == len(a["sp"]["steps"]) == TP_STEPS, "18a: every step ran")
    for i, (s, b) in enumerate(zip(a["sp"]["steps"], base)):
        check(s["loss"] == b["loss"], f"18a attn_seq step {i + 1}: loss {s['loss']!r} against "
                                      f"the unsharded {b['loss']!r}, bit for bit")
        check(_tp_launches(s) == _tp_launches(b), f"18a attn_seq step {i + 1}: launches "
                                                  f"{s['launches']} == unsharded {b['launches']}")
        check(s["collectives"].get("all_gather", 0) > 0 and
              s["collectives"].get("reduce_scatter", 0) > 0,
              "18a attn_seq: the sequence operators' collectives ran")
    check(_norm_gap(a["sp"], a["unsharded"])[0] <= TP_NORM_RTOL["18a"],
          f"18a attn_seq step 1's gradient norms: {_norm_gap(a['sp'], a['unsharded'])}")
    print(f"[18a] attn_seq over (1, 1) ({a['sp_group']['model_sharded']} leaves held as "
          f"model-axis pieces): every step's loss equal to the unsharded run's bit for bit, "
          f"launches a step equal; step 1's gradient norms: "
          f"{_norm_text(a['sp'], a['unsharded'])}")
    for i, (s, b) in enumerate(zip(tp, base)):
        rel = abs(s["loss"] - b["loss"]) / abs(b["loss"])
        check(rel <= TP_RTOL["18a"], f"18a step {i + 1}: loss {s['loss']!r} against the "
                                     f"unsharded {b['loss']!r} ({rel:.2e} relative)")
        check(_tp_launches(s) == _tp_launches(b), f"18a step {i + 1}: launches {s['launches']} "
                                                  f"== unsharded {b['launches']}")
        check(s["collectives"].get("all_reduce", 0) > 0, "18a: the operators' collectives ran")
    check(_norm_gap(a["tp"], a["unsharded"])[0] <= TP_NORM_RTOL["18a"],
          f"18a step 1's gradient norms: {_norm_gap(a['tp'], a['unsharded'])}")
    same = sum(s["loss"] == b["loss"] for s, b in zip(tp, base))
    print(f"[18a] every step's loss within {TP_RTOL['18a']:g} relative of the unsharded run's "
          f"(" + ", ".join(f"{abs(s['loss'] - b['loss']) / abs(b['loss']):.2e}"
                           for s, b in zip(tp, base))
          + f"; {same} of {TP_STEPS} bit for bit), launches a step equal: "
          + " ".join(f"{k}={v}" for k, v in _tp_launches(base[-1]).items())
          + f"; step 1's gradient norms, leaf by leaf: {_norm_text(a['tp'], a['unsharded'])} "
          f"(bar {TP_NORM_RTOL['18a']:g})")
    with tempfile.TemporaryDirectory() as tdir:
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), TP_GLOO_FLAG,
                                   str(r), f"{tdir}/store"], stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True) for r in range(2)]
        try:
            t_meta = time.monotonic()
            meta = [_tp_meta(torch, cfg, r) for r in range(2)]
            meta_sp = [_tp_meta(torch, cfg, r, attn_seq=True) for r in range(2)]
            t_meta = time.monotonic() - t_meta
            results = [p.communicate(timeout=900) for p in procs]
        finally:
            for p in procs:
                p.kill()
    ranks = []
    for p, (so, se) in zip(procs, results):
        lines = so.strip().splitlines()
        check(p.returncode == 0 and lines, f"phase 18b's rank: {so[-1500:]} {se[-2500:]}")
        ranks.append(json.loads(lines[-1]))
    for r, x in enumerate(ranks):
        check(x["backend"] == "gloo" and x["world"] == 2 and x["rank"] == r, f"18b rank {r}")
        check(x["held"] == {"q_heads": 20, "kv_heads": 4, "d_ff": cfg.d_ff // 2,
                            "vocab": cfg.vocab // 2}, f"18b rank {r} holds {x['held']}")
        print(f"[18b] rank {r} (gloo, world 2, on {card}) holds {x['held']}, weights "
              f"{x['weight_bytes'] / 1e9:.3f} GB; " + _tp_line(f"rank {r}", x, card)
              + f"; {x['seconds']:.1f}s")
        print(f"[18b] rank {r} on the meta device: " + " ".join(
            f"{k}={v}" for k, v in meta[r]["launches"].items())
              + f"; collectives {meta[r]['collectives']}")
        for i, (s, b) in enumerate(zip(x["steps"], base)):
            rel = abs(s["loss"] - b["loss"]) / abs(b["loss"])
            check(rel <= TP_RTOL["18b"], f"18b rank {r} step {i + 1}: loss {s['loss']!r} "
                                         f"against 18a's unsharded {b['loss']!r} ({rel:.2e})")
            check(_tp_launches(s) == meta[r]["launches"],
                  f"18b rank {r} step {i + 1}: launches {s['launches']}, meta trace "
                  f"{meta[r]['launches']}")
            check(s["collectives"] == meta[r]["collectives"],
                  f"18b rank {r} step {i + 1}: collectives {s['collectives']}, meta trace "
                  f"{meta[r]['collectives']}")
    check([s["loss"] for s in ranks[0]["steps"]] == [s["loss"] for s in ranks[1]["steps"]],
          "18b: both model ranks print the same loss")
    check(ranks[0]["grad_norms"] == ranks[1]["grad_norms"],
          "18b: both model ranks reduce the same gradient norms")
    gap = _norm_gap(ranks[0], a["unsharded"])
    print(f"[18b] step 1's gradient norms, leaf by leaf, against 18a's unsharded run's: "
          f"{_norm_text(ranks[0], a['unsharded'])} (bar {TP_NORM_RTOL['18b']:g})")
    check(gap[0] <= TP_NORM_RTOL["18b"], f"18b step 1's gradient norms: {gap}")
    print(f"[18b] both ranks' losses against 18a's unsharded run: " + ", ".join(
        f"{abs(s['loss'] - b['loss']) / abs(b['loss']):.2e}"
        for s, b in zip(ranks[0]["steps"], base))
          + f" relative (bar {TP_RTOL['18b']:g}); launches a step equal to each rank's meta "
          f"trace (18b's and 18d's, traced in {t_meta:.1f}s beside the ranks)")
    sp = [x["sp"] for x in ranks]
    _, Sq, _, Hq, Hkv, _ = SP_ATTENTION
    for r, x in enumerate(sp):
        check(x["held"] == {"q_heads": Hq, "kv_heads": Hkv, "d_ff": cfg.d_ff // 2,
                            "vocab": cfg.vocab // 2}, f"18d rank {r} holds {x['held']}")
        pairs = kcost.attention_pairs(Sq, TP_S, True, None, r * Sq)
        print(f"[18d] rank {r} (gloo, world 2, on {card}) holds {x['held']} and queries "
              f"{r * Sq}-{(r + 1) * Sq - 1} (q offset {r * Sq}, {pairs} pairs a head), weights "
              f"{x['weight_bytes'] / 1e9:.3f} GB; " + _tp_line(f"rank {r}", x, card)
              + f"; {x['seconds']:.1f}s")
        print(f"[18d] rank {r} on the meta device: " + " ".join(
            f"{k}={v}" for k, v in meta_sp[r]["launches"].items())
              + f"; collectives {meta_sp[r]['collectives']}; K5 / K5b operations a step "
              + " / ".join(f"{v / 1e9:.3f}" for v in meta_sp[r]["attention_ops"].values())
              + " G")
        for i, (s, b) in enumerate(zip(x["steps"], base)):
            rel = abs(s["loss"] - b["loss"]) / abs(b["loss"])
            check(rel <= TP_RTOL["18b"], f"18d rank {r} step {i + 1}: loss {s['loss']!r} "
                                         f"against 18a's unsharded {b['loss']!r} ({rel:.2e})")
            check(_tp_launches(s) == meta_sp[r]["launches"],
                  f"18d rank {r} step {i + 1}: launches {s['launches']}, meta trace "
                  f"{meta_sp[r]['launches']}")
            check(s["collectives"] == meta_sp[r]["collectives"],
                  f"18d rank {r} step {i + 1}: collectives {s['collectives']}, meta trace "
                  f"{meta_sp[r]['collectives']}")
    check(meta_sp[0]["attention_ops"]["flash_attention"]
          < meta_sp[1]["attention_ops"]["flash_attention"],
          "18d: the later chunk scores more pairs (its causal share)")
    check([s["loss"] for s in sp[0]["steps"]] == [s["loss"] for s in sp[1]["steps"]],
          "18d: both model ranks print the same loss")
    check(sp[0]["grad_norms"] == sp[1]["grad_norms"],
          "18d: both model ranks reduce the same gradient norms")
    gap = _norm_gap(sp[0], a["unsharded"])
    print(f"[18d] step 1's gradient norms, leaf by leaf, against 18a's unsharded run's: "
          f"{_norm_text(sp[0], a['unsharded'])} (bar {TP_NORM_RTOL['18b']:g})")
    check(gap[0] <= TP_NORM_RTOL["18b"], f"18d step 1's gradient norms: {gap}")
    print(f"[18d] both ranks' losses against 18a's unsharded run: " + ", ".join(
        f"{abs(s['loss'] - b['loss']) / abs(b['loss']):.2e}" for s, b in zip(sp[0]["steps"], base))
          + f" relative (bar {TP_RTOL['18b']:g}); launches and collectives a step equal to "
          f"each rank's meta trace")
    rows = phase_times_tp(torch, fa, gemm)
    rows.update(phase_times_sp(torch, fa))
    totals, totals_sp = collections.Counter(), collections.Counter()
    for run in [a["tp"]] + ranks:
        for s in run["steps"]:
            totals.update(_tp_launches(s))
    for run in [a["sp"]] + sp:
        for s in run["steps"]:
            totals_sp.update(_tp_launches(s))
    print(f"[18] phase 18 took {time.monotonic() - t0:.1f}s; launches of the head-parallel "
          f"runs' steps (18a's and both 18b ranks') " + " ".join(
              f"{k}={v}" for k, v in totals.items())
          + "; of the sequence-parallel runs' (18a's and both 18d ranks') " + " ".join(
              f"{k}={v}" for k, v in totals_sp.items()))
    return {"18a": a, "18b": ranks, "18d": sp, "meta": meta, "rows": rows,
            "totals": dict(totals), "totals_sp": dict(totals_sp)}


def phase_kernels_tp(torch, fa, gemm, ops):
    """18c: K5 (out and lse) and K5b at a rank's attention shape, causal and
    with a 512 window, bf16 and f32, and K1's forward, dX and dW at a
    rank's shapes in bf16, against their plain versions."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(18)
    worst = {"flash_attention:tp": 0.0, "flash_attention_bwd:tp": 0.0, "gemm:tp": 0.0}
    B, S, Hq, Hkv, D = TP_ATTENTION
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        for window in (None, 512):
            q, k, v, do = (torch.randn((B, S, h, D), generator=g, device=dev).to(dt)
                           for h in (Hq, Hkv, Hkv, Hq))
            out, lse = fa._forward(q, k, v, True, window, True)
            pout, plse = fa.flash_attention_plain(q, k, v, causal=True, window=window,
                                                  return_lse=True)
            e_out, _, ok = close(out, pout, *FLASH_TOL[dname])
            e_lse = float((lse - plse).abs().max())
            worst["flash_attention:tp"] = max(worst["flash_attention:tp"], e_out)
            check(ok and e_lse <= 1e-5, f"18c flash_attention {dname} window={window}")
            got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=True, window=window)
            want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal=True,
                                                window=window)
            errs = []
            for name, x, w in zip(("dq", "dk", "dv"), got, want):
                scale = float(w.float().abs().max())
                err = float((x.float() - w.float()).abs().max())
                errs.append(f"{name} {err:.2e}/{scale:.2e}")
                worst["flash_attention_bwd:tp"] = max(worst["flash_attention_bwd:tp"], err)
                check(x.dtype == dt and err <= BWD_TOL[dname] * scale,
                      f"18c flash_attention_bwd {dname} window={window} {name}")
            print(f"  18c flash_attention {dname} B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} causal "
                  f"window={window}: out max_abs={e_out:.3e} tol={FLASH_TOL[dname]}, lse "
                  f"max_abs {e_lse:.1e} (bar 1e-5); flash_attention_bwd max_abs/max "
                  + ", ".join(errs) + f" (bar {BWD_TOL[dname]:g} x max): ok")
            del q, k, v, do, out, lse, pout, plse, got, want
    rtol, atol = GEMM_TOL["bfloat16"]
    for name, K, N in TP_GEMMS:
        M = TP_B * (LOSS_CHUNK if name == "head" else TP_S)
        x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16).requires_grad_()
        w = (torch.randn((K, N), generator=g, device=dev) * K ** -0.5).to(torch.bfloat16) \
            .requires_grad_()
        dy = torch.randn((M, N), generator=g, device=dev).to(torch.bfloat16)
        before = gemm.launches
        y = ops.linear(x, w)
        dx, dw = torch.autograd.grad(y, (x, w), dy)
        check(gemm.launches - before == 3, f"18c gemm {name}: forward, dX, dW: three launches")
        errs = []
        for label, got, a, b in (("fwd", y, x, w), ("dX", dx, dy, w.t()), ("dW", dw, x.t(), dy)):
            e, _, ok = close(got, gemm.gemm_plain(a.detach(), b.detach(), torch.bfloat16),
                             rtol, atol)
            worst["gemm:tp"] = max(worst["gemm:tp"], e)
            errs.append(f"{label} {e:.3e}")
            check(ok, f"18c gemm {name} {label}")
        print(f"  18c gemm bf16 {name} M={M} {K}x{N}: max_abs " + ", ".join(errs)
              + f" tol=(rtol {rtol:g}, atol {atol:g}) ok")
        del x, w, dy, y, dx, dw
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return worst


def phase_times_tp(torch, fa, gemm):
    """The `:tp` entries' times at a rank's shapes (bf16, CUDA events): K5b
    and K5 with the lse at TP_ATTENTION, causal, beside SDPA's backward and
    forward (eager calls, K/V repeated to the q heads beforehand) and their
    bounds; K1 at a rank's gate projection (M = 2048, 5120 x 8704) beside
    torch.matmul."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(19)
    B, S, Hq, Hkv, D = TP_ATTENTION
    x = _attention_inputs(torch, fa, g, None, B=B, S=S, Hq=Hq, Hkv=Hkv, D=D)
    q, k, v, do, out, lse = (x[n] for n in ("q", "k", "v", "do", "out", "lse"))
    sdpa_bwd, sdpa_fwd = _sdpa_calls(torch, x, None)
    pairs = kcost.attention_pairs(S, S, True, None)
    rows = {}
    t_k = _time_ms(torch, [lambda: fa.flash_attention_bwd(q, k, v, out, lse, do)], 20)
    t_p = _time_ms(torch, [lambda: fa.flash_attention_bwd_plain(q, k, v, out, lse, do)], 3,
                   graph=False)
    t_l = _time_ms(torch, [sdpa_bwd], 10, graph=False)
    rows["flash_attention_bwd:tp"] = (t_k, t_p, t_l, *_bound(kcost.flash_attention_bwd(
        B, S, S, Hq, Hkv, D, pairs=pairs)))
    t_k = _time_ms(torch, [lambda: fa._forward(q, k, v, True, None, True)], 20)
    t_p = _time_ms(torch, [lambda: fa.flash_attention_plain(q, k, v, return_lse=True)], 3,
                   graph=False)
    t_l = _time_ms(torch, [sdpa_fwd], 20)
    rows["flash_attention:tp"] = (t_k, t_p, t_l, *_bound(kcost.flash_attention(
        B, S, S, Hq, Hkv, D, pairs=pairs, lse=True)))
    del x, q, k, v, do, out, lse, sdpa_bwd, sdpa_fwd
    M, (_, K, N) = TP_B * TP_S, TP_GEMMS[0]
    a = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
    b = torch.randn((K, N), generator=g, device=dev).to(torch.bfloat16)
    t_k = _time_ms(torch, [lambda: gemm.gemm(a, b, out_dtype=torch.bfloat16)], 10)
    t_l = _time_ms(torch, [lambda: torch.matmul(a, b)], 10)
    t_p = _time_ms(torch, [lambda: gemm.gemm_plain(a, b, torch.bfloat16)], 2, graph=False)
    rows["gemm:tp"] = (t_k, t_p, t_l, *_bound(kcost.gemm(M, K, N)))
    del a, b
    for name, (t_k, t_p, t_l, bound, by) in rows.items():
        print(f"  {name} bf16 at a rank's shape: kernel {t_k * 1e3:.1f} us, plain "
              f"{t_p * 1e3:.1f} us, library {t_l * 1e3:.1f} us (an eager call), bound "
              f"{bound * 1e3:.2f} us ({by}), {bound / t_k:.1%} of bound")
    torch.cuda.empty_cache()
    return rows


def phase_kernels_sp(torch, fa):
    """18c's offset checks: K5 (out and lse) and K5b at SP_OFFSET_SHAPES,
    causal, bf16 and f32, against their plain versions at the same q
    offset; the keys past the last query's position get dK = dV = 0
    exactly (K5b writes the key tiles no query sees over the wrapper's
    uninitialised outputs)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(20)
    worst = {"flash_attention:sp": 0.0, "flash_attention_bwd:sp": 0.0}
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        for B, Sq, Skv, Hq, Hkv, D, window, off in SP_OFFSET_SHAPES:
            q, k, v, do = (torch.randn((B, n, h, D), generator=g, device=dev).to(dt)
                           for n, h in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv), (Sq, Hq)))
            out, lse = fa._forward(q, k, v, True, window, True, off)
            pout, plse = fa.flash_attention_plain(q, k, v, causal=True, window=window,
                                                  q_offset=off, return_lse=True)
            e_out, _, ok = close(out, pout, *FLASH_TOL[dname])
            e_lse = float((lse - plse).abs().max())
            worst["flash_attention:sp"] = max(worst["flash_attention:sp"], e_out)
            label = f"{dname} B={B} Sq={Sq} Skv={Skv} Hq={Hq} Hkv={Hkv} D={D} window={window} " \
                f"q_offset={off}"
            check(ok and e_lse <= 1e-5, f"18c flash_attention {label}")
            got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=True, window=window,
                                         q_offset=off)
            want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal=True,
                                                window=window, q_offset=off)
            errs = []
            for name, x, w in zip(("dq", "dk", "dv"), got, want):
                scale = float(w.float().abs().max())
                err = float((x.float() - w.float()).abs().max())
                errs.append(f"{name} {err:.2e}/{scale:.2e}")
                worst["flash_attention_bwd:sp"] = max(worst["flash_attention_bwd:sp"], err)
                check(x.dtype == dt and err <= BWD_TOL[dname] * scale,
                      f"18c flash_attention_bwd {label} {name}")
            unseen = Skv - min(Skv, off + Sq)
            for x in got[1:]:
                check(bool((x[:, Skv - unseen:] == 0).all()),
                      f"18c flash_attention_bwd {label}: dK / dV zero past the last query")
            print(f"  18c flash_attention {label} causal: out max_abs={e_out:.3e} tol="
                  f"{FLASH_TOL[dname]}, lse max_abs {e_lse:.1e} (bar 1e-5); flash_attention_bwd "
                  f"max_abs/max " + ", ".join(errs) + f" (bar {BWD_TOL[dname]:g} x max); dK / dV "
                  f"of the {unseen} keys no query sees exactly 0: ok")
            del q, k, v, do, out, lse, pout, plse, got, want
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return worst


def phase_times_sp(torch, fa):
    """The `:sp` entries' times at a sequence-parallel rank's shape
    (SP_ATTENTION, bf16, causal, CUDA events): K5b and K5 with the lse at
    each rank's q offset, beside SDPA's backward and forward (eager calls,
    K/V repeated to the q heads beforehand, a boolean mask of the same
    offset) and their bounds from the offset's pairs.  The entries carry
    rank 1's (offset 512, the heavier causal share)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(21)
    B, Sq, Skv, Hq, Hkv, D = SP_ATTENTION
    rows = {}
    for rank in (0, 1):
        off = rank * Sq
        x = _attention_inputs(torch, fa, g, None, B=B, S=Sq, Hq=Hq, Hkv=Hkv, D=D, Skv=Skv,
                              q_offset=off)
        q, k, v, do, out, lse = (x[n] for n in ("q", "k", "v", "do", "out", "lse"))
        sdpa_bwd, sdpa_fwd = _sdpa_calls(torch, x, None)
        pairs = kcost.attention_pairs(Sq, Skv, True, None, off)
        suffix = "" if rank else "@0"
        t_k = _time_ms(torch, [lambda: fa.flash_attention_bwd(q, k, v, out, lse, do,
                                                              q_offset=off)], 20)
        t_p = _time_ms(torch, [lambda: fa.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                                                    q_offset=off)], 3,
                       graph=False)
        t_l = _time_ms(torch, [sdpa_bwd], 10, graph=False)
        rows["flash_attention_bwd:sp" + suffix] = (t_k, t_p, t_l, *_bound(
            kcost.flash_attention_bwd(B, Sq, Skv, Hq, Hkv, D, pairs=pairs)))
        t_k = _time_ms(torch, [lambda: fa._forward(q, k, v, True, None, True, off)], 20)
        t_p = _time_ms(torch, [lambda: fa.flash_attention_plain(q, k, v, q_offset=off,
                                                                return_lse=True)], 3,
                       graph=False)
        t_l = _time_ms(torch, [sdpa_fwd], 20)
        rows["flash_attention:sp" + suffix] = (t_k, t_p, t_l, *_bound(kcost.flash_attention(
            B, Sq, Skv, Hq, Hkv, D, pairs=pairs, lse=True)))
        for name in ("flash_attention_bwd:sp", "flash_attention:sp"):
            t_k, t_p, t_l, bound, by = rows[name + suffix]
            print(f"  {name} bf16 at a sequence-parallel rank's shape (B={B}, {Sq} queries at "
                  f"q offset {off} over {Skv} keys, Hq={Hq}, Hkv={Hkv}, D={D}, causal, {pairs} "
                  f"pairs a head): kernel {t_k * 1e3:.1f} us, plain {t_p * 1e3:.1f} us, library "
                  f"{t_l * 1e3:.1f} us (SDPA with a boolean mask, an eager call), bound "
                  f"{bound * 1e3:.2f} us ({by}), {bound / t_k:.1%} of bound")
        del x, q, k, v, do, out, lse, sdpa_bwd, sdpa_fwd
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
    if sys.argv[1:] == [PROFILE_FLAG]:   # phase 5's profiles, in a process of their own
        from repro_torch.kernels import flash_attention as fa
        print(json.dumps(profile_train_attention(torch, fa)))
        return 0
    if sys.argv[1:] == [ANALYSIS_FLAG]:  # phase 15, in a process of its own
        print(json.dumps(analysis_child(torch, np)))
        return 0
    if sys.argv[1:] == [FAMILIES_FLAG]:  # phase 16, in a process of its own
        print(json.dumps(families_child(torch, np)))
        return 0
    if sys.argv[1:] == [FAMILIES_META_FLAG]:  # phase 16's meta traces, on the CPU
        print(json.dumps(families_meta(torch)))
        return 0
    if sys.argv[1:] == [PARALLEL_FLAG]:  # phase 17a, under torchrun
        print(json.dumps(parallel_child(torch, np)))
        return 0
    if sys.argv[1:] == [TP_FLAG]:        # phase 18a, a process of its own
        print(json.dumps(tp_child(torch, np)))
        return 0
    if sys.argv[1:2] == [TP_GLOO_FLAG]:  # phase 18b: one of its two ranks
        print(json.dumps(tp_gloo_child(torch, np, int(sys.argv[2]), sys.argv[3])))
        return 0
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
    for name, op in (("gemm", "HMMA"), ("gemm_pipelined", "HMMA"), ("gemm_int8", "IMMA"),
                     ("flash_attention_bwd", "HGMMA")):
        n = sass_count(_build._lib_path(name), op)
        print(f"[1] lib{name}.so: " + (f"{op} not counted (no cuobjdump)" if n is None
                                      else f"{n} {op} (tensor-core) instructions"))
        check(n is None or n > 0, f"lib{name}.so runs its products on the tensor cores")

    print(f"[2] kernels vs plain versions on the card {stamp()}")
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
    print(f"[2] the training path's kernels: K5b, the forward's lse, K1's dX / dW {stamp()}")
    worst.update(phase_kernels_train(torch, fa, gemm, ops))
    print(f"[2] 18c: K5, K5b and K1 at a tensor-parallel rank's shapes (qwen3-14b over a "
          f"model axis of 2) {stamp()}")
    worst.update(phase_kernels_tp(torch, fa, gemm, ops))
    print(f"[2] 18c: K5 and K5b at a sequence-parallel rank's q offsets {stamp()}")
    worst.update(phase_kernels_sp(torch, fa))
    engine_args = (torch, np, configs, M, kvc, Engine, RequestSpec, mods, quant, ops)
    print(f"[3] full-width gemma3-1b engine run (26 layers, bf16) {stamp()}")
    summary = phase_engine(*engine_args, profile=True)
    print(f"[3b] the same run in w8a8 with an int8 KV pool {stamp()}")
    summary8 = phase_engine(*engine_args, precision="w8a8", kv_precision="int8", profile=True,
                            traffic=gemma_traffic_cut, reduced={**CUT_3CD, **GEMMA_CUT},
                            replay_traffic=gemma_traffic, cut=GEMMA_SERVE)
    print(f"[3c] the same run in calibrated w8a8 with an int8 KV pool {stamp()}")
    summary_cal = phase_engine(*engine_args, precision="w8a8-calibrated", kv_precision="int8",
                               traffic=gemma_traffic_cut, reduced={**CUT_3CD, **GEMMA_CUT},
                               replay_traffic=gemma_traffic, cut=GEMMA_SERVE)
    print(f"[3d] phase 3's float run under the pipelined GeMM backend (depth 3) {stamp()}")
    summary_pipe = phase_engine(*engine_args, backend="pipelined", traffic=gemma_traffic_cut,
                                reduced={**CUT_3CD, **GEMMA_CUT},
                                replay_traffic=gemma_traffic, cut=GEMMA_SERVE)
    print(f"[3e] the serve CLI at published widths, w8a8 + int8 KV {stamp()}")
    phase_serve_cli(np)
    print(f"[4] 6-layer full-width f32: CUDA kernels vs CPU plain versions {stamp()}")
    phase_parity(torch, np, configs, M, kvc, Engine, RequestSpec, quant, ops)
    print(f"[6] quality: forward NLL in float, w8a8 and calibrated w8a8 (26 layers, bf16) {stamp()}")
    summary_q = phase_quality(torch, np, configs, M, quant, mods)
    print(f"[5] kernel times at main-path shapes (bf16, CUDA events, L2 cold) {stamp()}")
    rows = phase_times(torch, gemm, gp, fd, kvc)
    agg = per_step(rows)
    rows_s3 = {**rows, **phase_times_flash(torch, fa)}
    agg.update(per_step_slice3(rows_s3))
    rows8 = phase_times_int8(torch, gemm8, kq, fd, kvc)
    agg.update(per_step_int8(rows8))
    w8 = per_step_w8a8(rows8, gemm8.FUSED_ROWS)
    agg["gemm_w8a8"] = [w8["decode"][k] for k in ("kernel", "plain", "int_mm", "bound")] \
        + ["bytes"]
    print(f"[5] one float decode step (26 layers): gemm {agg['gemm'][0]:.3f} ms (torch.matmul "
          f"{agg['gemm'][2]:.3f}, bound {agg['gemm'][3]:.3f}), flash_decode "
          f"{agg['flash_decode'][0]:.3f} ms (bound {agg['flash_decode'][3]:.3f}); engine "
          f"decode step (26 layers) {summary['decode_ms']:.2f} ms")
    chunk = per_prefill_chunk(rows)
    print(f"[5] one float prefill chunk (26 x projections at M=64, head at M=1): gemm "
          f"{chunk['gemm'][0]:.3f} ms, gemm_pipelined (depth 3) "
          f"{chunk['gemm_pipelined'][0]:.3f} ms, torch.matmul {chunk['gemm'][2]:.3f} ms, "
          f"bound {chunk['gemm'][3]:.3f} ms; engine prefill chunk (26 layers) "
          f"{summary['prefill_ms']:.2f} ms")
    for label, what in (("decode", "decode step (183 GeMMs at M=8)"),
                        ("prefill", "prefill chunk (26 x projections at M=64, head at M=1)")):
        t = w8[label]
        print(f"[5] one w8a8 {what}: as planned {t['plan']:.3f} ms; as one launch each "
              f"{t['kernel']:.3f} ms (eager calls {t['eager']:.3f}), static scales "
              f"{t['static']:.3f} ms; as two launches (quantize_rows + dequant_gemm) "
              f"{t['two_launch']:.3f} ms; torch._int_mm {t['int_mm']:.3f} ms, bound "
              f"{t['bound']:.3f} ms")
    # 3b-3d's engines run GEMMA_SERVE's layers: their kernel sums at that depth
    L = GEMMA_SERVE["n_layers"]
    cut8 = per_step_int8(rows8, n_layers=L, n_global=GEMMA_GLOBALS)
    cut_w8 = per_step_w8a8(rows8, gemm8.FUSED_ROWS, n_layers=L)["decode"]
    cut_pipe = per_step_slice3(rows_s3, n_layers=L, n_global=GEMMA_GLOBALS)["gemm_pipelined"]
    print(f"[5] one w8a8 + int8 KV decode step ({L} layers): gemm_w8a8 {cut_w8['kernel']:.3f} ms "
          f"(bound {cut_w8['bound']:.3f}), flash_decode_int8 "
          f"{cut8['flash_decode_int8'][0]:.3f} ms (bound {cut8['flash_decode_int8'][3]:.3f}); "
          f"engine decode step ({L} layers) {summary8['decode_ms']:.2f} ms; one prefill "
          f"chunk's {7 * L} projections at M=64: dequant_gemm {cut8['dequant_gemm'][0]:.3f} ms + "
          f"quantize_rows {cut8['quantize_rows'][0]:.3f} ms (bound "
          f"{cut8['quantize_rows'][3]:.4f}); engine prefill chunk ({L} layers) "
          f"{summary8['prefill_ms']:.2f} ms")
    print(f"[5] one decode step under the pipelined backend ({L} layers): gemm_pipelined "
          f"(depth 3) {cut_pipe[0]:.3f} ms (torch.matmul {cut_pipe[2]:.3f}, bound "
          f"{cut_pipe[3]:.3f}); engine decode step ({L} layers) {summary_pipe['decode_ms']:.2f} "
          f"ms; calibrated w8a8 engine decode step ({L} layers) {summary_cal['decode_ms']:.2f} ms")
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
    print(f"[5] whisper-medium's K5 shapes and the encdec / vlm K1 shapes {stamp()}")
    rows_ed = phase_times_encdec(torch, gemm, fa)
    print(f"[5] the training path: K5b and K1's products per train step {stamp()}")
    rows_tr = phase_times_train(torch, fa, gemm)
    print(f"[8a] qwen3-14b at published widths ({QWEN3_LAYERS} of its 40 layers, bf16), float "
          f"{stamp()}")
    summary_qf = phase_engine(*engine_args, arch="qwen3-14b", n_layers=40,
                              traffic=qwen3_traffic, profile=True, reduced=CUT_8,
                              cut={"n_layers": QWEN3_LAYERS})
    print(f"[8b] qwen3-14b at published widths ({QWEN3_LAYERS} layers), w8a8 with an int8 KV "
          f"pool {stamp()}")
    summary_q8 = phase_engine(*engine_args, precision="w8a8", kv_precision="int8",
                              arch="qwen3-14b", n_layers=40, traffic=qwen3_traffic,
                              reduced=CUT_8, cut={"n_layers": QWEN3_LAYERS})
    print(f"[8] qwen3-14b kernel times per decode step (bf16, CUDA events, L2 cold) {stamp()}")
    phase_times_dense(torch, gemm, gemm8, fd, kvc, gp, fa)
    print(f"[8c] the dense family at published widths, 2 layers, f32: CUDA kernels vs CPU "
          f"plain versions {stamp()}")
    phase_parity_dense(torch, np, configs, M, kvc, Engine, RequestSpec, quant, mods)
    args9 = (torch, np, configs, M, Engine, RequestSpec, mods)
    print(f"[9a] speculative greedy decoding, gemma3-1b at published widths "
          f"({GEMMA_SERVE['n_layers']} layers, "
          f"bf16), k = {DRAFT_K}, float {stamp()}")
    summary_9a = phase_speculative(*args9)
    print(f"[9b] the same in w8a8 with an int8 KV pool {stamp()}")
    summary_9b = phase_speculative(*args9, precision="w8a8", kv_precision="int8")
    print(f"[9c] sampling: temperature / top-k / top-p with seeded streams {stamp()}")
    phase_sampling(*args9)
    print(f"[9d] KV-swap preemption and the prefix cache {stamp()}")
    phase_preempt_prefix(*args9)
    print(f"[10] the recurrent, hybrid and MoE families {stamp()}")
    phase10(torch, np, configs, M, kvc, Engine, RequestSpec, mods, quant, worst)
    print(f"[11] the encoder-decoder and VLM families {stamp()}")
    summary11 = phase11(torch, np, configs, M, mods, quant)
    print(f"[12] the tile autotuner and the engine's observability {stamp()}")
    summary12 = phase12(torch, np, configs, M, kvc, Engine, RequestSpec, mods, quant)
    print(f"[13] the cluster layer: replicas on one card {stamp()}")
    summary13 = phase13(torch, np, configs, M, Engine, RequestSpec, mods)
    print(f"[14] the training path: gemma3-1b at published widths through "
          f"repro_torch.launch.train (B {TRAIN_B} x S {TRAIN_S}, {TRAIN_STEPS} steps, bf16, "
          f"AdamW f32 moments) {stamp()}")
    summary14 = phase_train(torch, np, configs, M, mods)
    print(f"[14b] a 2-layer full-width gemma3-1b train step in f32: card vs CPU {stamp()}")
    phase_train_parity(torch, np, configs, M)
    print(f"[15] the analysis layer: memory, attribution and rooflines of gemma3-1b's train "
          f"and decode steps (a process of its own) {stamp()}")
    phase15(torch)
    print(f"[16] the families train: xlstm-1.3b, whisper-medium, paligemma-3b whole and "
          f"dbrx-132b at one layer, bf16, {FAMILY_STEPS} steps each (xlstm-1.3b "
          f"{family_steps('xlstm-1.3b')}); five families' 2-layer "
          f"f32 gradients card vs CPU (a process of its own) {stamp()}")
    summary16 = phase16(torch)
    print(f"[17] data parallelism and ZeRO-3 through a process group: gemma3-1b at published "
          f"widths, {PARALLEL_STEPS} steps a run, world size 1 (NCCL; a process under "
          f"torchrun) {stamp()}")
    summary17 = phase17(torch)
    print(f"[18] tensor parallelism, head-parallel and with sequence-parallel attention: "
          f"qwen3-14b at published widths, 2 layers, B {TP_B} x S {TP_S}, bf16, {TP_STEPS} steps "
          f"a run; 18a world size 1 (NCCL), 18b (heads) and 18d (attn_seq) two gloo ranks on "
          f"the one card {stamp()}")
    summary18 = phase18(torch, fa, gemm)
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
    # Launches phase 12's tuner made to time candidates (replays included),
    # apart from the serving launches counted in "launches".
    tuner = collections.Counter(summary12["float"]["timing_launches"])
    tuner.update(summary12["w8a8"]["timing_launches"])
    tuner.update(summary12["depth_launches"])
    kernels = []
    for name, src, replaces, per, launches in entries:
        t_k, t_p, t_l, bound = agg[name][:4]
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "per": per, "launches": launches[name],
            "max_abs_err": worst[name], "ms": t_k, "plain_ms": t_p, "bound_ms": bound,
            "bound_by": agg[name][4] if len(agg[name]) > 4 else "bytes",
            "library_ms": t_l, "tuner_launches": tuner[name],
            "cluster_launches": summary13["launches"][name]})
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
            "bound_ms": bound, "bound_by": by, "library_ms": t_l, "tuner_launches": 0,
            "cluster_launches": 0})
    # The training path (phase 14): K5b per train step, and K1's products of a
    # train step; launches are the clean train run's.
    for name, src, replaces, per, key, err in (
            ("flash_attention_bwd", "flash_attention_bwd.cuh",
             "src/repro/kernels/flash_attention.py:28 (differentiated by jax.value_and_grad "
             "under jax.checkpoint, src/repro/models/attention.py:103-109; no backward kernel "
             "of its own)",
             "one gemma3-1b train step's attention backward: 4 global + 22 window-512 layers, "
             "B=4, S=1024, Hq=4, Hkv=1, D=256, bf16", "step", "flash_attention_bwd"),
            ("flash_attention:train_step", "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:28",
             "one gemma3-1b train step's attention forward with the lse, run twice (forward "
             "and remat's recompute): 2 x (4 global + 22 window-512 layers), B=4, S=1024, "
             "Hq=4, Hkv=1, D=256, bf16", "fwd_step", "flash_attention"),
            ("gemm:train_step", "gemm.cu", "src/repro/kernels/gemm.py:33",
             "one gemma3-1b train step's GeMMs: the forward and remat's recompute (26 x "
             "(q,k,v,o,gate,up,down) at M=4096, the tied head x 2 loss chunks at M=2048), "
             "dX and dW of each, bf16", "gemm_step", "gemm_bwd")):
        t_k, t_p, t_l, bound, by = rows_tr[key]
        kernel = name.split(":")[0]
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "per": per, "launches": summary14["launches"][kernel],
            "max_abs_err": worst[err], "ms": t_k, "plain_ms": t_p, "bound_ms": bound,
            "bound_by": by, "library_ms": t_l, "tuner_launches": 0, "cluster_launches": 0})
    # The families' training (phase 16): launches are 16a's four runs, 3
    # steps each; times and errors at one shape of each kernel on that path.
    fam = "(launches: phase 16a's train steps of xlstm-1.3b, whisper-medium, paligemma-3b " \
        "whole and dbrx-132b at one layer, 3 each)"
    for name, src, replaces, per, key in (
            ("flash_attention_bwd:families", "flash_attention_bwd.cuh",
             "src/repro/kernels/flash_attention.py:28 (differentiated by jax.value_and_grad, "
             "src/repro/models/attention.py:103-109)",
             "K5b at whisper-medium's cross-attention in training: B=4, 448 tokens over 1500 "
             f"frames, Hq=Hkv=16, D=64, non-causal, bf16 {fam}", "cross_bwd"),
            ("flash_attention:families", "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:28",
             "K5 with the lse at whisper-medium's encoder in training: B=4, 1500 frames over "
             f"1500, Hq=Hkv=16, D=64, non-causal, bf16 {fam}", "encoder_fwd"),
            ("gemm:families", "gemm.cu", "src/repro/kernels/gemm.py:33",
             "K1 at one dbrx-132b expert's gate projection in training: M=320 (the expert's "
             f"capacity at B 1 x S 1024), K=6144, N=10752, bf16 -> f32 {fam}",
             "expert_gemm")):
        t_k, t_p, t_l, bound, by, err = summary16["times"][key]
        kernel = name.split(":")[0]
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "per": per, "launches": summary16["totals"].get(kernel, 0),
            "max_abs_err": err, "ms": t_k, "plain_ms": t_p, "bound_ms": bound,
            "bound_by": by, "library_ms": t_l, "tuner_launches": 0, "cluster_launches": 0})
    # Data parallelism and ZeRO-3 (phase 17a): launches are the dp and ZeRO-3
    # runs' (PARALLEL_STEPS steps each, world size 1); times and errors are
    # phase 5's at the same shapes (M = 4096 / world rows).
    for name, src, replaces, per, key, err in (
            ("flash_attention_bwd:parallel", "flash_attention_bwd.cuh",
             "src/repro/kernels/flash_attention.py:28 (differentiated by jax.value_and_grad "
             "under jax.checkpoint, src/repro/models/attention.py:103-109)",
             "gemma3-1b's train step through a world-1 NCCL group, dp and ZeRO-3: 4 global + "
             "22 window-512 layers, B=4, S=1024, Hq=4, Hkv=1, D=256, bf16", "step",
             "flash_attention_bwd"),
            ("flash_attention:parallel", "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:28",
             "the same steps' attention forward with the lse, twice a layer (forward and "
             "remat's recompute), B=4, S=1024, bf16", "fwd_step", "flash_attention"),
            ("gemm:parallel", "gemm.cu", "src/repro/kernels/gemm.py:33",
             "the same steps' GeMMs: forward, recompute, dX and dW at M=4096, the tied head "
             "x 2 loss chunks at M=2048, bf16", "gemm_step", "gemm_bwd")):
        t_k, t_p, t_l, bound, by = rows_tr[key]
        kernel = name.split(":")[0]
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "per": per, "launches": summary17["totals"].get(kernel, 0),
            "max_abs_err": worst[err], "ms": t_k, "plain_ms": t_p, "bound_ms": bound,
            "bound_by": by, "library_ms": t_l, "tuner_launches": 0, "cluster_launches": 0})
    # Tensor parallelism (phase 18): launches are 18a's tp run and both 18b
    # ranks' (TP_STEPS steps each); times at a rank's shapes (phase_times_tp),
    # errors from 18c.
    for name, src, replaces, per in (
            ("flash_attention_bwd:tp", "flash_attention_bwd.cuh",
             "src/repro/kernels/flash_attention.py:28 (differentiated by jax.value_and_grad "
             "under jax.checkpoint, src/repro/models/attention.py:103-109)",
             "K5b at a tensor-parallel rank's attention (qwen3-14b over a model axis of 2): "
             "B=2, S=1024, Hq=20, Hkv=4, D=128, causal, bf16"),
            ("flash_attention:tp", "flash_attention.cu", "src/repro/kernels/flash_attention.py:28",
             "K5 with the lse at the same shape, bf16"),
            ("gemm:tp", "gemm.cu", "src/repro/kernels/gemm.py:33",
             "K1 at a rank's gate projection: M=2048, K=5120, N=8704, bf16")):
        t_k, t_p, t_l, bound, by = summary18["rows"][name]
        kernel = name.split(":")[0]
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "per": per, "launches": summary18["totals"].get(kernel, 0),
            "max_abs_err": worst[name], "ms": t_k, "plain_ms": t_p, "bound_ms": bound,
            "bound_by": by, "library_ms": t_l, "tuner_launches": 0, "cluster_launches": 0})
    # Sequence-parallel attention (phase 18): launches are 18a's attn_seq run
    # and both 18d ranks' (TP_STEPS steps each); K5 / K5b times at rank 1's
    # offset shape (phase_times_sp), errors from 18c's offset checks; K1's
    # gate product is the tp rank's shape (the gathered sequence, half of
    # d_ff), timed once in phase_times_tp.
    sp_rank = "B=2, 512 queries at q offset 512 over 1024 keys, Hq=40, Hkv=8, D=128, causal"
    for name, src, replaces, per, key, err in (
            ("flash_attention_bwd:sp", "flash_attention_bwd.cuh",
             "src/repro/kernels/flash_attention.py:28 (differentiated by jax.value_and_grad "
             "under jax.checkpoint, src/repro/models/attention.py:103-109)",
             f"K5b at a sequence-parallel rank's attention (qwen3-14b at (1, 2)): {sp_rank}, "
             "bf16", "flash_attention_bwd:sp", "flash_attention_bwd:sp"),
            ("flash_attention:sp", "flash_attention.cu", "src/repro/kernels/flash_attention.py:28",
             f"K5 with the lse at the same shape: {sp_rank}, bf16", "flash_attention:sp",
             "flash_attention:sp"),
            ("gemm:sp", "gemm.cu", "src/repro/kernels/gemm.py:33",
             "K1 at a sequence-parallel rank's gate projection over the gathered sequence: "
             "M=2048, K=5120, N=8704, bf16", "gemm:tp", "gemm:tp")):
        t_k, t_p, t_l, bound, by = summary18["rows"][key]
        kernel = name.split(":")[0]
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "per": per, "launches": summary18["totals_sp"].get(kernel, 0),
            "max_abs_err": worst[err], "ms": t_k, "plain_ms": t_p, "bound_ms": bound,
            "bound_by": by, "library_ms": t_l, "tuner_launches": 0, "cluster_launches": 0})
    print("kernels " + " ".join(
        f"{k['name']}: launches={k['launches']} tuner_launches={k['tuner_launches']} "
        f"cluster_launches={k['cluster_launches']} "
        f"max_abs_err={k['max_abs_err']:.3e} "
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
    c14 = summary14["clean"]
    tok_s = TRAIN_B * TRAIN_S / c14["median_ms"] * 1e3
    print(f"[7] 14 train step (gemma3-1b, B {TRAIN_B} x S {TRAIN_S}, bf16): median "
          f"{c14['median_ms']:.1f} ms after step 1, {tok_s:.0f} tokens/s, peak memory "
          f"{c14['peak'] / 1e9:.2f} GB; per step "
          + " ".join(f"{k}={v}" for k, v in train_plan(configs.get('gemma3-1b')).items())
          + f"; profiled step: hand kernels {summary14['profile']['hand_ms']:.1f} ms of "
          f"{summary14['profile']['kernel_ms']:.1f} ms kernel time")
    for arch, run in summary16["train"].items():
        B, S = next((b, s) for a, b, s in FAMILY_CLI + (FAMILY_DBRX,) if a == arch)
        med = _median([st[2] for st in run["steps"][1:]])
        print(f"[7] 16 train step ({arch}, B {B} x S {S}, bf16): median of steps 2-"
              f"{family_steps(arch)} {med:.1f} ms, {B * S / med * 1e3:.0f} tokens/s, peak memory "
              f"{run['peak'] / 1e9:.2f} GB; per step " + " ".join(
                  f"{k}={v}" for k, v in run["steps"][-1][3].items()))
    for label in ("dp", "zero3"):
        run = summary17[label]
        med = _median([st["ms"] for st in run["steps"][1:]])
        print(f"[7] 17 train step ({label}, gemma3-1b, B {TRAIN_B} x S {TRAIN_S}, bf16, world 1, "
              f"NCCL): median of steps 2-{PARALLEL_STEPS} {med:.1f} ms, "
              f"{TRAIN_B * TRAIN_S / med * 1e3:.0f} tokens/s, peak memory "
              f"{run['peak'] / 1e9:.2f} GB")
    card = card_line()
    for label, run in (("18a unsharded", summary18["18a"]["unsharded"]),
                       ("18a tp (1, 1), NCCL", summary18["18a"]["tp"]),
                       ("18a attn_seq (1, 1), NCCL", summary18["18a"]["sp"]),
                       *((f"18b tp (1, 2), gloo, rank {x['rank']}", x)
                         for x in summary18["18b"]),
                       *((f"18d attn_seq (1, 2), gloo, rank {r}", x)
                         for r, x in enumerate(summary18["18d"]))):
        print(f"[7] 18 train step ({label}, qwen3-14b 2 layers, B {TP_B} x S {TP_S}, bf16): "
              + _tp_line(label, run, card).split(": ", 1)[1].split("; per step")[0])
    print(f"total {time.monotonic() - t_start:.0f}s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
