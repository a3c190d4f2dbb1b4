#!/usr/bin/env python3
"""Interleaved engine runs of two checkouts of this repository on one
NVIDIA GPU.

    python3 chip_pairs.py OTHER_DIR [--pairs 5]

OTHER_DIR is another checkout (for example the parent commit, unpacked with
`git archive`).  One worker process runs in each checkout, importing that
checkout's `src/repro_torch` (its kernels build there at first use).  Each
worker builds, per mode, the engine as that checkout serves it on the card
(`Engine(...)`, then `warmup()`): gemma3-1b at full width (26 layers,
bf16, random weights from seed 0), 8 slots, chunk 64, block 16, in float,
in w8a8 with an int8 KV pool and in calibrated w8a8 with an int8 KV pool.
A run serves chip_smoke.py phase 3's traffic (12 requests of 200-1100
prompt tokens and 32-64 new tokens) through `Engine.run()` and reports the
run's decode ms per step (`decode_time_s / decode_steps`), prefill ms per
chunk (`prefill_time_s / prefill_chunks`) and the requests' tokens.  The
two workers take turns, OTHER first in even pairs and this checkout first
in odd ones, and a pair is one run of each.

Prints the card's name and power limit, whether the tokens are equal in
every run, and per mode the median of each checkout's runs and the number
of pairs in which this checkout's run was faster; the last line is a JSON
summary.  Exits non-zero without a CUDA device, if a worker fails or if
the tokens differ.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MODES = {"float": "float", "w8a8": "int8", "w8a8-calibrated": "int8"}   # mode -> KV pool


def _median(v):
    v = sorted(v)
    return v[len(v) // 2]


def worker(root: Path) -> None:
    """Serve run requests on stdin, one JSON line each way."""
    proto, sys.stdout = sys.stdout, sys.stderr      # the protocol owns stdout
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import RequestSpec

    def reply(obj) -> None:
        proto.write(json.dumps(obj) + "\n")
        proto.flush()

    cfg = configs.get("gemma3-1b")
    rng = np.random.default_rng(0)
    plens = rng.integers(200, 1101, size=12)
    plens[:3] = (1100, 800, 513)
    max_new = rng.integers(32, 65, size=12)
    traffic = [(rng.integers(0, cfg.vocab, size=int(n)), int(m)) for n, m in zip(plens, max_new)]
    engines = {}
    for mode, kv in MODES.items():
        eng = Engine(cfg, M.init_model(cfg, seed=0, device="cuda"), slots=8, max_seq=1200,
                     block_size=16, max_chunk=64, precision=mode, kv_precision=kv,
                     device="cuda")
        eng.warmup()
        engines[mode] = eng
    torch.cuda.synchronize()
    reply({"ready": True})
    for line in sys.stdin:
        cmd = json.loads(line)
        if cmd.get("quit"):
            break
        eng = engines[cmd["mode"]]
        m = eng.metrics
        before = (m.decode_time_s, m.decode_steps, m.prefill_time_s, m.prefill_chunks)
        rids = [eng.submit(RequestSpec(prompt=p, max_new=n)).rid for p, n in traffic]
        t0 = time.perf_counter()
        results = eng.run()
        torch.cuda.synchronize()
        reply({"run_s": time.perf_counter() - t0,
               "decode_ms": (m.decode_time_s - before[0]) / (m.decode_steps - before[1]) * 1e3,
               "prefill_ms": (m.prefill_time_s - before[2]) / (m.prefill_chunks - before[3]) * 1e3,
               "tokens": [results[r].tolist() for r in rids]})


def _ask(proc, obj):
    proc.stdin.write(json.dumps(obj) + "\n")
    proc.stdin.flush()
    line = proc.stdout.readline()
    if not line:
        raise SystemExit(f"FAIL: a worker exited (code {proc.wait()})")
    return json.loads(line)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", nargs="?", help="the other checkout's root")
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--worker", metavar="ROOT", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(Path(args.worker))
        return 0
    if args.other is None:
        ap.error("give the other checkout's root")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    roots = {"other": Path(args.other).resolve(), "this": ROOT}
    procs = {}
    try:
        t0 = time.monotonic()
        for name, root in roots.items():
            procs[name] = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--worker", str(root)],
                cwd=root, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
                env=dict(os.environ, PYTHONPATH=str(root / "src")))
        for name, proc in procs.items():
            if not proc.stdout.readline():
                raise SystemExit(f"FAIL: the {name} worker exited (code {proc.wait()})")
        print(f"workers ready in {time.monotonic() - t0:.0f}s")
        summary = {"card": card, "pairs": args.pairs, "modes": {}}
        same = True
        for mode in MODES:
            runs = {"other": [], "this": []}
            for i in range(args.pairs):
                for name in (("other", "this") if i % 2 == 0 else ("this", "other")):
                    runs[name].append(_ask(procs[name], {"mode": mode}))
            equal = all(t["tokens"] == o["tokens"] for t, o in zip(runs["this"], runs["other"]))
            same &= equal
            res = {"tokens_equal": equal}
            for key in ("decode_ms", "prefill_ms"):
                res[key] = {n: {"median": _median([r[key] for r in v]),
                                "runs": [r[key] for r in v]} for n, v in runs.items()}
                res[key]["this_faster_pairs"] = sum(
                    t[key] < o[key] for t, o in zip(runs["this"], runs["other"]))
            summary["modes"][mode] = res
            print(f"{mode}: tokens {'equal' if equal else 'DIFFER'} in all {args.pairs} pairs "
                  f"({sum(map(len, runs['this'][0]['tokens']))} tokens a run); "
                  + "; ".join(f"{key[:-3]} step medians other {res[key]['other']['median']:.3f} "
                              f"ms, this {res[key]['this']['median']:.3f} ms, this faster in "
                              f"{res[key]['this_faster_pairs']} of {args.pairs} pairs"
                              for key in ("decode_ms", "prefill_ms")))
        for proc in procs.values():
            proc.stdin.write(json.dumps({"quit": True}) + "\n")
            proc.stdin.flush()
            proc.wait(timeout=120)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(json.dumps(summary))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
