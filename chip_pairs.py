#!/usr/bin/env python3
"""Interleaved decode-step times of two checkouts of this repository on one
NVIDIA GPU.

    python3 chip_pairs.py OTHER_DIR [--pairs 12] [--steps 5]

OTHER_DIR is another checkout (for example the parent commit, unpacked with
`git archive`).  One worker process runs in each checkout, importing that
checkout's `src/repro_torch` (its kernels build there at first use).  Each
worker serves gemma3-1b at full width (26 layers, bf16, random weights from
seed 0) with chip_smoke.py phase 3b's engine and traffic (8 slots, 12
requests of 200-1100 prompt tokens, chunk 64, block 16) in w8a8 and in
calibrated w8a8, both with an int8 KV pool, and reports the requests'
tokens and the PyTorch ops, allocations and hand-kernel launches of one
decode step.  Then the two workers take turns, OTHER first in even pairs
and this checkout first in odd ones, each timing `--steps` decode steps
(all slots active, the state not advanced; host clock around a step that
ends in a device sync), and a pair is one turn of each.

Prints the card's name and power limit, whether the tokens are equal, the
op counts, and per mode the median wall and host ms per step of each
checkout over all turns and the number of pairs in which this checkout's
turn was faster; the last line is a JSON summary.  Exits non-zero without
a CUDA device or if a worker fails.
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
MODES = ("w8a8", "w8a8-calibrated")


def _median(v):
    v = sorted(v)
    return v[len(v) // 2]


def worker(root: Path) -> None:
    """Serve requests on stdin, one JSON line each way."""
    proto, sys.stdout = sys.stdout, sys.stderr      # the protocol owns stdout
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch import configs, quant
    from repro_torch.kernels import flash_attention, flash_decode, gemm, gemm_int8
    from repro_torch.kernels import gemm_pipelined
    from repro_torch.kernels import quant as kquant
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import RequestSpec

    mods = (gemm, gemm_int8, gemm_pipelined, kquant, flash_decode, flash_attention)

    def kernel_launches() -> int:
        return sum(v for m in mods for k, v in vars(m).items()
                   if "launches" in k and type(v) is int)

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = self.empty = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops += 1
            self.empty += func.overloadpacket.__name__ == "empty"
            return func(*args, **(kwargs or {}))

    def reply(obj) -> None:
        proto.write(json.dumps(obj) + "\n")
        proto.flush()

    cfg = configs.get("gemma3-1b")
    params = M.init_model(cfg, seed=0, device="cuda")
    engines, tokens, counts = {}, {}, {}
    for mode in MODES:
        eng = Engine(cfg, params, slots=8, max_seq=1200, block_size=16, max_chunk=64,
                     precision=mode, kv_precision="int8", device="cuda")
        eng.warmup()
        rng = np.random.default_rng(0)
        plens = rng.integers(200, 1101, size=12)
        plens[:3] = (1100, 800, 513)
        max_new = rng.integers(32, 65, size=12)
        for n, m in zip(plens, max_new):
            eng.submit(RequestSpec(prompt=rng.integers(0, cfg.vocab, size=int(n)),
                                   max_new=int(m)))
        results = eng.run()
        tokens[mode] = [results[r].tolist() for r in sorted(results)]
        step = (torch.zeros((eng.slots, 1), dtype=torch.int64, device="cuda"),
                torch.ones((eng.slots,), dtype=torch.bool, device="cuda"))
        k0 = kernel_launches()
        with torch.no_grad(), quant.precision(eng.precision), Count() as c:
            M.paged_decode_step(eng.params, eng.cfg, eng.state, *step)
        torch.cuda.synchronize()
        counts[mode] = {"ops": c.ops, "allocations": c.empty,
                        "kernel_launches": kernel_launches() - k0}
        engines[mode] = (eng, step)
    del params
    reply({"ready": True, "tokens": tokens, "counts": counts})
    for line in sys.stdin:
        cmd = json.loads(line)
        if cmd.get("quit"):
            break
        eng, step = engines[cmd["mode"]]
        wall, host = [], []
        with torch.no_grad(), quant.precision(eng.precision):
            for _ in range(cmd["steps"]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                M.paged_decode_step(eng.params, eng.cfg, eng.state, *step)
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                wall.append((time.perf_counter() - t0) * 1e3)
                host.append((t1 - t0) * 1e3)
        reply({"wall_ms": _median(wall), "host_ms": _median(host)})


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
    ap.add_argument("--pairs", type=int, default=12)
    ap.add_argument("--steps", type=int, default=5)
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
        ready = {}
        for name, proc in procs.items():
            line = proc.stdout.readline()
            if not line:
                raise SystemExit(f"FAIL: the {name} worker exited (code {proc.wait()})")
            ready[name] = json.loads(line)
        print(f"workers ready in {time.monotonic() - t0:.0f}s")
        same = {m: ready["this"]["tokens"][m] == ready["other"]["tokens"][m] for m in MODES}
        for m in MODES:
            print(f"{m}: the 12 requests' tokens {'equal' if same[m] else 'DIFFER'} "
                  f"({sum(map(len, ready['this']['tokens'][m]))} tokens); one decode step: "
                  + ", ".join(f"{n} {ready[n]['counts'][m]}" for n in ("other", "this")))
        summary = {"card": card, "tokens_equal": same,
                   "counts": {n: ready[n]["counts"] for n in roots}, "modes": {}}
        for m in MODES:
            turns = {"other": [], "this": []}
            for i in range(args.pairs):
                for name in (("other", "this") if i % 2 == 0 else ("this", "other")):
                    turns[name].append(_ask(procs[name], {"mode": m, "steps": args.steps}))
            faster = sum(t["wall_ms"] < o["wall_ms"] for t, o in zip(turns["this"], turns["other"]))
            res = {n: {"wall_ms": _median([t["wall_ms"] for t in v]),
                       "host_ms": _median([t["host_ms"] for t in v]),
                       "wall_ms_turns": [t["wall_ms"] for t in v]} for n, v in turns.items()}
            res["this_faster_pairs"] = faster
            summary["modes"][m] = res
            print(f"{m} decode step, {args.pairs} pairs of {args.steps} steps (median of "
                  f"turn medians): other wall {res['other']['wall_ms']:.2f} ms host "
                  f"{res['other']['host_ms']:.2f} ms; this wall {res['this']['wall_ms']:.2f} ms "
                  f"host {res['this']['host_ms']:.2f} ms; this faster in {faster} of "
                  f"{args.pairs} pairs")
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
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
