"""Serving launcher: thin CLI over the port's engine (port of the
single-engine path of repro/launch/serve.py).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b --requests 8
  PYTHONPATH=src python -m repro_torch.launch.serve --precision w8a8 --kv-precision int8
  PYTHONPATH=src python -m repro_torch.launch.serve --precision w8a8-calibrated
  PYTHONPATH=src python -m repro_torch.launch.serve --widths published   # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b --widths published

`--arch` takes any arch of the dense family the port registers
(`configs.list_archs()`): qwen3-14b, mistral-nemo-12b, qwen2.5-14b,
gemma3-1b (the default), bert-base and vit-b-16.

Runs on the CUDA device unless `--device cpu` is given; there the engine
serves through the CUDA graphs its warmup captures.  The prompts are
drawn exactly as the reference CLI draws them (np.random.default_rng(0)),
so with the same weights both print the same tokens.  The model is the
arch's smoke config, as in the reference CLI, or with `--widths
published` the arch at its published widths.  The card needs the latter:
the smoke config's head_dim of 16 is below the decode kernel's smallest
(64).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import configs
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import RequestSpec


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
    args = ap.parse_args(argv)

    cfg = configs.get_smoke(args.arch) if args.widths == "smoke" else configs.get(args.arch)
    slots = args.slots or args.requests
    max_seq = args.prompt_len + args.gen_len + 1
    eng = Engine(cfg, params, slots=slots, max_seq=max_seq,
                 block_size=args.block_size, num_blocks=args.kv_blocks or None,
                 max_chunk=args.chunk, precision=args.precision,
                 kv_precision=args.kv_precision, device=args.device, verbose=True)
    t0 = time.time()
    eng.warmup()
    t_warm = time.time() - t0

    rng = np.random.default_rng(0)
    prompts = [
        rng.integers(0, cfg.vocab, size=rng.integers(4, args.prompt_len + 1))
        for _ in range(args.requests)
    ]
    for p in prompts:
        eng.submit(RequestSpec(prompt=p, max_new=args.gen_len))
    t0 = time.time()
    results = eng.run()
    t_serve = time.time() - t0

    gen = np.stack([results[rid] for rid in sorted(results)])
    print(f"arch={cfg.name} slots={slots} precision={args.precision} "
          f"kv={args.kv_precision} device={eng.device} "
          f"warmup {t_warm * 1e3:.0f}ms serve {t_serve * 1e3:.0f}ms")
    print(f"engine: {eng.metrics.summary()}")
    print("sample continuations:", gen[:2, :8].tolist())
    return gen


if __name__ == "__main__":
    main()
