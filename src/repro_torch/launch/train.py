"""Training launcher (port of repro/launch/train.py): the same flags, the
same step function, the same JSON summary, on one card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \
      --preset full --steps 8 --batch 4 --seq 1024           # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --preset smoke --steps 40 --batch 4 --seq 32 --lr 3e-3

Parameters come from `init_model` (seed 0), batches from
`SyntheticLMData` (the reference's numpy stream), the step from
`steps.make_train_step` (loss, backward through the hand kernels,
warmup-cosine lr, in-place AdamW), and the loop from `Supervisor`
(async checkpoints every `--ckpt-every` steps and at the end, `--fail-at`
injects one failure, after which the latest checkpoint is restored and
the run continues, `--resume` starts from the latest checkpoint).

Runs on the CUDA device unless `--device cpu` is given, and raises without
one.  Differences from the reference CLI: `--model-parallel` other than 1
raises (the parallel package is not ported: ROADMAP A.4); `--quant` is
parsed and read by nothing, as in the reference; `--resume` starts the
loop at the restored step; the default checkpoint directory lies under
the system's temporary directory.  `main(on_step=...)` sees every step
(its loss, its seconds); the returned metrics hold every 10th, as the
reference's do.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

from repro_torch import configs, resolve_device
from repro_torch.data import SyntheticLMData, to_device
from repro_torch.launch import steps as steps_lib
from repro_torch.models import model as M
from repro_torch.optim import adamw_init
from repro_torch.runtime import Supervisor, TrainLoopConfig


def preset_config(arch: str, preset: str):
    cfg = configs.get(arch)
    if preset == "full":
        return cfg
    if preset == "smoke":
        return configs.get_smoke(arch)
    if preset == "100m":
        # ~100M-param member of the same family (CPU-trainable).
        kw = dict(
            n_layers=8, d_model=512, n_heads=8,
            n_kv_heads=min(cfg.n_kv_heads, 4), head_dim=64,
            d_ff=2048 if cfg.d_ff else 0, vocab=min(cfg.vocab, 32768),
            group_size=1, dtype="float32",
        )
        if cfg.family == "hybrid":
            kw["attn_every"] = 4
            kw["group_size"] = 4
        if cfg.family == "ssm":
            kw["slstm_every"] = 4
            kw["group_size"] = 4
            kw["d_ff"] = 0
        if cfg.moe:
            kw["moe"] = dataclasses.replace(cfg.moe, num_experts=8, d_ff_expert=1024)
        if cfg.local_ratio:
            kw["group_size"] = cfg.local_ratio + 1
            kw["n_layers"] = 2 * (cfg.local_ratio + 1)
        if cfg.family == "encdec":
            kw["encoder_layers"] = 4
            kw["encoder_seq"] = 64
        if cfg.family == "vlm":
            kw["prefix_len"] = 16
        return dataclasses.replace(cfg, **kw)
    raise ValueError(preset)


def main(argv=None, *, on_step=None):
    """Parse `argv`, train, print the JSON summary and return the
    supervisor's result (params, opt_state, step, restarts,
    straggler_steps, metrics).  `on_step(step, metrics, seconds)` is
    called after every step (`Supervisor`)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b", choices=configs.list_archs())
    ap.add_argument("--preset", default="100m", choices=["smoke", "100m", "full"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure at this step (fault-tolerance demo)")
    ap.add_argument("--quant", default=None, choices=[None, "int8"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    if args.model_parallel != 1:
        raise NotImplementedError(
            f"--model-parallel {args.model_parallel}: the parallel package "
            f"(sharding, FSDP, pipeline) is not ported (ROADMAP A.4); train on one device")
    device = resolve_device(args.device)
    cfg = preset_config(args.arch, args.preset)
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M device={device}")

    params = M.init_model(cfg, seed=0, device=device)
    opt_cfg = steps_lib.optimizer_config(cfg)
    opt_state = adamw_init(params, opt_cfg)
    train_step = steps_lib.make_train_step(cfg, opt_cfg, base_lr=args.lr,
                                           total_steps=args.steps)
    extras = {}
    if cfg.family == "encdec":
        extras["frames"] = (cfg.encoder_seq, cfg.d_model)
    if cfg.family == "vlm":
        extras["patches"] = (cfg.prefix_len, M.VISION_DIM)
    data = SyntheticLMData(cfg.vocab, args.batch, args.seq, extras=extras)

    sup = Supervisor(
        train_step,
        data_at=data.batch_at,
        loop_cfg=TrainLoopConfig(
            total_steps=args.steps, ckpt_every=args.ckpt_every,
            ckpt_dir=args.ckpt_dir,
        ),
        put_batch=lambda b: to_device(b, device, non_blocking=True),
        simulate_failure_at=args.fail_at,
        on_step=on_step,
    )
    start = 0
    if args.resume:
        restored = sup.restore(params, opt_state)
        if restored:
            params, opt_state, start = restored
            print(f"resumed from step {start}")
    t0 = time.time()
    out = sup.run(params, opt_state, start_step=start)
    dt = time.time() - t0

    losses = [m["loss"] for m in out["metrics"]]
    print(json.dumps({
        "steps": out["step"], "restarts": out["restarts"],
        "straggler_steps": out["straggler_steps"],
        "first_loss": losses[0] if losses else None,
        "last_loss": losses[-1] if losses else None,
        "wall_s": round(dt, 1),
    }, indent=1))
    return out


if __name__ == "__main__":
    main()
