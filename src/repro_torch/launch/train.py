"""Training launcher (port of repro/launch/train.py): the same flags, the
same step function, the same JSON summary, on one card or over a process
group.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \
      --preset full --steps 8 --batch 4 --seq 1024           # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --preset smoke --steps 40 --batch 4 --seq 32 --lr 3e-3
  PYTHONPATH=src python -m torch.distributed.run --standalone \
      --nproc-per-node 2 -m repro_torch.launch.train --device cpu \
      --preset smoke --steps 40 --batch 4 --seq 32          # two gloo ranks

Parameters come from `init_model` (seed 0), batches from
`SyntheticLMData` (the reference's numpy stream), the step from
`steps.make_train_step` (loss, backward through the hand kernels,
warmup-cosine lr, in-place AdamW), and the loop from `Supervisor`
(async checkpoints every `--ckpt-every` steps and at the end, `--fail-at`
injects one failure, after which the latest checkpoint is restored and
the run continues, `--resume` starts from the latest checkpoint).

The mesh and plan are the reference's: `make_local_mesh(--model-parallel)`
and `make_plan(mesh, param_count, force_fsdp=False)`, so an arch above
4e9 parameters trains head-parallel tensor parallelism over a model axis
> 1 (parallel/tensor.py) and a smaller one joins the model axis to the
batch axes.  Under torchrun
(`RANK`, `WORLD_SIZE`, `LOCAL_RANK` in the environment; the card is
`cuda:LOCAL_RANK`) the run joins a process group, NCCL for a CUDA device
and gloo for the CPU, and trains through `steps.make_sharded_train_step`:
each rank takes its rows of every batch (`data.rank_rows`), the
gradients are summed over the ranks, rank 0 writes the checkpoints and
alone prints the summary.  Without that environment the world is 1 and
there is no group.

Runs on the CUDA device unless `--device cpu` is given, and raises without
one.  Differences from the reference CLI: before any weight is made, a
plan the port does not execute raises (ROADMAP A.4c;
`parallel.fsdp.check_plan`): under a model axis an MoE arch, a family
other than the dense decoders, the GELU MLP, kv heads, d_ff or a vocab
the axis does not divide (the CLI's plans are head-parallel: like the
reference's CLI it passes `make_plan` no kv-head count, so it never takes
sequence-parallel attention, which `make_sharded_train_step` runs under a
plan that does); over a data axis > 1 an MoE arch; the plan's
parameters are whole over the data axes (`fsdp` is False), where the
reference's dp-mode specs shard them all the same; `--quant` is parsed
and read by nothing, as in the reference; `--resume` starts the loop at
the restored step; the default checkpoint directory lies under the
system's temporary directory.  `main(on_step=...)` sees every step (its
loss, its seconds); the returned metrics hold every 10th, as the
reference's do.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch import configs, resolve_device
from repro_torch.data import SyntheticLMData, rank_rows, to_device
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import MeshShape, backend_for, make_local_mesh
from repro_torch.models import model as M
from repro_torch.optim import adamw_init
from repro_torch.parallel import fsdp
from repro_torch.parallel.sharding import make_plan
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

    device = resolve_device(args.device)
    joined = "WORLD_SIZE" in os.environ and not dist.is_initialized()
    if joined:              # torchrun's ranks: one card each
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
            torch.cuda.set_device(device)
        dist.init_process_group(backend_for(device))
    try:
        return _train(args, device, on_step)
    finally:
        if joined:
            dist.destroy_process_group()


def _train(args, device, on_step):
    cfg = preset_config(args.arch, args.preset)
    mesh = MeshShape.of(make_local_mesh(args.model_parallel, device.type))
    plan = make_plan(mesh, cfg.param_count(), force_fsdp=False)
    fsdp.check_plan(cfg, mesh, plan)
    group = dist.is_initialized()
    rank = dist.get_rank() if group else 0
    if rank == 0:
        print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M device={device} "
              f"mesh={mesh.shape} mode={'dp' if plan.model_axis is None else 'tp'}")

    params = M.init_model(cfg, seed=0, device=device)
    opt_cfg = steps_lib.optimizer_config(cfg)
    layout = None
    if group:
        train_step = steps_lib.make_sharded_train_step(cfg, opt_cfg, mesh, plan,
                                                       base_lr=args.lr, total_steps=args.steps)
        layout = train_step.layout
        params = layout.shard(params)
    else:
        train_step = steps_lib.make_train_step(cfg, opt_cfg, base_lr=args.lr,
                                               total_steps=args.steps)
    opt_state = adamw_init(params, opt_cfg)
    extras = {}
    if cfg.family == "encdec":
        extras["frames"] = (cfg.encoder_seq, cfg.d_model)
    if cfg.family == "vlm":
        extras["patches"] = (cfg.prefix_len, M.VISION_DIM)
    data = SyntheticLMData(cfg.vocab, args.batch, args.seq, extras=extras)
    data_at = data.batch_at if not group else \
        (lambda cursor: rank_rows(data.batch_at(cursor), mesh, plan, rank))

    sup = Supervisor(
        train_step,
        data_at=data_at,
        loop_cfg=TrainLoopConfig(
            total_steps=args.steps, ckpt_every=args.ckpt_every,
            ckpt_dir=args.ckpt_dir,
        ),
        put_batch=lambda b: to_device(b, device, non_blocking=True),
        simulate_failure_at=args.fail_at,
        on_step=on_step,
        layout=layout,
    )
    start = 0
    if args.resume:
        restored = sup.restore(params, opt_state)
        if restored:
            params, opt_state, start = restored
            if rank == 0:
                print(f"resumed from step {start}")
    t0 = time.time()
    out = sup.run(params, opt_state, start_step=start)
    dt = time.time() - t0

    losses = [m["loss"] for m in out["metrics"]]
    if rank == 0:
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
