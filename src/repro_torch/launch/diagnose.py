"""Where a step's work goes, by source (port of repro/launch/diagnose.py).

The reference groups a step's collective bytes by the `op_name` that JAX's
trace writes into the HLO.  The port groups a step's work by the source
that ran it, with no annotation in the model code:

  * a hand kernel by its name ("kernel:gemm", "kernel:flash_attention_bwd");
  * a PyTorch op by the innermost frame of src/repro_torch on its Python
    stack ("models/layers.py:rms_norm", "optim/adamw.py:adamw_update");
  * an op of the backward, which the autograd engine runs with no frame of
    the model on its stack, by the forward op it differentiates, tied
    through the autograd sequence number ("backward of
    models/layers.py:rms_norm"); a Function's own backward and a
    checkpointed group's recompute keep their frames.

`attribute` takes either a `step_cost.StepCost` (FLOPs and bytes by
source, counted on any device, the meta device included) or a profile
that `profile_step` took: device time by source when it holds the card's
kernels, else the CPU ops' own time.  The profiler's own `with_stack`
record is not read: it is slow, and torch 2.11+cu128 on the H100 recorded
no frames in it.  Instead `profile_step` runs the step under
`step_cost.LabelMode`, which puts each op inside a `record_function`
named after its source, found from the Python stack as the op dispatches.
A kernel belongs to the op whose runtime call launched it (the two share
the CUPTI correlation id); a hand kernel is named by its own name.  A
CUDA-graph replay has no host ranges, so profile the eager step, which
launches the same kernels.  Profile in a process of its own:
`chip_smoke.py` found that torch.profiler recorded no device events once
earlier work had run in the same process.

  PYTHONPATH=src python -m repro_torch.launch.diagnose --arch qwen3-14b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.diagnose --arch gemma3-1b --profile train
"""

from __future__ import annotations

import argparse
import dataclasses
import re
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.launch import step_cost as sc

# Substrings of the hand kernels' device names -> the kernel (csrc/).
HAND_KERNELS = {
    "gemm_kernel": "gemm", "s8_kernel": "gemm_int8", "pipelined_kernel": "gemm_pipelined",
    "decode_split_kernel": "flash_decode", "decode_combine_kernel": "flash_decode",
    "quant_rows_kernel": "quantize_rows", "flash_kernel": "flash_attention",
    "mma_kernel": "flash_attention", "delta_kernel": "flash_attention_bwd",
    "dkdv_wgmma": "flash_attention_bwd", "dq_wgmma": "flash_attention_bwd",
    "dkdv_simt": "flash_attention_bwd", "dq_simt": "flash_attention_bwd",
}


def hand_kernel(name: str) -> Optional[str]:
    for frag, kernel in HAND_KERNELS.items():
        if frag in name:
            return kernel
    return None


@dataclasses.dataclass
class Attribution:
    """`rows`: (source, value, share of the total) by value, the top ones;
    `unattributed`: the share no source names; `metric`: what value is
    ("bytes", "device_ms" or "cpu_ms"); `flops`: FLOPs by source (a
    StepCost's)."""

    metric: str
    total: float
    rows: List[Tuple[str, float, float]]
    unattributed: float
    by_source: Dict[str, float]
    flops: Dict[str, float] = dataclasses.field(default_factory=dict)
    kernels: int = 0

    def table(self) -> str:
        unit = {"bytes": 1e9, "device_ms": 1.0, "cpu_ms": 1.0}[self.metric]
        name = {"bytes": "GB", "device_ms": "ms", "cpu_ms": "ms (CPU)"}[self.metric]
        lines = [f"  {'source':<58} {name:>12} {'share':>7}"
                 + ("  TFLOP" if self.flops else "")]
        for src, v, share in self.rows:
            extra = f"  {self.flops.get(src, 0.0) / 1e12:6.3f}" if self.flops else ""
            lines.append(f"  {src[:58]:<58} {v / unit:12.4f} {share:7.2%}{extra}")
        lines.append(f"  total {self.total / unit:.4f} {name}; unattributed "
                     f"{self.unattributed:.2%}")
        return "\n".join(lines)


def _finish(metric: str, by_source: Dict[str, float], top: int, flops=None,
            kernels: int = 0) -> Attribution:
    total = sum(by_source.values())
    rows = [(k, v, v / total if total else 0.0)
            for k, v in sorted(by_source.items(), key=lambda kv: -kv[1])[:top]]
    un = by_source.get(sc.UNATTRIBUTED, 0.0) / total if total else 0.0
    return Attribution(metric, total, rows, un, dict(by_source), dict(flops or {}), kernels)


def _label(e) -> Optional[str]:
    """The source named by the `step_cost.LabelMode` annotation at or above `e`."""
    while e is not None:
        if e.name.startswith(sc.LABEL):
            return e.name[len(sc.LABEL):]
        e = e.cpu_parent
    return None


def _is_runtime(e) -> bool:
    """A CUDA runtime or driver call (cudaLaunchKernel, cuLaunchKernelEx...)."""
    return e.name.startswith("cuda") or re.match(r"^cu[A-Z]", e.name) is not None


def _cpu_ms(cpu) -> Dict[str, float]:
    """CPU ms by source: each annotated op's whole time under its label, and
    the own time of every op that ran outside the mode as unattributed.  The
    time of what only wraps annotated ops (the mode's own dispatch, an
    autograd node, a Function's Python) is the tools' and the engine's, and
    is not counted."""
    wraps = set()
    for e in cpu:
        if e.name.startswith(sc.LABEL):
            p = e.cpu_parent
            while p is not None and id(p) not in wraps:
                wraps.add(id(p))
                p = p.cpu_parent
    by: Dict[str, float] = {}
    for e in cpu:
        if e.name.startswith(sc.LABEL):
            if _label(e.cpu_parent) is None:
                src = e.name[len(sc.LABEL):]
                by[src] = by.get(src, 0.0) + e.cpu_time_total / 1e3
        elif e.name.startswith("aten::") and id(e) not in wraps and _label(e) is None:
            by[sc.UNATTRIBUTED] = by.get(sc.UNATTRIBUTED, 0.0) + e.self_cpu_time_total / 1e3
    return by


def attribute(source, top: int = 15) -> Attribution:
    """Work by source (module docstring) of a StepCost (bytes, with FLOPs
    beside) or a `profile_step` profile (device time of the card's kernels,
    else the CPU ops' time)."""
    if isinstance(source, sc.StepCost):
        return _finish("bytes", source.bytes_by_source, top, source.flops_by_source,
                       sum(source.launches.values()))
    from torch.autograd import DeviceType

    events = source.events() if hasattr(source, "events") else source
    cpu = [e for e in events if e.device_type == DeviceType.CPU and not e.is_async]
    # Kineto also lays each annotation over the kernels it encloses as a
    # device range of its own name: a span, not a kernel.
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not (e.name.startswith(sc.LABEL) or getattr(e, "is_user_annotation", False))]
    if not device:
        return _finish("cpu_ms", _cpu_ms(cpu), top)
    # A kernel and the runtime call that launched it share the CUPTI
    # correlation id; the call sits inside the op that made it.
    runtime = {e.id: e for e in cpu if _is_runtime(e)}
    by: Dict[str, float] = {}
    for d in device:
        kernel = hand_kernel(d.name)
        src = sc.kernel_source(kernel) if kernel is not None else (
            _label(runtime[d.id]) if d.id in runtime else None)
        src = src or sc.UNATTRIBUTED
        by[src] = by.get(src, 0.0) + d.time_range.elapsed_us() / 1e3
    return _finish("device_ms", by, top, kernels=len(device))


# -- the CLI ---------------------------------------------------------------------


def _train_inputs(cfg, device, batch: int, seq: int, seed: int = 0):
    import torch

    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.optim import adamw_init

    params = M.init_model(cfg, seed=seed, device=device)
    opt_cfg = steps.optimizer_config(cfg)
    opt = adamw_init(params, opt_cfg)
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (batch, seq + 1), generator=g)
    data = {"tokens": tokens[:, :-1].to(device), "labels": tokens[:, 1:].to(device)}
    return steps.make_train_step(cfg, opt_cfg), params, opt, data


def profile_step(fn, *args, reps: int = 1):
    """torch.profiler over `reps` calls of fn(*args), after one call to
    warm it up, each op under its source's annotation
    (`step_cost.LabelMode`); the card's kernels too when it has one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    fn(*args)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    with profile(activities=acts) as prof, sc.LabelMode():
        for _ in range(reps):
            fn(*args)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    return prof


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None, help="a dry-run cell, counted on the meta device")
    ap.add_argument("--profile", choices=["train", "decode"], default=None,
                    help="measure one eager step with torch.profiler (on the card)")
    ap.add_argument("--preset", choices=["full", "smoke"], default="full")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    import torch

    from repro_torch import configs, resolve_device

    cfg = configs.get(args.arch) if args.preset == "full" else configs.get_smoke(args.arch)
    if args.shape:
        from repro_torch.launch import dryrun

        cost, _ = dryrun.trace_cell(cfg, configs.SHAPES[args.shape])
        print(f"top sources of {args.arch} x {args.shape} (counted on the meta device):")
        print(attribute(cost, args.top).table())
        return
    if not args.profile:
        ap.error("--shape or --profile")
    device = resolve_device(args.device)
    t0 = time.time()
    if args.profile == "train":
        step, params, opt, data = _train_inputs(cfg, device, args.batch, args.seq)
        prof = profile_step(step, params, opt, data)
    else:
        from repro_torch.models import model as M

        params = M.init_model(cfg, device=device)
        state = M.init_decode_state(params, cfg, args.batch, args.seq)
        tokens = torch.zeros((args.batch, 1), dtype=torch.long, device=device)
        with torch.no_grad():
            prof = profile_step(lambda: M.decode_step(params, cfg, state, tokens))
    att = attribute(prof, args.top)
    print(f"top sources of one {args.arch} {args.profile} step ({att.metric}, profiled in "
          f"{time.time() - t0:.1f}s):")
    print(att.table())


if __name__ == "__main__":
    main()
