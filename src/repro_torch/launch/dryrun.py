"""One-card dry run: build every (arch x shape) cell's step on the meta
device, run it through the counting mode and record what it would hold
and cost on one H100 (port of repro/launch/dryrun.py).

The reference lowers and compiles each cell for a TPU mesh without running
it.  Here the step runs eagerly on meta tensors (launch/steps.py's structs;
nothing is allocated or computed), so the cell's row holds the roofline
terms of `launch/roofline.py` from `launch/step_cost.py`'s counts and the
bytes a card would hold: the weights, the optimizer state (train), the
decode state (decode), and the traced peak of the step's own storages
(activations, gradients, temporaries), against 80 GB, with a `fits` flag.
The mesh is one card, unsharded ("single"); `run_cell(..., "multi")`
raises: the multi-card dry run (the production mesh's plans over the
cards' interconnect) is ROADMAP A.4c, so the CLI has no --mesh.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k
  python -m repro_torch.launch.dryrun --all --out dryrun_out
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Dict, Iterable, Tuple

import torch

from repro_torch import configs
from repro_torch import tree as tree_lib
from repro_torch.core import hw
from repro_torch.launch import roofline as rl
from repro_torch.launch import step_cost
from repro_torch.launch import steps as steps_lib


def storage_bytes(tensors: Iterable) -> int:
    """Bytes of the distinct storages under `tensors` (a row-padded matrix
    counts its padding; views of one storage count once)."""
    seen, total = set(), 0
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            continue
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            total += st.nbytes()
    return total


def trace_cell(cfg, shape: dict, opt_cfg=None) -> Tuple[step_cost.StepCost, Dict[str, int]]:
    """Count one cell's step on the meta device: (its StepCost, the bytes
    resident beside it: "weights", "opt_state", "decode_state", "inputs").
    A train cell's optimizer is `opt_cfg`, by default `cfg`'s own."""
    kind, B = shape["kind"], shape["global_batch"]
    params = steps_lib.params_struct(cfg)
    specs = steps_lib.input_specs(cfg, shape)
    held = {"weights": storage_bytes(tree_lib.leaves(params)), "opt_state": 0,
            "decode_state": 0,
            "inputs": storage_bytes(tree_lib.leaves(specs.get("batch", {}))
                                    + ([specs["tokens"]] if "tokens" in specs else []))}
    if kind == "train":
        opt_cfg = opt_cfg or steps_lib.optimizer_config(cfg)
        opt = steps_lib.opt_state_struct(cfg, params, opt_cfg)
        held["opt_state"] = storage_bytes(tree_lib.leaves(opt))
        return step_cost.analyze(steps_lib.make_train_step(cfg, opt_cfg), params, opt,
                                 specs["batch"]), held
    with torch.no_grad():
        if kind == "prefill":
            return step_cost.analyze(steps_lib.make_prefill_step(cfg), params,
                                     specs["batch"]), held
        state = steps_lib.decode_state_struct(cfg, params, B, specs["max_seq"])
        held["decode_state"] = storage_bytes(tree_lib.leaves(
            [state.caches, state.cross_caches or [], state.index]))
        return step_cost.analyze(steps_lib.make_serve_step(cfg), params, state,
                                 specs["tokens"]), held


def run_cell(arch: str, shape_name: str, mesh_kind: str = "single", verbose: bool = True,
             cfg=None) -> dict:
    """The cell's row (module docstring).  `cfg` overrides the arch's
    published config (a smoke config, in the tests)."""
    if mesh_kind != "single":
        raise NotImplementedError(
            f"mesh {mesh_kind!r}: the port's dry run is one card's; the multi-card dry "
            f"run (the parallel plans over the cards' interconnect) is ROADMAP A.4c")
    cfg = cfg or configs.get(arch)
    shape = configs.SHAPES[shape_name]
    t0 = time.time()
    cost, held = trace_cell(cfg, shape)
    peak = sum(held.values()) + cost.peak_live_bytes
    roof = rl.analyze(arch=arch, shape_name=shape_name, shape=shape, cfg=cfg, cost=cost,
                      mesh_name=mesh_kind, peak_memory_bytes=float(peak))
    row = roof.row()
    row.update(
        weight_bytes=held["weights"], opt_state_bytes=held["opt_state"],
        decode_state_bytes=held["decode_state"], input_bytes=held["inputs"],
        activation_peak_bytes=cost.peak_live_bytes, device_bytes=hw.DEVICE_BYTES,
        fits=peak <= hw.DEVICE_BYTES, launches=dict(cost.launches),
        trace_s=time.time() - t0,
    )
    if verbose:
        print(f"== {arch} x {shape_name} x {mesh_kind} (1 H100) ==")
        print(f"  weights {held['weights'] / 1e9:.2f} GB, optimizer state "
              f"{held['opt_state'] / 1e9:.2f} GB, decode state {held['decode_state'] / 1e9:.2f} "
              f"GB, activations (traced peak) {cost.peak_live_bytes / 1e9:.2f} GB -> "
              f"{peak / 1e9:.2f} GB of {hw.DEVICE_BYTES / 1e9:.0f}: "
              f"{'fits' if row['fits'] else 'does not fit'}")
        print(f"  roofline: compute {roof.compute_s * 1e3:.2f}ms memory "
              f"{roof.memory_s * 1e3:.2f}ms collective {roof.collective_s * 1e3:.2f}ms -> "
              f"{roof.bound}-bound, MFU {roof.mfu * 100:.1f}%, useful/counted "
              f"{roof.useful_flops_ratio:.2f} (traced in {row['trace_s']:.1f}s)")
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None, help="directory for per-cell JSON")
    args = ap.parse_args(argv)

    if args.all:
        cells = [
            (a, s) for a in configs.list_archs()
            if a not in ("bert-base", "vit-b-16")
            for s in configs.shapes_for(a)
        ]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    failures = []
    for arch, shape in cells:
        fn = os.path.join(args.out, f"{arch}__{shape}__single.json") if args.out else None
        if fn and os.path.exists(fn):
            print(f"skip (done): {arch} x {shape} x single")
            continue
        try:
            res = run_cell(arch, shape)
            if fn:
                os.makedirs(args.out, exist_ok=True)
                with open(fn, "w") as f:
                    json.dump(res, f, indent=1, default=str)
        except Exception as e:
            traceback.print_exc()
            failures.append((arch, shape, repr(e)))
    if failures:
        print("FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print(f"dry-run OK: {len(cells)} cells on one card")


if __name__ == "__main__":
    main()
