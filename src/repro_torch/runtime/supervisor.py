"""Fault-tolerant training runtime (port of repro/runtime/supervisor.py).

  * every train step is a function of (params, opt_state, batch cursor);
    the job's state (params, opt, step) is checkpointed asynchronously
    every `ckpt_every` steps and at the end, with atomic commit;
  * the Supervisor runs the step loop under a retry harness: a failure
    (`simulate_failure_at` injects one, deterministically) restores the
    latest checkpoint and continues;
  * straggler watchdog: per-step wall times feed an EWMA; a step slower
    than `straggler_factor` x the EWMA after the first `start_grace` steps
    is counted and passed to `on_straggler`.

A step's wall time ends when its loss has been read on the host (the
reference's `jax.block_until_ready(loss)`), which waits for the step's
kernels.  `on_step(step, metrics, seconds)`, a port addition, is called
after every step with the step number just completed, so a caller can read
per-step numbers (the launch counters, memory) without the loop logging
them.

Over a process group (`layout`, a `parallel.fsdp.Layout`) every rank runs
the same loop: a checkpoint holds the whole leaves, gathered from the
ranks' pieces and written by rank 0 alone, and every rank waits for the
write at a barrier before it reads a checkpoint, so an injected failure
restarts every rank from the same step.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, Optional

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int
    ckpt_every: int = 50
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep_last: int = 3
    straggler_factor: float = 3.0
    max_restarts: int = 5
    log_every: int = 10


class Supervisor:
    def __init__(
        self,
        train_step: Callable,            # (params, opt, batch) -> (params, opt, metrics)
        data_at: Callable[[int], Any],   # cursor -> host batch
        loop_cfg: TrainLoopConfig,
        *,
        put_batch: Optional[Callable[[Any], Any]] = None,
        on_straggler: Optional[Callable[[int, float, float], None]] = None,
        simulate_failure_at: Optional[int] = None,
        on_step: Optional[Callable[[int, Dict[str, Any], float], None]] = None,
        layout=None,
    ):
        self.train_step = train_step
        self.data_at = data_at
        self.cfg = loop_cfg
        self.put_batch = put_batch or (lambda b: b)
        self.on_straggler = on_straggler
        self.on_step = on_step
        self.simulate_failure_at = simulate_failure_at
        self.layout = layout
        self.ckpt = AsyncCheckpointer(loop_cfg.ckpt_dir, keep_last=loop_cfg.keep_last)
        self.restarts = 0
        self.straggler_steps = 0
        self.metrics_log: list = []

    # -- state (de)hydration ---------------------------------------------------

    def _pack(self, params, opt_state, step: int):
        return {"params": params, "opt": opt_state, "step": int(step)}

    def restore(self, template_params, template_opt):
        """(params, opt_state, step) of the latest checkpoint, made like the
        templates on their device, or None without one."""
        step = latest_step(self.cfg.ckpt_dir)
        if step is None:
            return None
        pieces = None
        if self.layout is not None:
            pieces = self.layout.pieces(self.layout.state_dims(template_opt))
        tree = restore_checkpoint(self.cfg.ckpt_dir, step,
                                  self._pack(template_params, template_opt, 0), pieces=pieces)
        return tree["params"], tree["opt"], int(tree["step"])

    def _save(self, step: int, params, opt_state) -> None:
        tree = self._pack(params, opt_state, step)
        if self.layout is not None:
            tree = self.layout.gather_to_host(tree, self.layout.state_dims(opt_state))
        if tree is not None:
            self.ckpt.save(step, tree)

    def _wait(self) -> None:
        """The pending write done (on every rank, behind a barrier)."""
        try:
            self.ckpt.wait()
        finally:
            if self.layout is not None:
                self.layout.barrier()

    # -- the supervised loop ----------------------------------------------------

    def run(self, params, opt_state, start_step: int = 0) -> Dict[str, Any]:
        step = start_step
        ewma = None
        while step < self.cfg.total_steps:
            try:
                step, params, opt_state, ewma = self._run_span(params, opt_state, step, ewma)
            except _SimulatedFailure:
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise RuntimeError("restart budget exhausted")
                self._wait()
                restored = self.restore(params, opt_state)
                if restored is None:
                    step = start_step
                else:
                    params, opt_state, step = restored
                # do not re-fire the same simulated failure
                self.simulate_failure_at = None
        self._wait()
        return {
            "params": params,
            "opt_state": opt_state,
            "step": step,
            "restarts": self.restarts,
            "straggler_steps": self.straggler_steps,
            "metrics": self.metrics_log,
        }

    def _run_span(self, params, opt_state, step, ewma):
        while step < self.cfg.total_steps:
            if self.simulate_failure_at is not None and step == self.simulate_failure_at:
                raise _SimulatedFailure()
            batch = self.put_batch(self.data_at(step))
            t0 = time.perf_counter()
            params, opt_state, metrics = self.train_step(params, opt_state, batch)
            loss = float(metrics["loss"])     # waits for the step's kernels
            dt = time.perf_counter() - t0
            if ewma is None:
                ewma = dt
            if dt > self.cfg.straggler_factor * ewma and step > start_grace(step):
                self.straggler_steps += 1
                if self.on_straggler:
                    self.on_straggler(step, dt, ewma)
            ewma = 0.9 * ewma + 0.1 * dt
            step += 1
            if self.on_step:
                self.on_step(step, metrics, dt)
            if step % self.cfg.log_every == 0:
                self.metrics_log.append({"step": step, "loss": loss, "sec": dt})
            if step % self.cfg.ckpt_every == 0 or step == self.cfg.total_steps:
                self._save(step, params, opt_state)
        return step, params, opt_state, ewma


def start_grace(step: int) -> int:
    """First steps include warmup (kernel builds, allocator growth); exempt
    them from straggler counting."""
    return 2


class _SimulatedFailure(RuntimeError):
    pass
