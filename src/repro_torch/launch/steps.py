"""The train steps (port of repro/launch/steps.py: `optimizer_config`,
`make_train_step`, and over a process group `make_sharded_train_step`),
the unpaged serve step (`make_serve_step`) and its CUDA graph.

The reference jits `make_train_step`: `jax.value_and_grad(M.loss_fn)`,
the warmup-cosine learning rate at the optimizer's count, then AdamW.  The
port's step runs the same three eagerly: the loss, `torch.autograd.grad`
over every parameter leaf (through the hand kernels' Functions: K1 for
every projection and the tied head, K5 / K5b for attention), then the
in-place `adamw_update`.  A CUDA graph of the whole step is later work.
`make_sharded_train_step` is the same step over a process group (data
parallelism, ZeRO-3 and tensor parallelism, head-parallel or with
sequence-parallel attention: parallel/fsdp.py, parallel/tensor.py).

The dry run's step builders and shape structs (`make_prefill_step`,
`params_struct`, `opt_state_struct`, `decode_state_struct`,
`input_specs`) build on the "meta" device, where the reference uses
`jax.eval_shape` and `ShapeDtypeStruct`s: a cell of hundreds of billions
of parameters allocates nothing, and the steps run on those tensors
through the kernels' meta routes (launch/step_cost.py).

The reference jits `make_serve_step(cfg)`; the port's counterpart on the
card is one CUDA graph of the step over one `DecodeState`
(`GraphedServeStep`): the step writes the dense caches and the recurrent
states in place and advances the device-held index, so every replay reads
and writes the same addresses.  The cross caches are fixed per batch, so a
graph serves one (batch, max_seq) and one batch of encoder frames.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch import tree as tree_lib
from repro_torch.kernels import launches
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, warmup_cosine


def optimizer_config(cfg: ArchConfig) -> AdamWConfig:
    # Sub-fp32 moments for models whose fp32 state would not fit device memory.
    big = cfg.param_count() > 8e9
    return AdamWConfig(state_dtype="bfloat16" if big else "float32")


def make_train_step(cfg: ArchConfig, opt_cfg: Optional[AdamWConfig] = None,
                    base_lr: float = 3e-4, total_steps: int = 100_000):
    """train_step(params, opt_state, batch) -> (params, opt_state, {"loss",
    "lr"}): the parameters and moments update in place (optim/adamw.py),
    `opt_state["count"]` advances.  Every parameter leaf is marked as
    requiring a gradient at the step's first call on it; a leaf the loss
    does not reach gets a zero gradient, as `jax.value_and_grad` gives."""
    opt_cfg = opt_cfg or optimizer_config(cfg)
    sched = warmup_cosine(base_lr, warmup=min(2000, total_steps // 10), total=total_steps)

    def train_step(params, opt_state, batch):
        leaves = tree_lib.leaves(params)
        for p in leaves:
            if not p.requires_grad:
                p.requires_grad_(True)
        with torch.enable_grad():
            loss = M.loss_fn(params, cfg, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        lr = sched(opt_state["count"])
        params, opt_state = adamw_update(grads, opt_state, params, lr, opt_cfg)
        return params, opt_state, {"loss": loss.detach(), "lr": lr}

    return train_step


class ShardedTrainStep:
    """`make_sharded_train_step`'s step: `make_train_step`'s over a
    rank's pieces (parallel/fsdp.py).  Call it as the unsharded step,
    with this rank's pieces (`self.layout.shard(params)`), AdamW state
    made on them, and this rank's rows (`data.rank_rows`); the returned
    loss is the whole batch's, on every rank, beside the step's
    collectives by kind (calls and bytes).  With `rank` and no process
    group it is that rank's step traced on the "meta" device
    (`launch.step_cost.analyze`): its collectives are counted, not run."""

    def __init__(self, cfg: ArchConfig, opt_cfg: Optional[AdamWConfig], mesh, plan, *,
                 base_lr: float = 3e-4, total_steps: int = 100_000,
                 rank: Optional[int] = None, seq_len: Optional[int] = None):
        from repro_torch.launch.mesh import MeshShape
        from repro_torch.parallel import fsdp

        self.cfg = cfg
        self.opt_cfg = opt_cfg or optimizer_config(cfg)
        fsdp.check_plan(cfg, mesh, plan, seq_len=seq_len)
        self.mesh, self.plan = MeshShape.of(mesh), plan
        self.layout = fsdp.Layout(params_struct(cfg), mesh, plan, rank=rank,
                                  int8_moments=self.opt_cfg.state_dtype == "int8")
        self.sched = warmup_cosine(base_lr, warmup=min(2000, total_steps // 10),
                                   total=total_steps)

    def gradients(self, params, batch):
        """(this rank's part of the loss, the gradient of each leaf of this
        rank's pieces, summed over the ranks: `Layout.reduce`) over this
        rank's rows.  Under sequence-parallel attention each model rank
        takes the whole sequence of its rows' tokens, labels and mask: its
        embedding lookup keeps its chunk of the positions
        (`parallel.tensor.vocab_embed`), and the loss runs over the whole
        sequence after the head's gather."""
        from repro_torch.parallel import tensor
        from repro_torch.parallel.logical import use_rules

        layout = self.layout
        whole = layout.gather(tree_lib.leaves(params))
        labels, mask = batch["labels"], batch.get("mask")
        count = (torch.sum(mask.to(torch.float32)) if mask is not None else
                 torch.full((), float(labels.numel()), device=labels.device))
        count = layout.all_reduce(count)        # over the batch axes: model ranks share rows
        with torch.enable_grad(), use_rules(self.mesh, self.plan.activation_rules()), \
                tensor.use_model_axis(layout.model):
            loss = M.loss_fn(tree_lib.unflatten(params, whole), self.cfg, batch,
                             denominator=count)
            grads = torch.autograd.grad(loss, whole, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(whole, grads)]
        return loss.detach(), layout.reduce(grads)

    def __call__(self, params, opt_state, batch):
        layout = self.layout
        layout.collectives.clear()
        layout.collective_bytes.clear()
        loss, grads = self.gradients(params, batch)
        lr = self.sched(opt_state["count"])
        params, opt_state = adamw_update(grads, opt_state, params, lr, self.opt_cfg,
                                         norm_reduce=layout.norm_reduce)
        loss = layout.all_reduce(loss)
        return params, opt_state, {"loss": loss, "lr": lr,
                                   "collectives": dict(layout.collectives),
                                   "collective_bytes": dict(layout.collective_bytes)}


def make_sharded_train_step(cfg: ArchConfig, opt_cfg: Optional[AdamWConfig], mesh, plan, *,
                            base_lr: float = 3e-4, total_steps: int = 100_000,
                            rank: Optional[int] = None,
                            seq_len: Optional[int] = None) -> ShardedTrainStep:
    """The train step under `plan` over `mesh` and the running process
    group: data parallelism, ZeRO-3 where `plan.fsdp`, and under a tp-mode
    plan tensor parallelism over the model axis, head-parallel or, where
    `plan.attn_seq`, with sequence-parallel attention (the reference
    reaches them by jitting `make_train_step` with the plan's
    `in_shardings`).  Each step gathers the parameters sharded over the
    data axes, runs `loss_fn` over this rank's rows with the batch axes'
    mask count as the denominator (under a model axis on this rank's MLP
    columns and vocabulary, and its heads or its chunk of the sequence,
    through `parallel/tensor.py`'s operators), takes
    `torch.autograd.grad`, sums the gradients over the batch axes
    (reduce-scatter into the pieces, all-reduce the others; a leaf whose
    gradient is a rank's part, over the model axis too), and runs AdamW on
    the pieces with the whole gradient's norm.  At world size 1 under a
    dp-mode plan the arithmetic is `make_train_step`'s, bit for bit (a 0/1
    mask's count is exact).  Raises, before any weight is made, for a plan
    the port does not execute (`parallel.fsdp.check_plan`), and for a
    `seq_len` a sequence-parallel axis does not divide (a step given such
    a batch raises at its first reduce-scatter).  With `rank` and no group:
    that rank's step on the "meta" device (`ShardedTrainStep`)."""
    return ShardedTrainStep(cfg, opt_cfg, mesh, plan, base_lr=base_lr,
                            total_steps=total_steps, rank=rank, seq_len=seq_len)


def make_prefill_step(cfg: ArchConfig):
    def prefill_step(params, batch):
        # Serving prefill: only the next-token logits leave the step.
        return M.forward(params, cfg, batch, last_only=True)

    return prefill_step


def make_serve_step(cfg: ArchConfig):
    def serve_step(params, state: M.DecodeState, tokens):
        return M.decode_step(params, cfg, state, tokens)

    return serve_step


class GraphedServeStep:
    """`make_serve_step(cfg)` captured as a CUDA graph over `state` (CUDA
    tensors only).  Calling it copies tokens (B, 1) into the graph's input
    and replays it: it returns the graph's logits buffer (valid until the
    next replay) and `state`, which the replay advanced in place.

    Capture records the step without running it, so `state` is as it was;
    the step must have run once before on this device (the kernels' build
    and one-time attribute calls, the split-K scratch).  `launches` holds
    the hand-kernel launches of one replay.  Capture under the precision
    mode the replays should run in: it binds then."""

    def __init__(self, cfg: ArchConfig, params: dict, state: M.DecodeState, batch: int):
        if state.index.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA state, got {state.index.device}")
        self.params, self.state = params, state
        self.tokens = torch.zeros((batch, 1), dtype=torch.int64, device=state.index.device)
        step = make_serve_step(cfg)
        before = launches.counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), torch.cuda.graph(self.graph):
            self.logits, _ = step(params, state, self.tokens)
        after = launches.counts()
        self.launches: Dict[str, int] = {k: after[k] - v for k, v in before.items()
                                         if after[k] != v}

    def __call__(self, params: dict, state: M.DecodeState, tokens: torch.Tensor):
        if params is not self.params or state is not self.state:
            raise ValueError("the graph was captured over other params or another state")
        self.tokens.copy_(tokens)
        self.graph.replay()
        return self.logits, state


# ---------------------------------------------------------------------------
# Meta-device inputs per (arch x shape) cell: shapes and dtypes, no memory.
# ---------------------------------------------------------------------------

META = torch.device("meta")


def _batch_extras(cfg: ArchConfig, batch: int) -> Dict[str, Any]:
    extras: Dict[str, Any] = {}
    if cfg.family == "encdec":
        extras["frames"] = torch.empty((batch, cfg.encoder_seq, cfg.d_model),
                                       dtype=torch.float32, device=META)
    if cfg.family == "vlm":
        extras["patches"] = torch.empty((batch, cfg.prefix_len, M.VISION_DIM),
                                        dtype=torch.float32, device=META)
    return extras


def params_struct(cfg: ArchConfig) -> dict:
    """`init_model`'s tree on the meta device (no generator draws)."""
    return M.init_model(cfg, device=META)


def opt_state_struct(cfg: ArchConfig, p_struct: dict, opt_cfg: AdamWConfig) -> dict:
    return adamw_init(p_struct, opt_cfg)


def decode_state_struct(cfg: ArchConfig, p_struct: dict, batch: int, max_seq: int
                        ) -> M.DecodeState:
    enc = None
    if cfg.family == "encdec":
        enc = torch.empty((batch, cfg.encoder_seq, cfg.d_model), dtype=cfg.torch_dtype,
                          device=META)
    return M.init_decode_state(p_struct, cfg, batch, max_seq, encoder_out=enc)


def input_specs(cfg: ArchConfig, shape: Dict[str, Any]) -> Dict[str, Any]:
    """Meta tensors for one shape cell: what the step consumes.

    train  -> {"batch": {tokens, labels, ...}}
    prefill-> {"batch": {tokens, ...}}
    decode -> {"tokens": (B,1), "max_seq": S}  (DecodeState built separately)
    """
    kind, S, B = shape["kind"], shape["seq_len"], shape["global_batch"]
    tok = lambda s: torch.empty(s, dtype=torch.int32, device=META)  # noqa: E731
    if kind == "train":
        return {"batch": {"tokens": tok((B, S)), "labels": tok((B, S)),
                          **_batch_extras(cfg, B)}}
    if kind == "prefill":
        return {"batch": {"tokens": tok((B, S)), **_batch_extras(cfg, B)}}
    if kind == "decode":
        return {"tokens": tok((B, 1)), "max_seq": S}
    raise ValueError(kind)
