"""AdamW with gradient clipping, the warmup-cosine schedule, and compressed
optimizer state (bf16 or block-quantized int8 moments): port of
repro/optim/adamw.py, the same arithmetic in the same order.

The port's parameter tree is the dict of `models.model.init_model` (a flat
"layers" list where the reference stacks each group on a leading axis).
Two differences follow from that, and from PyTorch:

* Weight decay goes to every leaf the reference decays.  The reference
  decays leaves of ndim >= 2; its layer leaves carry the stacked group
  axis, so every one of them (the norm vectors and biases included) is
  decayed there.  Here a leaf under "layers" or "encoder_blocks" is
  decayed whatever its ndim, every other leaf by ndim >= 2.
* `adamw_update` writes the new parameters and moments in place (the
  reference returns new trees).  The tensors keep their addresses and
  their storage: an untied head or projector stored with padded rows
  (`gemm.aligned_rows`) stays padded, so K1 reads it without a copy after
  every step.  `count` is a 0-d int32 tensor on the parameters' device.

Plain PyTorch, as the reference's update is plain jnp: no TPU kernel lies
here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch import tree as tree_lib


class BlockQ(NamedTuple):
    """Block-quantized tensor: q int8, scale f32 per 128-wide block."""

    q: torch.Tensor
    scale: torch.Tensor


_BLOCK = 128
# Subtrees whose leaves the reference stacks on a leading group axis.
STACKED = ("layers", "encoder_blocks")


def _bq_encode(x: torch.Tensor) -> BlockQ:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % _BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, _BLOCK)
    absmax = torch.amax(torch.abs(blocks), dim=-1, keepdim=True)
    scale = torch.clamp_min(absmax, 1e-12) / 127.0
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return BlockQ(q=q, scale=scale.to(torch.float32))


def _bq_decode(bq: BlockQ, shape, dtype=torch.float32) -> torch.Tensor:
    flat = (bq.q.to(torch.float32) * bq.scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape).to(dtype)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    state_dtype: str = "float32"       # float32 | bfloat16 | int8


_STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": None}


def adamw_init(params, cfg: AdamWConfig):
    """Zero moments shaped like `params` (BlockQ in int8) and count 0."""
    if cfg.state_dtype not in _STATE_DTYPES:
        raise ValueError(f"unknown state_dtype {cfg.state_dtype!r}")
    if cfg.state_dtype == "int8":
        zeros = lambda p: _bq_encode(torch.zeros(p.shape, dtype=torch.float32, device=p.device))
    else:
        dt = _STATE_DTYPES[cfg.state_dtype]
        zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    device = tree_lib.leaves(params)[0].device
    return {
        "m": tree_lib.map_tree(zeros, params),
        "v": tree_lib.map_tree(zeros, params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in the tree's fixed order) of each
    leaf's f32 sum of squares."""
    leaves = [torch.sum(torch.square(x.to(torch.float32))) for x in tree_lib.leaves(tree)]
    return torch.sqrt(sum(leaves))


def decayed(params) -> list:
    """Per leaf of `params` (fixed order): whether the reference decays it
    (module docstring)."""
    return [path[0] in STACKED or leaf.dim() >= 2
            for path, leaf in tree_lib.leaves_with_paths(params)]


def _moments(tree, int8: bool) -> list:
    """The moment leaves in the parameters' order: BlockQ pairs whole."""
    if not int8:
        return tree_lib.leaves(tree)
    out = []

    def walk(t):
        if isinstance(t, BlockQ):
            out.append(t)
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        else:
            for x in t:
                walk(x)

    walk(tree)
    return out


@torch.no_grad()
def adamw_update(grads, state, params, lr, cfg: AdamWConfig) -> Tuple[Any, Any]:
    """One AdamW step, in place on `params` and `state["m"]`, `state["v"]`;
    `state["count"]` becomes count + 1.  `grads` is a tree like `params`
    or the list of its leaves in the fixed order; `lr` a float or a 0-d
    tensor.  Returns (params, state)."""
    count = state["count"] + 1
    flat_g = grads if isinstance(grads, (list, tuple)) else tree_lib.leaves(grads)
    gnorm = global_norm(list(flat_g))
    if cfg.clip_norm is not None:
        clip = torch.clamp(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9), max=1.0)
    else:
        clip = 1.0
    cnt = count.to(torch.float32)
    b1c = 1 - torch.pow(torch.full_like(cnt, cfg.b1), cnt)
    b2c = 1 - torch.pow(torch.full_like(cnt, cfg.b2), cnt)
    int8 = cfg.state_dtype == "int8"

    flat_p = tree_lib.leaves(params)
    flat_m, flat_v = _moments(state["m"], int8), _moments(state["v"], int8)
    for p, g, m, v, decay in zip(flat_p, flat_g, flat_m, flat_v, decayed(params)):
        g = g.to(torch.float32) * clip
        mf = _bq_decode(m, p.shape) if int8 else m.to(torch.float32)
        vf = _bq_decode(v, p.shape) if int8 else v.to(torch.float32)
        mf = cfg.b1 * mf + (1 - cfg.b1) * g
        vf = cfg.b2 * vf + (1 - cfg.b2) * g * g
        update = (mf / b1c) / (torch.sqrt(vf / b2c) + cfg.eps)
        pf = p.to(torch.float32)
        if decay:  # decoupled weight decay on what the reference decays
            update = update + cfg.weight_decay * pf
        p.copy_(pf - lr * update)
        for old, new in ((m, mf), (v, vf)):
            if int8:
                enc = _bq_encode(new)
                old.q.copy_(enc.q)
                old.scale.copy_(enc.scale)
            else:
                old.copy_(new)
    state["count"] = count
    return params, state


def warmup_cosine(base_lr: float, warmup: int, total: int, min_frac: float = 0.1
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warmup to `base_lr` over `warmup` steps, then a cosine to
    `min_frac * base_lr` at `total`; step and result f32 tensors."""
    def sched(step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(1, warmup)
        prog = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)

    return sched
