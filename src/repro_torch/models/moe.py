"""Mixture-of-Experts: top-k routing with capacity-bounded dispatch (port of
repro/models/moe.py).

  * router logits (float32, `layers.dense`, so under w8a8 the router runs
    the int8 path on the fly, as in the reference) -> top-k -> softmax over
    the chosen experts;
  * position-in-expert by a cumulative sum over the one-hot assignment:
    earlier (token, choice) pairs win capacity slots;
  * the pairs are written into an (E, capacity + 1, d) buffer whose last
    row is the sacrificial slot of the pairs that did not fit;
  * each expert's SwiGLU runs on its (capacity, d) rows through the float
    GeMM (`ops.gemm`: K1 on the card) with float32 output.  The reference
    upcasts operands to float32 and runs an f32 einsum; products of bf16
    values are exact in float32 and the GeMM accumulates in float32, so
    this is the same function without materializing a float32 copy of the
    expert weights (sums in another order);
  * the k weighted expert outputs of each token are summed in choice order
    (a fixed order, where a scatter-add would sum in atomic order on the
    card), in the model dtype, as the reference's scatter-add does.

Top-k ties go to the lower expert index, as `jax.lax.top_k` breaks them
(a stable descending sort).  Arctic's dense residual runs a SwiGLU MLP in
parallel and adds it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers


def init_moe(gen: torch.Generator, cfg, device) -> dict:
    mc = cfg.moe
    d, E, ffe = cfg.d_model, mc.num_experts, mc.d_ff_expert
    dt = cfg.torch_dtype

    def stacked(d_in, d_out):
        w = torch.randn((E, d_in, d_out), generator=gen, dtype=torch.float32, device=device)
        return (w * d_in ** -0.5).to(dt)

    p = {
        "router": layers._init_dense(gen, d, E, torch.float32, device),
        "w_gate": stacked(d, ffe),
        "w_up": stacked(d, ffe),
        "w_down": stacked(ffe, d),
    }
    if mc.dense_residual:
        p["dense"] = layers.init_mlp(gen, d, cfg.d_ff, "swiglu", dt, device)
    return p


def _capacity(tokens: int, cfg) -> int:
    mc = cfg.moe
    c = int(tokens * mc.top_k / mc.num_experts * mc.capacity_factor)
    return max(8, -(-c // 8) * 8)


def route(logits: torch.Tensor, k: int):
    """Top-k of router logits (T, E) -> (gate values, expert ids) (T, k),
    largest first, ties to the lower expert index."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def moe_block(x: torch.Tensor, p: dict, cfg, *, quant: Optional[str] = None) -> torch.Tensor:
    B, S, d = x.shape
    mc = cfg.moe
    E, k = mc.num_experts, mc.top_k
    T = B * S
    C = _capacity(T, cfg)
    dev = x.device

    x2 = x.reshape(T, d)
    logits = layers.dense(x2.to(torch.float32), p["router"])           # (T, E)
    gate_vals, expert_idx = route(logits, k)                           # (T, k)
    weights = torch.softmax(gate_vals, dim=-1)

    # (token, choice) pairs in token order; earlier pairs win slots
    # (one-hot and the token ids built without a host sync, so a CUDA graph
    # captures the block)
    flat_e = expert_idx.reshape(T * k)
    oh = (flat_e[:, None] == torch.arange(E, device=dev)[None, :]).to(torch.int32)
    pos_in_e = ((torch.cumsum(oh, dim=0) - oh) * oh).sum(dim=-1)       # (T*k,)
    keep = pos_in_e < C
    slot = torch.where(keep, pos_in_e, torch.full_like(pos_in_e, C))   # C: sacrificial
    token_ids = torch.arange(T, device=dev)[:, None].expand(T, k).reshape(T * k)

    buf = torch.zeros((E * (C + 1), d), dtype=x.dtype, device=dev)
    buf.index_copy_(0, flat_e * (C + 1) + slot, x2[token_ids])
    buf = buf.reshape(E, C + 1, d)[:, :C]                              # (E, C, d)

    # each expert's SwiGLU: f32 gate / up / down products of the model-dtype
    # operands (module docstring)
    # (the stacked weights split once: each expert's index read would cost
    # the backward a zero-filled gradient of the whole stacked leaf)
    out_buf = torch.empty((E, C, d), dtype=x.dtype, device=dev)
    w_gate, w_up, w_down = (p[k].unbind(0) for k in ("w_gate", "w_up", "w_down"))
    for e in range(E):
        be = buf[e]
        gate = ops.gemm(be, w_gate[e])
        up = ops.gemm(be, w_up[e])
        h = (F.silu(gate) * up).to(x.dtype)
        out_buf[e] = ops.gemm(h, w_down[e]).to(x.dtype)

    # gather back; dropped pairs contribute zero
    out_pairs = out_buf[flat_e, torch.clamp(slot, max=C - 1)]         # (T*k, d)
    out_pairs = torch.where(keep[:, None], out_pairs, torch.zeros_like(out_pairs))
    w_pairs = weights.reshape(T * k, 1).to(out_pairs.dtype)
    contrib = (out_pairs * w_pairs).reshape(T, k, d)
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    y = y.reshape(B, S, d).to(x.dtype)

    if mc.dense_residual:
        y = y + layers.mlp(x, p["dense"], "swiglu", quant=quant)
    return y


def aux_load_balance_loss(logits: torch.Tensor, expert_idx: torch.Tensor,
                          E: int) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss (for training)."""
    probs = torch.softmax(logits, dim=-1)                              # (T, E)
    frac_tokens = F.one_hot(expert_idx[:, 0], E).to(torch.float32).mean(dim=0)
    frac_probs = probs.mean(dim=0)
    return E * torch.sum(frac_tokens * frac_probs)
