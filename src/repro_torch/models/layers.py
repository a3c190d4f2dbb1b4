"""Elementary layers: norms (RMS and LayerNorm), embeddings, RoPE, the
SwiGLU and GELU MLPs (port of repro/models/layers.py).

Every dense projection goes through `kernels.ops.linear`, so the GeMM
kernel underlies the whole model; a bias is added after it, in the
activations' dtype, as the reference adds it outside its kernel.  Cast
points follow the reference exactly: norms and RoPE compute in float32
and cast back, the SwiGLU gate is `silu(gate.f32).to(x.dtype) * up`, and
the GELU is `gelu(h.f32)` in its tanh form (`jax.nn.gelu`'s default;
torch's default is the exact erf form).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.parallel import tensor
from repro_torch.parallel.logical import shard


def _init_dense(gen: torch.Generator, d_in: int, d_out: int, dtype,
                device) -> torch.Tensor:
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * d_in ** -0.5).to(dtype)


def dense(x: torch.Tensor, w, b: Optional[torch.Tensor] = None, *,
          quant: Optional[str] = None) -> torch.Tensor:
    """x @ w (+ b) for a float weight or an int8-resident QuantTensor.
    `quant` goes to `ops.linear`: None follows the precision mode, "none"
    keeps a float weight float under w8a8 (the recurrences' gate
    projections)."""
    y = ops.linear(x, w, quant=quant)
    if b is not None:
        y = y + b
    return y


# -- norms -------------------------------------------------------------------

ROW_PARTS = 16


def row_mean(v: torch.Tensor) -> torch.Tensor:
    """Mean over the last axis (keepdim), summed in an order that does not
    depend on how many rows `v` holds: 16 partial sums a row, then their
    sum.  PyTorch's CUDA reduction picks its thread layout from the number
    of outputs, and below 16 outputs it lays a row over more threads; with
    16 or more in each pass, a row of a verify step (slots x S rows) sums
    in the same order as in a decode step (slots rows), so the two agree
    bit for bit on the card.  A width that 16 does not divide takes
    `torch.mean`."""
    d = v.shape[-1]
    if d % ROW_PARTS:
        return torch.mean(v, dim=-1, keepdim=True)
    parts = v.reshape(*v.shape[:-1], ROW_PARTS, d // ROW_PARTS).sum(dim=-1)
    return parts.sum(dim=-1, keepdim=True) * (1.0 / d)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = row_mean(xf * xf)
    y = xf * torch.rsqrt(var + eps)
    return (y * w.to(torch.float32)).to(x.dtype)


def init_layernorm(d: int, dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layer_norm(x: torch.Tensor, p: dict, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = row_mean(xf)
    var = row_mean((xf - mu) ** 2)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)
            + p["bias"].to(torch.float32)).to(x.dtype)


# -- embeddings ---------------------------------------------------------------

def init_embedding(gen: torch.Generator, vocab: int, d: int, dtype,
                   device) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32, device=device)
    return (w * 0.02).to(dtype)


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """table[tokens], through `F.embedding`: the same gather forward, and a
    backward that sums the rows' gradients by sorting the indices (the
    same bits run to run on the card), where indexing's backward is an
    accumulating scatter.  Under a model axis `table` is this rank's vocab
    rows (`parallel.tensor.vocab_embed`; under a sequence-parallel one the
    tokens are the whole sequence and x this rank's chunk of it)."""
    axis = tensor.current()
    x = F.embedding(tokens, table) if axis is None else tensor.vocab_embed(tokens, table, axis)
    return shard(x, "batch", "seq", "embed")


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Logits = x @ table^T (tied; table is (vocab, d)).  The transpose is a
    strided view the GeMM reads in place.  Under a model axis the table is
    this rank's vocab rows: a column-parallel product, whose input the
    caller has put on the axis (`models.model.loss_fn`)."""
    logits = ops.linear(x, table.t().to(x.dtype))
    return shard(logits, "batch", "seq", "vocab")


# -- rotary position embedding -------------------------------------------------

@functools.lru_cache(maxsize=16)
def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    """Inverse frequencies (head_dim // 2,) float32.  Computed on the CPU
    and copied, so every device rotates by bit-identical frequencies."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32) / half))
    return freqs.to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x (B, S, H, D), positions (B, S) or (S,).  Rotates split halves
    (not interleaved pairs) in float32, then casts back."""
    freqs = rope_frequencies(x.shape[-1], float(theta), x.device)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(torch.float32) * freqs          # (B, S, D/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- feed-forward ---------------------------------------------------------------

def init_mlp(gen: torch.Generator, d: int, d_ff: int, variant: str, dtype,
             device) -> dict:
    if variant == "swiglu":
        return {
            "w_gate": _init_dense(gen, d, d_ff, dtype, device),
            "w_up": _init_dense(gen, d, d_ff, dtype, device),
            "w_down": _init_dense(gen, d_ff, d, dtype, device),
        }
    if variant == "gelu":
        return {
            "w_up": _init_dense(gen, d, d_ff, dtype, device),
            "b_up": torch.zeros((d_ff,), dtype=dtype, device=device),
            "w_down": _init_dense(gen, d_ff, d, dtype, device),
            "b_down": torch.zeros((d,), dtype=dtype, device=device),
        }
    raise ValueError(f"unknown mlp variant {variant!r}")


def mlp(x: torch.Tensor, p: dict, variant: str, *,
        quant: Optional[str] = None) -> torch.Tensor:
    """SwiGLU: down(silu(gate.f32).to(x.dtype) * up).  GELU: h = x @ w_up +
    b_up, then gelu_tanh(h.f32).to(x.dtype) @ w_down + b_down.  Under a
    model axis (SwiGLU only: `parallel.fsdp.check_plan`) w_gate / w_up are
    this rank's columns and w_down its rows: the partial products of
    w_down are summed over the ranks.  Under a sequence-parallel axis x is
    this rank's chunk: gathered over the sequence before w_gate / w_up,
    the sum reduce-scattered back to the chunk after w_down."""
    if variant == "swiglu":
        x = tensor.copy_to_model(x)
        gate = dense(x, p["w_gate"], quant=quant)
        up = dense(x, p["w_up"], quant=quant)
        h = F.silu(gate.to(torch.float32)).to(x.dtype) * up
        h = shard(h, "batch", "seq", "mlp")
        return tensor.reduce_from_model(dense(h, p["w_down"], quant=quant))
    if variant != "gelu":
        raise ValueError(f"unknown mlp variant {variant!r}")
    h = dense(x, p["w_up"], p["b_up"], quant=quant)
    h = F.gelu(h.to(torch.float32), approximate="tanh").to(x.dtype)
    h = shard(h, "batch", "seq", "mlp")
    return dense(h, p["w_down"], p["b_down"], quant=quant)
