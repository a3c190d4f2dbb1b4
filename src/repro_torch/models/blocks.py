"""Transformer blocks: attention (global or sliding-window) plus the SwiGLU
or GELU FFN, with pre-norms and optional gemma-style post-norms, each an
RMS norm or a LayerNorm as `cfg.norm` says (port of repro/models/blocks.py
for the `attn` / `attn_local` kinds: `_init_norm`, `_norm`, `apply_block`
over the paged cache or over the sequence itself, and `apply_group`).

Residual adds run in the model dtype, as in the reference.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models import layers


def _init_norm(cfg, device):
    """A norm's parameters: the RMS weight (d,), or LayerNorm's
    {"scale", "bias"}."""
    if cfg.norm == "ln":
        return layers.init_layernorm(cfg.d_model, cfg.torch_dtype, device)
    return torch.ones((cfg.d_model,), dtype=cfg.torch_dtype, device=device)


def _norm(x: torch.Tensor, p, cfg) -> torch.Tensor:
    if cfg.norm == "ln":
        return layers.layer_norm(x, p, cfg.norm_eps)
    return layers.rms_norm(x, p, cfg.norm_eps)


def init_block(gen: torch.Generator, cfg, kind: str, device) -> dict:
    if kind not in ("attn", "attn_local"):
        raise NotImplementedError(f"block kind {kind!r} is not ported")
    p = {"norm1": _init_norm(cfg, device),
         "mixer": attn_lib.init_attention(gen, cfg, device)}
    if cfg.d_ff:
        p["norm2"] = _init_norm(cfg, device)
        p["ffn"] = layers.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_variant,
                                   cfg.torch_dtype, device)
    if cfg.post_block_norm:
        p["post_norm1"] = _init_norm(cfg, device)
        if "ffn" in p:
            p["post_norm2"] = _init_norm(cfg, device)
    return p


def apply_block(x: torch.Tensor, p: dict, cfg, kind: str, *,
                positions: torch.Tensor, cache=None,
                cache_index: Optional[torch.Tensor] = None,
                block_tables: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One block, over the sequence itself (cache None) or over the paged
    cache (the layer's pools update in place)."""
    h = _norm(x, p["norm1"], cfg)
    window = cfg.local_window if kind == "attn_local" else None
    h = attn_lib.attention(h, p["mixer"], cfg, positions=positions,
                           window=window, cache=cache,
                           cache_index=cache_index, block_tables=block_tables)
    if cfg.post_block_norm:
        h = _norm(h, p["post_norm1"], cfg)
    x = x + h
    if "ffn" in p:
        h = _norm(x, p["norm2"], cfg)
        h = layers.mlp(h, p["ffn"], cfg.mlp_variant)
        if cfg.post_block_norm:
            h = _norm(h, p["post_norm2"], cfg)
        x = x + h
    return x


def apply_group(x: torch.Tensor, group_layers: Sequence[dict], cfg, *,
                positions: torch.Tensor) -> torch.Tensor:
    """One group of `cfg.group_size` blocks over the sequence itself:
    `group_layers` is layers g * group_size .. + group_size - 1 of the flat
    `params["layers"]` list (the reference's scanned group g), of kinds
    `cfg.layer_kinds()`."""
    kinds = cfg.layer_kinds()
    if len(group_layers) != len(kinds):
        raise ValueError(f"a group holds {len(kinds)} layers, got {len(group_layers)}")
    for p, kind in zip(group_layers, kinds):
        x = apply_block(x, p, cfg, kind, positions=positions)
    return x
