"""Transformer blocks: attention (global or sliding-window) plus the SwiGLU
FFN, with pre-norms and optional gemma-style post-norms (port of
repro/models/blocks.py for the `attn` / `attn_local` kinds: `apply_block`
over the paged cache or over the sequence itself, and `apply_group`).

Residual adds run in the model dtype, as in the reference.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models import layers


def init_block(gen: torch.Generator, cfg, kind: str, device) -> dict:
    if kind not in ("attn", "attn_local"):
        raise NotImplementedError(f"block kind {kind!r} is not ported")
    ones = lambda: torch.ones((cfg.d_model,), dtype=cfg.torch_dtype, device=device)
    p = {"norm1": ones(), "mixer": attn_lib.init_attention(gen, cfg, device)}
    if cfg.d_ff:
        p["norm2"] = ones()
        p["ffn"] = layers.init_mlp(gen, cfg.d_model, cfg.d_ff,
                                   cfg.torch_dtype, device)
    if cfg.post_block_norm:
        p["post_norm1"] = ones()
        if "ffn" in p:
            p["post_norm2"] = ones()
    return p


def apply_block(x: torch.Tensor, p: dict, cfg, kind: str, *,
                positions: torch.Tensor, cache=None,
                cache_index: Optional[torch.Tensor] = None,
                block_tables: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One block, over the sequence itself (cache None) or over the paged
    cache (the layer's pools update in place)."""
    h = layers.rms_norm(x, p["norm1"], cfg.norm_eps)
    window = cfg.local_window if kind == "attn_local" else None
    h = attn_lib.attention(h, p["mixer"], cfg, positions=positions,
                           window=window, cache=cache,
                           cache_index=cache_index, block_tables=block_tables)
    if cfg.post_block_norm:
        h = layers.rms_norm(h, p["post_norm1"], cfg.norm_eps)
    x = x + h
    if "ffn" in p:
        h = layers.rms_norm(x, p["norm2"], cfg.norm_eps)
        h = layers.mlp(h, p["ffn"])
        if cfg.post_block_norm:
            h = layers.rms_norm(h, p["post_norm2"], cfg.norm_eps)
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
