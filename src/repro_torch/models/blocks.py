"""Blocks: one mixer (attention, global or sliding-window | Mamba | mLSTM |
sLSTM), whisper's cross-attention after it, and its FFN (the SwiGLU or
GELU MLP, or MoE), with pre-norms and optional gemma-style post-norms,
each an RMS norm or a LayerNorm as `cfg.norm` says (port of
repro/models/blocks.py: `_init_norm`, `_norm`, `init_block`,
`apply_block` over the sequence itself, a dense decode cache or the paged
pool, `apply_group`, `init_cache_for_kind` and
`init_paged_cache_for_kind`).

The xLSTM kinds carry their own feed-forward (no FFN); the other kinds take
an MLP, or MoE on every `cfg.moe_every`-th layer of a group (by the layer's
index inside its group).  Residual adds run in the model dtype, as in the
reference.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels import gemm
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers, moe as moe_lib, ssm
from repro_torch.serving import kv_cache as kvc

ATTENTION_KINDS = ("attn", "attn_local")


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


def _layer_uses_moe(cfg, layer_idx: int) -> bool:
    return cfg.moe is not None and (layer_idx + 1) % cfg.moe_every == 0


_INIT_MIXER = {"attn": attn_lib.init_attention, "attn_local": attn_lib.init_attention,
               "mamba": ssm.init_mamba, "mlstm": ssm.init_mlstm, "slstm": ssm.init_slstm}


def stored(tree):
    """A layer's parameters as the GeMMs read them in place: every matrix
    with 16-byte-aligned rows (`gemm.aligned_rows`; the mLSTM gates (di, H)
    are 8-byte rows in bf16), everything else as it is."""
    if isinstance(tree, dict):
        return {k: stored(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.dim() == 2:
        return gemm.aligned_rows(tree)
    return tree


def init_block(gen: torch.Generator, cfg, kind: str, device, *,
               layer_idx: int = 0, cross_attention: bool = False) -> dict:
    """One block of `kind`; `layer_idx` is its index inside its group,
    which places MoE; `cross_attention` adds "norm_cross" and "cross"
    (whisper's decoder layers)."""
    if kind not in _INIT_MIXER:
        raise ValueError(f"unknown block kind {kind!r}")
    p = {"norm1": _init_norm(cfg, device),
         "mixer": _INIT_MIXER[kind](gen, cfg, device)}
    if cross_attention:
        p["norm_cross"] = _init_norm(cfg, device)
        p["cross"] = attn_lib.init_attention(gen, cfg, device, cross=True)
    # xLSTM blocks carry their own FFN; the others get an MLP or MoE.
    if kind in ATTENTION_KINDS + ("mamba",) and (cfg.d_ff or cfg.moe):
        p["norm2"] = _init_norm(cfg, device)
        if _layer_uses_moe(cfg, layer_idx):
            p["ffn"] = moe_lib.init_moe(gen, cfg, device)
        else:
            p["ffn"] = layers.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_variant,
                                       cfg.torch_dtype, device)
    if cfg.post_block_norm:
        p["post_norm1"] = _init_norm(cfg, device)
        if "ffn" in p:
            p["post_norm2"] = _init_norm(cfg, device)
    return stored(p)


_RECURRENT = {"mamba": ssm.mamba_block, "mlstm": ssm.mlstm_block,
              "slstm": ssm.slstm_block}


def apply_block(x: torch.Tensor, p: dict, cfg, kind: str, *,
                positions: torch.Tensor, causal: bool = True, prefix_len: int = 0,
                cache=None, cache_index: Optional[torch.Tensor] = None,
                encoder_out: Optional[torch.Tensor] = None,
                cross_cache: Optional[attn_lib.KVCache] = None,
                block_tables: Optional[torch.Tensor] = None,
                collect_states: bool = False):
    """One block over the sequence itself (cache None) or over its decode
    state: returns (x, new recurrent state or None).  An attention layer's
    dense cache or paged pools update in place and it returns None; a
    recurrent layer returns its new state (per position with
    `collect_states`) and leaves `cache` untouched, for the caller to
    commit.  A block with "cross" attends over `encoder_out` or, at
    decode, over `cross_cache`."""
    h = _norm(x, p["norm1"], cfg)
    new_state = None
    if kind in ATTENTION_KINDS:
        window = cfg.local_window if kind == "attn_local" else None
        h = attn_lib.attention(h, p["mixer"], cfg, positions=positions,
                               causal=causal, window=window, prefix_len=prefix_len,
                               cache=cache, cache_index=cache_index,
                               block_tables=block_tables)
    elif kind in _RECURRENT:
        h, new_state = _RECURRENT[kind](h, p["mixer"], cfg, state=cache,
                                        collect_states=collect_states)
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    if cfg.post_block_norm:
        h = _norm(h, p["post_norm1"], cfg)
    x = x + h
    if "cross" in p:
        h = _norm(x, p["norm_cross"], cfg)
        h = attn_lib.attention(h, p["cross"], cfg, positions=positions, causal=False,
                               kv_src=encoder_out if cross_cache is None else h,
                               cache=cross_cache)
        x = x + h
    if "ffn" in p:
        h = _norm(x, p["norm2"], cfg)
        if "router" in p["ffn"]:
            h = moe_lib.moe_block(h, p["ffn"], cfg)
        else:
            h = layers.mlp(h, p["ffn"], cfg.mlp_variant)
        if cfg.post_block_norm:
            h = _norm(h, p["post_norm2"], cfg)
        x = x + h
    return x, new_state


def apply_group(x: torch.Tensor, group_layers: Sequence[dict], cfg, *,
                positions: torch.Tensor, prefix_len: int = 0,
                encoder_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One group of `cfg.group_size` blocks over the sequence itself:
    `group_layers` is layers g * group_size .. + group_size - 1 of the flat
    `params["layers"]` list (the reference's scanned group g), of kinds
    `cfg.layer_kinds()`."""
    kinds = cfg.layer_kinds()
    if len(group_layers) != len(kinds):
        raise ValueError(f"a group holds {len(kinds)} layers, got {len(group_layers)}")
    for p, kind in zip(group_layers, kinds):
        x, _ = apply_block(x, p, cfg, kind, positions=positions,
                           prefix_len=prefix_len, encoder_out=encoder_out)
    return x


def init_cache_for_kind(cfg, kind: str, batch: int, max_seq: int, device):
    """The unpaged decode state of one block: a zero dense `KVCache` (batch,
    max_seq, Hkv, D) for the attention kinds, the per-slot recurrent state
    at its init for the others."""
    if kind in ATTENTION_KINDS:
        shape = (batch, max_seq, cfg.n_kv_heads, cfg.resolved_head_dim)
        return attn_lib.KVCache(
            k=torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            v=torch.zeros(shape, dtype=cfg.torch_dtype, device=device))
    return ssm.init_state_for_kind(cfg, kind, batch, device)


def init_paged_cache_for_kind(cfg, kind: str, batch: int, num_blocks: int,
                              block_size: int, device, kv_precision: str = "float"):
    """Paged-serving decode state of one layer: attention kinds share a
    block pool (int8-resident with per-(block, position, head) scales under
    kv_precision="int8"); the recurrent kinds keep their O(1) per-slot
    state."""
    if kind in ATTENTION_KINDS:
        return kvc.init_paged_kv(num_blocks, block_size, cfg.n_kv_heads,
                                 cfg.resolved_head_dim, cfg.torch_dtype, device,
                                 kv_precision=kv_precision)
    return ssm.init_state_for_kind(cfg, kind, batch, device)
