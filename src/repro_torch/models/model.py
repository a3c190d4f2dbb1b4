"""Model assembly (port of repro/models/model.py: `init_model`, the unpaged
`forward`, the paged decode state, `paged_decode_step`, `prefill_chunk` and
`reset_slots`).

Parameters are a plain dict: "embed" (vocab, d), "final_norm" (an RMS
weight (d,) or LayerNorm's {"scale", "bias"}), "head" (d, vocab) for an
untied head, and "layers", a flat list of per-layer dicts.  The untied head
is stored with its rows padded to 16 bytes (`gemm.aligned_rows`), so the
GeMM reads it in place at any vocab.  The reference stacks each
group's parameters on a leading n_groups axis and scans the groups; here
layer g * group_size + i simply has kind `cfg.layer_kinds()[i]`
(`cfg.all_layer_kinds()`).

Under the w8a8 precision the projection matrices are `QuantTensor`s
(quant/params.py), an untied "head" among them, and "head_q" holds the
int8 copy of a tied head; the model code is the same, since `ops.linear` dispatches on the weight.

The KV pools update in place where the reference donates the state to its
jitted steps: the reference never keeps a pre-step pool (inactive slots and
slot slices pass the pools through whole), so the result is the same.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.kernels import gemm
from repro_torch.models import blocks, layers
from repro_torch.models.config import ArchConfig
from repro_torch.serving import kv_cache as kvc


def init_model(cfg: ArchConfig, *, seed: int = 0, device=None) -> dict:
    """Random parameters from a seeded `torch.Generator` on `device`
    (CUDA unless the caller names another)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dt = cfg.torch_dtype
    params = {
        "embed": layers.init_embedding(gen, cfg.vocab, cfg.d_model, dt, device),
        "final_norm": blocks._init_norm(cfg, device),
        "layers": [blocks.init_block(gen, cfg, kind, device)
                   for kind in cfg.all_layer_kinds()],
    }
    if not cfg.tie_embeddings:
        params["head"] = gemm.aligned_rows(
            layers._init_dense(gen, cfg.d_model, cfg.vocab, dt, device))
    return params


@dataclasses.dataclass
class PagedDecodeState:
    """Serving decode state: one KV block pool per layer plus per-slot
    block tables and lengths (all on the model's device)."""

    caches: List[kvc.PagedKVCache]
    block_tables: torch.Tensor        # (slots, max_blocks) int32
    lengths: torch.Tensor             # (slots,) int32 tokens held per slot


def init_paged_decode_state(cfg: ArchConfig, slots: int, *, num_blocks: int,
                            block_size: int, max_blocks_per_slot: int,
                            device, kv_precision: str = "float") -> PagedDecodeState:
    caches = [kvc.init_paged_kv(num_blocks, block_size, cfg.n_kv_heads,
                                cfg.resolved_head_dim, cfg.torch_dtype, device,
                                kv_precision=kv_precision)
              for _ in range(cfg.n_layers)]
    return PagedDecodeState(
        caches=caches,
        block_tables=torch.zeros((slots, max_blocks_per_slot),
                                 dtype=torch.int32, device=device),
        lengths=torch.zeros((slots,), dtype=torch.int32, device=device),
    )


def clear_paged_decode_state(state: PagedDecodeState) -> PagedDecodeState:
    """Return `state` to `init_paged_decode_state`'s contents in place
    (zero pools and unit int8 scales, null tables, zero lengths): every
    tensor keeps its address."""
    for cache in state.caches:
        kvc.clear_paged_kv(cache)
    state.block_tables.zero_()
    state.lengths.zero_()
    return state


def _embed_tokens(params: dict, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    x = layers.embed(tokens, params["embed"])
    if not cfg.tie_embeddings:
        return x
    # Tied embeddings scale by sqrt(d_model) in x's dtype: the scale is
    # rounded to that dtype first, as the reference's jnp.asarray does.
    scale = torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype).item()
    return x * scale


def group_layers(params: dict, cfg: ArchConfig, g: int) -> list:
    """Layers g * group_size .. + group_size - 1: the reference's group g."""
    return params["layers"][g * cfg.group_size:(g + 1) * cfg.group_size]


def _run_groups(x: torch.Tensor, params: dict, cfg: ArchConfig, *,
                positions: torch.Tensor) -> torch.Tensor:
    for g in range(cfg.n_groups):
        x = blocks.apply_group(x, group_layers(params, cfg, g), cfg,
                               positions=positions)
    return x


def forward(params: dict, cfg: ArchConfig, batch: Dict[str, torch.Tensor], *,
            last_only: bool = False) -> torch.Tensor:
    """Logits (B, S, vocab) for batch["tokens"] (B, S) at positions 0..S-1,
    or only the last position's (B, 1, vocab) when `last_only`: causal
    attention over the sequence itself, no cache (train / prefill /
    calibration / evaluation).  Dense decoders only."""
    if cfg.family != "dense":
        raise NotImplementedError(f"forward for family {cfg.family!r} is not ported")
    tokens = batch["tokens"]
    x = _embed_tokens(params, cfg, tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)
    x = _run_groups(x, params, cfg, positions=positions)
    x = blocks._norm(x, params["final_norm"], cfg)
    if last_only:
        x = x[:, -1:]
    return _unembed(x, params, cfg)


def _unembed(x: torch.Tensor, params: dict, cfg: ArchConfig) -> torch.Tensor:
    # "head_q" is the int8 copy of the tied table that quantize_params adds:
    # without it a w8a8 step would re-quantize the (vocab x d) table.  An
    # untied "head" is a float matrix or, quantized, a QuantTensor.
    if "head_q" in params:
        return layers.dense(x, params["head_q"])
    if cfg.tie_embeddings:
        return layers.unembed(x, params["embed"])
    return layers.dense(x, params["head"])


def _trunk_step(params: dict, cfg: ArchConfig, x: torch.Tensor,
                positions: torch.Tensor, caches, cache_index: torch.Tensor,
                block_tables: torch.Tensor) -> torch.Tensor:
    for p, kind, cache in zip(params["layers"], cfg.all_layer_kinds(), caches):
        x = blocks.apply_block(x, p, cfg, kind, positions=positions,
                               cache=cache, cache_index=cache_index,
                               block_tables=block_tables)
    return x


def paged_decode_step(params: dict, cfg: ArchConfig, state: PagedDecodeState,
                      tokens: torch.Tensor, active: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, PagedDecodeState]:
    """One token for every slot at its own position: tokens (B, 1) ->
    logits (B, 1, vocab).  `active` (B,) bool holds the lengths of idle or
    mid-prefill slots; their KV writes land at/above their length (hidden
    until a real write replaces them) or in the null block."""
    x = _embed_tokens(params, cfg, tokens)
    positions = state.lengths[:, None]
    x = _trunk_step(params, cfg, x, positions, state.caches, state.lengths,
                    state.block_tables)
    step = 1 if active is None else active.to(torch.int32)
    new_lengths = state.lengths + step
    x = blocks._norm(x, params["final_norm"], cfg)
    logits = _unembed(x, params, cfg)
    return logits, PagedDecodeState(caches=state.caches,
                                    block_tables=state.block_tables,
                                    lengths=new_lengths.to(torch.int32))


def prefill_chunk(params: dict, cfg: ArchConfig, state: PagedDecodeState,
                  tokens: torch.Tensor, slot) -> Tuple[torch.Tensor, PagedDecodeState]:
    """Advance one slot by a chunk of C prompt tokens: tokens (1, C) ->
    (last-position logits (1, 1, vocab), updated state).  The chunk attends
    causally over the slot's block-table view, which this step just wrote;
    the LM head runs on the last position only.

    `slot` is a Python int or a 0-d / (1,) integer tensor on the state's
    device, as the reference traces it: read on the device, one captured
    step serves every slot.  Both forms compute the same thing."""
    C = tokens.shape[1]
    idx = torch.as_tensor(slot, device=state.lengths.device).reshape(1).long()
    start = state.lengths.index_select(0, idx)                  # (1,)
    tables = state.block_tables.index_select(0, idx)            # (1, max_blocks)
    x = _embed_tokens(params, cfg, tokens)
    positions = start[:, None] + torch.arange(C, dtype=torch.int32,
                                              device=tokens.device)[None, :]
    x = _trunk_step(params, cfg, x, positions, state.caches, start, tables)
    x = blocks._norm(x[:, -1:], params["final_norm"], cfg)
    logits = _unembed(x, params, cfg)
    new_lengths = state.lengths.index_add(
        0, idx, torch.full((1,), C, dtype=state.lengths.dtype, device=idx.device))
    return logits, PagedDecodeState(caches=state.caches,
                                    block_tables=state.block_tables,
                                    lengths=new_lengths)


def reset_slots(cfg: ArchConfig, state: PagedDecodeState,
                mask: torch.Tensor) -> PagedDecodeState:
    """Zero the length of every masked slot for a fresh request.  KV pages
    need no reset: freed blocks are rewritten before the length mask
    exposes them."""
    lengths = torch.where(mask, torch.zeros_like(state.lengths), state.lengths)
    return PagedDecodeState(caches=state.caches,
                            block_tables=state.block_tables, lengths=lengths)
