"""Model assembly (port of repro/models/model.py: `init_model`, the unpaged
`forward` and `trunk`, whisper's `_run_encoder`, the unpaged decode path
(`DecodeState`, `init_decode_state`, `decode_step`, `prefill`), the paged
decode state, `paged_decode_step`, `prefill_chunk`, `reset_slots`, the
speculative `paged_verify_step`, and the sampling head: `_adjusted_logits`,
`sample_tokens`, `paged_decode_sample_step` and
`paged_verify_sample_step`), for every family of the reference: dense,
moe, hybrid, ssm, encdec (whisper) and vlm (paligemma).  The paged state
refuses encdec and vlm, as the reference's does.

Parameters are a plain dict: "embed" (vocab, d), "final_norm" (an RMS
weight (d,) or LayerNorm's {"scale", "bias"}), "head" (d, vocab) for an
untied head, and "layers", a flat list of per-layer dicts.  The untied head
is stored with its rows padded to 16 bytes (`gemm.aligned_rows`), so the
GeMM reads it in place at any vocab.  The reference stacks each
group's parameters on a leading n_groups axis and scans the groups; here
layer g * group_size + i simply has kind `cfg.layer_kinds()[i]`
(`cfg.all_layer_kinds()`).

Whisper adds "encoder_blocks" (a flat list of `encoder_layers` blocks;
the reference stacks them on a leading axis), "encoder_norm", and a
cross-attention ("norm_cross", "cross") in every decoder layer;
paligemma adds "projector" (VISION_DIM x d).  The unpaged decode state
holds a dense (B, S_max, Hkv, D) `KVCache` per attention layer, written
in place at a device-held index, so `decode_step` is captured as one CUDA
graph per (batch, max_seq) (`launch/steps.py`); whisper's cross caches
are projected from the encoder's output once per batch.

Under the w8a8 precision the projection matrices are `QuantTensor`s
(quant/params.py), an untied "head" among them, and "head_q" holds the
int8 copy of a tied head; the model code is the same, since `ops.linear` dispatches on the weight.

The KV pools update in place where the reference donates the state to its
jitted steps: the reference never keeps a pre-step pool (inactive slots and
slot slices pass the pools through whole), so the result is the same.  The
recurrent layers (Mamba, mLSTM, sLSTM) hold one state per slot instead of a
pool, and every step writes it in place too, right after the layer ran:
the decode step keeps inactive slots' state (`ssm.select_into_`), a prefill
chunk runs on its slot's slice and writes the slice back (`index_copy_`),
the verify steps collect per-position states and commit each slot's at its
accepted position, and the reset returns masked slots to their init.  So a
captured CUDA graph reads and writes every state at a fixed address.

Sampling draws from the port's own counter-based stream (`_fold_keys`):
an integer hash of (seed, generated index[, draw]) computed with tensor
ops, so it is a pure function of its inputs, gives the same bits on the
CPU and on the card, and advances no generator state inside a CUDA graph.
The reference's threefry keys cannot be matched, so sampled tokens agree
with it in distribution, not bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.kernels import gemm
from repro_torch.models import blocks, layers, ssm
from repro_torch.models.config import ArchConfig
from repro_torch.serving import kv_cache as kvc

VISION_DIM = 1152  # SigLIP-so400m width (paligemma's stub frontend)
# Families the paged engine does not serve, as in the reference: they
# decode through the unpaged `decode_step`.
UNPAGED_FAMILIES = ("encdec", "vlm")


def init_model(cfg: ArchConfig, *, seed: int = 0, device=None) -> dict:
    """Random parameters from a seeded `torch.Generator` on `device`
    (CUDA unless the caller names another).  On the "meta" device it
    allocates nothing: the tree's shapes and dtypes, e.g. to size the
    weights before making them."""
    device = resolve_device(device)
    gen = None                      # the meta device: shapes and dtypes only
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    dt = cfg.torch_dtype
    cross = cfg.family == "encdec"
    params = {
        "embed": layers.init_embedding(gen, cfg.vocab, cfg.d_model, dt, device),
        "final_norm": blocks._init_norm(cfg, device),
        "layers": [blocks.init_block(gen, cfg, kind, device, layer_idx=i,
                                     cross_attention=cross)
                   for _ in range(cfg.n_groups)
                   for i, kind in enumerate(cfg.layer_kinds())],
    }
    if not cfg.tie_embeddings:
        params["head"] = gemm.aligned_rows(
            layers._init_dense(gen, cfg.d_model, cfg.vocab, dt, device))
    if cross:
        # Same width as the decoder; non-causal, no cross-attention.
        params["encoder_blocks"] = [blocks.init_block(gen, cfg, "attn", device)
                                    for _ in range(cfg.encoder_layers)]
        params["encoder_norm"] = blocks._init_norm(cfg, device)
    if cfg.family == "vlm":
        params["projector"] = gemm.aligned_rows(
            layers._init_dense(gen, VISION_DIM, cfg.d_model, dt, device))
    return params


def check_paged_family(cfg: ArchConfig) -> None:
    """Raise for a family the paged engine does not serve (encdec, vlm),
    naming it, as the reference's `init_paged_decode_state` does."""
    if cfg.family in UNPAGED_FAMILIES:
        raise NotImplementedError(
            f"paged serving not wired for family {cfg.family!r} ({cfg.name}); "
            f"it decodes through the unpaged decode_step")


@dataclasses.dataclass
class PagedDecodeState:
    """Serving decode state: per layer a KV block pool (attention kinds) or
    a per-slot recurrent state (`ssm.MambaState`, `MLSTMState`,
    `SLSTMState`), plus per-slot block tables and lengths (all on the
    model's device)."""

    caches: List
    block_tables: torch.Tensor        # (slots, max_blocks) int32
    lengths: torch.Tensor             # (slots,) int32 tokens held per slot


def init_paged_decode_state(cfg: ArchConfig, slots: int, *, num_blocks: int,
                            block_size: int, max_blocks_per_slot: int,
                            device, kv_precision: str = "float") -> PagedDecodeState:
    check_paged_family(cfg)
    caches = [blocks.init_paged_cache_for_kind(cfg, kind, slots, num_blocks,
                                               block_size, device, kv_precision)
              for kind in cfg.all_layer_kinds()]
    return PagedDecodeState(
        caches=caches,
        block_tables=torch.zeros((slots, max_blocks_per_slot),
                                 dtype=torch.int32, device=device),
        lengths=torch.zeros((slots,), dtype=torch.int32, device=device),
    )


def clear_paged_decode_state(state: PagedDecodeState) -> PagedDecodeState:
    """Return `state` to `init_paged_decode_state`'s contents in place
    (zero pools and unit int8 scales, recurrent states at their init, null
    tables, zero lengths): every tensor keeps its address."""
    for cache in state.caches:
        if isinstance(cache, kvc.PagedKVCache):
            kvc.clear_paged_kv(cache)
        else:
            ssm.reset_state_(cache)
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
                positions: torch.Tensor, prefix_len: int = 0,
                encoder_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    for g in range(cfg.n_groups):
        x = blocks.apply_group(x, group_layers(params, cfg, g), cfg,
                               positions=positions, prefix_len=prefix_len,
                               encoder_out=encoder_out)
    return x


def _run_encoder(frames: torch.Tensor, params: dict, cfg: ArchConfig) -> torch.Tensor:
    """Whisper's encoder over the stub frontend's frame embeddings (B,
    S_enc, d): non-causal blocks with RoPE at the frames' positions, then
    "encoder_norm"."""
    x = frames.to(cfg.torch_dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    for p in params["encoder_blocks"]:
        x, _ = blocks.apply_block(x, p, cfg, "attn", positions=positions, causal=False)
    return blocks._norm(x, params["encoder_norm"], cfg)


def trunk(params: dict, cfg: ArchConfig, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Final hidden states (B, S, d) of batch["tokens"] (B, S) at positions
    0..S-1, before the head: causal attention over the sequence itself,
    recurrent layers from their init state.  encdec: the decoder
    cross-attends to the encoder's run over batch["frames"] (B, S_enc, d).
    vlm: batch["patches"] (B, P, VISION_DIM) projected (unscaled) form a
    prefix before the token embeddings, attended bidirectionally
    (prefix-LM), and dropped before the head."""
    tokens = batch["tokens"]
    x = _embed_tokens(params, cfg, tokens)
    prefix_len, encoder_out = 0, None
    if cfg.family == "vlm":
        prefix = layers.dense(batch["patches"].to(cfg.torch_dtype), params["projector"])
        x = torch.cat([prefix, x], dim=1)
        prefix_len = prefix.shape[1]
    elif cfg.family == "encdec":
        encoder_out = _run_encoder(batch["frames"], params, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    x = _run_groups(x, params, cfg, positions=positions, prefix_len=prefix_len,
                    encoder_out=encoder_out)
    x = blocks._norm(x, params["final_norm"], cfg)
    return x[:, prefix_len:]


def forward(params: dict, cfg: ArchConfig, batch: Dict[str, torch.Tensor], *,
            last_only: bool = False) -> torch.Tensor:
    """Logits (B, S, vocab) of `trunk`, or only the last position's (B, 1,
    vocab) when `last_only` (train / prefill / calibration / evaluation)."""
    x = trunk(params, cfg, batch)
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
                block_tables: Optional[torch.Tensor], commit: Callable,
                collect_states: bool = False, cross_caches=None) -> torch.Tensor:
    """Every layer over its decode state; a recurrent layer's new state goes
    to `commit(layer index, new state)` as soon as the layer ran."""
    for i, (p, kind, cache) in enumerate(zip(params["layers"],
                                             cfg.all_layer_kinds(), caches)):
        x, new = blocks.apply_block(
            x, p, cfg, kind, positions=positions, cache=cache,
            cache_index=cache_index, block_tables=block_tables,
            cross_cache=None if cross_caches is None else cross_caches[i],
            collect_states=collect_states)
        if new is not None:
            commit(i, new)
    return x


# ---------------------------------------------------------------------------
# The unpaged decode path: every sequence of the batch at one position
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DecodeState:
    """Lock-step decode state: per layer a dense `KVCache` (attention
    kinds) or a recurrent state, per decoder layer whisper's cross
    `KVCache` over the encoder's frames (None for the other families),
    and the position of the next token, a 0-d int32 tensor on the model's
    device.  `decode_step` updates all of it in place."""

    caches: List
    cross_caches: Optional[List]
    index: torch.Tensor


def init_decode_state(params: dict, cfg: ArchConfig, batch: int, max_seq: int,
                      encoder_out: Optional[torch.Tensor] = None) -> DecodeState:
    """A fresh state for `batch` sequences of up to `max_seq` tokens on the
    parameters' device; encdec needs `encoder_out` (batch, S_enc, d), whose
    K/V each decoder layer's cross-attention projects once here."""
    device = params["embed"].device
    caches = [blocks.init_cache_for_kind(cfg, kind, batch, max_seq, device)
              for kind in cfg.all_layer_kinds()]
    cross = None
    if cfg.family == "encdec":
        if encoder_out is None:
            raise ValueError(f"{cfg.name}: the encdec decode state needs encoder_out")
        hd, hkv = cfg.resolved_head_dim, cfg.n_kv_heads
        cross = [blocks.attn_lib.KVCache(
            layers.dense(encoder_out, p["cross"]["wk"]).reshape(batch, -1, hkv, hd),
            layers.dense(encoder_out, p["cross"]["wv"]).reshape(batch, -1, hkv, hd))
            for p in params["layers"]]
    return DecodeState(caches=caches, cross_caches=cross,
                       index=torch.zeros((), dtype=torch.int32, device=device))


def clear_decode_state(state: DecodeState) -> DecodeState:
    """Return `state` to `init_decode_state`'s contents in place (zero
    caches, recurrent states at their init, index 0); the cross caches
    stay.  Every tensor keeps its address."""
    for cache in state.caches:
        if isinstance(cache, blocks.attn_lib.KVCache):
            cache.k.zero_()
            cache.v.zero_()
        else:
            ssm.reset_state_(cache)
    state.index.zero_()
    return state


def decode_step(params: dict, cfg: ArchConfig, state: DecodeState,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, DecodeState]:
    """One token for every sequence at position `state.index`: tokens (B, 1)
    -> logits (B, 1, vocab).  The caches and recurrent states update in
    place and the index advances on the device, so the step is one CUDA
    graph.  Returns (logits, state)."""
    B = tokens.shape[0]
    x = _embed_tokens(params, cfg, tokens)
    positions = state.index + torch.zeros((B, 1), dtype=state.index.dtype,
                                          device=tokens.device)

    def commit(i, new):
        ssm.select_into_(state.caches[i], new)

    x = _trunk_step(params, cfg, x, positions, state.caches, state.index, None,
                    commit, cross_caches=state.cross_caches)
    x = blocks._norm(x, params["final_norm"], cfg)
    logits = _unembed(x, params, cfg)
    state.index.add_(1)
    return logits, state


def prefill(params: dict, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            max_seq: int) -> Tuple[torch.Tensor, DecodeState]:
    """The reference's serving prefill: (last-position logits (B, 1,
    vocab), a DecodeState ready for `decode_step`).  The logits are
    `forward`'s; the caches are built by feeding batch["tokens"] through
    `decode_step` one position at a time.  As in the reference, whisper's
    encoder runs twice (once for the cross caches, once inside `forward`),
    and paligemma's caches hold the text tokens alone: its logits see the
    image prefix, its later decode steps do not."""
    tokens = batch["tokens"]
    encoder_out = None
    if cfg.family == "encdec":
        encoder_out = _run_encoder(batch["frames"], params, cfg)
    state = init_decode_state(params, cfg, tokens.shape[0], max_seq,
                              encoder_out=encoder_out)
    logits = forward(params, cfg, batch)
    for t in range(tokens.shape[1]):
        _, state = decode_step(params, cfg, state, tokens[:, t:t + 1])
    return logits[:, -1:], state


def paged_decode_step(params: dict, cfg: ArchConfig, state: PagedDecodeState,
                      tokens: torch.Tensor, active: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, PagedDecodeState]:
    """One token for every slot at its own position: tokens (B, 1) ->
    logits (B, 1, vocab).  `active` (B,) bool holds the lengths and the
    recurrent states of idle or mid-prefill slots (the whole batch
    computes; inactive updates are discarded); their KV writes land
    at/above their length (hidden until a real write replaces them) or in
    the null block."""
    x = _embed_tokens(params, cfg, tokens)
    positions = state.lengths[:, None]

    def commit(i, new):
        ssm.select_into_(state.caches[i], new, active)

    x = _trunk_step(params, cfg, x, positions, state.caches, state.lengths,
                    state.block_tables, commit)
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
    step serves every slot.  Both forms compute the same thing.  Recurrent
    layers advance the slot's slice of their state and write it back."""
    C = tokens.shape[1]
    idx = torch.as_tensor(slot, device=state.lengths.device).reshape(1).long()
    start = state.lengths.index_select(0, idx)                  # (1,)
    tables = state.block_tables.index_select(0, idx)            # (1, max_blocks)
    x = _embed_tokens(params, cfg, tokens)
    positions = start[:, None] + torch.arange(C, dtype=torch.int32,
                                              device=tokens.device)[None, :]
    caches = [c if isinstance(c, kvc.PagedKVCache)
              else type(c)(*(t.index_select(0, idx) for t in c)) for c in state.caches]

    def commit(i, new):
        for full, part in zip(state.caches[i], new):
            full.index_copy_(0, idx, part.to(full.dtype))

    x = _trunk_step(params, cfg, x, positions, caches, start, tables, commit)
    x = blocks._norm(x[:, -1:], params["final_norm"], cfg)
    logits = _unembed(x, params, cfg)
    new_lengths = state.lengths.index_add(
        0, idx, torch.full((1,), C, dtype=state.lengths.dtype, device=idx.device))
    return logits, PagedDecodeState(caches=state.caches,
                                    block_tables=state.block_tables,
                                    lengths=new_lengths)


def reset_slots(cfg: ArchConfig, state: PagedDecodeState,
                mask: torch.Tensor) -> PagedDecodeState:
    """Zero the length of every masked slot for a fresh request and return
    its recurrent states to their init, in place (m = -1e30, the rest 0).
    KV pages need no reset: freed blocks are rewritten before the length
    mask exposes them."""
    for cache in state.caches:
        if not isinstance(cache, kvc.PagedKVCache):
            ssm.reset_state_(cache, mask)
    lengths = torch.where(mask, torch.zeros_like(state.lengths), state.lengths)
    return PagedDecodeState(caches=state.caches,
                            block_tables=state.block_tables, lengths=lengths)


# ---------------------------------------------------------------------------
# Speculative verification
# ---------------------------------------------------------------------------


def _commit_verified(state: PagedDecodeState, per_pos: List[tuple],
                     active: torch.Tensor, sel: torch.Tensor) -> list:
    """The caches after a verify step, in place.  Paged KV pools pass
    through: writes at rejected positions sit at or past the committed
    length, hidden until a later write replaces them.  Each recurrent layer
    (`per_pos`: (layer index, its per-position states, leaves (B, S, ...)))
    takes each active slot's state after its `sel`-th token; inactive slots
    keep theirs."""
    for c in state.caches:
        if not isinstance(c, (kvc.PagedKVCache,) + ssm.RECURRENT_STATES):
            raise NotImplementedError(
                f"verify over a {type(c).__name__}: neither a paged pool nor a "
                f"recurrent state the port knows")
    rows = torch.arange(sel.shape[0], device=sel.device)
    sel = sel.to(torch.int64)
    for i, states in per_pos:
        picked = type(states)(*(leaf[rows, sel] for leaf in states))
        ssm.select_into_(state.caches[i], picked, active)
    return state.caches


def _verify_pass(params: dict, cfg: ArchConfig, state: PagedDecodeState,
                 tokens: torch.Tensor) -> Tuple[torch.Tensor, List[tuple]]:
    """Logits (B, S, vocab) of S tokens per slot at positions lengths ..
    lengths + S - 1, K/V of all S positions written through the tables, and
    each recurrent layer's per-position states, not yet committed."""
    S = tokens.shape[1]
    x = _embed_tokens(params, cfg, tokens)
    positions = state.lengths[:, None] + torch.arange(
        S, dtype=torch.int32, device=tokens.device)[None, :]
    per_pos: List[tuple] = []
    x = _trunk_step(params, cfg, x, positions, state.caches, state.lengths,
                    state.block_tables, lambda i, new: per_pos.append((i, new)),
                    collect_states=True)
    x = blocks._norm(x, params["final_norm"], cfg)
    return _unembed(x, params, cfg), per_pos


def _verify_trunk(params: dict, cfg: ArchConfig, state: PagedDecodeState,
                  tokens: torch.Tensor) -> torch.Tensor:
    """`_verify_pass`'s logits; recurrent states are left as they were."""
    return _verify_pass(params, cfg, state, tokens)[0]


def _emitted(out: torch.Tensor, acc: torch.Tensor, active: torch.Tensor,
             eos: torch.Tensor) -> torch.Tensor:
    """Tokens each slot commits: acc + 1 (the accepted drafts and one more),
    cut after the first eos among them; 0 for inactive slots."""
    S = out.shape[1]
    emit = torch.arange(S, device=out.device)[None, :] <= acc[:, None]
    eos_hit = (out == eos[:, None].to(out.dtype)) & emit
    first_eos = torch.argmax(eos_hit.to(torch.int32), dim=1)
    n_new = torch.where(eos_hit.any(dim=1), first_eos + 1, acc + 1)
    return torch.where(active, n_new, torch.zeros_like(n_new)).to(torch.int32)


def paged_verify_step(params: dict, cfg: ArchConfig, state: PagedDecodeState,
                      tokens: torch.Tensor, active: torch.Tensor,
                      limits: torch.Tensor, eos: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, PagedDecodeState]:
    """Score S drafted positions per slot in one paged pass and greedily
    accept the longest matching prefix: every projection and the head run
    at M = slots x S.

    tokens (B, S): the last committed token, then the drafter's S - 1
    guesses (padding past a slot's real drafts, bounded by `limits`);
    active (B,) bool; limits (B,) int32, the most tokens a slot may emit
    (>= 1 when active); eos (B,) int32, -1 for none.

    Returns (greedy (B, S) int64, n_new (B,) int32, state): greedy[i,
    :n_new[i]] are slot i's committed tokens, those n_new[i] successive
    `paged_decode_step` calls would emit; lengths advance by n_new, and
    each recurrent layer keeps its state after the n_new-th token
    (checkpoint and restore at token granularity, not a KV rewind)."""
    logits, per_pos = _verify_pass(params, cfg, state, tokens)
    greedy = torch.argmax(logits, dim=-1)                     # (B, S)
    # Draft i is kept iff it equals the argmax at the position before it;
    # the run stops at the first miss.
    match = (tokens[:, 1:] == greedy[:, :-1]).to(torch.int32)
    acc = torch.cumprod(match, dim=1).sum(dim=1)
    acc = torch.minimum(acc, torch.clamp(limits, min=1) - 1)
    n_new = _emitted(greedy, acc, active, eos)
    caches = _commit_verified(state, per_pos, active, torch.clamp(n_new - 1, min=0))
    return greedy, n_new, PagedDecodeState(
        caches=caches, block_tables=state.block_tables,
        lengths=(state.lengths + n_new).to(torch.int32))


# ---------------------------------------------------------------------------
# Sampling: temperature / top-k / top-p from a counter-based stream
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32) and a 32-bit constant,
    through the constant's 16-bit halves so no int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """A bijective 32-bit integer mix (xorshift-multiply, `lowbias32`'s
    constants) of int64 values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _fold_keys(seeds, idx) -> torch.Tensor:
    """Per-element keys: the 0-based generated-token index folded into the
    seed.  A pure function of (seed, index), never of the batch, tick or
    chunking, so a seeded request replays whatever else the engine serves;
    for one seed, distinct indices give distinct keys.  seeds / idx share a
    shape; the keys are int64 in [0, 2**32)."""
    seeds = torch.as_tensor(seeds).to(torch.int64) & _M32
    idx = torch.as_tensor(idx, device=seeds.device).to(torch.int64) & _M32
    return _hash32(_hash32(seeds ^ 0x5EED5EED) ^ idx)


def _fold_in(keys: torch.Tensor, data: int) -> torch.Tensor:
    """A second key derived from `keys` and a small integer."""
    return _hash32(keys ^ _hash32(torch.full_like(keys, data ^ 0x9E3779B9)))


def _uniform(keys: torch.Tensor) -> torch.Tensor:
    """One float32 uniform in (0, 1) per key: the top 24 bits of another
    round of the hash, centred in their interval (exact in float32)."""
    bits = _hash32(keys ^ 0x2545F491) >> 8
    return (bits.to(torch.float32) + 0.5) * (2.0 ** -24)


def _categorical(keys: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
    """One draw per row of softmax(adj) (..., V) by inverse CDF at the
    key's uniform: the first index whose running mass reaches u x total.
    A row's -inf entries add exactly 0 to the running mass, so they are
    never drawn; a one-hot row always returns its hot index."""
    probs = torch.softmax(adj, dim=-1)
    cdf = torch.cumsum(probs, dim=-1)
    target = _uniform(keys)[..., None] * cdf[..., -1:]
    tok = torch.searchsorted(cdf.contiguous(), target.contiguous())[..., 0]
    return torch.clamp(tok, max=adj.shape[-1] - 1)


def _adjusted_logits(logits: torch.Tensor, temperature, top_k, top_p
                     ) -> torch.Tensor:
    """Temperature, then top-k and top-p over logits (..., V) (knobs
    broadcast over logits.shape[:-1]): unnormalized float32 log-probs with
    truncated entries at -inf, whose softmax is the sampling distribution.
    Rows with temperature <= 0 are greedy: a one-hot 0 / -inf row at
    argmax(logits).  Computes what the reference computes, op for op."""
    V = logits.shape[-1]
    dev = logits.device
    logits = logits.to(torch.float32)
    temperature = torch.as_tensor(temperature, dtype=torch.float32, device=dev)
    top_k = torch.as_tensor(top_k, device=dev).to(torch.int64)
    top_p = torch.as_tensor(top_p, dtype=torch.float32, device=dev)
    greedy = temperature <= 0.0
    scaled = logits / torch.where(greedy, torch.ones_like(temperature),
                                  temperature)[..., None]
    desc = torch.sort(scaled, dim=-1, descending=True).values
    # top-k: keep entries >= the k-th largest (k = 0 keeps all); ties at
    # the threshold all survive.
    k = torch.where(top_k > 0, torch.clamp(top_k, max=V), torch.full_like(top_k, V))
    kth = torch.gather(desc, -1, (k - 1)[..., None].expand(desc.shape[:-1] + (1,)))
    keep = scaled >= kth
    # top-p: the smallest sorted prefix whose mass reaches top_p (exclusive
    # cumsum, so the boundary token stays and top_p = 1 keeps everything).
    probs = torch.softmax(desc, dim=-1)
    before = torch.cumsum(probs, dim=-1) - probs
    in_nucleus = before < top_p[..., None]
    cutoff = torch.amin(torch.where(in_nucleus, desc, torch.full_like(desc, float("inf"))),
                        dim=-1, keepdim=True)
    keep = keep & (scaled >= cutoff)
    neg_inf = torch.full_like(scaled, float("-inf"))
    adj = torch.where(keep, scaled, neg_inf)
    onehot = torch.arange(V, device=dev) == torch.argmax(logits, dim=-1, keepdim=True)
    return torch.where(greedy[..., None], torch.where(onehot, torch.zeros_like(adj), neg_inf),
                       adj)


def sample_tokens(logits: torch.Tensor, seeds, gen_idx, temperature, top_k,
                  top_p) -> torch.Tensor:
    """One token per row of logits (..., V) from the (seed, gen_idx) stream
    (int64, logits.shape[:-1]); greedy rows return argmax exactly."""
    adj = _adjusted_logits(logits, temperature, top_k, top_p)
    return _categorical(_fold_keys(seeds, gen_idx), adj)


def paged_decode_sample_step(params: dict, cfg: ArchConfig,
                             state: PagedDecodeState, tokens: torch.Tensor,
                             active: Optional[torch.Tensor], temperature, top_k,
                             top_p, seeds, gen_idx
                             ) -> Tuple[torch.Tensor, PagedDecodeState]:
    """`paged_decode_step` with the sampling head: (tokens (B,), state).
    The trunk is the greedy step's; greedy rows of a mixed batch still emit
    argmax."""
    logits, new_state = paged_decode_step(params, cfg, state, tokens, active)
    return sample_tokens(logits[:, -1], seeds, gen_idx, temperature, top_k,
                         top_p), new_state


def paged_verify_sample_step(params: dict, cfg: ArchConfig,
                             state: PagedDecodeState, tokens: torch.Tensor,
                             active: torch.Tensor, limits: torch.Tensor,
                             eos: torch.Tensor, temperature, top_k, top_p,
                             seeds, gen_idx
                             ) -> Tuple[torch.Tensor, torch.Tensor, PagedDecodeState]:
    """Speculative verification under sampling: `paged_verify_step`'s inputs
    plus the per-slot knobs, its (out (B, S), n_new (B,), state) contract.

    The drafter proposes a point mass, so rejection sampling reduces to:
    accept draft d_j with probability p~(d_j) (the adjusted distribution at
    the position before it) against the uniform of key (seed, gen_idx + j);
    at the first real rejection resample p~ with the rejected token masked
    out, from the key folded once more; after a run ended by the drafts or
    the limit, sample p~ unmasked.  Every emitted position is distributed
    as p~.  Greedy rows reduce to `paged_verify_step`'s accept rule."""
    logits, per_pos = _verify_pass(params, cfg, state, tokens)
    out, n_new = _verify_sample_tail(logits, tokens, active, limits, eos,
                                     temperature, top_k, top_p, seeds, gen_idx)
    caches = _commit_verified(state, per_pos, active, torch.clamp(n_new - 1, min=0))
    return out, n_new, PagedDecodeState(
        caches=caches, block_tables=state.block_tables,
        lengths=(state.lengths + n_new).to(torch.int32))


def _verify_sample_tail(logits: torch.Tensor, tokens: torch.Tensor,
                        active: torch.Tensor, limits: torch.Tensor,
                        eos: torch.Tensor, temperature, top_k, top_p, seeds,
                        gen_idx) -> Tuple[torch.Tensor, torch.Tensor]:
    """`paged_verify_sample_step` after its trunk: the verify logits (B, S,
    V) and the step's inputs -> (out (B, S), n_new (B,))."""
    B, S = tokens.shape
    V = logits.shape[-1]
    dev = tokens.device

    def bcast(a):
        return torch.as_tensor(a, device=dev)[:, None].expand(B, S)

    adj = _adjusted_logits(logits, bcast(temperature), bcast(top_k), bcast(top_p))
    probs = torch.softmax(adj, dim=-1)                        # p~
    pos = torch.arange(S, device=dev)
    keys = _fold_keys(bcast(seeds), bcast(gen_idx).to(torch.int64) + pos[None, :])
    u = _uniform(keys)                                        # (B, S)
    drafts = tokens[:, 1:]
    p_draft = torch.gather(probs[:, :-1], -1, drafts[..., None])[..., 0]
    accept = (u[:, :S - 1] < p_draft).to(torch.int32)
    acc_raw = torch.cumprod(accept, dim=1).sum(dim=1)
    acc = torch.minimum(acc_raw, torch.clamp(limits, min=1) - 1)
    # Position acc emits a fresh draw: masked when a real rejection ended
    # the run, unmasked after the drafts or the limit ran out.
    rejected = (acc == acc_raw) & (acc < S - 1)
    rows = torch.arange(B, device=dev)
    acc64 = acc.to(torch.int64)
    key2 = _fold_in(keys[rows, acc64], 1)
    bad = tokens[rows, torch.clamp(acc64 + 1, max=S - 1)]
    row = adj[rows, acc64]                                    # (B, V)
    hit = rejected[:, None] & (torch.arange(V, device=dev)[None, :] == bad[:, None])
    final = _categorical(key2, torch.where(hit, torch.full_like(row, float("-inf")), row))
    draft_shift = torch.nn.functional.pad(drafts, (0, 1))
    out = torch.where(pos[None, :] < acc[:, None], draft_shift, final[:, None])
    return out, _emitted(out, acc, active, eos)
