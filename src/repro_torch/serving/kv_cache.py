"""Paged KV cache: fixed-size blocks + per-request block tables (port of
repro/serving/kv_cache.py).

Per attention layer K and V live in a shared pool

  k / v            : (num_blocks, block_size, H_kv, D)
  k_scale / v_scale: (num_blocks, block_size, H_kv) float32, int8 pools only
  block_tables     : (slots, max_blocks_per_slot) int32, entries index blocks

An int8 pool (`kv_precision="int8"`) holds symmetric int8 codes with one
scale per (block, position, kv head): a token is quantized once, when it
is written, and readers dequantize (the decode kernel in registers,
`gather_kv` into float32).  The quantize-on-write is plain PyTorch, as it
is jnp in the reference.

Block 0 is the reserved null block: unallocated table entries point at it,
and writes from idle slots or positions past a table's capacity land there.
The allocator never hands it out and the causal length mask never exposes
it, so its contents are garbage nobody reads.

Device side: `write_kv` updates the pools in place.  The reference returns
new pools, but it never keeps the old ones (its steps donate the state and
pass the pools through unchanged wherever a slot is inactive), so writing
in place computes the same thing without copying the pool every step.
Host side: `BlockAllocator` and `BlockTables` decide allocation between
steps.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

NULL_BLOCK = 0


class PagedKVCache(NamedTuple):
    """Block-pooled decode cache for one attention layer: float pools, or
    int8 pools with per-(block, position, kv-head) scales."""

    k: torch.Tensor  # (num_blocks, block_size, H_kv, D)
    v: torch.Tensor  # (num_blocks, block_size, H_kv, D)
    k_scale: Optional[torch.Tensor] = None  # (num_blocks, block_size, H_kv) f32
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def init_paged_kv(num_blocks: int, block_size: int, n_kv_heads: int,
                  head_dim: int, dtype: torch.dtype, device, *,
                  kv_precision: str = "float") -> PagedKVCache:
    shape = (num_blocks, block_size, n_kv_heads, head_dim)
    if kv_precision == "int8":
        z8 = dict(dtype=torch.int8, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        return PagedKVCache(k=torch.zeros(shape, **z8), v=torch.zeros(shape, **z8),
                            k_scale=torch.ones(shape[:-1], **f32),
                            v_scale=torch.ones(shape[:-1], **f32))
    if kv_precision != "float":
        raise ValueError(
            f"unknown kv_precision {kv_precision!r}; known: float, int8")
    return PagedKVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                        v=torch.zeros(shape, dtype=dtype, device=device))


def clear_paged_kv(cache: PagedKVCache) -> PagedKVCache:
    """Return the pools to `init_paged_kv`'s contents, in place: zero codes
    and, for an int8 pool, unit scales."""
    cache.k.zero_()
    cache.v.zero_()
    if cache.quantized:
        cache.k_scale.fill_(1.0)
        cache.v_scale.fill_(1.0)
    return cache


def quantize_kv_tokens(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per (token, kv head): (B, S, H, D) float -> ((B, S, H, D)
    int8 codes, (B, S, H) f32 scales).  A zero row quantizes to zero codes
    at scale 1, not at the 1e-8 floor of `quantize_ref`.  The scale is
    amax * f32(1/127), as the reference's compiled write computes it (see
    kernels/quant.py)."""
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=-1)
    scale = torch.where(amax > 0, amax * (1.0 / 127.0), torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def _flat_positions(block_tables: torch.Tensor, start, S: int,
                    block_size: int) -> torch.Tensor:
    """Pool-flat indices (B, S) int64 for S tokens from `start` per slot.

    block_tables (B, max_blocks); start a scalar or (B,).  Positions past a
    slot's table capacity resolve to the null block (without the mask the
    table lookup would clamp to the last entry and overwrite a live block),
    so every index is in range and no write is ever dropped."""
    B, max_blocks = block_tables.shape
    dev = block_tables.device
    start = torch.as_tensor(start, dtype=torch.int64, device=dev)
    if start.dim() == 0:
        start = start.expand(B)
    pos = start.to(torch.int64)[:, None] + torch.arange(S, device=dev)[None, :]
    pos = pos.clamp_min(0)
    table_cap = max_blocks * block_size
    blk = torch.gather(block_tables.to(torch.int64), 1,
                       pos.clamp_max(table_cap - 1) // block_size)
    blk = torch.where(pos < table_cap, blk, torch.full_like(blk, NULL_BLOCK))
    return blk * block_size + pos % block_size


def write_kv(cache: PagedKVCache, block_tables: torch.Tensor,
             k_new: torch.Tensor, v_new: torch.Tensor, start) -> PagedKVCache:
    """Scatter S new tokens per slot (k_new/v_new (B, S, H, D)) into the
    pools at positions start..start+S-1, in place; an int8 pool quantizes
    them first and scatters the scales through the same indices.  Distinct
    live slots own distinct blocks, so real writes never collide; only
    idle-slot and past-capacity writes share an index, all inside the null
    block."""
    nb, bs, H, D = cache.k.shape
    S = k_new.shape[1]
    flat = _flat_positions(block_tables, start, S, bs).reshape(-1)
    if cache.quantized:
        k_new, ks = quantize_kv_tokens(k_new)
        v_new, vs = quantize_kv_tokens(v_new)
        cache.k_scale.view(nb * bs, H).index_copy_(0, flat, ks.reshape(-1, H))
        cache.v_scale.view(nb * bs, H).index_copy_(0, flat, vs.reshape(-1, H))
    cache.k.view(nb * bs, H, D).index_copy_(
        0, flat, k_new.reshape(-1, H, D).to(cache.k.dtype))
    cache.v.view(nb * bs, H, D).index_copy_(
        0, flat, v_new.reshape(-1, H, D).to(cache.v.dtype))
    return cache


def gather_kv(cache: PagedKVCache, block_tables: torch.Tensor):
    """Per-slot contiguous K/V views (B, max_blocks * block_size, H, D): a
    gather through the block table.  Entries past a slot's length read the
    null block; callers mask by position.  int8 pools are dequantized here
    (float32 out)."""
    nb, bs, H, D = cache.k.shape
    B = block_tables.shape[0]
    offs = torch.arange(bs, device=block_tables.device)
    flat = (block_tables.to(torch.int64)[:, :, None] * bs
            + offs[None, None, :]).reshape(B, -1)
    k = cache.k.reshape(nb * bs, H, D)[flat]
    v = cache.v.reshape(nb * bs, H, D)[flat]
    if cache.quantized:
        k = k.to(torch.float32) * cache.k_scale.reshape(nb * bs, H)[flat][..., None]
        v = v.to(torch.float32) * cache.v_scale.reshape(nb * bs, H)[flat][..., None]
    return k, v


def pool_bytes(cache: PagedKVCache) -> int:
    """Resident bytes of this pool (codes and, for int8, scales)."""
    return sum(t.numel() * t.element_size() for t in cache if t is not None)


# ---------------------------------------------------------------------------
# Host side: allocation decisions between steps
# ---------------------------------------------------------------------------


def blocks_for(tokens: int, block_size: int) -> int:
    return -(-tokens // block_size) if tokens > 0 else 0


class BlockAllocator:
    """Free-list allocator over pool blocks 1..num_blocks-1 (0 is the null
    block) with admission-time reservations.

    A request reserves its worst-case block count when admitted and draws
    blocks lazily as its length crosses block boundaries, so admission
    control guarantees it never starves mid-decode."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (block 0 is reserved)")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))  # pop() -> 1 first
        self._live: set = set()
        self._reserved = 0

    @property
    def reserved(self) -> int:
        """Blocks promised to admitted requests but not yet drawn."""
        return self._reserved

    @property
    def available(self) -> int:
        """Blocks neither allocated nor promised to an admitted request."""
        return len(self._free) - self._reserved

    @property
    def in_use(self) -> int:
        return (self.num_blocks - 1) - len(self._free)

    def occupancy(self) -> float:
        return self.in_use / max(1, self.num_blocks - 1)

    def can_reserve(self, n: int) -> bool:
        return n <= self.available

    def reserve(self, n: int) -> bool:
        if not self.can_reserve(n):
            return False
        self._reserved += n
        return True

    def alloc(self, n: int, *, reserved: bool = True) -> List[int]:
        if n > len(self._free):
            raise RuntimeError(
                f"block pool exhausted: want {n}, free {len(self._free)}")
        out = [self._free.pop() for _ in range(n)]
        self._live.update(out)
        if reserved:
            self._reserved = max(0, self._reserved - n)
        return out

    def free(self, ids: List[int], *, unreserve: int = 0) -> int:
        """Return blocks to the free list and drop `unreserve` blocks of the
        caller's unused reservation; returns the number freed."""
        for b in ids:
            if b == NULL_BLOCK:
                raise ValueError("cannot free the null block")
            if b not in self._live:
                raise ValueError(f"double free of block {b}")
            self._live.remove(b)
            self._free.append(b)
        self._reserved = max(0, self._reserved - unreserve)
        return len(ids)

    def check(self) -> None:
        """Invariant: free list and live blocks partition blocks 1..n-1."""
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate ids on the free list"
        assert not (free & self._live), "blocks both free and live"
        assert NULL_BLOCK not in free | self._live, "null block escaped"
        assert free | self._live == set(range(1, self.num_blocks)), "leaked blocks"
        assert 0 <= self._reserved <= len(self._free), "over-reserved"


class BlockTables:
    """Host mirror of the device block tables: (slots, max_blocks) int32.

    The engine copies it into the device tables (`copy_to`) whenever a row
    changed (growth, release)."""

    def __init__(self, slots: int, max_blocks: int):
        self.slots = slots
        self.max_blocks = max_blocks
        self.table = np.zeros((slots, max_blocks), np.int32)
        self.blocks: List[List[int]] = [[] for _ in range(slots)]
        self.dirty = True

    def ensure(self, slot: int, length: int, alloc: BlockAllocator) -> bool:
        """Grow slot's table to cover `length` tokens; True if it changed."""
        need = blocks_for(length, alloc.block_size) - len(self.blocks[slot])
        if need <= 0:
            return False
        if len(self.blocks[slot]) + need > self.max_blocks:
            raise RuntimeError(
                f"slot {slot}: {length} tokens exceed max_blocks {self.max_blocks}")
        for b in alloc.alloc(need):
            self.table[slot, len(self.blocks[slot])] = b
            self.blocks[slot].append(b)
        self.dirty = True
        return True

    def release(self, slot: int, alloc: BlockAllocator, *, unreserve: int = 0) -> int:
        """Free all of slot's blocks back to the pool; returns count freed."""
        ids = self.blocks[slot]
        n = len(ids)
        alloc.free(ids, unreserve=unreserve)
        self.blocks[slot] = []
        self.table[slot, :] = NULL_BLOCK
        self.dirty = True
        return n

    def array(self, device) -> torch.Tensor:
        self.dirty = False
        return torch.from_numpy(self.table.copy()).to(device)

    def copy_to(self, dst: torch.Tensor) -> None:
        """Write the tables into the device tensor `dst` in place, which
        keeps its address (a CUDA graph reads the tables there)."""
        dst.copy_(torch.from_numpy(self.table))
        self.dirty = False


def default_pool_blocks(slots: int, max_seq: int, block_size: int, *,
                        headroom: float = 1.0) -> int:
    """Pool sizing: null block + headroom * worst-case concurrent demand."""
    per_slot = blocks_for(max_seq, block_size)
    return 1 + max(1, math.ceil(headroom * slots * per_slot))
