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

Device side: `write_kv`, `copy_blocks` and `swap_in_blocks` update the
pools in place.  The reference returns new pools, but it never keeps the
old ones (its steps donate the state and pass the pools through unchanged
wherever a slot is inactive), so writing in place computes the same thing
without copying the pool, and a captured CUDA graph keeps reading the pools
at their addresses.  `swap_out_blocks` copies blocks to (pinned) host
memory for KV-swap preemption.
Host side: `BlockAllocator` (refcounted blocks) and `BlockTables` (growth,
prefix seeding, copy-on-write divergence, speculative rewind) decide
allocation between steps.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

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


def _ids(ids, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(ids, np.int64), device=device)


def copy_blocks(cache: PagedKVCache, src, dst) -> PagedKVCache:
    """pool[dst[i]] = pool[src[i]] for K and V (and an int8 pool's scales),
    in place: the write half of copy-on-write divergence
    (`BlockTables.make_writable`).  `src` / `dst` are (n,) block ids."""
    src, dst = _ids(src, cache.k.device), _ids(dst, cache.k.device)
    for t in cache:
        if t is not None:
            t.index_copy_(0, dst, t.index_select(0, src))
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


_FIELDS = ("k", "v", "k_scale", "v_scale")


def swap_out_blocks(caches, ids) -> List[Dict[str, torch.Tensor]]:
    """Copy pool blocks `ids` of every layer to host memory (pinned when the
    pools live on a card): one dict of tensors per layer, in the pool's
    dtypes (an int8 pool's codes and f32 scales).  The device-to-host half
    of KV-swap preemption.  The copies are queued on the current stream;
    the caller synchronizes before it reads them on the host, and any
    later write to those blocks is ordered after them on the stream."""
    out: List[Dict[str, torch.Tensor]] = []
    for c in caches:
        if not isinstance(c, PagedKVCache):
            raise TypeError(
                "swap_out_blocks requires paged (attention) cache kinds; "
                "recurrent state is not block-addressable")
        idx = _ids(ids, c.k.device)
        pin = c.k.device.type == "cuda"
        entry = {}
        for name, t in zip(_FIELDS, c):
            if t is None:
                continue
            sel = t.index_select(0, idx)
            host = torch.empty(sel.shape, dtype=sel.dtype, pin_memory=pin)
            entry[name] = host.copy_(sel, non_blocking=pin)
        out.append(entry)
    return out


def swap_in_blocks(caches, ids, saved: List[Dict[str, torch.Tensor]]):
    """Write a `swap_out_blocks` payload into pool blocks `ids` (freshly
    allocated, not necessarily the ids swapped out: block contents do not
    depend on their id), in place; returns the caches."""
    for c, entry in zip(caches, saved):
        idx = _ids(ids, c.k.device)
        for name, t in zip(_FIELDS, c):
            if t is not None:
                t.index_copy_(0, idx, entry[name].to(t.device, non_blocking=True))
    return caches


# ---------------------------------------------------------------------------
# Host side: allocation decisions between steps
# ---------------------------------------------------------------------------


def blocks_for(tokens: int, block_size: int) -> int:
    return -(-tokens // block_size) if tokens > 0 else 0


class BlockAllocator:
    """Free-list allocator over pool blocks 1..num_blocks-1 (0 is the null
    block) with admission-time reservations and per-block refcounts.

    A request reserves its worst-case block count when admitted and draws
    blocks lazily as its length crosses block boundaries, so admission
    control guarantees it never starves mid-decode.  Refcounts make blocks
    shareable (`ref`, `fork_blocks`): a prompt prefix reused by a later
    request, or held by the prefix cache.  `free` returns a block to the
    free list only when its last owner lets go.  Shared blocks are
    read-only by convention; `BlockTables.make_writable` + `copy_blocks`
    diverge one before a write."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (block 0 is reserved)")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))  # pop() -> 1 first
        self._refs: Dict[int, int] = {}
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
        for b in out:
            self._refs[b] = 1
        if reserved:
            self._reserved = max(0, self._reserved - n)
        return out

    def ref(self, ids: List[int]) -> None:
        """Add one owner to each (already allocated) block."""
        for b in ids:
            if b not in self._refs:
                raise ValueError(f"block {b} is not allocated; cannot share it")
            self._refs[b] += 1

    def refcount(self, b: int) -> int:
        return self._refs.get(b, 0)

    def free(self, ids: List[int], *, unreserve: int = 0,
             rereserve: bool = False) -> int:
        """Drop one owner per block; a block returns to the free list only
        when its last owner frees it.  `unreserve` drops that many blocks of
        the caller's unused reservation.  `rereserve` puts every block that
        reached the free list back under the caller's reservation (the
        speculative rewind: the request may redraw them later); a shared
        block only loses a ref and is not re-reserved, since the free list
        did not grow.  Returns the number of blocks that reached the free
        list."""
        returned = 0
        for b in ids:
            if b == NULL_BLOCK:
                raise ValueError("cannot free the null block")
            rc = self._refs.get(b, 0)
            if rc <= 0:
                raise ValueError(f"double free of block {b}")
            if rc == 1:
                del self._refs[b]
                self._free.append(b)
                returned += 1
            else:
                self._refs[b] = rc - 1
        self._reserved = max(0, self._reserved - unreserve)
        if rereserve:
            self._reserved += returned
        return returned

    def check(self) -> None:
        """Invariant: the free list and the refcounted blocks partition
        blocks 1..n-1, every refcount is positive, the null block is owned
        by neither, and reservations fit the free list."""
        free, live = set(self._free), set(self._refs)
        assert len(free) == len(self._free), "duplicate ids on the free list"
        assert not (free & live), f"blocks both free and live: {free & live}"
        assert NULL_BLOCK not in free | live, "null block escaped"
        every = set(range(1, self.num_blocks))
        assert free | live == every, f"leaked blocks: {sorted(every - free - live)}"
        assert all(rc > 0 for rc in self._refs.values()), "non-positive refcount"
        assert 0 <= self._reserved <= len(self._free), "over-reserved"


def fork_blocks(alloc: BlockAllocator, ids: List[int]) -> List[int]:
    """Copy-on-write fork: share `ids` with a new owner (refcount + 1 each)
    and return the same ids.  No KV bytes move.  The engine forks only full
    blocks at block-aligned prefix boundaries, so its writes never reach a
    forked block."""
    alloc.ref(ids)
    return list(ids)


class BlockTables:
    """Host mirror of the device block tables: (slots, max_blocks) int32.

    The engine copies it into the device tables (`copy_to`) whenever a row
    changed (growth, seeding, divergence, rewind, release)."""

    def __init__(self, slots: int, max_blocks: int):
        self.slots = slots
        self.max_blocks = max_blocks
        self.table = np.zeros((slots, max_blocks), np.int32)
        self.blocks: List[List[int]] = [[] for _ in range(slots)]
        self.dirty = True

    def covered_tokens(self, slot: int, block_size: int) -> int:
        return len(self.blocks[slot]) * block_size

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

    def seed(self, slot: int, ids: List[int]) -> None:
        """Install already-owned blocks (a forked prefix, or restored swap
        blocks) at the head of an empty slot row; `release` later drops
        them like any other entry."""
        if self.blocks[slot]:
            raise RuntimeError(f"slot {slot} is not empty; seed only a fresh slot")
        if len(ids) > self.max_blocks:
            raise RuntimeError(
                f"seed of {len(ids)} blocks exceeds max_blocks {self.max_blocks}")
        self.table[slot, :len(ids)] = ids
        self.blocks[slot] = list(ids)
        self.dirty = True

    def make_writable(self, slot: int, block_idx: int, alloc: BlockAllocator
                      ) -> Optional[Tuple[int, int]]:
        """Copy-on-write divergence of one entry: if its block is shared,
        allocate a private replacement, swap it into the row, drop this
        slot's ref on the original and return (src, dst) for `copy_blocks`;
        None when the block is already exclusive."""
        b = self.blocks[slot][block_idx]
        if alloc.refcount(b) <= 1:
            return None
        [fresh] = alloc.alloc(1, reserved=False)
        alloc.free([b])
        self.blocks[slot][block_idx] = fresh
        self.table[slot, block_idx] = fresh
        self.dirty = True
        return b, fresh

    def rewind(self, slot: int, length: int, alloc: BlockAllocator, *,
               rereserve: bool = True) -> Tuple[int, Optional[Tuple[int, int]]]:
        """Shrink slot's table to cover exactly `length` tokens, returning
        the blocks past it to the pool (and, with `rereserve`, to the
        request's reservation): the rollback of rejected speculative
        positions.  Freed blocks are not zeroed; every block is rewritten
        before the length mask exposes it.  A partial, shared new tail
        block is diverged first (`make_writable`), so the slot never writes
        bytes another owner reads.  Returns (blocks freed, the (src, dst)
        pair to clone with `copy_blocks` or None)."""
        keep = blocks_for(length, alloc.block_size)
        ids = self.blocks[slot]
        if keep > len(ids):
            raise ValueError(
                f"slot {slot}: cannot rewind to {length} tokens ({keep} blocks)"
                f" - only {len(ids)} blocks held")
        dropped = ids[keep:]
        if dropped:
            alloc.free(dropped, rereserve=rereserve)
            del ids[keep:]
            self.table[slot, keep:] = NULL_BLOCK
            self.dirty = True
        pair = None
        if keep and length % alloc.block_size:
            pair = self.make_writable(slot, keep - 1, alloc)
        return len(dropped), pair

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
