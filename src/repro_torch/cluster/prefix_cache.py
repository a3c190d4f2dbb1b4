"""Radix-tree prompt-prefix cache over the paged KV block pool (copy of
repro/cluster/prefix_cache.py).

Requests that share a prompt prefix — the shared-system-prompt pattern, or
any repeated prompt — should not re-prefill it: the KV for those tokens is
already sitting in pool blocks written by an earlier request.  This cache
indexes those blocks by their *token content* so a later admission can fork
them (refcount, zero bytes copied; kv_cache.fork_blocks) and prefill only
the uncached suffix.  It is the request-level face of the same idea as the
paper's multi-banked scratchpad: one shared physical pool, many concurrent
streams addressing into it.

Granularity is one KV block: a tree node keys on a ``block_size``-token
tuple and owns exactly the pool block holding those tokens' K/V.  The tree
is a radix trie over block-sized token chunks — a path root..node spells a
block-aligned prompt prefix.  Only *full* blocks are ever cached, so a hit
is always block-aligned and the admitting request's KV writes (which start
at the first uncached position) never touch a shared block; the
copy-on-write machinery in kv_cache.py therefore stays off the hot path.

Ownership: the cache holds one allocator ref per node (taken at insert,
dropped at evict).  A block freed by its writing request thus survives in
the pool while cached, and a block evicted from the cache survives while
any request still reads it — the refcounted pool is the single source of
truth.  Eviction is LRU over leaves (deepest, stalest prefixes go first),
so every cached path stays rooted.

The cache is engine-local and runs on the engine's thread.  (The
reference's router, which steers same-prefix requests to one replica, is
not ported yet.)
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple


class _Node:
    __slots__ = ("children", "block", "stamp", "parent", "key")

    def __init__(self, parent: Optional["_Node"] = None,
                 key: Optional[Tuple[int, ...]] = None,
                 block: Optional[int] = None):
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.block = block
        self.stamp = 0
        self.parent = parent
        self.key = key


class PrefixCache:
    """Block-granular radix cache bound to one BlockAllocator."""

    def __init__(self, alloc, *, max_blocks: Optional[int] = None):
        self.alloc = alloc
        self.block_size = alloc.block_size
        self.max_blocks = max_blocks      # None: bounded only by pool pressure
        self._root = _Node()
        self._clock = 0
        self._count = 0
        # stats
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0
        self.lookup_tokens = 0
        self.inserted_blocks = 0
        self.evicted_blocks = 0

    # -- content keys --------------------------------------------------------

    def _keys(self, tokens) -> List[Tuple[int, ...]]:
        toks = [int(t) for t in tokens]
        bs = self.block_size
        return [tuple(toks[i * bs:(i + 1) * bs])
                for i in range(len(toks) // bs)]

    # -- the request path ----------------------------------------------------

    def lookup(self, tokens) -> Tuple[List[int], int]:
        """Longest cached full-block prefix of `tokens`.

        Capped at ``len(tokens) - 1`` so at least one suffix token remains
        to prefill — the final prefill chunk's logits are what produce the
        request's first generated token.  Returns ``(block_ids, covered)``
        *without* taking refs; the caller forks (kv_cache.fork_blocks) the
        ids it actually uses.
        """
        self.lookups += 1
        self.lookup_tokens += len(tokens)
        self._clock += 1
        usable = (len(tokens) - 1) // self.block_size
        node, out = self._root, []
        for key in self._keys(tokens)[:usable]:
            child = node.children.get(key)
            if child is None:
                break
            child.stamp = self._clock
            out.append(child.block)
            node = child
        if out:
            self.hits += 1
            self.hit_tokens += len(out) * self.block_size
        return out, len(out) * self.block_size

    def insert(self, tokens, blocks: List[int]) -> int:
        """Publish `blocks` — full, already-written pool blocks spelling
        `tokens` — taking one cache-owned ref per *newly adopted* block.

        Existing nodes keep their block (first writer wins): a concurrent
        duplicate prefill keeps sole ownership of its copy and frees it at
        finish, so refcounts stay exact.  Returns the adopted count.
        """
        keys = self._keys(tokens)
        if len(keys) * self.block_size != len(tokens):
            raise ValueError(
                f"insert must be block-aligned: {len(tokens)} tokens vs "
                f"block_size {self.block_size}")
        if len(blocks) != len(keys):
            raise ValueError(f"{len(blocks)} blocks for {len(keys)} chunks")
        self._clock += 1
        node, adopted = self._root, 0
        for key, b in zip(keys, blocks):
            child = node.children.get(key)
            if child is None:
                self.alloc.ref([b])          # the cache's own share
                child = _Node(parent=node, key=key, block=b)
                node.children[key] = child
                self._count += 1
                self.inserted_blocks += 1
                adopted += 1
            child.stamp = self._clock
            node = child
        if self.max_blocks is not None and self._count > self.max_blocks:
            self.evict(self._count - self.max_blocks)
        return adopted

    # -- eviction ------------------------------------------------------------

    def _leaves(self) -> List[_Node]:
        stack, out = [self._root], []
        while stack:
            n = stack.pop()
            for c in n.children.values():
                (stack if c.children else out).append(c)
        return out

    def evict(self, n_blocks: int) -> int:
        """Drop up to `n_blocks` LRU leaves, freeing the cache's refs.

        A freed block returns to the pool immediately iff no in-flight
        request still shares it (the allocator keeps it alive otherwise).
        Leaves-first keeps every remaining cached path rooted; evicting a
        leaf may expose its parent, which the next sweep considers.
        """
        freed = 0
        while freed < n_blocks:
            leaves = self._leaves()
            if not leaves:
                break
            leaves.sort(key=lambda nd: nd.stamp)
            for nd in leaves:
                if freed >= n_blocks:
                    break
                self.alloc.free([nd.block])
                del nd.parent.children[nd.key]
                self._count -= 1
                self.evicted_blocks += 1
                freed += 1
        return freed

    def clear(self) -> int:
        return self.evict(self._count)

    # -- introspection -------------------------------------------------------

    @property
    def cached_blocks(self) -> int:
        return self._count

    @property
    def cached_tokens(self) -> int:
        return self._count * self.block_size

    @property
    def hit_rate(self) -> float:
        return self.hits / max(1, self.lookups)

    def __repr__(self) -> str:
        return (f"PrefixCache(blocks={self._count}, hits={self.hits}/"
                f"{self.lookups}, hit_tokens={self.hit_tokens})")
