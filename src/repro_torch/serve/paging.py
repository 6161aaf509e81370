"""Paged KV-cache bookkeeping + radix prefix-cache sharing (host side).

The fixed per-slot KV tensors bound concurrency by worst-case sequence
length: a slot owns ``max_seq`` cache positions whether its request uses 9
or 9000. Paging replaces that with fixed-size KV *blocks* (``block_size``
positions each) drawn from one shared pool; a slot's cache is a *block
table* — an ordered list of block ids — and the jitted steps gather the
slot's logical view through that indirection (``models.common.paged_gather``/
``paged_scatter_*``). Blocks are reference-counted: a block shared by N
owners is stored once, and copy-on-write (``ensure_writable``) guarantees a
writer never mutates a block another owner can still read.

On top of the allocator sits a radix/trie prefix cache keyed on token
content at block granularity: production traffic is dominated by shared
system prompts, and a request whose prompt prefix matches cached blocks maps
them into its table (refcount bump, ZERO prefill compute) and only prefills
the unmatched tail. Prefill cost becomes O(distinct prefixes), not
O(requests). Trie nodes hold their own reference, so prefix blocks survive
the request that computed them; when the pool runs dry the engine evicts
LRU trie entries nobody else references.

Invariants the engine relies on:

- block 0 is the reserved *null* block: free slots and unallocated table
  entries point at it, so gather/scatter indices are always in range and
  duplicate scatters land harmlessly in a block nothing ever reads.
- only FULL blocks are ever shared (trie matching is block-granular), so a
  slot's write position — decode append or prefill tail — always lands in a
  block it owns exclusively; ``ensure_writable`` is a defensive backstop,
  not a hot path.
- freed blocks are queued on ``pending_zero`` and zeroed (one jitted
  scatter, engine-side) before reuse, keeping the pool bit-identical to a
  contiguous cache that resets slot rows on release.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["PagePool", "RadixPrefixCache", "resolve_kv_block_size"]


def resolve_kv_block_size(spec, max_seq: int, supported: bool = True):
    """Normalize a ``kv_block_size`` argument.

    ``"auto"``/True -> the largest power-of-two block size <= 32 that
    divides ``max_seq`` (divisibility keeps the paged logical view exactly
    ``max_seq`` positions long — the bit-exactness contract vs. the
    contiguous cache needs identical attention reduction shapes); ``None``/
    ``"off"``/False -> paging disabled (contiguous per-slot cache). An
    explicit int must divide ``max_seq`` and raises otherwise. With
    ``supported=False`` (recurrent families, windowed ring caches) ``auto``
    silently degrades to off; an explicit size raises.
    """
    if spec in (None, False, "off", "none"):
        return None
    if spec in (True, "auto"):
        if not supported:
            return None
        for bs in (32, 16, 8, 4, 2):
            if bs <= max_seq and max_seq % bs == 0:
                return bs
        return None                      # odd max_seq: not worth paging
    bs = int(spec)
    if not supported:
        raise ValueError(
            "this model family cannot use a paged KV cache "
            "(pass kv_block_size='off')")
    if bs < 1 or max_seq % bs != 0:
        raise ValueError(
            f"kv_block_size={bs} must divide max_seq={max_seq} "
            "(the paged view must cover exactly max_seq positions)")
    return bs


@dataclasses.dataclass
class PageStats:
    total_blocks: int = 0
    peak_used: int = 0
    allocs: int = 0
    cow_copies: int = 0

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


class PagePool:
    """Block allocator + per-slot block tables (host bookkeeping only).

    The device-side pool tensor lives in the engine; this class tracks which
    pool blocks back which slot positions, reference counts, the free list,
    and the ``pending_zero`` queue of freed blocks the engine must scrub
    before reuse.
    """

    NULL = 0

    def __init__(self, n_slots: int, n_slot_blocks: int, n_blocks: int,
                 block_size: int):
        if n_blocks < n_slot_blocks + 1:
            raise ValueError(
                f"pool of {n_blocks} blocks cannot back even one full slot "
                f"({n_slot_blocks} blocks + the reserved null block)")
        self.n_slots = n_slots
        self.n_slot_blocks = n_slot_blocks
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.tables = np.zeros((n_slots, n_slot_blocks), np.int32)
        self.refcount = np.zeros(n_blocks, np.int32)
        self.refcount[self.NULL] = 2**30          # pinned, never allocatable
        self._free: List[int] = list(range(n_blocks - 1, 0, -1))  # pop() -> 1
        self.pending_zero: List[int] = []
        self.stats = PageStats(total_blocks=n_blocks - 1)

    # -- allocation ----------------------------------------------------------

    def free_blocks(self) -> int:
        return len(self._free)

    def used_blocks(self) -> int:
        return self.n_blocks - 1 - len(self._free)

    def blocks_for(self, n_positions: int) -> int:
        """Blocks needed to back ``n_positions`` cache positions."""
        return -(-int(n_positions) // self.block_size)

    def alloc(self) -> Optional[int]:
        """Pop a free block (refcount 1); None when the pool is dry.

        The caller (engine) must flush ``pending_zero`` first — a freed
        block re-enters circulation only after its stale KV is scrubbed.
        """
        if not self._free:
            return None
        blk = self._free.pop()
        self.refcount[blk] = 1
        self.stats.allocs += 1
        self.stats.peak_used = max(self.stats.peak_used, self.used_blocks())
        return blk

    def retain(self, blk: int):
        assert blk != self.NULL
        assert self.refcount[blk] > 0, f"retain of dead block {blk}"
        self.refcount[blk] += 1

    def free(self, blk: int):
        """Drop one reference; a block nobody references returns to the
        free list and is queued for zeroing."""
        if blk == self.NULL:
            return
        assert self.refcount[blk] > 0, f"double free of block {blk}"
        self.refcount[blk] -= 1
        if self.refcount[blk] == 0:
            self._free.append(blk)
            self.pending_zero.append(blk)

    def drain_pending_zero(self) -> List[int]:
        out, self.pending_zero = self.pending_zero, []
        return out

    # -- slot tables ---------------------------------------------------------

    def table_row(self, slot: int) -> np.ndarray:
        return self.tables[slot]

    def slot_blocks(self, slot: int) -> List[int]:
        """Non-null blocks currently mapped by ``slot`` (table order)."""
        row = self.tables[slot]
        return [int(b) for b in row[row != self.NULL]]

    def map_shared(self, slot: int, blocks: Sequence[int]):
        """Map already-populated blocks (a matched prefix) into the head of
        ``slot``'s table, taking one reference each — the zero-compute path
        a prefix-cache hit rides."""
        assert len(blocks) <= self.n_slot_blocks
        for j, blk in enumerate(blocks):
            assert self.tables[slot, j] == self.NULL, (
                f"slot {slot} entry {j} already mapped")
            self.retain(blk)
            self.tables[slot, j] = blk

    def ensure_capacity(self, slot: int, n_positions: int,
                        alloc_fn=None) -> bool:
        """Allocate blocks so positions [0, n_positions) are backed.

        ``alloc_fn`` (default ``self.alloc``) lets the engine interpose
        prefix-cache eviction + pending-zero flushing. Returns False —
        with any partial allocations kept mapped — when the pool is dry.
        """
        alloc_fn = alloc_fn or self.alloc
        for j in range(self.blocks_for(n_positions)):
            if self.tables[slot, j] == self.NULL:
                blk = alloc_fn()
                if blk is None:
                    return False
                self.tables[slot, j] = blk
        return True

    def ensure_writable(self, slot: int, pos: int,
                        alloc_fn=None) -> Tuple[str, int, int]:
        """Make the block holding position ``pos`` exclusively writable.

        Returns one of::

            ("ok",   blk,  -1)   already backed and exclusively owned
            ("new",  blk,  -1)   freshly allocated (engine: nothing to copy)
            ("cow",  src, dst)   was shared: caller must copy src -> dst
            ("oom",  -1,   -1)   pool dry — finish the request (reason
                                 "pages") or defer

        Full-block-only sharing means the "cow" arm is a defensive backstop
        (appends always land in exclusively-owned or fresh blocks), but it
        keeps the allocator honest for any future partial-block sharing
        policy.
        """
        alloc_fn = alloc_fn or self.alloc
        j = pos // self.block_size
        blk = int(self.tables[slot, j])
        if blk == self.NULL:
            new = alloc_fn()
            if new is None:
                return ("oom", -1, -1)
            self.tables[slot, j] = new
            return ("new", new, -1)
        if self.refcount[blk] > 1:
            new = alloc_fn()
            if new is None:
                return ("oom", -1, -1)
            self.tables[slot, j] = new
            self.free(blk)               # drop our shared reference
            self.stats.cow_copies += 1
            return ("cow", blk, new)
        return ("ok", blk, -1)

    def release_slot(self, slot: int):
        """Drop every reference ``slot`` holds and clear its table; blocks
        retained elsewhere (trie, other slots) survive untouched."""
        for j in range(self.n_slot_blocks):
            blk = int(self.tables[slot, j])
            if blk != self.NULL:
                self.free(blk)
                self.tables[slot, j] = self.NULL


# ---------------------------------------------------------------------------
# radix prefix cache


class _TrieNode:
    __slots__ = ("children", "block", "last_used", "parent", "key")

    def __init__(self, parent=None, key=None, block: int = -1):
        self.children: Dict[Tuple[int, ...], _TrieNode] = {}
        self.block = block
        self.last_used = 0
        self.parent = parent
        self.key = key


@dataclasses.dataclass
class PrefixCacheStats:
    hits: int = 0                # prefills that reused >= 1 cached block
    misses: int = 0
    cached_tokens: int = 0       # prompt tokens served from cache (no compute)
    inserted_blocks: int = 0
    evictions: int = 0

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def as_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["hit_rate"] = self.hit_rate
        return d


class RadixPrefixCache:
    """Block-granularity radix tree over prompt token prefixes.

    Each edge is the tuple of ``block_size`` token ids a block holds; the
    node stores the pool block containing that span's KV. ``match`` walks
    the longest fully-matched block chain (always leaving >= 1 prompt token
    for the tail prefill — the next-token logits must still be computed);
    ``insert`` adopts a request's freshly-computed full prompt blocks, the
    trie taking one reference so they outlive the request. ``evict`` frees
    least-recently-used entries nobody else references.
    """

    def __init__(self, block_size: int, pool: PagePool):
        self.bs = block_size
        self.pool = pool
        self.root = _TrieNode()
        self._clock = 0
        self.stats = PrefixCacheStats()

    def _touch(self, node: _TrieNode):
        self._clock += 1
        node.last_used = self._clock

    def _walk(self, tokens: np.ndarray, max_blocks: int, touch: bool):
        node, path = self.root, []
        for j in range(max_blocks):
            key = tuple(int(t) for t in tokens[j * self.bs:(j + 1) * self.bs])
            child = node.children.get(key)
            if child is None:
                break
            if touch:
                self._touch(child)
            path.append(child)
            node = child
        return node, path

    def match(self, tokens: np.ndarray) -> List[int]:
        """Block ids covering the longest cached prefix of ``tokens``,
        capped so at least one token is left for the tail prefill. Records
        hit/miss stats and refreshes LRU stamps; the caller must map the
        returned blocks (``PagePool.map_shared``) before anything else can
        trigger eviction."""
        max_blocks = (len(tokens) - 1) // self.bs
        _, path = self._walk(tokens, max_blocks, touch=True)
        blocks = [n.block for n in path]
        if blocks:
            self.stats.hits += 1
            self.stats.cached_tokens += len(blocks) * self.bs
        else:
            self.stats.misses += 1
        return blocks

    def probe(self, tokens: np.ndarray) -> int:
        """Cached-token count for ``tokens`` without stats/LRU side effects
        (admission + TTL wait estimates)."""
        max_blocks = (max(len(tokens), 1) - 1) // self.bs
        _, path = self._walk(tokens, max_blocks, touch=False)
        return len(path) * self.bs

    def insert(self, tokens: np.ndarray, blocks: Sequence[int]):
        """Adopt the full prompt blocks of a freshly prefilled request:
        ``blocks[j]`` holds KV for tokens [j*bs, (j+1)*bs). Already-cached
        prefixes are kept (first writer wins); each newly adopted block gets
        one trie-owned reference."""
        n_full = len(tokens) // self.bs
        node = self.root
        for j in range(min(n_full, len(blocks))):
            key = tuple(int(t) for t in tokens[j * self.bs:(j + 1) * self.bs])
            child = node.children.get(key)
            if child is None:
                child = _TrieNode(parent=node, key=key, block=int(blocks[j]))
                self.pool.retain(child.block)
                node.children[key] = child
                self.stats.inserted_blocks += 1
            self._touch(child)
            node = child

    # -- eviction ------------------------------------------------------------

    def _evictable(self, node: _TrieNode, out: List[_TrieNode]) -> bool:
        """Post-order: a node is evictable iff nobody but the trie
        references its block AND its whole subtree is evictable (children
        pin their ancestors — a matched chain needs every link)."""
        ok = all([self._evictable(c, out) for c in node.children.values()])
        if node is self.root:
            return ok
        ok = ok and self.pool.refcount[node.block] == 1
        if ok:
            out.append(node)
        return ok

    def evictable_blocks(self) -> int:
        out: List[_TrieNode] = []
        self._evictable(self.root, out)
        return len(out)

    def evict(self, n_blocks: int) -> int:
        """Free up to ``n_blocks`` LRU evictable entries (leaves first —
        removing a node makes its parent a candidate next round). Returns
        the number of blocks actually freed."""
        freed = 0
        while freed < n_blocks:
            victims: List[_TrieNode] = []
            self._evictable(self.root, victims)
            leaves = [n for n in victims if not n.children]
            if not leaves:
                break
            victim = min(leaves, key=lambda n: n.last_used)
            del victim.parent.children[victim.key]
            self.pool.free(victim.block)
            self.stats.evictions += 1
            freed += 1
        return freed

    def clear(self):
        """Drop every cached entry (benchmark cold-start): all trie-held
        references return to the pool."""
        def drop(node):
            for c in node.children.values():
                drop(c)
                self.pool.free(c.block)
        drop(self.root)
        self.root = _TrieNode()
        self.stats = PrefixCacheStats()

    def __len__(self):
        n = 0
        stack = [self.root]
        while stack:
            node = stack.pop()
            n += len(node.children)
            stack.extend(node.children.values())
        return n

    def __bool__(self):
        return True     # __len__ would make an *empty* cache falsy
