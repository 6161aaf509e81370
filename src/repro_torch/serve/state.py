"""Per-slot cache/state adapters behind one continuous engine.

``CacheAdapter``     the interface the engine speaks: per-slot
                     alloc/free, chunked prefill into one slot, fused
                     whole-batch decode, admission queries, and declared
                     capability flags (``ServingCaps`` from the model
                     registry).
``PagedKVAdapter``   flat (k, v) caches behind a refcounted ``PagePool`` +
                     radix prefix trie (the dense transformers).

The window-ring (gemma3) and recurrent-state (xlstm/zamba2/whisper)
adapters of the reference come with the slices that port those families.

Every step runs through ``counting_call`` against the engine's shared
``TraceStats``, so signature counts stay bounded by the bucket count, as
the reference's compile counts are.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.registry import ServingCaps, serving_caps
from repro_torch.serve.paging import (PagePool, RadixPrefixCache,
                                      resolve_kv_block_size)
from repro_torch.serve.queue import Request
from repro_torch.serve.step import (TraceStats, counting_call, make_block_ops,
                                    make_paged_decode_step,
                                    make_paged_slot_prefill, pad_to_bucket)
from repro_torch.serve.step import prefill_buckets as auto_prefill_buckets

__all__ = ["PrefillOutcome", "CacheAdapter", "PagedKVAdapter",
           "make_adapter", "resolve_buckets"]


def to_device(array, device) -> torch.Tensor:
    """A host array's copy on ``device`` without a host sync.

    A blocking host-to-device copy synchronises the stream, which would add
    a sync per step beside the designed ones; this copies the array (the
    caller may mutate its own afterwards) and lets the driver stage the
    pageable copy while the stream keeps running."""
    return torch.tensor(np.asarray(array)).to(device, non_blocking=True)


def resolve_buckets(spec, max_seq: int, model=None):
    """Normalize a ``prefill_buckets`` argument.

    ``"auto"``/True -> power-of-two edges up to ``max_seq``; ``None``/
    ``"off"``/False -> bucketing disabled (exact-length prefill, one
    signature per distinct length); an iterable -> explicit edges (sorted,
    deduped, capped at ``max_seq``). With a ``model``, ``"auto"`` degrades
    to off when the family declares ``bucketed_prefill=False``; explicitly
    requested edges raise."""
    if spec in (None, False, "off", "none"):
        return None
    supported = model is None or serving_caps(model.cfg).bucketed_prefill
    if spec in (True, "auto"):
        return auto_prefill_buckets(max_seq) if supported else None
    if not supported:
        raise ValueError(
            f"family '{model.cfg.family}' declares bucketed_prefill=False: "
            "right-pad would corrupt carried recurrent state — its chunked "
            "prefill is already compile-bounded (pass prefill_buckets='off')")
    edges = sorted({min(int(b), max_seq) for b in spec if int(b) >= 1})
    if not edges:
        raise ValueError(f"no usable prefill buckets in {spec!r}")
    if edges[-1] < max_seq:
        edges.append(max_seq)     # every admissible prompt must fit a bucket
    return tuple(edges)


@dataclasses.dataclass
class PrefillOutcome:
    """What one slot prefill did. ``first_token is None`` means the backend
    could not back the prompt (paged pool dry): the adapter has already
    dropped its slot resources and the engine finishes the request with
    reason "pages"."""

    first_token: Optional[int]
    cached_tokens: int = 0     # prompt span served from the prefix cache
    computed_tokens: int = 0   # prompt tokens that actually ran


class CacheAdapter:
    """Base adapter: owns the model's per-slot serving state and every step
    that touches it. The engine never inspects model methods or cache
    layouts — it calls this interface and trusts ``self.caps``.

    Lifecycle per slot: ``prefill(slot, req)`` claims the row (fresh state,
    prompt fed in), ``decode_step`` advances every row in one fused call,
    ``free_slot`` resets/releases the row the moment its request finishes —
    slot reuse without that reset is exactly what dalek-lint DLK008 flags.
    """

    kind: str = "base"

    def __init__(self, model, params, *, batch_size: int, max_seq: int,
                 buckets, caps: ServingCaps, trace_stats: TraceStats,
                 on_compile=None):
        self.model = model
        self.params = params
        self.device = params["embedding"].device
        self.batch_size = batch_size
        self.max_seq = max_seq
        self.buckets = buckets
        self.caps = caps
        self.trace_stats = trace_stats
        self.on_compile = on_compile
        self.caches = None
        self.pages: Optional[PagePool] = None
        self.prefix: Optional[RadixPrefixCache] = None
        self.block_size: Optional[int] = None

    # -- lifecycle ----------------------------------------------------------

    def ensure_ready(self):
        """Lazy state allocation (first ``run``)."""
        raise NotImplementedError

    def prefill(self, slot_index: int, req: Request) -> PrefillOutcome:
        """Feed one request's prompt into ``slot_index`` (fresh per-slot
        state; other rows untouched) and sample its first token."""
        raise NotImplementedError

    def begin_step(self, active_slots) -> List:
        """Pre-decode bookkeeping; returns slots the backend can no longer
        back (engine finishes them with reason "pages")."""
        return []

    def decode_step(self, tokens, pos):
        """One fused decode for the whole batch; returns the [B, 1] device
        token tensor (the engine owns the single host sync)."""
        raise NotImplementedError

    def free_slot(self, slot_index: int):
        """Release/reset one slot's state so the next occupant starts
        clean. Must be called before ``SlotManager.release`` (DLK008)."""
        raise NotImplementedError

    # -- admission ----------------------------------------------------------

    def can_admit(self, req: Request) -> bool:
        """Head-of-line resource check (paged: worst-case pool coverage)."""
        return True

    def expected_cached(self, req: Request) -> int:
        """Prompt span a prefix cache would serve right now (probe only)."""
        return 0

    # -- observability ------------------------------------------------------

    def pool_gauges(self):
        """(free_blocks, evictable_blocks) for step gauges; (-1, -1) when
        the backend has no pool."""
        return -1, -1

    def run_stats(self) -> Dict:
        return {"kv_block_size": self.block_size}

    def reset_metrics(self):
        """Benchmark warmup reset: drop cached/shared state *statistics*
        (buffers survive — freed slots are always re-prefilled before
        reuse)."""


class PagedKVAdapter(CacheAdapter):
    """Flat (k, v) layer caches behind a refcounted block pool with radix
    prefix sharing: COW on defensively-shared write positions, zero-on-free
    scrubbing, lazy block growth in decode, trie eviction under pool
    pressure. Steps update the pool tensors in place."""

    kind = "paged-kv"

    def __init__(self, model, params, *, block_size: int,
                 prefix_cache: bool = True,
                 kv_pool_blocks: Optional[int] = None, **kw):
        super().__init__(model, params, **kw)
        self.block_size = block_size
        self.n_slot_blocks = self.max_seq // block_size
        n_blocks = (kv_pool_blocks if kv_pool_blocks is not None
                    else self.batch_size * self.n_slot_blocks + 1)
        self.pages = PagePool(self.batch_size, self.n_slot_blocks, n_blocks,
                              block_size)
        self.prefix = (RadixPrefixCache(block_size, self.pages)
                       if prefix_cache else None)
        self._decode = counting_call(
            make_paged_decode_step(model), "decode", self.trace_stats,
            on_compile=self.on_compile)
        self._prefill_slot = counting_call(
            make_paged_slot_prefill(model, bucketed=bool(self.buckets)),
            "prefill", self.trace_stats, on_compile=self.on_compile)
        self._zero_blocks, self._copy_block = make_block_ops(
            self.trace_stats, self.on_compile)

    def _dev(self, array):
        return to_device(array, self.device)

    def ensure_ready(self):
        if self.caches is None:
            # the "batch" axis of the cache is the POOL of blocks, each
            # block_size positions long; slots see contiguous views
            # through their block tables
            self.caches = self.model.init_cache(
                self.pages.n_blocks, self.block_size, device=self.device)

    # -- pool bookkeeping ---------------------------------------------------

    def _flush_freed(self):
        """Scrub freed blocks before any realloc, in fixed-width chunks
        padded with the null block (one signature)."""
        pending = self.pages.drain_pending_zero()
        if not pending:
            return
        width = self.n_slot_blocks
        for i in range(0, len(pending), width):
            chunk = pending[i:i + width]
            chunk = chunk + [PagePool.NULL] * (width - len(chunk))
            self.caches = self._zero_blocks(
                self.caches, self._dev(np.asarray(chunk, np.int64)))

    def _alloc_block(self) -> Optional[int]:
        """One zeroed block, evicting cold prefix-cache entries if the free
        list is dry. Returns None only when every block is live."""
        self._flush_freed()
        blk = self.pages.alloc()
        if blk is None and self.prefix is not None:
            if self.prefix.evict(1):
                self._flush_freed()
                blk = self.pages.alloc()
        return blk

    # -- admission ----------------------------------------------------------

    def expected_cached(self, req: Request) -> int:
        if self.prefix is None:
            return 0
        return self.prefix.probe(np.asarray(req.prompt, np.int32))

    def can_admit(self, req: Request) -> bool:
        """Admit only when the pool can cover the request's worst-case
        footprint (prompt + budget, capped at max_seq) net of the blocks a
        prefix-cache hit would share. Evictable trie blocks count as
        available — ``_alloc_block`` reclaims them on demand."""
        span = min(len(req.prompt) + req.max_new_tokens, self.max_seq)
        needed = self.pages.blocks_for(span) \
            - self.expected_cached(req) // self.block_size
        available = self.pages.free_blocks()
        if self.prefix is not None:
            available += self.prefix.evictable_blocks()
        return needed <= available

    # -- lifecycle ----------------------------------------------------------

    def prefill(self, slot_index: int, req: Request) -> PrefillOutcome:
        """Map the matched prefix (zero compute), allocate blocks for the
        unmatched span, chunk-prefill the tail only, offer the full prompt
        blocks to the trie."""
        prompt = np.asarray(req.prompt, np.int32)
        matched = (self.prefix.match(prompt)
                   if self.prefix is not None else [])
        if matched:
            self.pages.map_shared(slot_index, matched)
        start = len(matched) * self.block_size
        if not self.pages.ensure_capacity(slot_index, len(prompt),
                                          self._alloc_block):
            self.pages.release_slot(slot_index)
            return PrefillOutcome(None)
        tail = prompt[start:]
        table_row = self._dev(self.pages.table_row(slot_index))
        if self.buckets:
            padded, n = pad_to_bucket(tail, self.buckets)
            next_tok, _, self.caches = self._prefill_slot(
                self.params, self._dev(padded[None, :]), n, start,
                table_row, self.caches)
        else:
            next_tok, _, self.caches = self._prefill_slot(
                self.params, self._dev(tail[None, :]), start, table_row,
                self.caches)
        # dalek: allow[host-sync] first sampled token must reach the host to emit/EOS-check
        first = int(next_tok[0, 0].item())
        if self.prefix is not None:
            self.prefix.insert(prompt, self.pages.table_row(slot_index))
        return PrefillOutcome(first, cached_tokens=start,
                              computed_tokens=len(tail))

    def begin_step(self, active_slots) -> List:
        """Back every active slot's write position before the fused step:
        fresh block on a boundary, COW if (defensively) shared, report the
        slot for a "pages" finish when the pool is dry."""
        doomed = []
        for s in active_slots:
            state, src, dst = self.pages.ensure_writable(
                s.index, s.pos, self._alloc_block)
            if state == "cow":
                self.caches = self._copy_block(self.caches, int(src),
                                               int(dst))
            elif state == "oom":
                doomed.append(s)
        return doomed

    def decode_step(self, tokens, pos):
        tables = self._dev(self.pages.tables)
        next_tok, _, self.caches = self._decode(
            self.params, tokens, pos, tables, self.caches)
        return next_tok

    def free_slot(self, slot_index: int):
        # drop the slot's block refs; blocks whose refcount hits zero queue
        # for scrubbing and are re-zeroed before any realloc
        self.pages.release_slot(slot_index)

    # -- observability ------------------------------------------------------

    def pool_gauges(self):
        free = self.pages.free_blocks()
        evictable = (self.prefix.evictable_blocks()
                     if self.prefix is not None else -1)
        return free, evictable

    def run_stats(self) -> Dict:
        pg = self.pages.stats.as_dict()
        pg["free_blocks"] = self.pages.free_blocks()
        out = {"kv_block_size": self.block_size, "kv_pages": pg}
        if self.prefix is not None:
            out["prefix_cache"] = self.prefix.stats.as_dict()
        return out

    def reset_metrics(self):
        if self.prefix is not None:
            # cold prefix cache: a benchmark's measured phase must not reap
            # hits the warmup planted
            self.prefix.clear()
        self.pages.stats = type(self.pages.stats)(
            total_blocks=self.pages.stats.total_blocks)


def make_adapter(model, params, *, batch_size: int, max_seq: int,
                 prefill_buckets="auto", kv_block_size="auto",
                 prefix_cache: bool = True,
                 kv_pool_blocks: Optional[int] = None,
                 trace_stats: Optional[TraceStats] = None, on_compile=None):
    """Select and build the backend for ``model``'s declared capabilities.

    The paged-KV backend is the one this slice ports; the others raise,
    naming the slice that adds them."""
    caps = serving_caps(model.cfg)
    buckets = resolve_buckets(prefill_buckets, max_seq, model)
    trace_stats = trace_stats if trace_stats is not None else TraceStats()
    block_size = resolve_kv_block_size(kv_block_size, max_seq, caps.paged_kv)
    if caps.kind == "recurrent":
        raise NotImplementedError(
            "the recurrent-state adapter comes with the recurrent families "
            "(ROADMAP Queue 1 item 10)")
    if not block_size:
        raise NotImplementedError(
            "the contiguous/window-ring adapter comes with the gemma3 "
            "window-ring slice (ROADMAP Queue 1 item 8); serve the flat "
            "families with a kv_block_size that divides max_seq")
    return PagedKVAdapter(model, params, block_size=block_size,
                          prefix_cache=prefix_cache,
                          kv_pool_blocks=kv_pool_blocks,
                          batch_size=batch_size, max_seq=max_seq,
                          buckets=buckets, caps=caps,
                          trace_stats=trace_stats, on_compile=on_compile)
