"""Serving steps on the paged KV pool: prefill one request's uncached tail
into its block table, decode every slot in one fused call, and the pool
maintenance ops.

Prompt-length bucketing: an exact-length prefill makes one signature per
distinct prompt length, so production-shaped traffic (every prompt a
different length) would turn the reference engine into a compile loop.
``prefill_buckets`` computes power-of-two bucket edges,
``bucket_for``/``pad_to_bucket`` right-pad a prompt to its bucket edge, and
the bucketed step takes the *true* length: logits come from the true last
token and only the real cache positions survive the scatter
(``mask_cache_tail``). Every engine step goes through ``counting_call``, so
``TraceStats`` counts signatures exactly where the reference counts jit
compiles.

Greedy sampling stays on the device: a step returns the ``[B, 1]`` token
tensor and the engine makes the one host fetch per step.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.tracing import TraceStats, counting_call
from repro_torch.models.common import (copy_cache_block, mask_cache_tail,
                                       paged_gather, paged_scatter_block,
                                       paged_scatter_slot, reset_cache_blocks)

# ---------------------------------------------------------------------------
# prompt-length bucketing


def prefill_buckets(max_len: int, min_bucket: int = 8) -> Tuple[int, ...]:
    """Power-of-two bucket edges covering prompt lengths in [1, max_len].

    Edges double from ``min_bucket`` and the last edge is clamped to
    ``max_len`` (a prompt can never exceed the cache), so the number of
    distinct prefill shapes is O(log2(max_len / min_bucket)) regardless of
    traffic.
    """
    if max_len < 1:
        raise ValueError(f"max_len must be >= 1, got {max_len}")
    edges: List[int] = []
    b = min(min_bucket, max_len)
    while b < max_len:
        edges.append(b)
        b *= 2
    edges.append(min(b, max_len))
    return tuple(edges)


def bucket_for(length: int, buckets: Sequence[int]) -> int:
    """Smallest bucket edge >= length (exact length past the last edge)."""
    for edge in buckets:
        if length <= edge:
            return edge
    return length


def pad_to_bucket(prompt: np.ndarray, buckets: Sequence[int],
                  pad_id: int = 0) -> Tuple[np.ndarray, int]:
    """Right-pad a [S] prompt to its bucket edge; returns (padded, true_len).

    Right-padding keeps every real token at its true position: under causal
    masking the pad tail cannot influence real positions, so bucketed
    logits at ``true_len - 1`` match the exact-length prefill.
    """
    prompt = np.asarray(prompt, np.int32)
    n = len(prompt)
    edge = bucket_for(n, buckets)
    if edge == n:
        return prompt, n
    padded = np.full(edge, pad_id, np.int32)
    padded[:n] = prompt
    return padded, n


# ---------------------------------------------------------------------------
# step builders


def _greedy(logits):
    return torch.argmax(logits, dim=-1).to(torch.int32)


def make_paged_decode_step(model):
    """Fused decode through block-table indirection.

    The pool ([L, P, block, kvh, dh] leaves) is gathered into per-slot
    contiguous views via ``tables`` ([B, NB] block ids), the model decodes
    on the view, and only each slot's touched block is scattered back into
    the pool (in place). Table *values* are data, so remaps (prefix
    sharing, COW, lazy growth) never make a new signature.
    """
    def paged_decode_step(params, tokens, pos, tables, pool):
        view = paged_gather(pool, tables)
        logits, view = model.decode_step(params, tokens, pos, view)
        pool = paged_scatter_block(pool, view, tables, pos)
        return _greedy(logits), logits, pool
    return paged_decode_step


def make_paged_slot_prefill(model, bucketed: bool = False):
    """Prefill one request's *uncached tail* through its block table.

    ``start_pos`` is the first uncached position: the matched prefix blocks
    already mapped into ``table_row`` supply KV for [0, start_pos) with zero
    compute, the chunk attends causally over prefix + itself, and logits
    come from the chunk's (true) last token. Everything at or past
    ``start_pos + true_len`` is zeroed before the scatter so pad KV and
    stale block contents never reach decode.
    """
    if not bucketed:
        def paged_slot_prefill(params, tokens, start_pos, table_row, pool):
            sub = paged_gather(pool, table_row[None, :])
            logits, sub = model.prefill(params, {"tokens": tokens}, sub,
                                        start_pos=start_pos)
            sub = mask_cache_tail(sub, start_pos + tokens.shape[1])
            pool = paged_scatter_slot(pool, sub, table_row)
            return _greedy(logits), logits, pool
        return paged_slot_prefill

    def paged_bucketed_slot_prefill(params, tokens, true_len, start_pos,
                                    table_row, pool):
        sub = paged_gather(pool, table_row[None, :])
        logits, sub = model.prefill(params, {"tokens": tokens}, sub,
                                    true_len=true_len, start_pos=start_pos)
        sub = mask_cache_tail(sub, start_pos + true_len)
        pool = paged_scatter_slot(pool, sub, table_row)
        return _greedy(logits), logits, pool
    return paged_bucketed_slot_prefill


def make_block_ops(stats: Optional[TraceStats] = None, on_compile=None):
    """Pool maintenance ops: (zero_blocks, copy_block), counted like the
    other steps. ``zero_blocks(pool, blocks)`` scrubs freed blocks (a
    fixed-width id vector padded with the null block); ``copy_block(pool,
    src, dst)`` is the copy-on-write arm."""
    return (counting_call(reset_cache_blocks, "zero_blocks", stats,
                          on_compile=on_compile),
            counting_call(copy_cache_block, "copy_block", stats,
                          on_compile=on_compile))
