"""Serving steps: whole-batch prefill and decode over per-slot cache rows
(the static engine, and the window-ring/contiguous adapter's one-slot
prefill), the paged KV pool's steps (prefill one request's uncached tail
into its block table, decode every slot in one fused call) and the pool
maintenance ops.

Prompt-length bucketing: an exact-length prefill makes one signature per
distinct prompt length, so production-shaped traffic (every prompt a
different length) would turn the reference engine into a compile loop.
``prefill_buckets`` computes power-of-two bucket edges,
``bucket_for``/``pad_to_bucket`` right-pad a prompt to its bucket edge, and
the bucketed step takes the *true* length: logits come from the true last
token and only the real cache positions are kept
(``mask_cache_tail``). Every engine step goes through ``counting_call``, so
``TraceStats`` counts signatures exactly where the reference counts jit
compiles.

Greedy sampling stays on the device: a step returns the ``[B, 1]`` token
tensor and the engine makes the one host fetch per step. ``greedy`` is kept
for the reference's signatures only (the decode step factories,
``make_adapter`` and ``ContinuousEngine`` accept it and pass it nowhere):
the reference samples only when it is given a key, which its engines never
pass, so it decodes greedily under either setting, and so does the port.

``serve_rules`` and ``cache_specs`` give the caches' sharding specs, and
:class:`ShardedServeStep` runs a model's prefill and decode on a mesh as
the reference's dry-run lays its serve cells out (``cell_rules``): the
parameters and caches at rest are each rank's blocks, each layer gathers
its own leaves where it runs, heads, MLP width, the recurrent layers'
inner channels, vocabulary and experts split over ``model``, and the
caches over KV heads (the recurrent states over heads) or, where those
are too few, over sequence (``common.attention``'s ``kv_split``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.tracing import TraceStats, counting_call
from repro_torch.models.common import (PagedLayers, cache_slot_view,
                                       copy_cache_block, mask_cache_tail,
                                       reset_cache_blocks)
from repro_torch.models.registry import abstract_params
from repro_torch.parallel import comm
from repro_torch.parallel.sharding import (NamedSharding, mesh_shape,
                                           spec_axes, spec_for, tree_specs)

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


def make_prefill_step(model, bucketed: bool = False):
    """Whole-batch prefill. ``bucketed=True`` adds a ``true_len`` argument:
    the batch is right-padded to a bucket edge, logits come from the true
    last token, and cache positions >= true_len are zeroed so pad KV never
    reaches decode."""
    if not bucketed:
        def prefill_step(params, batch, caches):
            return model.prefill(params, batch, caches)
        return prefill_step

    def bucketed_prefill_step(params, batch, true_len, caches):
        logits, caches = model.prefill(params, batch, caches,
                                       true_len=true_len)
        return logits, mask_cache_tail(caches, true_len)
    return bucketed_prefill_step


def make_decode_step(model, greedy: bool = True):
    """Fused decode + greedy sampling over per-slot cache rows. ``pos``: a
    Python int or a [B] int tensor. ``greedy`` changes nothing (module
    docstring)."""
    def decode_step(params, tokens, pos, caches):
        logits, caches = model.decode_step(params, tokens, pos, caches)
        return _greedy(logits), logits, caches
    return decode_step


def make_slot_prefill(model, bucketed: bool = False):
    """Prefill one request ([1, S] tokens) into batch row ``slot`` of a
    shared cache tree; every other row is untouched.

    Exact mode makes one signature per distinct prompt length. Bucketed
    mode takes right-padded tokens plus the true length: signatures are
    bounded by the bucket count, the next token comes from the logits at
    ``true_len - 1``, and only the real ``[0, true_len)`` cache positions
    are kept. The model runs on a view of the row (``cache_slot_view``)
    and writes it in place."""
    if not bucketed:
        def slot_prefill(params, tokens, slot, caches):
            logits, _ = model.prefill(params, {"tokens": tokens},
                                      cache_slot_view(caches, slot))
            return _greedy(logits), logits, caches
        return slot_prefill

    def bucketed_slot_prefill(params, tokens, true_len, slot, caches):
        sub = cache_slot_view(caches, slot)
        logits, sub = model.prefill(params, {"tokens": tokens}, sub,
                                    true_len=true_len)
        mask_cache_tail(sub, true_len)
        return _greedy(logits), logits, caches
    return bucketed_slot_prefill


def make_paged_decode_step(model, greedy: bool = True):
    """Fused decode through block-table indirection.

    The pool ([L, P, block, kvh, dh] leaves) is read through ``tables``
    ([B, NB] block ids) one layer at a time (``PagedLayers``): each
    layer's per-slot contiguous views are gathered, the layer decodes on
    them, and only each slot's touched block is scattered back into the
    pool (in place). Table *values* are data, so remaps (prefix sharing,
    COW, lazy growth) never make a new signature. ``greedy`` changes
    nothing (module docstring).
    """
    def paged_decode_step(params, tokens, pos, tables, pool):
        logits, _ = model.decode_step(params, tokens, pos,
                                      PagedLayers(pool, tables, pos=pos))
        return _greedy(logits), logits, pool
    return paged_decode_step


def make_paged_slot_prefill(model, bucketed: bool = False):
    """Prefill one request's *uncached tail* through its block table.

    ``start_pos`` is the first uncached position: the matched prefix blocks
    already mapped into ``table_row`` supply KV for [0, start_pos) with zero
    compute, the chunk attends causally over prefix + itself, and logits
    come from the chunk's (true) last token. Everything at or past
    ``start_pos + true_len`` is zeroed before the scatter so pad KV and
    stale block contents never reach decode. The row's view is gathered
    and scattered one layer at a time (``PagedLayers``).
    """
    if not bucketed:
        def paged_slot_prefill(params, tokens, start_pos, table_row, pool):
            logits, _ = model.prefill(
                params, {"tokens": tokens}, PagedLayers(
                    pool, table_row[None, :],
                    keep=start_pos + tokens.shape[1]), start_pos=start_pos)
            return _greedy(logits), logits, pool
        return paged_slot_prefill

    def paged_bucketed_slot_prefill(params, tokens, true_len, start_pos,
                                    table_row, pool):
        logits, _ = model.prefill(
            params, {"tokens": tokens}, PagedLayers(
                pool, table_row[None, :], keep=start_pos + true_len),
            true_len=true_len, start_pos=start_pos)
        return _greedy(logits), logits, pool
    return paged_bucketed_slot_prefill


def pow2_chunks(n: int) -> List[int]:
    """Decompose a prompt length into power-of-two chunk sizes, largest
    first (its binary representation).

    Chunked left-to-right prefill for the recurrent families feeds these
    through ``model.prefill`` carrying state between chunks: positions stay
    monotone, every chunk size is a power of two (the chunkwise SSM forms
    require ``t % min(chunk, t) == 0``), and the number of distinct chunk
    shapes over any traffic is <= log2(max_seq) — so the signature count
    stays bounded without ever right-padding carried state.
    """
    if n < 1:
        raise ValueError(f"prompt length must be >= 1, got {n}")
    return [1 << b for b in range(n.bit_length() - 1, -1, -1) if n & (1 << b)]


def capped_chunks(n: int, max_chunk: Optional[int] = None) -> List[int]:
    """``pow2_chunks(n)`` with no chunk larger than ``max_chunk``.

    None keeps ``pow2_chunks`` exactly (the reference's chunking). A cap
    ``c`` (a power of two) feeds ``n // c`` chunks of ``c`` and then
    ``pow2_chunks(n % c)``: every chunk is still a power of two, the
    distinct sizes stay <= log2(c) + 1, and a chunk's transient memory
    stays that of ``c`` tokens however long the prompt. The boundary does
    not change what a chunked prefill computes (the state is carried)."""
    if max_chunk is None:
        return pow2_chunks(n)
    if max_chunk < 1 or max_chunk & (max_chunk - 1):
        raise ValueError(f"max_chunk must be a power of two, got {max_chunk}")
    if n < 1:
        raise ValueError(f"prompt length must be >= 1, got {n}")
    rest = n % max_chunk
    return [max_chunk] * (n // max_chunk) + (pow2_chunks(rest) if rest
                                             else [])


def make_recurrent_chunk_prefill(model):
    """One chunk of a left-to-right recurrent prefill.

    ``state`` is the batch-1 carried state tree (fresh on the first chunk),
    written in place; ``start_pos`` is the chunk's absolute offset —
    position-free families ignore it, the attention-bearing ones (zamba2's
    shared attention, whisper's decoder self-attention) offset their KV
    writes and masks with it. ``frames`` is None except on an audio
    request's first chunk, where it feeds the encoder and fills the cross
    cache that later chunks (and decode) reuse; None against a tensor gives
    the frames variant a signature of its own, counted like any other.

    Returns ``(next_token, logits, state)`` with the next token sampled from
    the chunk's last position — after the final chunk that is the request's
    first generated token.
    """
    def chunk_prefill(params, tokens, frames, start_pos, state):
        batch = {"tokens": tokens}
        if frames is not None:
            batch["frames"] = frames
        logits, state = model.prefill(params, batch, state,
                                      start_pos=start_pos)
        return _greedy(logits), logits, state
    return chunk_prefill


def make_block_ops(stats: Optional[TraceStats] = None, on_compile=None):
    """Pool maintenance ops: (zero_blocks, copy_block), counted like the
    other steps. ``zero_blocks(pool, blocks)`` scrubs freed blocks (a
    fixed-width id vector padded with the null block); ``copy_block(pool,
    src, dst)`` is the copy-on-write arm."""
    return (counting_call(reset_cache_blocks, "zero_blocks", stats,
                          on_compile=on_compile),
            counting_call(copy_cache_block, "copy_block", stats,
                          on_compile=on_compile))


# ---------------------------------------------------------------------------
# sharding specs for the caches, and the steps on a mesh (the engines
# serve on one device, as the reference's do)


def serve_rules(shape):
    """Sharding-rule overrides per shape cell.

    batch=1 (long_500k): nothing to shard on batch -> sequence-shard KV
    caches over ("pod","data") and keep TP on heads.
    """
    if shape.global_batch == 1:
        return {"batch": None, "kv_seq": ("pod", "data")}
    return {}


def cache_specs(mesh, model, cache_sds, rules=None):
    """PartitionSpecs of a cache tree (``model.cache_axes()``); the leaves
    of ``cache_sds`` need only a ``shape`` (``init_cache(...,
    device="meta")`` allocates nothing)."""
    return tree_specs(mesh, model.cache_axes(), cache_sds, rules)


def abstract_cache(model, batch: int, max_seq: int):
    """The cache tree of ``batch`` rows of ``max_seq`` positions on the
    meta device (``init_cache``'s shapes and dtypes; nothing allocated)."""
    return model.init_cache(batch, max_seq, device="meta")


def cell_rules(cfg, batch: int, mesh) -> dict:
    """The rule overrides of a serve cell of ``batch`` rows on ``mesh``
    (the reference dry-run's ``serve_rules``): a batch of one splits the
    caches' sequence over the data axes; KV heads too few for ``model``
    (GQA, MQA) split it over ``model`` instead (flash-decoding-style
    parallel KV)."""
    rules = {}
    sizes = mesh_shape(mesh)
    if batch == 1:
        rules["batch"] = None
        rules["kv_seq"] = ("pod", "data") if "pod" in sizes else ("data",)
    elif cfg.num_kv_heads % sizes.get("model", 1) != 0:
        rules["kv_seq"] = "model"
    return rules


class ShardedServeStep:
    """A model's prefill and decode on a DeviceMesh over the whole process
    group, or on a ``launch.mesh.RankMesh`` (the dry-run's rank, on meta
    tensors), for caches of ``batch`` rows of ``max_seq`` positions.

    The model is built on ``mesh`` with its cell's rules
    (``build_model(cfg, mesh, shd_rules=cell_rules(cfg, batch, mesh))``).
    ``layout`` and ``layout_cache`` cut full trees into the rank's blocks
    (``param_specs``; ``cache_specs`` under the same rules: each family's
    ``cache_axes``), ``rows`` cuts the rank's rows of a global
    batch tensor, and ``prefill``/``decode`` run the model on blocks
    (``Sharder.rank_blocks``) and return the logits of the rank's rows as
    its block of the vocabulary, as the reference's ``act_vocab`` spec
    leaves them (``whole_logits`` gathers them). At one rank every split
    is a no-op and the steps are the model's own."""

    def __init__(self, model, mesh, batch: int, max_seq: int):
        self.model, self.mesh = model, mesh
        rules = model.shd.rules
        shapes, self.axes = abstract_params(model)
        self.param_specs = tree_specs(mesh, self.axes, shapes, rules)
        self.cache_specs = cache_specs(
            mesh, model, abstract_cache(model, batch, max_seq), rules)
        spec = spec_for(mesh, ("batch",), (batch,), rules)
        self.row_split = NamedSharding(mesh, spec)
        self.batch_axes = spec_axes(spec[0]) if len(spec) else ()

    def layout(self, params):
        """The rank's blocks of a full parameter tree, in place (each full
        leaf is dropped as its block is cut)."""
        def cut(tree, specs):
            for k in list(tree):
                if isinstance(tree[k], dict):
                    cut(tree[k], specs[k])
                else:
                    tree[k] = NamedSharding(self.mesh, specs[k]).block(
                        tree[k])
        cut(params, self.param_specs)
        return params

    def layout_cache(self, caches):
        """The rank's blocks of a full cache tree."""
        def cut(tree, specs):
            if isinstance(tree, dict):
                return {k: cut(tree[k], specs[k]) for k in tree}
            if isinstance(tree, (tuple, list)):
                return type(tree)(cut(t, s) for t, s in zip(tree, specs))
            return NamedSharding(self.mesh, specs).block(tree)
        return cut(caches, self.cache_specs)

    def rows(self, x):
        """The rank's rows of a global batch tensor (dim 0)."""
        return self.row_split.block(torch.as_tensor(x))

    def _run(self, fn, *args, **kw):
        shd = self.model.shd
        with shd.rank_batch(self.batch_axes), shd.rank_blocks(
                self.param_specs, self.axes, self.cache_specs):
            return fn(*args, **kw)

    def prefill(self, params, batch, caches, true_len=None, start_pos=None):
        """``model.prefill`` of the rank's rows ``batch`` on its blocks:
        (the vocabulary block of the last true token's logits, caches)."""
        kw = {k: v for k, v in (("true_len", true_len),
                                ("start_pos", start_pos)) if v is not None}
        return self._run(self.model.prefill, params, batch, caches, **kw)

    def decode(self, params, tokens, pos, caches):
        """``model.decode_step`` of the rank's rows ``tokens`` [B_l, 1] at
        ``pos`` (an int, or the rank's rows of a [B] tensor)."""
        return self._run(self.model.decode_step, params, tokens, pos, caches)

    def whole_logits(self, logits):
        """The whole vocabulary's logits from each ``model`` rank's block
        (an all-gather; the logits themselves where they are whole)."""
        vocab = self.model.cfg.vocab_size
        if logits.shape[-1] == vocab:
            return logits
        return comm.all_gather(logits, self.mesh.get_group("model"), dim=-1)

