"""Shared model components: norms, RoPE, GQA attention, KV-cache helpers,
MLP, embeddings and the training losses.

Plain functions over explicit parameter dicts of tensors, with the
reference's names, shapes and ``[L, ...]`` stacking. Where the reference
returns updated cache arrays, these helpers update the cache tensors in
place (and return them): a serving step then holds one copy of its cache
view instead of one per layer.

Prefill attention runs on the Hopper flash kernel
(``repro_torch.kernels.flash_attention``), causal on global layers and with
the sliding window on gemma3's local ones; single-token decode attention
(over a flat cache or a window ring) stays plain tensor ops over the
gathered cache view, as in the reference. Under a gradient the flash call
runs through its autograd Function (``ops.FlashAttention``), so the
training forward reaches the same kernel. A cache whose sequence is split
over ranks (``kv_split``) is decoded block by block, each block's partial
softmax joined by ``parallel.comm.softmax_combine``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.parallel import comm

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# norms


def rms_norm(x, scale, eps=1e-6, cols=None):
    """RMS norm in f32, scaled by ``1 + scale`` (zero-initialised scale).
    ``cols`` (a slice): only those columns of the normed ``x`` are kept,
    ``scale`` being their block (a rank's channels of a whole ``x``)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    if cols is not None:
        y = y[..., cols]
    return (y * (1.0 + scale.float())).to(x.dtype)


def rms_norm_split(x, scale, tp, eps=1e-6):
    """``rms_norm`` over a dim split over ``tp``'s ranks, ``x`` [..., C]
    and ``scale`` [C] the rank's block of its ``C * tp.size`` entries: the
    ranks' sums of squares summed (``tp.sum``, whose backward sums the
    gradient too) make the mean over the whole dim."""
    xf = x.float()
    ss = tp.sum(xf.square().sum(dim=-1, keepdim=True))
    y = xf * torch.rsqrt(ss / (x.shape[-1] * tp.size) + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings


def rope_tables(positions, dh, theta=10_000.0):
    """(cos, sin) of shape [..., S, 1, dh/2] for int ``positions`` [..., S].

    Half-split RoPE with freqs ``exp(-log θ · i / half)``, all in f32."""
    half = dh // 2
    log_theta = torch.tensor(theta, dtype=torch.float32).log()
    freqs = torch.exp(-log_theta * torch.arange(
        0, half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.float()[..., None] * freqs            # [..., S, half]
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def apply_rope(x, cos, sin):
    half = x.shape[-1] // 2
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x, positions, theta=10_000.0):
    """x: [..., S, H, Dh]; positions: [..., S] int."""
    cos, sin = rope_tables(positions, x.shape[-1], theta)
    return apply_rope(x, cos, sin)


# ---------------------------------------------------------------------------
# attention (GQA by head index; prefill on the flash kernel, decode plain)


def _proj(x, w):
    """x [B,S,d] @ w [d, ...] -> [B,S, ...] in x's dtype."""
    w = w.to(x.dtype)
    return (x @ w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1],
                                                   *w.shape[1:])


def rank_kv_heads(cfg: ModelConfig, tp, h_local: int):
    """The KV heads the rank's ``h_local`` query heads read when the KV
    heads are whole (too few to split): a slice of them under which the
    local heads keep GQA's uniform map, else one KV head a query head (a
    list)."""
    g = cfg.q_heads // cfg.num_kv_heads
    heads = [(tp.rank * h_local + j) // g for j in range(h_local)]
    lo, n = heads[0], heads[-1] + 1 - heads[0]
    if h_local % n == 0 and all(h - lo == j // (h_local // n)
                                for j, h in enumerate(heads)):
        return slice(lo, lo + n)
    return heads


def _kv_heads(t, sel):
    """The KV heads ``sel`` (``rank_kv_heads``) of ``t`` [..., Hkv, Dh]."""
    if isinstance(sel, list):
        return t.index_select(-2, torch.tensor(sel, device=t.device))
    return t[..., sel, :]


def _qkv(x, p, cfg: ModelConfig, rope_cs, tp=None):
    """Projected q [B,S,H,Dh] and k, v [B,S,Hkv,Dh]; with ``cfg.qk_norm``
    each head of q and k is RMS-normed before RoPE; ``rope_cs`` None (a
    layer without RoPE: whisper's) leaves them unrotated. Under ``tp``
    with the query heads split, H is the rank's heads and Hkv the KV
    heads they read (``rank_kv_heads`` where those are whole)."""
    wk, wv = p["wk"], p["wv"]
    h_local = p["wq"].shape[-2]
    if (tp is not None and tp.splits(h_local, cfg.q_heads)
            and not tp.splits(wk.shape[-2], cfg.num_kv_heads)):
        sel = rank_kv_heads(cfg, tp, h_local)
        wk, wv = _kv_heads(wk, sel), _kv_heads(wv, sel)
    q = _proj(x, p["wq"])
    k = _proj(x, wk)
    v = _proj(x, wv)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if rope_cs is None:
        return q, k, v
    cos, sin = rope_cs
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _repeat_kv(k, n_q_heads):
    """GQA: repeat KV heads [B,T,Hkv,Dh] to the query-head count (head h
    reads kv head ``h // (H // Hkv)``)."""
    kvh = k.shape[2]
    if kvh == n_q_heads:
        return k
    idx = torch.arange(n_q_heads, device=k.device) // (n_q_heads // kvh)
    return k.index_select(2, idx)


def _mask(q_pos, k_pos, *, causal, window, is_global):
    """Attention mask.

    Unbatched: q_pos [S], k_pos [T] -> bool [S, T].
    Batched (per-slot positions): q_pos [B, S] and/or k_pos [B, T] ->
    bool [B, S, T]."""
    if q_pos.dim() > 1 or k_pos.dim() > 1:
        qp = (q_pos if q_pos.dim() > 1 else q_pos[None])[:, :, None]
        kp = (k_pos if k_pos.dim() > 1 else k_pos[None])[:, None, :]
    else:
        qp, kp = q_pos[:, None], k_pos[None, :]
    m = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                   dtype=torch.bool, device=qp.device)
    if causal:
        m = m & (kp <= qp)
    if window is not None and not is_global:
        m = m & ((qp - kp) < window)
    return m


def attention_scores(q, k, v, mask, scores_f32=True):
    """Naive full attention. q [B,S,H,Dh]; k, v [B,T,Hkv,Dh] with
    ``Hkv | H`` (GQA by head index, no repeat); mask [S,T] or [B,S,T].

    ``scores_f32=False`` keeps scores and probabilities in q's dtype
    (max-subtracted exp, f32 denominator), as the reference does."""
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, dh)
    mb = (mask[None, None, None] if mask.dim() == 2
          else mask[:, None, None])                     # [B|1,1,1,S,T]
    if scores_f32:
        sc = torch.einsum("bsngd,btnd->bngst", qg, k).float() / math.sqrt(dh)
        sc = torch.where(mb, sc, torch.full((), NEG_INF, device=q.device))
        p = torch.softmax(sc, dim=-1).to(q.dtype)
        o = torch.einsum("bngst,btnd->bsngd", p, v)
        return o.reshape(b, s, h, dh)
    sc = torch.einsum("bsngd,btnd->bngst", qg, k) / torch.tensor(
        math.sqrt(dh), dtype=q.dtype)
    sc = torch.where(mb, sc, torch.full((), -math.inf, dtype=sc.dtype,
                                        device=q.device))
    m = sc.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(sc - m)
    denom = p.float().sum(dim=-1, keepdim=True)        # [B,n,g,S,1]
    o = torch.einsum("bngst,btnd->bsngd", p, v)
    denom = denom.clamp_min(1e-30).permute(0, 3, 1, 2, 4)  # [B,S,n,g,1]
    return (o / denom.to(o.dtype)).reshape(b, s, h, dh)


def partial_attention(q, k, v, mask):
    """One block of keys' share of attention (``comm.softmax_combine``
    joins the blocks). q [B,S,H,Dh]; k, v [B,T,Hkv,Dh] (GQA by head
    index); mask [S,T] or [B,S,T]. Returns, each [B,S,H] or [B,S,H,Dh] in
    f32: the block's max score, the sum of ``exp(score - max)`` and that
    of ``exp(score - max) v``, with masked scores at ``NEG_INF`` as
    ``attention_scores`` has them (a row with no valid key in the block
    has max ``NEG_INF``)."""
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, dh)
    mb = (mask[None, None, None] if mask.dim() == 2
          else mask[:, None, None])                     # [B|1,1,1,S,T]
    sc = torch.einsum("bsngd,btnd->bngst", qg, k).float() / math.sqrt(dh)
    sc = torch.where(mb, sc, torch.full((), NEG_INF, device=q.device))
    m = sc.amax(dim=-1, keepdim=True)
    e = torch.exp(sc - m)
    o = torch.einsum("bngst,btnd->bsngd", e.to(q.dtype), v).float()
    return (m[..., 0].permute(0, 3, 1, 2).reshape(b, s, h),
            e.sum(dim=-1).permute(0, 3, 1, 2).reshape(b, s, h),
            o.reshape(b, s, h, dh))


def blocked_attention(q, k, v, *, q_offset=0, window=None, causal=True):
    """Prefill attention on the flash kernel.

    q [B,S,H,Dh]; k, v [B,T,Hkv,Dh]. Query row i sits at position
    ``q_offset + i`` and key j at position j, so under causal masking the
    cache tail past ``q_offset + S`` is never read — the same result as the
    reference's ``blocked_attention`` with its invalid key positions sent to
    ``2**30``. ``window``: row i sees only keys j with
    ``q_offset + i - j < window`` (a local layer). ``causal`` False: every
    row sees every key (whisper's encoder)."""
    o = flash_attention(q.transpose(1, 2).contiguous(),
                        k.transpose(1, 2).contiguous(),
                        v.transpose(1, 2).contiguous(), causal=causal,
                        q_offset=q_offset, window=window)
    return o.transpose(1, 2)


def write_cache(cache, new, cache_pos):
    """Write ``new`` [B,S,Hkv,Dh] into ``cache`` [B,T,Hkv,Dh] in place.

    Scalar ``cache_pos``: rows [start, start+S) with ``lax.dynamic_update_
    slice``'s rule — the start is clamped to ``[0, T - S]`` so the update
    fits. ``[B]`` tensor ``cache_pos`` (single-token decode): row b writes
    at ``cache_pos[b]``."""
    new = new.to(cache.dtype)
    if isinstance(cache_pos, torch.Tensor):
        assert new.shape[1] == 1, \
            "per-row cache positions require single-token decode"
        bidx = torch.arange(cache.shape[0], device=cache.device)
        cache[bidx, cache_pos.long()] = new[:, 0]
        return cache
    s, t = new.shape[1], cache.shape[1]
    start = min(max(int(cache_pos), 0), t - s)
    cache[:, start:start + s] = new
    return cache


def write_cache_block(cache, new, cache_pos, split):
    """``write_cache`` on the rank's block of a cache whose sequence is
    split over ``split``'s ranks (block ``split.rank`` of ``split.size``):
    only the positions the block holds are written, a [B] ``cache_pos``
    row by row (the other rows keep what they hold)."""
    new = new.to(cache.dtype)
    tl = cache.shape[1]
    base = split.rank * tl
    if isinstance(cache_pos, torch.Tensor):
        local = cache_pos.long() - base
        held = ((local >= 0) & (local < tl))[:, None, None]
        idx = local.clamp(0, tl - 1)
        bidx = torch.arange(cache.shape[0], device=cache.device)
        cache[bidx, idx] = torch.where(held, new[:, 0], cache[bidx, idx])
        return cache
    s = new.shape[1]
    start = min(max(int(cache_pos), 0), tl * split.size - s)
    lo, hi = max(start, base), min(start + s, base + tl)
    if lo < hi:
        cache[:, lo - base:hi - base] = new[:, lo - start:hi - start]
    return cache


def _split_cache_attention(q, k, v, cfg: ModelConfig, kv_cache, cache_pos,
                           positions, window, is_global, causal, tp, split):
    """Attention with a cache whose sequence is split over ``split``'s
    ranks (the reference's "flash-decoding-style parallel KV"): over
    ``model`` where the KV heads are too few to split over it, or, for a
    batch of one, over the data axes. The rank's cache block holds every
    KV head of its positions, and ``k``, ``v`` are the call's every KV
    head, unless the KV heads split over ``tp`` too: then the block, ``k``
    and ``v`` hold the rank's KV heads. The rank writes the positions its
    block holds.

    Decode: where the block holds every KV head, the rank's query heads
    are gathered over ``tp`` (B x 1 x H x Dh); the heads attend over the
    rank's block, the blocks combine (``comm.softmax_combine``) and the
    rank keeps its own heads. Prefill from position 0 attends with the
    rank's heads over the prompt's own keys on the flash kernel; a tail
    prefill (``cache_pos`` > 0) gathers the cache's blocks first (the
    whole prefix: correct, not fast)."""
    ck, cv = kv_cache
    b, s, h_local, _ = q.shape
    write_cache_block(ck, k, cache_pos, split)
    write_cache_block(cv, v, cache_pos, split)
    heads = (tp is not None and tp.splits(h_local, cfg.q_heads)
             and not tp.splits(ck.shape[2], cfg.num_kv_heads))
    if s == 1:
        qa = comm.all_gather(q, tp.group, dim=2) if heads else q
        tl = ck.shape[1]
        k_pos = torch.arange(tl, device=q.device) + split.rank * tl
        if isinstance(cache_pos, torch.Tensor):
            valid = (k_pos[None, :] < cache_pos[:, None] + 1)[:, None, :]
        else:
            valid = k_pos < cache_pos + 1
        m = _mask(positions, k_pos, causal=causal, window=window,
                  is_global=is_global) & valid
        o = comm.softmax_combine(*partial_attention(
            qa, ck.to(q.dtype), cv.to(q.dtype), m), split.group).to(q.dtype)
        return o[:, :, tp.rank * h_local:(tp.rank + 1) * h_local] if heads \
            else o
    offset = int(cache_pos)
    if offset:
        k = comm.all_gather(ck, split.group, dim=1)
        v = comm.all_gather(cv, split.group, dim=1)
    if heads:
        sel = rank_kv_heads(cfg, tp, h_local)
        k, v = _kv_heads(k, sel), _kv_heads(v, sel)
    return blocked_attention(q, k.to(q.dtype), v.to(q.dtype),
                             q_offset=offset, window=window, causal=causal)


def attention(x, p, cfg: ModelConfig, *, positions, is_global=True,
              causal=True, use_rope=True, rope_cs=None, kv_cache=None,
              cache_pos=None, cache_slot=None, k_positions=None,
              k_valid=None, return_kv=False, tp=None, kv_split=None):
    """Attention module, causal unless ``causal`` is False. Returns (out,
    kv_cache), or (out, (k, v)) of the fresh keys and values with
    ``return_kv``. ``use_rope`` False leaves q and k unrotated (whisper's
    sinusoid-embedded layers).

    A local layer (``is_global`` False with ``cfg.sliding_window`` > 0)
    sees only the last ``sliding_window`` positions.

    kv_cache: optional (k_cache, v_cache) of shape [B, T_max, Hkv, Dh],
    written in place at ``cache_pos`` (a Python int, or a [B] tensor during
    single-token decode with ``positions`` [B, 1]), or at ``cache_slot``
    when the cache is a window ring; a ring passes the position each slot
    holds as ``k_positions`` ([W] or [B, W]) and which slots hold one as
    ``k_valid``. Without a cache the call attends over its own keys at
    ``positions`` (the training/scoring forward and a local layer's
    prefill). ``kv_split``: the ranks a flat cache's sequence is split
    over (``_split_cache_attention``); the cache is then the rank's block
    of positions, with every KV head (the rank's, where they split over
    ``tp`` too)."""
    b, s, _ = x.shape
    window = (cfg.sliding_window
              if cfg.sliding_window > 0 and not is_global else None)
    if not use_rope:
        rope_cs = None
    elif rope_cs is None:
        rope_cs = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    split = kv_split is not None and kv_cache is not None
    # a sequence-split cache holds every KV head unless they split too
    q, k, v = _qkv(x, p, cfg, rope_cs, tp if not split or (
        tp is not None and tp.splits(kv_cache[0].shape[2],
                                     cfg.num_kv_heads)) else None)
    fresh_kv = (k, v)

    if split:
        assert cache_slot is None, "a window ring is never sequence-split"
        o = _split_cache_attention(q, k, v, cfg, kv_cache, cache_pos,
                                   positions, window, is_global, causal, tp,
                                   kv_split)
    elif kv_cache is None:
        # the masks depend on position differences only, so the call's own
        # keys sit at offset 0 whatever ``positions`` start at
        o = blocked_attention(q, k, v, window=window, causal=causal)
    else:
        ck, cv = kv_cache
        write_at = cache_pos if cache_slot is None else cache_slot
        write_cache(ck, k, write_at)
        write_cache(cv, v, write_at)
        if s == 1:
            # decode: one query per row, masked attention over the cache
            if k_positions is None:
                k_positions = torch.arange(ck.shape[1], device=x.device)
                if isinstance(cache_pos, torch.Tensor):
                    k_valid = k_positions[None, :] < (cache_pos[:, None] + s)
                else:
                    k_valid = k_positions < (cache_pos + s)
            m = _mask(positions, k_positions, causal=causal, window=window,
                      is_global=is_global)
            m = m & (k_valid[None, :] if k_valid.dim() == 1
                     else k_valid[:, None, :])
            o = attention_scores(q, ck.to(q.dtype), cv.to(q.dtype), m)
        else:
            o = blocked_attention(q, ck.to(q.dtype), cv.to(q.dtype),
                                  q_offset=int(cache_pos), window=window,
                                  causal=causal)

    wo = p["wo"]
    out = _proj(o.reshape(b, s, -1), wo.reshape(-1, wo.shape[-1]))
    if tp is not None and tp.splits(wo.shape[0], cfg.q_heads):
        out = tp.sum(out)
    if return_kv:
        return out, fresh_kv
    return out, kv_cache


# ---------------------------------------------------------------------------
# KV-cache helpers (flat [L, B, T, kvh, dh] caches, gemma3's dict of global
# caches and local window rings, and paged pools)
#
# The physical pool stores fixed-size KV blocks: each leaf is
# [L, P, block, kvh, dh] — a contiguous cache whose "batch" axis is the
# block id and whose seq axis is block_size positions. A slot's logical
# cache is its block table (an [NB] row of block ids): logical position t
# lives in pool block ``table[t // block]`` at offset ``t % block``.


def cache_leaves(caches):
    """The leaves of a cache tree (its tensors, or the shapes of
    ``DecoderLM.cache_shapes``): a flat (k, v) pair, or gemma3's
    ``{"global": (k, v), "local": (k, v)}``."""
    if isinstance(caches, dict):
        return [c for pair in caches.values() for c in pair]
    return list(caches)


def mask_cache_tail(caches, true_len):
    """Zero cache entries at positions >= ``true_len`` (seq axis 2), in
    place: right-pad hygiene for bucketed prefill. On a window ring the
    seq axis is the ring slot; ``_ring_gather`` already zeroed the slots
    past a short prompt, so there the mask changes nothing."""
    for c in cache_leaves(caches):
        c[:, :, true_len:] = 0
    return caches


def reset_cache_slot(caches, slot: int):
    """Zero batch row ``slot`` (axis 1) of every cache leaf, in place:
    slot recycling."""
    for c in cache_leaves(caches):
        c[:, slot] = 0
    return caches


def cache_slot_view(caches, slot: int):
    """Batch row ``slot`` of a cache tree as a batch-1 view. The model
    writes caches in place, so a prefill on the view fills the shared row
    and leaves the others untouched: the port needs no counterpart of the
    reference's functional ``gather_cache_slot``/``scatter_cache_slot``
    copies."""
    if isinstance(caches, dict):
        return {k: cache_slot_view(v, slot) for k, v in caches.items()}
    return tuple(c[:, slot:slot + 1] for c in caches)


def paged_gather(pool, tables):
    """Logical cache views through block tables.

    pool leaves: [L, P, block, kvh, dh]; tables: [B, NB] int block ids.
    Returns new leaves [L, B, NB*block, kvh, dh]."""
    out = []
    for c in pool:
        v = c[:, tables.long()]                     # [L, B, NB, block, ...]
        out.append(v.reshape(v.shape[0], tables.shape[0], -1, *v.shape[4:]))
    return tuple(out)


def paged_scatter_block(pool, view, tables, pos):
    """Write back, per batch row, the single block containing ``pos`` ([B]).

    Free slots point at the reserved null block; their duplicate writes
    collide there harmlessly, because the null block is never read."""
    b = tables.shape[0]
    bidx = torch.arange(b, device=tables.device)
    for c, v in zip(pool, view):
        blk_size = c.shape[2]
        blk = pos.long() // blk_size
        vr = v.reshape(v.shape[0], b, -1, blk_size, *v.shape[3:])
        c[:, tables[bidx, blk].long()] = vr[:, bidx, blk]
    return pool


def paged_scatter_slot(pool, view, table_row):
    """Write a batch-1 logical view back through one slot's block table
    (unallocated tail entries land in the null block)."""
    for c, v in zip(pool, view):
        blk_size = c.shape[2]
        c[:, table_row.long()] = v.reshape(v.shape[0], -1, blk_size,
                                           *v.shape[3:])
    return pool


class PagedLayers:
    """A paged pool seen through block tables one layer at a time, as a
    step's ``caches``: the layer stack takes layer ``i``'s logical views
    [B, NB*block, kvh, dh] from ``layer(i)`` (a copy, as ``paged_gather``
    makes of every layer) and hands them back to ``put(i, kv)`` once the
    layer has written them, which writes back what the step changed: with
    ``pos`` ([B], a decode step) each row's block holding it (as
    ``paged_scatter_block``), else (one row's prefill, ``tables`` [1,
    NB]) the row's every block after zeroing its positions from ``keep``
    on (as ``mask_cache_tail`` and ``paged_scatter_slot``). The pool and
    the values are those of gathering every layer at once, but only one
    layer's views are live beside the pool, not the whole stack's: at
    32768 positions of MHA that whole copy is a row of cache (7.5 GB on
    deepseek-moe-16b) beside a prefill and the batch's whole cache beside
    a decode step. The block ids (and a decode step's touched blocks) are
    indexed once a step, not once a layer."""

    def __init__(self, pool, tables, pos=None, keep=None):
        self.pool, self.keep = pool, keep
        self.ids = tables.long()                             # [B, NB]
        self.n = tables.shape[0] * tables.shape[1]           # B * NB
        if pos is not None:
            # the touched block of each row: its id in the pool, and its
            # index in the row-major [B * NB] blocks of the views
            blk = pos.long() // pool[0].shape[2]
            at = torch.arange(tables.shape[0], device=tables.device)
            self.touched = self.ids[at, blk]
            self.at = at * tables.shape[1] + blk
        self.decode = pos is not None

    def layer(self, i):
        b = self.ids.shape[0]
        return tuple(c[i][self.ids].reshape(b, -1, *c.shape[3:])
                     for c in self.pool)

    def put(self, i, kv):
        for c, v in zip(self.pool, kv):
            v = v.reshape(self.n, *c.shape[2:])        # [B * NB, block, ..]
            if self.decode:
                c[i][self.touched] = v[self.at]
            else:
                v.view(-1, *c.shape[3:])[self.keep:] = 0
                c[i][self.ids[0]] = v


def reset_cache_blocks(pool, blocks):
    """Zero a batch of pool blocks (``blocks`` [K], padded with the null
    block id 0)."""
    for c in pool:
        # index_fill_ takes the zero as a scalar argument; an indexed
        # assignment of 0 would copy it to the device and sync the stream
        c.index_fill_(1, blocks.long(), 0)
    return pool


def copy_cache_block(pool, src: int, dst: int):
    """Copy one pool block (copy-on-write): dst <- src across every leaf."""
    for c in pool:
        c[:, dst] = c[:, src]
    return pool


# ---------------------------------------------------------------------------
# mixed-axis state trees (recurrent serving)
#
# Recurrent families stack per-layer state with the batch on different axes
# per leaf: xlstm's mLSTM and conv leaves are [L, B, ...] (axis 1), its
# sLSTM leaves [B, ...] (axis 0); zamba2 mixes [L, B, ...] mamba state with
# [B, T, ...] attention KV. ``axes`` is a tree of the same structure (an
# int batch axis a leaf, which ``serve.state`` infers once from two
# ``init_cache`` calls on the meta device), so one gather/scatter pair
# serves every family. Trees are dicts and tuples of tensors.


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of dict/tuple trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def gather_state_slot(state, slot: int, axes):
    """Batch row ``slot`` of a mixed-axis state tree as a batch-1 tree of
    views (a write to one lands in the shared row)."""
    return tree_map(lambda c, ax: c.narrow(ax, slot, 1), state, axes)


def scatter_state_slot(state, update, slot: int, axes):
    """Write a batch-1 mixed-axis state tree into batch row ``slot``, in
    place. Scattering a freshly initialised batch-1 template is also how a
    slot is reset: every leaf row is overwritten wholesale, so no carried
    state (or KV) of a prior occupant survives slot reuse."""
    tree_map(lambda c, u, ax: c.narrow(ax, slot, 1).copy_(u), state, update,
             axes)
    return state


# ---------------------------------------------------------------------------
# parameters: (shape, fan_in) spec trees in the reference's layout, and the
# per-layer slices of its stacked [L, ...] leaves


def embed_shapes(cfg: ModelConfig):
    """The embedding, unembedding and final norm (``embed_init``)."""
    d = cfg.d_model
    return {"embedding": ((cfg.vocab_size, d), d),
            "unembed": ((d, cfg.vocab_size), d),
            "final_norm": ((d,), None)}


def attn_shapes(cfg: ModelConfig, pre: tuple = ()):
    """One attention block's leaves (``attn_init``), stacked over ``pre``."""
    d, h, kvh, dh = cfg.d_model, cfg.q_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": (pre + (d, h, dh), d),
        "wk": (pre + (d, kvh, dh), d),
        "wv": (pre + (d, kvh, dh), d),
        "wo": (pre + (h, dh, d), h * dh),
        **({"q_norm": (pre + (dh,), None), "k_norm": (pre + (dh,), None)}
           if cfg.qk_norm else {}),
    }


def mlp_shapes(d_model: int, d_ff: int, pre: tuple = ()):
    """One gated MLP's leaves (``mlp_init``), stacked over ``pre``."""
    return {"w_gate": (pre + (d_model, d_ff), d_model),
            "w_up": (pre + (d_model, d_ff), d_model),
            "w_down": (pre + (d_ff, d_model), d_ff)}


# the logical axes of each leaf (``repro_torch.parallel.sharding``), tree
# for tree beside the shapes above; ``pre`` is ``("layers",)`` for a stack


def embed_axes():
    return {"embedding": ("vocab", "embed"),
            "unembed": ("embed", "vocab"),
            "final_norm": ("norm",)}


def attn_axes(cfg: ModelConfig, pre: tuple = ()):
    return {
        "wq": pre + ("embed", "heads", "head_dim"),
        "wk": pre + ("embed", "kv_heads", "head_dim"),
        "wv": pre + ("embed", "kv_heads", "head_dim"),
        "wo": pre + ("heads", "head_dim", "embed"),
        **({"q_norm": pre + ("norm",), "k_norm": pre + ("norm",)}
           if cfg.qk_norm else {}),
    }


def mlp_axes(pre: tuple = (), hidden: str = "mlp"):
    return {"w_gate": pre + ("embed", hidden),
            "w_up": pre + ("embed", hidden),
            "w_down": pre + (hidden, "embed")}


def layer_of(v, i):
    """Layer ``i``'s slice of a stacked ``[L, ...]`` parameter tree."""
    if isinstance(v, dict):
        return {k: layer_of(u, i) for k, u in v.items()}
    return v[i]


def layers_of(v, n):
    """Every layer's slice of a stacked ``[L, ...]`` tree at once
    (``unbind``). Under a gradient the slices' gradients are then stacked
    once per leaf; indexing layer by layer would scatter each into a
    zero-filled copy of the whole stack and sum the copies: L full-size
    fills and L - 1 full-size sums per leaf."""
    if isinstance(v, dict):
        per = {k: layers_of(u, n) for k, u in v.items()}
        return [{k: per[k][i] for k in per} for i in range(n)]
    return v.unbind(0)


def init_tree(spec, generator, device, dtype):
    """Tensors for a (shape, fan_in) spec tree on ``device``: N(0, 1/fan_in)
    from ``generator``, filled in place a leading row at a time (no f32
    copy of a bf16 model); fan_in None gives zeros (norm scales and
    biases), ``"ones"`` ones (the reference's ``one=True`` leaves)."""
    if isinstance(spec, dict):
        return {k: init_tree(v, generator, device, dtype)
                for k, v in spec.items()}
    shape, fan_in = spec
    if fan_in == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    t = torch.zeros(shape, dtype=dtype, device=device)
    if fan_in is not None:
        std = 1.0 / max(fan_in, 1) ** 0.5
        for row in (t if len(shape) > 2 else (t,)):
            row.normal_(0.0, std, generator=generator)
    return t


# ---------------------------------------------------------------------------
# jax.nn's softplus and log_sigmoid, formula for formula (the recurrent
# gates)


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def log_sigmoid(x):
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -softplus(-x)


# ---------------------------------------------------------------------------
# MLP and embeddings


def rank_block(tp, block: int, full: int):
    """The slice of a dim of ``full`` entries that the rank's ``block`` of
    them covers (``tp.splits``): its ``tp.rank``-th block; None where the
    dim is not split or ``tp`` is None."""
    if tp is None or not tp.splits(block, full):
        return None
    return slice(tp.rank * block, (tp.rank + 1) * block)


def rank_heads(tp, nh: int):
    """The rank's heads of a recurrent layer (a slice): its ``1/tp.size``
    of the ``nh`` where they divide over the ranks (the ``act_heads``
    spec splits the state so); None where every rank runs all of them."""
    if tp is None or nh % tp.size:
        return None
    k = nh // tp.size
    return slice(tp.rank * k, (tp.rank + 1) * k)


def gathered_product(x, w, tp=None, full: int = 0):
    """``x @ w`` in x's dtype. Under ``tp`` with the ``full`` output
    columns of ``w`` split, the product of the rank's contiguous block of
    columns, all-gathered over the ranks (whose backward reduce-scatters):
    every rank holds the whole product, for a weight whose blocks do not
    line up with what its columns mean (a concatenation such as mamba2's
    ``[z|x|B|C|dt]``)."""
    y = x @ w.to(x.dtype)
    if tp is not None and tp.splits(w.shape[-1], full):
        y = comm.all_gather(y, tp.group, dim=-1)
    return y


def row_product(x, w, tp=None, full: int = 0):
    """``x @ w`` in x's dtype; under ``tp`` with the ``full`` input rows of
    ``w`` split (row-parallel: ``x`` the rank's channels), the ranks'
    partial products summed."""
    y = x @ w.to(x.dtype)
    if tp is not None and tp.splits(w.shape[0], full):
        y = tp.sum(y)
    return y


def mlp(x, p, tp=None, width: int = 0):
    """The gated MLP; under ``tp`` with its ``width`` split, the rank's
    columns of ``w_gate`` and ``w_up`` and rows of ``w_down``, summed over
    the ranks."""
    g = x @ p["w_gate"].to(x.dtype)
    u = x @ p["w_up"].to(x.dtype)
    return row_product(F.silu(g) * u, p["w_down"], tp, width)


def _vocab_rows(ids, tp, v_local):
    """(row in the rank's vocabulary block, whether the block holds it)
    of each id."""
    local = ids.long() - tp.rank * v_local
    held = (local >= 0) & (local < v_local)
    return local.clamp(0, v_local - 1), held


def embed(tokens, p, dtype, tp=None, vocab: int = 0):
    """Rows of the embedding table, indexed before any cast. Under ``tp``
    with the ``vocab`` rows split: each rank's rows of its block (zero
    for tokens it does not hold), summed over the ranks."""
    table = p["embedding"]
    if tp is None or not tp.splits(table.shape[0], vocab):
        return table[tokens].to(dtype)
    rows, held = _vocab_rows(tokens, tp, table.shape[0])
    x = torch.where(held[..., None], table[rows], 0.0).to(dtype)
    return tp.sum(x)


def unembed(x, p):
    """Logits (under tensor parallelism, the rank's block of the
    vocabulary: its columns of ``unembed``)."""
    x = rms_norm(x, p["final_norm"])
    return x @ p["unembed"].to(x.dtype)


# ---------------------------------------------------------------------------
# losses


def _vocab_sums(m_run, s_run, gold, tp):
    """The whole vocabulary's max, sum of exponentials and gold logit
    from each rank's over its block: the max (no gradient: the log-sum is
    the same at any shift) over the ranks, each sum rescaled to it, and
    the sums and gold logits summed over the ranks."""
    m = comm.all_reduce_max(m_run.detach().clone(), tp.group)
    return (m, tp.sum(s_run * torch.exp(m_run - m)), tp.sum(gold))


def _xent_chunk(m_run, s_run, gold, hn, wc, labels, lo):
    """One vocab chunk of ``chunked_softmax_xent``: the chunk's logits
    [B,S,c] in f32 folded into the running max, sum and gold logit."""
    c = wc.shape[1]
    logits = (hn @ wc.to(hn.dtype)).float()
    m_new = torch.maximum(m_run, logits.amax(dim=-1))
    s_run = (s_run * torch.exp(m_run - m_new)
             + torch.exp(logits - m_new[..., None]).sum(dim=-1))
    in_range = (labels >= lo) & (labels < lo + c)
    idx = (labels - lo).clamp(0, c - 1)
    g = logits.gather(-1, idx[..., None].long())[..., 0]
    return m_new, s_run, gold + torch.where(in_range, g, 0.0)


def chunked_softmax_xent(h, params, labels, mask=None, n_chunks=16,
                         tp=None, vocab: int = 0):
    """Cross-entropy without materializing [B,S,V] logits.

    Online logsumexp over vocab chunks; each chunk runs under
    ``torch.utils.checkpoint``, so its logits are recomputed in the
    backward pass (the reference's ``jax.checkpoint(nothing_saveable)``)
    and peak memory is O(B*S*V/n). The whole vocabulary must be a multiple
    of ``n_chunks``, as the reference asserts. Under ``tp`` with the
    ``vocab`` columns split, ``params["unembed"]`` is the rank's block,
    cut into ``n_chunks`` chunks whose widths differ by at most one, and
    the running terms meet over the ranks at the end (``_vocab_sums``)."""
    hn = rms_norm(h, params["final_norm"])
    w = params["unembed"]
    v = w.shape[1]
    if tp is not None and not tp.splits(v, vocab):
        tp = None
    full = v if tp is None else vocab
    if full % n_chunks:
        raise ValueError(f"vocab {full} is not a multiple of {n_chunks} "
                         "chunks")
    base = 0 if tp is None else tp.rank * v
    b, s, _ = h.shape
    m_run = torch.full((b, s), NEG_INF, dtype=torch.float32, device=h.device)
    s_run = torch.zeros((b, s), dtype=torch.float32, device=h.device)
    gold = torch.zeros((b, s), dtype=torch.float32, device=h.device)
    for i in range(n_chunks):
        lo, hi = i * v // n_chunks, (i + 1) * v // n_chunks
        m_run, s_run, gold = checkpoint(
            _xent_chunk, m_run, s_run, gold, hn, w[:, lo:hi], labels,
            base + lo, use_reentrant=False, preserve_rng_state=False)
    if tp is not None:
        m_run, s_run, gold = _vocab_sums(m_run, s_run, gold, tp)
    nll = torch.log(s_run.clamp_min(1e-30)) + m_run - gold
    if mask is not None:
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()


def softmax_xent(logits, labels, mask=None, tp=None, vocab: int = 0):
    """Mean cross-entropy in fp32; labels: int [B,S]. Under ``tp`` with
    the ``vocab`` columns split, ``logits`` is the rank's block
    (``_vocab_sums``)."""
    lf = logits.float()
    if tp is None or not tp.splits(lf.shape[-1], vocab):
        lse = torch.logsumexp(lf, dim=-1)
        gold = lf.gather(-1, labels[..., None].long())[..., 0]
    else:
        # the max over the whole vocabulary first, so that each
        # exponential is the one-rank formula's
        m = comm.all_reduce_max(lf.detach().amax(dim=-1), tp.group)
        s = tp.sum(torch.exp(lf - m[..., None]).sum(dim=-1))
        rows, held = _vocab_rows(labels, tp, lf.shape[-1])
        gold = tp.sum(torch.where(
            held, lf.gather(-1, rows[..., None])[..., 0], 0.0))
        lse = torch.log(s) + m
    nll = lse - gold
    if mask is not None:
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()
