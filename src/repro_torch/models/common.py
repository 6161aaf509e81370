"""Shared model components: norms, RoPE, GQA attention, KV-cache helpers,
MLP, embeddings.

Plain functions over explicit parameter dicts of tensors, with the
reference's names, shapes and ``[L, ...]`` stacking. Where the reference
returns updated cache arrays, these helpers update the cache tensors in
place (and return them): a serving step then holds one copy of its cache
view instead of one per layer.

Prefill attention runs on the Hopper flash kernel
(``repro_torch.kernels.flash_attention``); single-token decode attention
stays plain tensor ops over the gathered cache view, as in the reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# norms


def rms_norm(x, scale, eps=1e-6):
    """RMS norm in f32, scaled by ``1 + scale`` (zero-initialised scale)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
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


def _qkv(x, p, cfg: ModelConfig, rope_cs):
    """Projected q [B,S,H,Dh] and k, v [B,S,Hkv,Dh], RoPE applied."""
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
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


def blocked_attention(q, k, v, *, q_offset=0):
    """Causal prefill attention on the flash kernel.

    q [B,S,H,Dh]; k, v [B,T,Hkv,Dh]. Query row i sits at position
    ``q_offset + i`` and key j at position j, so under causal masking the
    cache tail past ``q_offset + S`` is never read — the same result as the
    reference's ``blocked_attention`` with its invalid key positions sent to
    ``2**30``."""
    o = flash_attention(q.transpose(1, 2).contiguous(),
                        k.transpose(1, 2).contiguous(),
                        v.transpose(1, 2).contiguous(), q_offset=q_offset)
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


def attention(x, p, cfg: ModelConfig, *, positions, rope_cs=None,
              kv_cache=None, cache_pos=None):
    """Causal attention module of the flat-cache path (every layer global,
    so no window). Returns (out, kv_cache).

    kv_cache: optional (k_cache, v_cache) of shape [B, T_max, Hkv, Dh],
    written in place at ``cache_pos`` (a Python int, or a [B] tensor during
    single-token decode with ``positions`` [B, 1]). Without a cache the
    call attends over its own keys at ``positions`` 0..S-1 (the training/
    scoring forward)."""
    b, s, _ = x.shape
    if rope_cs is None:
        rope_cs = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    q, k, v = _qkv(x, p, cfg, rope_cs)

    if kv_cache is None:
        o = blocked_attention(q, k, v)
    else:
        ck, cv = kv_cache
        write_cache(ck, k, cache_pos)
        write_cache(cv, v, cache_pos)
        if s == 1:
            # decode: one query per row, masked attention over the cache
            k_pos = torch.arange(ck.shape[1], device=x.device)
            if isinstance(cache_pos, torch.Tensor):
                valid = k_pos[None, :] < (cache_pos[:, None] + s)
            else:
                valid = k_pos < (cache_pos + s)
            m = _mask(positions, k_pos, causal=True, window=None,
                      is_global=True)
            m = m & (valid[None, :] if valid.dim() == 1
                     else valid[:, None, :])
            o = attention_scores(q, ck.to(q.dtype), cv.to(q.dtype), m)
        else:
            o = blocked_attention(q, ck.to(q.dtype), cv.to(q.dtype),
                                  q_offset=int(cache_pos))

    out = _proj(o.reshape(b, s, cfg.q_heads * cfg.head_dim),
                p["wo"].reshape(cfg.q_heads * cfg.head_dim, cfg.d_model))
    return out, kv_cache


# ---------------------------------------------------------------------------
# KV-cache helpers (flat [L, B, T, kvh, dh] caches and paged pools)
#
# The physical pool stores fixed-size KV blocks: each leaf is
# [L, P, block, kvh, dh] — a contiguous cache whose "batch" axis is the
# block id and whose seq axis is block_size positions. A slot's logical
# cache is its block table (an [NB] row of block ids): logical position t
# lives in pool block ``table[t // block]`` at offset ``t % block``.


def mask_cache_tail(caches, true_len):
    """Zero cache entries at positions >= ``true_len`` (seq axis 2), in
    place: right-pad hygiene for bucketed prefill."""
    for c in caches:
        c[:, :, true_len:] = 0
    return caches


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
# MLP and embeddings


def mlp(x, p):
    g = x @ p["w_gate"].to(x.dtype)
    u = x @ p["w_up"].to(x.dtype)
    return (F.silu(g) * u) @ p["w_down"].to(x.dtype)


def embed(tokens, p, dtype):
    """Rows of the embedding table, indexed before any cast."""
    return p["embedding"][tokens].to(dtype)


def unembed(x, p):
    x = rms_norm(x, p["final_norm"])
    return x @ p["unembed"].to(x.dtype)
