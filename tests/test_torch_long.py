"""The port at long positions against the reference, on the host.

The serve parity tests elsewhere stop at 32-64 positions; these run the
smoke models of the families the card serves at 32768 positions
(granite-20b and the MoE models paged with a shared prefix, gemma3-27b on
window rings, zamba2-1.2b in pow2 chunks) at max_seq 4096, in f32, with
the weights drawn from a numpy seed (``torch_weights``), against the
reference's ``ContinuousEngine`` and models; and RoPE at positions near
32767 and 524287 against the reference's ``rope``. A fault that shows only at long
positions (the rope angle, block tables 128 blocks long, the last bucket
at max_seq, a state carried over a dozen pow2 chunks) fails here. The
port's chunk cap (``max_chunk``, which the card's 524288-position serve
of zamba2-1.2b needs: the dry-run's count here says why) serves each
recurrent family as the reference's uncapped chunking does. The dry-run's
counts pin the batch each model serves at 32768 positions, and the paged
steps' own count holds them to one layer's views beside the pool.

The smoke models are cut so that each test runs in under 20 s alone on a
host CPU (the port's plain attention builds every 4096 x 4096 score):
granite-20b's and the MoE models' to 2 of 4 layers (an MoE model's dense
first layer and one MoE layer), gemma3-27b's to one local and one global
layer (``local_global_period`` 2), zamba2-1.2b's to its first
shared-attention site (3 of 6 layers).

Tolerances: the engines emit equal greedy tokens and finish reasons, and
the logits of every prefill step (a prefix hit's tail, a ring prefill, a
pow2 chunk) agree within 1e-4 of max|logit|. RoPE: an f32 angle near
position p is good to ~p x 2^-23 rad (the rounding of the frequencies'
exponent, carried through ``exp``), so both packages are held within p x
2^-22 rad of the exact rotation (f64 angles) and of each other
(``_rope_bound``); at position 524287 that is 0.125 rad, where the two
read up to 1.6e-2 apart.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import hw as jhw
from repro.models import build_model as jbuild
from repro.models import common as jcommon
from repro.serve import paging as jpaging
from repro.serve.engine import ContinuousEngine as JEngine
from repro.serve.queue import Request as JRequest
from repro_torch import configs as tconfigs
from repro_torch.core.hw import H100_SXM
from repro_torch.models import build_model as tbuild
from repro_torch.models import common as tcommon
from repro_torch.models import moe as tmoe
from repro_torch.serve import paging as tpaging
from repro_torch.serve.engine import ContinuousEngine, Request
from repro_torch.models.registry import serving_caps
from repro_torch.serve.step import capped_chunks, pow2_chunks
from repro.serve.step import pow2_chunks as jpow2_chunks
from torch_weights import both_trees

MAX_SEQ = 4096
REL = 1e-4


@pytest.fixture(autouse=True)
def four_torch_threads():
    """The plain attention over 4096 x 4096 scores is the port's host
    time: four intra-op threads (restored after the test)."""
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, rel=REL, what=""):
    """max|got - want| <= rel * max|want| (and the same shape)."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    scale = max(float(np.abs(w).max()), 1e-30)
    err = float(np.abs(g - w).max())
    assert err <= rel * scale, f"{what}: max|err| {err} > {rel} x {scale}"


@pytest.mark.parametrize("top", [32767, 524287])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_at_long_positions(top, d, theta):
    """The last 64 positions up to ``top`` (and position 0), 4 heads, in
    f32: the port's ``rope`` and the reference's, each against the exact
    rotation (f64 angles) and against each other, within
    ``_rope_bound``."""
    rng = np.random.default_rng(top + d)
    pos = np.concatenate([[0], np.arange(top - 63, top + 1)]).astype(
        np.int32)
    x = rng.standard_normal((2, len(pos), 4, d)).astype(np.float32)
    want = _np(jcommon.rope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = _np(tcommon.rope(torch.from_numpy(x), torch.from_numpy(pos),
                           theta))
    half = d // 2
    ang = pos[:, None].astype(np.float64) * np.exp(
        -np.log(theta) * np.arange(half) / half)
    cos, sin = np.cos(ang)[:, None], np.sin(ang)[:, None]
    x1, x2 = x[..., :half].astype(np.float64), x[..., half:]
    exact = np.concatenate([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    bound = _rope_bound(x, pos)
    assert (np.abs(want - exact) <= bound).all()
    assert (np.abs(got - exact) <= bound).all()
    assert (np.abs(got - want) <= bound).all()
    # near position 0 the two agree to f32 rounding
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=0, atol=1e-6)


def _rope_bound(x, pos):
    """How far an f32 RoPE may sit from the exact rotation at ``pos``: the
    f32 angle ``pos * freq`` carries the rounding of ``-log(theta) * i /
    half`` through ``exp`` (a relative error of up to ~|log freq| x 2^-23,
    so an angle error of up to ~0.37 x pos x 2^-23 rad) and of the
    product (2^-24 x pos): 2^-22 x pos rad bounds both with room. The
    reference's exp and the port's differ by one ulp in 0-10 of the 32-64
    frequencies, so at 524287 the two packages' rotations part by up to
    ~1.6e-2 of |x|: each stays within this bound of the exact one."""
    half = x.shape[-1] // 2
    mag = np.abs(x[..., :half]) + np.abs(x[..., half:])
    mag = np.concatenate([mag, mag], -1)
    return mag * (pos[None, :, None, None] * 2.0 ** -22) + 1e-6


def _capture(adapter, name):
    """Wrap ``adapter.<name>`` (a step returning (token, logits, state)) so
    that every call's logits are kept, in call order."""
    seen = []
    step = getattr(adapter, name)

    def spy(*args):
        out = step(*args)
        seen.append(_np(out[1]).copy())
        return out

    setattr(adapter, name, spy)
    return seen


def _jdev():
    return jhw.DeviceSpec(**dataclasses.asdict(H100_SXM))


def _serve_both(name, cut, prompts, batch, max_new, seed, max_seq=MAX_SEQ,
                watch=None):
    """The port's engine and the reference's on the same requests and
    numpy-seeded f32 weights (bf16 caches on both sides, as each engine
    makes them): tokens, finish reasons and counts equal, and the logits
    of every prefill step (a recurrent prompt's last chunk: its first
    step) within ``REL`` of max|logit|. ``watch`` is called with the
    port's engine before it serves. Returns (the port's requests, its
    stats, its prefill steps' logits, the reference's stats)."""
    jcfg = jconfigs.get_smoke(name).replace(dtype="float32", **cut)
    tcfg = tconfigs.get_smoke(name).replace(dtype="float32", **cut)
    jp, tp = both_trees(tcfg, seed)
    jreqs = [JRequest(i, p.copy(), max_new_tokens=max_new)
             for i, p in enumerate(prompts)]
    treqs = [Request(i, p.copy(), max_new_tokens=max_new)
             for i, p in enumerate(prompts)]
    jeng = JEngine(jbuild(jcfg), jp, batch_size=batch, max_seq=max_seq,
                   dev=_jdev())
    eng = ContinuousEngine(tbuild(tcfg), tp, batch_size=batch,
                           max_seq=max_seq, telemetry=False)
    if watch is not None:
        watch(eng)
    step = "_chunk" if eng.adapter.kind == "recurrent" else "_prefill_slot"
    want = _capture(jeng.adapter, step)
    got = _capture(eng.adapter, step)
    jst = jeng.serve(jreqs)
    with torch.no_grad():
        tst = eng.serve(treqs)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert [r.finish_reason for r in treqs] == \
        [r.finish_reason for r in jreqs]
    for key in ("completed", "prefills", "decode_steps", "tokens_decoded",
                "prefill_compiles", "decode_compiles", "adapter"):
        assert tst[key] == jst[key], key
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, what=f"prefill step {i} logits")
    return treqs, tst, got, jst


def _prompts(vocab, lens, seed, shared=0):
    """Prompts of ``lens`` tokens; with ``shared`` all but the first begin
    with the first one's ``shared`` tokens."""
    rng = np.random.default_rng(seed)
    out = [rng.integers(0, vocab, n).astype(np.int32) for n in lens]
    for p in out[1:]:
        p[:shared] = out[0][:shared]
    return out


def test_granite_paged_engine_at_4096_with_a_shared_prefix():
    """3 prompts of ~4000 tokens at batch 4, the last two sharing the
    first's 2048 tokens: the paged engine (block 32, 128-block tables)
    takes two prefix hits and prefills their tails in the 2048 bucket at
    q_offset 2048, the cold prompt in the 4096 bucket (max_seq)."""
    prompts = _prompts(512, (4000, 4020, 3990), 0, shared=2048)
    treqs, tst, *_ = _serve_both("granite-20b", dict(num_layers=2), prompts,
                                  4, 4, 0)
    assert tst["kv_block_size"] == 32
    assert tst["prefix_cache"]["hits"] == 2
    assert [r.cached_prompt_tokens for r in treqs] == [0, 2048, 2048]
    assert tst["prefill_buckets"][-1] == MAX_SEQ


def test_admission_that_evicts_scrubs_once():
    """The card's 32k serve of moonshot-v1-16b-a3b at batch 1, in small: a
    pool of one row (16 blocks of 32 at max_seq 512), two prompts of ~480
    tokens sharing 128. The second's admission needs 10 blocks of the
    first's prefix-trie entries: they are evicted at once and scrubbed with
    the slot's freed block in one ``zero_blocks`` call, one row of blocks
    wide (the null block pads it). Evicting and scrubbing a block at a
    time made 11 calls, each a row wide (ROADMAP Queue 3). Tokens, logits,
    counts and the prefix cache's stats as the reference engine's."""
    scrubs = []

    def watch(eng):
        ad = eng.adapter
        zero = ad._zero_blocks

        def spy(pool, blocks):
            scrubs.append((int((blocks != 0).sum()), blocks.numel() * sum(
                c[:, 0].numel() * c.element_size() for c in pool),
                ad.prefix.stats.evictions))
            return zero(pool, blocks)

        ad._zero_blocks = spy

    prompts = _prompts(512, (480, 470), 7, shared=128)
    treqs, tst, _, jst = _serve_both("granite-20b", dict(num_layers=2),
                                     prompts, 1, 4, 7, max_seq=512,
                                     watch=watch)
    assert [r.cached_prompt_tokens for r in treqs] == [0, 128]
    assert tst["prefix_cache"] == jst["prefix_cache"]
    assert tst["prefix_cache"]["evictions"] == 10
    tcfg = tconfigs.get_smoke("granite-20b").replace(num_layers=2)
    row = 2 * 2 * tcfg.num_kv_heads * tcfg.head_dim * 512 * 2   # bf16 k, v
    # the slot's freed last block and the 10 evicted, in one call
    assert scrubs == [(11, row, 10)]


@pytest.fixture
def routed(monkeypatch):
    """The port's ``moe.route`` counted by routing shape (G, T, capacity):
    {shape: [choices, dropped]}."""
    seen = {}
    route = tmoe.route

    def spy(xg, logits, cfg, capacity):
        out = route(xg, logits, cfg, capacity)
        n = seen.setdefault((xg.shape[0], xg.shape[1], capacity), [0, 0])
        n[0] += out[3].numel()
        n[1] += int((~out[3]).sum())
        return out

    monkeypatch.setattr(tmoe, "route", spy)
    return seen


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "moonshot-v1-16b-a3b"])
def test_moe_paged_engine_at_4096_with_a_shared_prefix(name, routed):
    """The MoE family on the card's 32k serve, at max_seq 4096: the smoke
    config at 2 layers (its dense first layer and one MoE layer), 3
    prompts of ~4000 tokens at batch 4, the last two sharing the first's
    2048 tokens. Each prefill routes its bucket as one group, pad tokens
    and all: the cold prompt at (1, 4096, 1280), where choices drop, each
    tail at (1, 2048, 640); tokens, stats and every prefill's logits as
    the reference engine's, 2 prefix hits."""
    prompts = _prompts(512, (4000, 4020, 3990), 6, shared=2048)
    treqs, tst, *_ = _serve_both(name, dict(num_layers=2), prompts, 4, 4, 6)
    assert tst["prefix_cache"]["hits"] == 2
    assert [r.cached_prompt_tokens for r in treqs] == [0, 2048, 2048]
    prefills = {key: n for key, n in routed.items() if key[1] > 1}
    assert set(prefills) == {(1, 4096, 1280), (1, 2048, 640)}
    assert prefills[(1, 4096, 1280)][1] > 0
    assert set(routed) - set(prefills) == {(4, 1, 1)}


def test_gemma3_window_rings_at_4096():
    """2 prompts of ~4000 tokens (each past 100 windows of 32) at batch 1
    on the window rings, the second waiting for the slot the first frees
    (its ring rows reset)."""
    prompts = _prompts(512, (4000, 4050), 1)
    treqs, tst, *_ = _serve_both("gemma3-27b", dict(
        num_layers=2, local_global_period=2), prompts, 1, 4, 1)
    assert tst["adapter"] == "window-ring"
    assert tst["slots_recycled"] >= 1
    assert min(len(p) for p in prompts) > 100 * 32


def test_zamba2_twelve_pow2_chunks_at_4096():
    """A 4095-token prompt (12 pow2 chunks, 2048 down to 1) at max_seq
    4096, the state carried over every chunk: each chunk's logits as the
    reference's, the last one's the first step's."""
    (prompt,) = _prompts(512, (4095,), 2)
    assert len(pow2_chunks(len(prompt))) == 12
    _, tst, logits, _ = _serve_both("zamba2-1.2b", dict(num_layers=3),
                                 [prompt], 1, 4, 2)
    assert tst["adapter"] == "recurrent" and len(logits) == 12


def test_capped_chunks():
    """No cap: ``pow2_chunks`` exactly (the reference's chunking). A cap
    ``c``: ``n // c`` chunks of ``c``, then ``pow2_chunks(n % c)``."""
    for n in list(range(1, 70)) + [255, 256, 4095, 32736, 524256]:
        assert capped_chunks(n) == pow2_chunks(n) == jpow2_chunks(n)
        for cap in (1, 4, 256):
            got = capped_chunks(n, cap)
            assert sum(got) == n and max(got) <= cap
            assert got == [cap] * (n // cap) + (pow2_chunks(n % cap)
                                                 if n % cap else [])
    assert capped_chunks(4095, 256) == [256] * 15 + pow2_chunks(255)
    assert len(capped_chunks(524256, 131072)) == 15
    for bad in (0, 3, 100):
        with pytest.raises(ValueError):
            capped_chunks(8, bad)


#: the recurrent smoke models, cut for the 4096-position serve: zamba2-1.2b
#: to its first shared-attention site, whisper-small to one layer each side
RECURRENT_CUTS = {"zamba2-1.2b": dict(num_layers=3), "xlstm-1.3b": {},
                  "whisper-small": dict(num_layers=1, enc_layers=1)}


@pytest.mark.parametrize("name", sorted(RECURRENT_CUTS))
def test_capped_chunks_serve_as_the_reference_at_4096(name):
    """A 4095-token prompt at max_seq 4096 through the port's engine with
    ``max_chunk`` 256 (15 x 256, then the 8 pow2 chunks of 255) against
    the reference's engine in its 12 pow2 chunks, 2 new tokens (the
    decode step at position 4095 fills the cache); whisper's frames go
    with the first chunk only. Tokens and finish reasons equal; the last
    chunk's logits (the first token's) and the decode step's within
    ``REL`` of max|logit|."""
    cut = RECURRENT_CUTS[name]
    jcfg = jconfigs.get_smoke(name).replace(dtype="float32", **cut)
    tcfg = tconfigs.get_smoke(name).replace(dtype="float32", **cut)
    jp, tp = both_trees(tcfg, 4)
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, tcfg.vocab_size, 4095).astype(np.int32)
    frames = (rng.standard_normal((tcfg.enc_seq, tcfg.d_model)).astype(
        np.float32) if serving_caps(tcfg).needs_frames else None)
    jreq = JRequest(0, prompt.copy(), max_new_tokens=2, frames=frames)
    treq = Request(0, prompt.copy(), max_new_tokens=2, frames=frames)
    jeng = JEngine(jbuild(jcfg), jp, batch_size=1, max_seq=MAX_SEQ,
                   dev=_jdev())
    eng = ContinuousEngine(tbuild(tcfg), tp, batch_size=1, max_seq=MAX_SEQ,
                           telemetry=False, max_chunk=256)
    with_frames = []
    chunk = eng.adapter._chunk

    def spy(params, tokens, fr, offset, state):
        with_frames.append(fr is not None)
        return chunk(params, tokens, fr, offset, state)

    eng.adapter._chunk = spy
    want, got = (_capture(e.adapter, "_chunk") for e in (jeng, eng))
    jdec, tdec = (_capture(e.adapter, "_decode") for e in (jeng, eng))
    jeng.serve([jreq])
    with torch.no_grad():
        eng.serve([treq])
    assert len(want) == len(pow2_chunks(4095)) == 12
    assert len(got) == len(capped_chunks(4095, 256)) == 23
    assert with_frames == [frames is not None] + [False] * 22
    assert treq.output == jreq.output and len(treq.output) == 2
    assert treq.finish_reason == jreq.finish_reason == "length"
    _close(got[-1], want[-1], what="the last chunk's logits")
    assert len(tdec) == len(jdec) == 1
    for i, (g, w) in enumerate(zip(tdec, jdec)):
        _close(g, w, what=f"decode step {i} logits")


def test_long_500k_serve_needs_a_chunk_cap():
    """The dry-run's count of zamba2-1.2b's long_500k serve (one 524256-
    token prompt at batch 1 x 524288, bf16 weights, the adapter's row and
    working tree live; the meta device): uncapped its 262144-token chunk
    does not fit the 76 GB (95 % of 80) the card's serve allows, and the
    cap the count takes, 131072, does; the state is a row and the
    working tree, 2 x 25.8 GB."""
    from repro_torch.launch.dryrun import recurrent_serve_count
    limit = 0.95 * H100_SXM.mem_gb * 1e9
    n = recurrent_serve_count(tconfigs.get("zamba2-1.2b"), batch=1,
                              max_seq=524288, prompt=524256, limit=limit)
    assert n["serve"][None] > limit
    assert n["cap"] == 131072 and n["serve"][131072] <= limit
    assert list(n["serve"]) == [None, 131072]
    assert 51e9 < n["state"] < 52e9
    assert n["decode"] < n["serve"][131072]


#: the batch the card's 32k serve takes by the dry-run's count
#: (``long_serve_count``; None: it does not serve)
LONG_BATCH = {"deepseek-moe-16b": 4, "moonshot-v1-16b-a3b": 1,
              "qwen3-32b": None}


@functools.lru_cache(maxsize=None)
def _long_count(name):
    from repro_torch.launch.dryrun import long_serve_count
    return long_serve_count(tconfigs.get(name), max_seq=32768,
                            limit=0.95 * H100_SXM.mem_gb * 1e9)


def _bf16_bytes(cfg):
    """The bf16 weights and a row of bf16 cache at 32768 positions (layers
    x k, v x kvh x dh x 32768 x 2 B), from the config's widths."""
    from repro_torch.perf import roofline
    from repro_torch.models.registry import abstract_params
    shapes, _ = abstract_params(tbuild(cfg))
    row = cfg.num_layers * 2 * cfg.num_kv_heads * cfg.head_dim * 32768 * 2
    return 2 * int(roofline.count_params(shapes)), row


@pytest.mark.parametrize("name", sorted(LONG_BATCH))
def test_moe_32k_serves_batch_by_the_count(name):
    """The dry-run's count of a flat family's serve at 32768 positions
    (bf16 weights, the meta device): the decode step at batch b and a
    one-row 32768-token prefill with b - 1 more rows beside it, against
    the 76 GB (95 % of 80) the card's serve allows. deepseek-moe-16b
    serves at batch 4, moonshot-v1-16b-a3b at one row but not at two;
    qwen3-32b does not fit at one row. A row of cache is the config's
    widths at 32768 positions, and each peak holds at least the weights
    and the rows it counts."""
    limit = 0.95 * H100_SXM.mem_gb * 1e9
    n = _long_count(name)
    weights, row = _bf16_bytes(tconfigs.get(name))
    batch = LONG_BATCH[name]
    assert n["batch"] == batch and n["row"] == row
    assert n["prefill"] > weights + row
    for b, decode in n["decode"].items():
        assert decode > weights + b * row
        assert (n["serve"][b] <= limit) == (b == batch)
    # every batch above the one taken was counted and does not fit
    assert list(n["serve"]) == [b for b in (4, 2, 1) if b >= (batch or 1)]


@pytest.mark.parametrize("name,batch", [("deepseek-moe-16b", 4),
                                        ("moonshot-v1-16b-a3b", 1)])
def test_paged_steps_hold_one_layer_of_views(name, batch):
    """The paged adapter's own steps, counted on the meta device with the
    pool live (``paged_serve_count``), at the batch the count takes for
    the 32k serve: a decode step holds one layer's views of the batch's
    rows beside the pool, and a cold 32768-token prefill one layer's view
    of its row, so each stays within 5 % of one layer's views of the
    model's own count. Gathering the whole stack's views at once
    (ROADMAP Queue 3) held 30.07 GB more at deepseek-moe-16b's decode step
    at batch 4 (93.44 GB) and 12.89 GB more at moonshot-v1-16b-a3b's
    prefill (88.02 GB), past the card."""
    from repro_torch.launch.dryrun import paged_serve_count
    cfg = tconfigs.get(name)
    count = _long_count(name)
    row, decode, serve = count["row"], count["decode"], count["serve"]
    n = paged_serve_count(cfg, batch=batch, max_seq=32768, prompt=32736)
    # the batch's rows and the null block (one of a row's 1024 blocks of 32)
    assert n["pool"] == batch * row + row // 1024
    layer = row // cfg.num_layers                    # one row, one layer
    assert 0 < n["decode"] - decode[batch] < 1.05 * batch * layer
    assert 0 < n["prefill"] - serve[batch] < 1.05 * layer
    assert n["serve"] <= 0.95 * H100_SXM.mem_gb * 1e9


def _trie_prompts(depth, branches, bs, seed=3):
    """``_trie``'s prompts: ``branches`` of ``depth`` blocks, each past the
    first sharing the first one's first half."""
    rng = np.random.default_rng(seed)
    n = depth * bs
    base = rng.integers(0, 512, n).astype(np.int32)
    out = []
    for _ in range(branches):
        prompt = base.copy()
        prompt[n // 2:] = rng.integers(0, 512, n - n // 2)
        out.append(prompt)
    return out


def _trie(mod, depth, branches, bs, seed=3):
    """A pool and radix prefix cache of ``mod`` (either package's
    ``serve.paging``) holding ``branches`` prompts of ``depth`` blocks,
    each past the first sharing the first one's first half: each matched,
    backed, inserted from slot 0 and released, as the paged adapter does,
    so the trie holds the only reference to every block."""
    pool = mod.PagePool(1, depth, branches * depth + 1, bs)
    cache = mod.RadixPrefixCache(bs, pool)
    for prompt in _trie_prompts(depth, branches, bs, seed):
        matched = cache.match(prompt)
        if matched:
            pool.map_shared(0, matched)
        assert pool.ensure_capacity(0, len(prompt))
        cache.insert(prompt, pool.table_row(0))
        pool.release_slot(0)
    return pool, cache


def test_prefix_trie_eviction_as_the_reference():
    """A branching trie below the recursion limit (3 prompts of 64 blocks):
    the evictable count, each round of LRU evictions (the pool's free list
    and scrub queue after it) and ``clear`` as the reference's."""
    (tp, tc), (jp, jc) = (_trie(m, 64, 3, 4) for m in (tpaging, jpaging))
    assert tc.evictable_blocks() == jc.evictable_blocks() == 64 + 2 * 32
    for n in (1, 5, 40):
        assert tc.evict(n) == jc.evict(n) == n
        assert tp._free == jp._free
        assert tp.drain_pending_zero() == jp.drain_pending_zero()
        assert tc.evictable_blocks() == jc.evictable_blocks()
    tc.clear()
    jc.clear()
    assert tp._free == jp._free and len(tc) == len(jc) == 0


def test_prefix_trie_eviction_around_a_live_slot():
    """The trie of ``test_prefix_trie_eviction_as_the_reference`` with a
    fourth prompt matched and still mapped by a live slot, and the first
    prompt matched again (its stamps refreshed): the live chain's blocks
    and their ancestors are pinned, and each round of evictions frees the
    reference's blocks in the reference's order, up to the last
    evictable one."""
    prompts = _trie_prompts(64, 3, 4)
    # the second prompt's first 50 blocks, then tokens of its own
    live = np.concatenate([prompts[1][:200], np.random.default_rng(
        11).integers(0, 512, 64).astype(np.int32)])
    out = []
    for mod in (tpaging, jpaging):
        pool, cache = _trie(mod, 64, 3, 4)
        pool.map_shared(0, cache.match(live))
        cache.match(prompts[0])
        rounds = []
        for n in (3, 17, 200):
            rounds.append((cache.evict(n), list(pool._free),
                           pool.drain_pending_zero(),
                           cache.evictable_blocks()))
        out.append(rounds)
    assert out[0] == out[1]
    # 78 evictable: each other prompt's 32 blocks of its own, and the
    # second prompt's 14 past the live slot's 50
    assert [r[0] for r in out[0]] == [3, 17, 58] and out[0][-1][3] == 0


def test_prefix_trie_of_a_32k_prompt():
    """Two 32768-token prompts at block 16 (a chain of 2048 blocks, the
    second sharing the first 1024): the trie is walked with a stack, not
    by recursion, so admission (``evictable_blocks``), eviction and
    ``clear`` run at that depth; the reference's recursive walk passes
    Python's recursion limit at ~1000 blocks (ROADMAP Queue 3)."""
    pool, cache = _trie(tpaging, 2048, 2, 16)
    assert len(cache) == cache.evictable_blocks() == 2048 + 1024
    assert cache.probe(np.zeros(16, np.int32)) == 0
    free = pool.free_blocks()
    assert cache.evict(3) == 3 and pool.free_blocks() == free + 3
    cache.clear()
    assert len(cache) == 0 and pool.free_blocks() == pool.n_blocks - 1
