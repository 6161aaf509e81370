"""gemma3's local:global window rings in the port against the reference, on
the gemma3-27b smoke config (6 layers, every 3rd global, window 32) in f32
with bridged weights: forward logits, one-slot prefill (exact and
bucketed) into a ring cache, decode at per-row positions that cross the
window, and the continuous engine on the window-ring adapter.

Every comparison holds fp32 numerics to atol 1e-4 (rtol 1e-4), as the
dense model's parity tests do; token streams are greedy.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import hw as jhw
from repro.models import build_model as jbuild
from repro.serve.engine import ContinuousEngine as JEngine
from repro.serve.queue import Request as JRequest
from repro.serve.step import make_decode_step as jmake_decode_step
from repro.serve.step import make_slot_prefill as jmake_slot_prefill
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_numpy
from repro_torch.core.hw import H100_SXM
from repro_torch.models import build_model as tbuild
from repro_torch.models import common as tc
from repro_torch.models.transformer import layer_flags, param_shapes
from repro_torch.serve.engine import ContinuousEngine, Request, ServeEngine
from repro_torch.serve.step import (make_decode_step, make_slot_prefill,
                                    pad_to_bucket, prefill_buckets)

TOL = dict(rtol=1e-4, atol=1e-4)
MAX_SEQ = 64


def _numpy_weights(spec, rng):
    """N(0, 1/fan_in) weights of a (shape, fan_in) spec tree from a numpy
    generator (zeros for fan_in None, ones for ``"ones"``): the same draw
    on every process, where the reference's ``init`` folds ``hash(name)``
    into each key and so draws other weights under each hash seed."""
    if isinstance(spec, dict):
        return {k: _numpy_weights(v, rng) for k, v in spec.items()}
    shape, fan_in = spec
    if fan_in is None:
        return np.zeros(shape, np.float32)
    if fan_in == "ones":
        return np.ones(shape, np.float32)
    return (rng.standard_normal(shape) / np.sqrt(max(fan_in, 1))).astype(
        np.float32)


@pytest.fixture(scope="module")
def models():
    jcfg = jconfigs.get_smoke("gemma3-27b").replace(dtype="float32")
    tcfg = tconfigs.get_smoke("gemma3-27b").replace(dtype="float32")
    jm = jbuild(jcfg, q_block=8)
    p = _numpy_weights(param_shapes(tcfg), np.random.default_rng(1))
    jp = jax.tree.map(jnp.asarray, p)
    tp = params_from_numpy(p, "cpu")
    return jcfg, jm, jp, tcfg, tbuild(tcfg), tp


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _assert_caches_close(tcache, jcache):
    jl = jax.tree.leaves(jcache)
    tl = tc.cache_leaves(tcache)
    assert len(tl) == len(jl) == 4
    for a, b in zip(tl, jl):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(_np(a), _np(b), **TOL)


def test_config_and_cache_layout(models):
    jcfg, jm, jp, tcfg, tm, tp = models
    assert tconfigs.get("gemma3-27b") == tconfigs.base.ModelConfig(
        **dataclasses.asdict(jconfigs.get("gemma3-27b")))
    np.testing.assert_array_equal(layer_flags(tcfg),
                                  np.asarray([False, False, True] * 2))
    # the tree carries the qk_norm leaves, name for name
    jshapes = jax.tree.map(lambda a: a.shape, jax.tree.map(np.asarray, jp))
    own = tm.init(torch.Generator().manual_seed(0), "cpu")
    assert jshapes == jax.tree.map(
        lambda t: tuple(t.shape), own,
        is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert "q_norm" in own["layers"]["attn"]
    # 2 global stacks of max_seq, 4 local rings of min(window, max_seq)
    for max_seq in (16, MAX_SEQ):
        jc = jm.init_cache(2, max_seq, jnp.float32)
        tcache = tm.init_cache(2, max_seq, torch.float32, device="cpu")
        assert [tuple(c.shape) for c in tc.cache_leaves(tcache)] == \
            [c.shape for c in jax.tree.leaves(jc)]


def test_forward_logits(models):
    _, jm, jp, _, tm, tp = models
    toks = np.random.default_rng(5).integers(0, 512, (2, 45)).astype(np.int32)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got, _ = tm.forward(tp, {"tokens": _t(toks).long()})
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.fixture(scope="module")
def slot_steps(models):
    _, jm, _, _, tm, _ = models
    return ((jax.jit(jmake_slot_prefill(jm)),
             jax.jit(jmake_slot_prefill(jm, bucketed=True))),
            (make_slot_prefill(tm), make_slot_prefill(tm, bucketed=True)))


@pytest.mark.parametrize("n", [7, 31, 33, 45])
def test_slot_prefill_into_a_ring(models, slot_steps, n):
    """A prompt into slot 1 of a batch-2 cache whose slot 0 holds another
    request, exact and bucketed: logits, next token and every cache leaf
    against the reference; and the port's bucketed prefill equals its
    exact one (the ring built from the true last token, not the pad
    tail). Prompts below, at and past the 32-slot ring."""
    _, jm, jp, _, tm, tp = models
    (jexact, jbucketed), (exact, bucketed) = slot_steps
    rng = np.random.default_rng(n)
    prompt = rng.integers(0, 512, n).astype(np.int32)
    other = rng.integers(0, 512, 20).astype(np.int32)
    padded, true_len = pad_to_bucket(prompt, prefill_buckets(MAX_SEQ))
    assert len(padded) > n or n == MAX_SEQ
    results = {}
    for mode in ("exact", "bucketed"):
        jcache = jm.init_cache(2, MAX_SEQ, jnp.float32)
        tcache = tm.init_cache(2, MAX_SEQ, torch.float32, device="cpu")
        _, _, jcache = jexact(jp, jnp.asarray(other[None]), jnp.int32(0),
                              jcache)
        _, _, tcache = exact(tp, _t(other[None]).long(), 0, tcache)
        if mode == "exact":
            jt, jl, jcache = jexact(jp, jnp.asarray(prompt[None]),
                                    jnp.int32(1), jcache)
            tt, tl, tcache = exact(tp, _t(prompt[None]).long(), 1, tcache)
        else:
            jt, jl, jcache = jbucketed(jp, jnp.asarray(padded[None]),
                                       jnp.int32(true_len), jnp.int32(1),
                                       jcache)
            tt, tl, tcache = bucketed(tp, _t(padded[None]).long(), true_len,
                                      1, tcache)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        assert int(tt[0, 0]) == int(np.asarray(jt)[0, 0])
        _assert_caches_close(tcache, jcache)
        results[mode] = (tl, tt, tcache)
    (la, ta, ca), (lb, tb, cb) = results["exact"], results["bucketed"]
    assert torch.equal(ta, tb)
    # eager f32 matmuls at another length may sum in another order, so the
    # port's bucketed == exact holds to 1e-5 where the reference's jitted
    # steps are bitwise
    np.testing.assert_allclose(_np(la), _np(lb), rtol=0, atol=1e-5)
    for xa, xb in zip(tc.cache_leaves(ca), tc.cache_leaves(cb)):
        np.testing.assert_allclose(_np(xa), _np(xb), rtol=0, atol=1e-5)


def test_teacher_forced_decode_crosses_the_window(models):
    """Rows at their own positions (one below the 32-slot ring, one
    crossing it, one past it) decode 6 steps over random ring and global
    caches: logits and caches against the reference at every step; a
    scalar position too (the static engine's)."""
    _, jm, jp, _, tm, tp = models
    rng = np.random.default_rng(8)
    b = 3
    init = {k: tuple(rng.normal(size=c.shape).astype(np.float32)
                     for c in pair)
            for k, pair in jm.init_cache(b, MAX_SEQ, jnp.float32).items()}
    jcache = {k: tuple(map(jnp.asarray, v)) for k, v in init.items()}
    tcache = {k: tuple(map(_t, v)) for k, v in init.items()}
    pos = np.array([5, 29, 40], np.int32)
    toks = rng.integers(0, 512, (6, b, 1)).astype(np.int32)
    jstep = jax.jit(jmake_decode_step(jm))
    tstep = make_decode_step(tm)
    for step in range(6):
        p = pos + step
        jt, jl, jcache = jstep(jp, jnp.asarray(toks[step]), jnp.asarray(p),
                               jcache)
        tt, tl, tcache = tstep(tp, _t(toks[step]).long(), _t(p), tcache)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    _assert_caches_close(tcache, jcache)
    jt, jl, jcache = jstep(jp, jnp.asarray(toks[0]), jnp.int32(33), jcache)
    tt, tl, tcache = tstep(tp, _t(toks[0]).long(), 33, tcache)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    _assert_caches_close(tcache, jcache)


def _prompts(n_list, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, n).astype(np.int32) for n in n_list]


# prompt lengths below and past the 32-slot ring; 14 new tokens each, so
# rows cross position 32 while decoding
LENGTHS = [40, 12, 25, 50, 5, 30]


@pytest.fixture(scope="module")
def both_runs(models):
    _, jm, jp, _, tm, tp = models
    prompts = _prompts(LENGTHS, 3)
    jreqs = [JRequest(i, p.copy(), max_new_tokens=14)
             for i, p in enumerate(prompts)]
    treqs = [Request(i, p.copy(), max_new_tokens=14)
             for i, p in enumerate(prompts)]
    jdev = jhw.DeviceSpec(**dataclasses.asdict(H100_SXM))
    jstats = JEngine(jm, jp, batch_size=3, max_seq=MAX_SEQ,
                     dev=jdev).serve(jreqs)
    tstats = ContinuousEngine(tm, tp, batch_size=3,
                              max_seq=MAX_SEQ).serve(treqs)
    return jreqs, jstats, treqs, tstats


def test_window_engine_matches_reference(both_runs):
    jreqs, jstats, treqs, tstats = both_runs
    assert tstats["adapter"] == "window-ring" and tstats["kv_block_size"] \
        is None
    for key in ("completed", "shed", "tokens_decoded", "prefills",
                "prompt_tokens", "prefill_tokens_computed", "decode_steps",
                "slots_recycled", "peak_active", "prefill_compiles",
                "decode_compiles", "prefill_buckets", "kv_block_size",
                "adapter", "family"):
        assert tstats[key] == jstats[key], key
    assert tstats["decode_compiles"] == 1
    assert tstats["compiles"]["reset_slot"] == 1
    for a, b in zip(treqs, jreqs):
        assert a.finish_reason == b.finish_reason == "length"
        assert a.output == b.output, f"req {a.req_id}"


def test_window_engine_joules_partition(models):
    """Per-request joules partition the slot tags' energy to 1e-6 J on the
    window-ring engine."""
    _, _, _, _, tm, tp = models
    treqs = [Request(i, p, max_new_tokens=8)
             for i, p in enumerate(_prompts([40, 12, 25, 50], 4))]
    eng = ContinuousEngine(tm, tp, batch_size=3, max_seq=MAX_SEQ)
    eng.serve(treqs)
    slot_tags = {eng.tel.slot_tag(i) for i in range(eng.batch_size)}
    slot_j = 0.0
    for blk in eng.tel.session.blocks():
        any_slot = np.zeros(blk.n, bool)
        for tag in slot_tags:
            any_slot |= blk.tag_mask(tag)
        slot_j += float((blk.watts * blk.dt)[any_slot].sum())
    assert all(r.energy_j > 0.0 for r in treqs)
    assert sum(r.energy_j for r in treqs) == pytest.approx(slot_j, abs=1e-6)


def test_window_engine_bucketed_matches_exact(models):
    _, _, _, _, tm, tp = models
    prompts = _prompts([5, 7, 11, 21, 37], 6)
    a = [Request(i, p.copy(), max_new_tokens=6) for i, p in enumerate(prompts)]
    b = [Request(i, p.copy(), max_new_tokens=6) for i, p in enumerate(prompts)]
    sa = ContinuousEngine(tm, tp, batch_size=2, max_seq=MAX_SEQ,
                          telemetry=False, prefill_buckets="off").serve(a)
    sb = ContinuousEngine(tm, tp, batch_size=2, max_seq=MAX_SEQ,
                          telemetry=False, prefill_buckets="auto").serve(b)
    assert sa["prefill_compiles"] == 5 and sb["prefill_compiles"] == 4
    for ra, rb in zip(a, b):
        assert ra.output == rb.output


def test_static_engine_matches_continuous(models):
    """The static batch (left-padded to one length, lock-step decode at a
    scalar position) and the continuous engine (per-row positions) emit
    the same tokens for equal-length prompts, one past the ring."""
    _, _, _, _, tm, tp = models
    prompts = _prompts([36, 36], 12)
    a = [Request(i, p.copy(), max_new_tokens=8) for i, p in enumerate(prompts)]
    b = [Request(i, p.copy(), max_new_tokens=8) for i, p in enumerate(prompts)]
    st = ServeEngine(tm, tp, batch_size=2, max_seq=MAX_SEQ,
                     telemetry=False).serve(a)
    ContinuousEngine(tm, tp, batch_size=2, max_seq=MAX_SEQ,
                     telemetry=False).serve(b)
    assert st["decode_compiles"] == 1 and st["prefill_compiles"] == 1
    for ra, rb in zip(a, b):
        assert ra.finish_reason == rb.finish_reason == "length"
        assert ra.output == rb.output


def test_chunked_prefill_on_a_ring_raises(models):
    _, _, _, _, tm, tp = models
    cache = tm.init_cache(1, MAX_SEQ, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="window ring"):
        tm.prefill(tp, {"tokens": torch.zeros((1, 4), dtype=torch.long)},
                   cache, start_pos=8)
