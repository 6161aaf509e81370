"""The port's model layer against the reference, on granite-20b's smoke
config in f32 with bridged weights.

Inputs come from numpy seeds; weights are the reference's init carried
across by ``repro_torch.bridge`` (the reference seeds parameter children
with Python's per-process ``hash``, so inits are never compared). Every
comparison holds fp32 numerics to atol 1e-4 (rtol 1e-4): the two
frameworks sum matmuls in different orders, nothing more.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build_model as jbuild
from repro.models import common as jc
from repro.parallel.sharding import Sharder
from repro_torch import configs as tconfigs
from repro_torch.models import build_model as tbuild
from repro_torch.models import common as tc
from torch_weights import both_trees

TOL = dict(rtol=1e-4, atol=1e-4)
SHD = Sharder(None)


@pytest.fixture(scope="module")
def models():
    jcfg = jconfigs.get_smoke("granite-20b").replace(dtype="float32")
    tcfg = tconfigs.get_smoke("granite-20b").replace(dtype="float32")
    jm = jbuild(jcfg, q_block=8)
    jp, tp = both_trees(tcfg, 0)
    return jcfg, jm, jp, tcfg, tbuild(tcfg), tp


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _layer(p, i):
    return jax.tree.map(lambda a: a[i], p)


def _tlayer(p, i):
    return {k: _tlayer(v, i) if isinstance(v, dict) else v[i]
            for k, v in p.items()}


def test_bridge_is_name_for_name_shape_for_shape(models):
    _, _, jp, _, tm, tp = models
    jflat = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    assert len(jflat) == 12
    for path, leaf in jflat.items():
        node = tp
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    # the port's own init makes the same tree
    own = tm.init(torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.map(lambda a: a.shape, jax.tree.map(np.asarray, jp)) == \
        jax.tree.map(lambda t: tuple(t.shape), own,
                     is_leaf=lambda x: isinstance(x, torch.Tensor))


def test_rms_norm_and_rope(models):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 128)).astype(np.float32)
    scale = rng.normal(size=(128,)).astype(np.float32) * 0.1
    np.testing.assert_allclose(_np(tc.rms_norm(_t(x), _t(scale))),
                               _np(jc.rms_norm(x, scale)), **TOL)
    h = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    pos = np.arange(7) + 5
    np.testing.assert_allclose(_np(tc.rope(_t(h), _t(pos))),
                               _np(jc.rope(jnp.asarray(h), jnp.asarray(pos))),
                               **TOL)
    bpos = np.array([[3], [11]])                      # per-row decode
    hb = h[:, :1]
    np.testing.assert_allclose(
        _np(tc.rope(_t(hb), _t(bpos))),
        _np(jc.rope(jnp.asarray(hb), jnp.asarray(bpos))), **TOL)


@pytest.mark.parametrize("scores_f32", [True, False])
def test_attention_scores_gqa(scores_f32):
    rng = np.random.default_rng(1)
    q = rng.normal(size=(2, 3, 8, 16)).astype(np.float32)
    k = rng.normal(size=(2, 10, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 10, 2, 16)).astype(np.float32)
    mask = rng.random((2, 3, 10)) < 0.7
    mask[:, :, 0] = True
    want = jc.attention_scores(jnp.asarray(q), jc._repeat_kv(k, 8),
                               jc._repeat_kv(v, 8), jnp.asarray(mask),
                               scores_f32)
    got = tc.attention_scores(_t(q), _t(k), _t(v), _t(mask), scores_f32)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_array_equal(_np(tc._repeat_kv(_t(k), 8)),
                                  _np(jc._repeat_kv(k, 8)))


def test_attention_mlp_layer0(models):
    jcfg, _, jp, tcfg, _, tp = models
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 12, 128)).astype(np.float32)
    pj, pt = _layer(jp["layers"], 0), _tlayer(tp["layers"], 0)
    pos = np.arange(12)
    want, _ = jc.attention(jnp.asarray(x), pj["attn"], jcfg, SHD,
                           positions=jnp.asarray(pos), q_block=8)
    got, _ = tc.attention(_t(x), pt["attn"], tcfg, positions=_t(pos))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(tc.mlp(_t(x), pt["mlp"])),
                               _np(jc.mlp(jnp.asarray(x), pj["mlp"], SHD)),
                               **TOL)


def test_attention_with_cache_scalar_and_per_row(models):
    jcfg, _, jp, tcfg, _, tp = models
    rng = np.random.default_rng(3)
    pj, pt = _layer(jp["layers"], 1)["attn"], _tlayer(tp["layers"], 1)["attn"]
    ck = rng.normal(size=(2, 24, 1, 16)).astype(np.float32)
    cv = rng.normal(size=(2, 24, 1, 16)).astype(np.float32)
    # chunk of 6 at offset 9 (prefill after a prefix hit)
    x = rng.normal(size=(2, 6, 128)).astype(np.float32)
    pos = np.arange(6) + 9
    want, (wk, wv) = jc.attention(
        jnp.asarray(x), pj, jcfg, SHD, positions=jnp.asarray(pos),
        q_block=8, kv_cache=(jnp.asarray(ck), jnp.asarray(cv)),
        cache_pos=jnp.int32(9))
    tk, tv = _t(ck), _t(cv)
    got, _ = tc.attention(_t(x), pt, tcfg, positions=_t(pos),
                          kv_cache=(tk, tv), cache_pos=9)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(tk), _np(wk), **TOL)
    np.testing.assert_allclose(_np(tv), _np(wv), **TOL)
    # single-token decode, every row at its own position
    x1 = rng.normal(size=(2, 1, 128)).astype(np.float32)
    bpos = np.array([4, 17], np.int32)
    want, (wk, wv) = jc.attention(
        jnp.asarray(x1), pj, jcfg, SHD, positions=jnp.asarray(bpos)[:, None],
        kv_cache=(jnp.asarray(ck), jnp.asarray(cv)),
        cache_pos=jnp.asarray(bpos))
    tk, tv = _t(ck), _t(cv)
    got, _ = tc.attention(_t(x1), pt, tcfg, positions=_t(bpos)[:, None],
                          kv_cache=(tk, tv), cache_pos=_t(bpos))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(tk), _np(wk), **TOL)


def _pool(rng, n_blocks=7, blk=4):
    shape = (3, n_blocks, blk, 1, 16)
    return tuple(rng.normal(size=shape).astype(np.float32) for _ in range(2))


def test_paged_helpers_match_reference():
    rng = np.random.default_rng(4)
    pool = _pool(rng)
    tables = np.array([[3, 1, 0], [5, 6, 2]], np.int32)
    jview = jc.paged_gather(tuple(map(jnp.asarray, pool)), jnp.asarray(tables))
    tview = tc.paged_gather(tuple(map(_t, pool)), _t(tables))
    for a, b in zip(tview, jview):
        np.testing.assert_array_equal(_np(a), _np(b))
    # decode write-back: one block per row
    view = tuple(rng.normal(size=v.shape).astype(np.float32) for v in jview)
    pos = np.array([5, 9], np.int32)
    want = jc.paged_scatter_block(tuple(map(jnp.asarray, pool)),
                                  tuple(map(jnp.asarray, view)),
                                  jnp.asarray(tables), jnp.asarray(pos))
    got = tc.paged_scatter_block(tuple(map(_t, pool)), tuple(map(_t, view)),
                                 _t(tables), _t(pos))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_np(a), _np(b))
    # slot write-back through one table row (null entries collide in 0)
    row = np.array([4, 2, 0], np.int32)
    sview = tuple(rng.normal(size=(3, 1, 12, 1, 16)).astype(np.float32)
                  for _ in range(2))
    want = jc.paged_scatter_slot(tuple(map(jnp.asarray, pool)),
                                 tuple(map(jnp.asarray, sview)),
                                 jnp.asarray(row))
    got = tc.paged_scatter_slot(tuple(map(_t, pool)), tuple(map(_t, sview)),
                                _t(row))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_np(a)[:, 1:], _np(b)[:, 1:])
    # scrub, copy-on-write, tail mask
    blocks = np.array([2, 5, 0, 0], np.int32)
    for a, b in zip(tc.reset_cache_blocks(tuple(map(_t, pool)), _t(blocks)),
                    jc.reset_cache_blocks(tuple(map(jnp.asarray, pool)),
                                          jnp.asarray(blocks))):
        np.testing.assert_array_equal(_np(a), _np(b))
    for a, b in zip(tc.copy_cache_block(tuple(map(_t, pool)), 3, 6),
                    jc.copy_cache_block(tuple(map(jnp.asarray, pool)),
                                        jnp.int32(3), jnp.int32(6))):
        np.testing.assert_array_equal(_np(a), _np(b))
    for a, b in zip(tc.mask_cache_tail(tuple(map(_t, sview)), 7),
                    jc.mask_cache_tail(tuple(map(jnp.asarray, sview)), 7)):
        np.testing.assert_array_equal(_np(a), _np(b))


def test_forward_logits(models):
    _, jm, jp, _, tm, tp = models
    toks = np.random.default_rng(5).integers(0, 512, (2, 13)).astype(np.int32)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got, aux = tm.forward(tp, {"tokens": _t(toks).long()})
    assert aux == 0.0
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def _caches(jm, tm, b, t):
    jcache = jm.init_cache(b, t, jnp.float32)
    tcache = tm.init_cache(b, t, torch.float32, device="cpu")
    return jcache, tcache


@pytest.mark.parametrize("true_len,start_pos", [(None, None), (9, None),
                                                (None, 16), (5, 16)])
def test_prefill_matches(models, true_len, start_pos):
    _, jm, jp, _, tm, tp = models
    rng = np.random.default_rng(6)
    jcache, tcache = _caches(jm, tm, 1, 48)
    if start_pos is not None:
        # a cached prefix at [0, start_pos), as a prefix hit maps it
        prefix = rng.normal(size=(4, 1, start_pos, 1, 16)).astype(np.float32)
        jcache = tuple(c.at[:, :, :start_pos].set(prefix) for c in jcache)
        for c in tcache:
            c[:, :, :start_pos] = _t(prefix)
    toks = rng.integers(0, 512, (1, 16)).astype(np.int32)
    kw = {}
    if true_len is not None:
        kw["true_len"] = jnp.int32(true_len)
    if start_pos is not None:
        kw["start_pos"] = jnp.int32(start_pos)
    want, wcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jcache, **kw)
    got, gcache = tm.prefill(tp, {"tokens": _t(toks).long()}, tcache,
                             true_len=true_len, start_pos=start_pos)
    assert got.shape == (1, 1, 512)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    for a, b in zip(gcache, wcache):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)


def test_prefill_past_the_view_clamps_like_the_reference(models):
    """A bucketed tail that runs past the cache view: max_seq 40, 16 cached
    positions, a 23-token tail padded to bucket 32 -> 16 + 32 = 48 > 40.
    ``lax.dynamic_update_slice`` clamps the write start to 40 - 32 = 8, so
    the reference overwrites cached prefix positions [8, 16) with the
    chunk's first keys (a reference fault, filed in ROADMAP Queue 3). The
    port reproduces the clamp, and the two agree."""
    _, jm, jp, _, tm, tp = models
    rng = np.random.default_rng(7)
    jcache, tcache = _caches(jm, tm, 1, 40)
    prefix = rng.normal(size=(4, 1, 16, 1, 16)).astype(np.float32)
    jcache = tuple(c.at[:, :, :16].set(prefix) for c in jcache)
    for c in tcache:
        c[:, :, :16] = _t(prefix)
    toks = np.zeros((1, 32), np.int32)
    toks[0, :23] = rng.integers(0, 512, 23)
    want, wcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jcache,
                              true_len=jnp.int32(23), start_pos=jnp.int32(16))
    got, gcache = tm.prefill(tp, {"tokens": _t(toks).long()}, tcache,
                             true_len=23, start_pos=16)
    # what the reference does: the cached prefix at [8, 16) is gone
    assert not np.allclose(np.asarray(wcache[0])[:, :, 8:16], prefix[:, :, 8:])
    np.testing.assert_allclose(np.asarray(wcache[0])[:, :, :8],
                               prefix[:, :, :8])
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    for a, b in zip(gcache, wcache):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)


def test_teacher_forced_decode_per_row_positions(models):
    _, jm, jp, _, tm, tp = models
    rng = np.random.default_rng(8)
    b, t = 3, 32
    init = tuple(rng.normal(size=(4, b, t, 1, 16)).astype(np.float32)
                 for _ in range(2))
    jcache = tuple(map(jnp.asarray, init))
    tcache = tuple(map(_t, init))
    pos = np.array([5, 17, 0], np.int32)
    toks = rng.integers(0, 512, (4, b, 1)).astype(np.int32)
    for step in range(4):
        p = pos + step
        want, jcache = jm.decode_step(jp, jnp.asarray(toks[step]),
                                      jnp.asarray(p), jcache)
        got, tcache = tm.decode_step(tp, _t(toks[step]).long(), _t(p),
                                     tcache)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
    for a, b_ in zip(tcache, jcache):
        np.testing.assert_allclose(_np(a), _np(b_), **TOL)
    # scalar position: every row at one position
    want, _ = jm.decode_step(jp, jnp.asarray(toks[0]), jnp.int32(9), jcache)
    got, _ = tm.decode_step(tp, _t(toks[0]).long(), 9, tcache)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
