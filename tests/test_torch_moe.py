"""The MoE and VLM families in the port against the reference:
deepseek-moe-16b, moonshot-v1-16b-a3b and internvl2-76b on their smoke
configs in f32, the same weights on both sides: N(0, 1/fan_in) in the
reference's tree from a numpy seed. (The reference's own init derives each
child builder's key from Python's string hash, ``ParamBuilder.child``,
which changes from process to process, so its weights would too, and with
them the margins at every routing and greedy decision.)

- Routing (``moe.route``, ``moe.combine``) on identical inputs against
  ``repro.models.moe._route_group``/``_combine_group``: expert ids, sort
  order, slots, source tokens and the keep mask exactly equal, with drops
  and with exact ties (lower index first); dispatch buffers equal, floats
  within 1e-6.
- ``moe.moe_apply`` against ``_moe_apply_gspmd(..., Sharder(None))`` at
  batch 1, 2, 3, 4 and 6 (1/2/1/4/2 routing groups): 1e-5.
- The reference's two MoE properties (``tests/test_properties.py``) on both
  packages.
- ``forward`` (logits and aux; internvl2 with patch embeddings), the train
  loss and its gradients with ``aux_loss_weight``, prefill (bucketed, after
  a cached prefix), decode at per-row positions, and the continuous engine
  at batch 2 and 3 (the rows compete for experts): 1e-4, tokens equal.
- Head padding (``adapt_for_mesh``): the padded model's logits equal to the
  unpadded one's and to the reference's padded model's: 1e-4.
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import configs as jconfigs
from repro.core import hw as jhw
from repro.models import build_model as jbuild
from repro.models import moe as jmoe
from repro.parallel.sharding import Sharder
from repro.serve.engine import ContinuousEngine as JEngine
from repro.serve.queue import Request as JRequest
from repro.train import step as jstep
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_numpy
from repro_torch.core.hw import H100_SXM
from repro_torch.models import build_model as tbuild
from repro_torch.models import moe as tmoe
from repro_torch.models.transformer import head_mask, param_shapes
from repro_torch.serve.engine import ContinuousEngine, Request
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep
from torch_weights import both_trees, numpy_tree

TOL = dict(rtol=1e-4, atol=1e-4)
MOE_TOL = dict(rtol=1e-5, atol=1e-5)
ROUTE_TOL = dict(rtol=1e-6, atol=1e-6)
ARCHES = ["deepseek-moe-16b", "moonshot-v1-16b-a3b", "internvl2-76b"]
SHD = Sharder(None)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _bridge(jp):
    return params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


_MODELS = {}


def _models(name):
    """(jcfg, reference model, its params, tcfg, port model, its params),
    f32, made once per process."""
    if name not in _MODELS:
        jcfg = jconfigs.get_smoke(name).replace(dtype="float32")
        tcfg = tconfigs.get_smoke(name).replace(dtype="float32")
        jp, tp = both_trees(tcfg, 2)
        _MODELS[name] = (jcfg, jbuild(jcfg, q_block=8), jp, tcfg,
                         tbuild(tcfg), tp)
    return _MODELS[name]


def _moe_layer(cfg, seed):
    """One unstacked MoE layer's params for the reference and the port."""
    tree = numpy_tree(tmoe.moe_param_shapes(cfg, 1), seed, unstack=True)
    return jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu")


# ---------------------------------------------------------------------------
# configs and parameter trees


@pytest.mark.parametrize("name", ARCHES)
def test_config_and_param_tree(name):
    """The configs equal the reference's, and the port's init (and
    ``param_shapes``) give the reference init's tree, leaf for leaf."""
    jcfg, jm, _, tcfg, tm, _ = _models(name)
    assert tconfigs.get(name) == tconfigs.base.ModelConfig(
        **dataclasses.asdict(jconfigs.get(name)))
    assert tcfg == tconfigs.base.ModelConfig(**dataclasses.asdict(jcfg))
    jp, _ = jm.init(jax.random.key(2))
    jshapes = jax.tree.map(lambda a: a.shape, jax.tree.map(np.asarray, jp))
    assert jshapes == jax.tree.map(lambda leaf: leaf[0], param_shapes(tcfg),
                                   is_leaf=lambda x: isinstance(x, tuple))
    own = tm.init(torch.Generator().manual_seed(0), "cpu")
    assert jshapes == jax.tree.map(
        lambda t: tuple(t.shape), own,
        is_leaf=lambda x: isinstance(x, torch.Tensor))


# ---------------------------------------------------------------------------
# routing and combine on identical inputs

# (tokens, capacity, seed, tied logits); 32768 tokens: serve_long's cold
# prefill group, at the smoke config's capacity (``capacity_for``: 10240)
# and at 4096, where choices drop
ROUTE_CASES = [(16, 4, 0, False), (16, 2, 1, False), (5, 1, 2, False),
               (24, 9, 3, False), (16, 3, 4, True), (7, 1, 5, True),
               (32768, 10240, 6, False), (32768, 4096, 7, False)]


@pytest.mark.parametrize("case", ROUTE_CASES,
                         ids=lambda c: f"t{c[0]}-c{c[1]}-s{c[2]}"
                                       + ("-ties" if c[3] else ""))
def test_route_and_combine_match_reference(case):
    t, capacity, seed, ties = case
    if t == 32768 and capacity != 4096:
        assert tmoe.capacity_for(tconfigs.get_smoke("deepseek-moe-16b"),
                                 t) == capacity
    _route_and_combine(tconfigs.get_smoke("deepseek-moe-16b"),
                       jconfigs.get_smoke("deepseek-moe-16b"), t, capacity,
                       seed, ties)


@pytest.mark.parametrize("t,capacity", [(32768, 3840), (16384, 1920)])
def test_route_and_combine_at_deepseek_routing_shape(t, capacity):
    """deepseek-moe-16b's routing shape on serve_long's groups: 64 experts,
    top-6, a cold 32768-token bucket (capacity 3840) and a prefix hit's
    16384-token tail (1920), the smoke config widened to that routing
    (d 6): as the reference's, exactly."""
    full = tconfigs.get("deepseek-moe-16b")
    moe_keys = dict(num_experts=full.num_experts,
                    experts_per_token=full.experts_per_token)
    cfg = tconfigs.get_smoke("deepseek-moe-16b").replace(**moe_keys)
    assert tmoe.capacity_for(full, t) == tmoe.capacity_for(cfg, t) == capacity
    _route_and_combine(cfg, jconfigs.get_smoke("deepseek-moe-16b").replace(
        **moe_keys), t, capacity, 8, False)


def _route_and_combine(cfg, jcfg, t, capacity, seed, ties):
    """``route`` and ``combine`` on ``t`` tokens of width 6 at ``capacity``
    against the reference's ``_route_group`` and ``_combine_group``:
    slots, source tokens, order, keep and the dispatch buffer equal, the
    weights, aux and combine within ``ROUTE_TOL``; choices drop wherever
    the capacity is short of ``t * k``."""
    e, k, d = cfg.num_experts, cfg.experts_per_token, 6
    rng = np.random.default_rng(seed)
    xg = rng.normal(size=(t, d)).astype(np.float32)
    if ties:       # three logit levels: equal probabilities everywhere
        logits = rng.integers(0, 3, (t, e)).astype(np.float32)
    else:
        logits = rng.normal(size=(t, e)).astype(np.float32)
    want = jmoe._route_group(jnp.asarray(xg), jnp.asarray(logits), jcfg,
                             capacity)
    got = tmoe.route(_t(xg)[None], _t(logits)[None], cfg, capacity)
    (wd, (wslot, wtok, worder), ww, wkeep, waux) = want
    (gd, (gslot, gtok, gorder), gw, gkeep, gaux) = got
    for g, w in ((gslot, wslot), (gtok, wtok), (gorder, worder),
                 (gkeep, wkeep)):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))
    np.testing.assert_array_equal(gd[0].numpy(), np.asarray(wd))
    np.testing.assert_allclose(gw[0].numpy(), np.asarray(ww), **ROUTE_TOL)
    np.testing.assert_allclose(float(gaux[0]), float(waux), **ROUTE_TOL)
    probs = torch.softmax(_t(logits), -1)
    _, ids = tmoe.top_k(probs, k)
    _, wids = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), -1), k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(wids))
    if capacity * e < t * k:
        assert not bool(gkeep.all())                 # some tokens dropped
    out = rng.normal(size=(e, capacity, d)).astype(np.float32)
    ywant = jmoe._combine_group(jnp.asarray(out), (wslot, wtok, worder), ww,
                                wkeep, t, k)
    ygot = tmoe.combine(_t(out)[None], (gslot, gtok, gorder), gw, gkeep, t, k)
    np.testing.assert_allclose(ygot[0].numpy(), np.asarray(ywant),
                               **ROUTE_TOL)


@pytest.mark.parametrize("groups,t", [(1, 12), (3, 5)])
def test_dispatch_gathers_each_copy_once(groups, t):
    """``route``'s dispatch buffer equals a gather of each token's row by
    its token index (``order // k``), bit for bit, and gives the same
    input gradient; its backward writes the gradient rows by ``order``, a
    permutation, and runs no scatter-add (atomics on the card: a
    different sum each run), as that gather's backward does."""
    cfg = tconfigs.get_smoke("deepseek-moe-16b").replace(dtype="float32")
    e, k, d = cfg.num_experts, cfg.experts_per_token, cfg.d_model
    rng = np.random.default_rng(t)
    xg = _t(rng.standard_normal((groups, t, d)).astype(np.float32))
    xg.requires_grad_()
    logits = _t(rng.standard_normal((groups, t, e)).astype(np.float32))
    cap = tmoe.capacity_for(cfg, t)
    dispatch, (slot, tok, order), *_ = tmoe.route(xg, logits, cfg, cap)
    assert torch.equal(order.sort(dim=-1).values,
                       torch.arange(t * k).expand(groups, t * k))
    src = xg.gather(1, tok[..., None].expand(groups, t * k, d))
    buf = torch.zeros((groups, e * cap + 1, d)).scatter(
        1, slot[..., None].expand(groups, t * k, d), src)
    want = buf[:, :-1].reshape(groups, e, cap, d)
    assert torch.equal(dispatch, want)
    w = _t(rng.standard_normal(tuple(want.shape)).astype(np.float32))

    def backward_ops(y):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            (g,) = torch.autograd.grad((y * w).sum(), xg)
        return g, {e.key for e in prof.key_averages()}

    got_g, got_ops = backward_ops(dispatch)
    want_g, want_ops = backward_ops(want)
    torch.testing.assert_close(got_g, want_g, rtol=1e-6, atol=1e-6)
    assert float(got_g.abs().max()) > 0
    adds = {"aten::scatter_add", "aten::scatter_add_", "aten::index_add",
            "aten::index_add_", "aten::index_put_"}
    assert want_ops & adds, sorted(want_ops)
    assert not got_ops & adds, sorted(got_ops & adds)


def test_top_k_breaks_ties_toward_the_lower_index():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25],
                          [0.1, 0.3, 0.3, 0.3],
                          [0.4, 0.1, 0.4, 0.1]])
    vals, idx = tmoe.top_k(probs, 2)
    assert idx.tolist() == [[0, 1], [1, 2], [0, 2]]
    _, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert np.asarray(jidx).tolist() == idx.tolist()


@pytest.mark.parametrize("b,groups", [(1, 1), (2, 2), (3, 1), (4, 4),
                                      (6, 2)])
def test_moe_apply_matches_reference(b, groups):
    jcfg = jconfigs.get_smoke("deepseek-moe-16b").replace(dtype="float32")
    tcfg = tconfigs.get_smoke("deepseek-moe-16b").replace(dtype="float32")
    assert tmoe.n_groups(b) == groups
    jp, tp = _moe_layer(tcfg, b)
    x = np.random.default_rng(b).normal(size=(b, 5, jcfg.d_model)).astype(
        np.float32)
    want, waux = jmoe._moe_apply_gspmd(jnp.asarray(x), jp, jcfg, SHD)
    got, gaux = tmoe.moe_apply(_t(x), tp, tcfg)
    np.testing.assert_allclose(_np(got), _np(want), **MOE_TOL)
    np.testing.assert_allclose(float(gaux), float(waux), **MOE_TOL)


# ---------------------------------------------------------------------------
# the reference's MoE properties, on both packages


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2**16))
def test_moe_router_weights_normalized_and_conserved_both(seed):
    jcfg = jconfigs.get_smoke("deepseek-moe-16b")
    tcfg = tconfigs.get_smoke("deepseek-moe-16b")
    jp, tp = _moe_layer(tcfg, seed % 100)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 8, jcfg.d_model)) * 0.1
    jy, jaux = jmoe.moe_apply(jnp.asarray(x, jnp.bfloat16), jp, jcfg, SHD)
    ty, taux = tmoe.moe_apply(_t(x).to(torch.bfloat16), tp, tcfg)
    for y, aux in ((_np(jy), float(jaux)), (_np(ty), float(taux))):
        assert y.shape == x.shape
        assert np.isfinite(y).all()
        assert aux >= 0.99       # load-balance loss >= 1 at the optimum


def test_moe_capacity_drops_tokens_but_stays_finite_both():
    jcfg = jconfigs.get_smoke("deepseek-moe-16b").replace(capacity_factor=0.1)
    tcfg = tconfigs.get_smoke("deepseek-moe-16b").replace(capacity_factor=0.1)
    jp, tp = _moe_layer(tcfg, 0)
    x = np.random.default_rng(0).normal(size=(2, 32, jcfg.d_model))
    jy, _ = jmoe.moe_apply(jnp.asarray(x, jnp.bfloat16), jp, jcfg, SHD)
    ty, _ = tmoe.moe_apply(_t(x).to(torch.bfloat16), tp, tcfg)
    assert np.isfinite(_np(jy)).all() and np.isfinite(_np(ty)).all()
    # 2 groups of 32 tokens: ceil(0.1 * 32 * 2 / 8) = 1 slot an expert
    assert tmoe.n_groups(2) == 2 and tmoe.capacity_for(tcfg, 32) == 1


# ---------------------------------------------------------------------------
# the model


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    batch = {"tokens": toks}
    if cfg.family == "vlm":
        batch["patch_embeddings"] = rng.normal(
            size=(b, cfg.stub_prefix_len, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("name", ARCHES)
def test_forward_logits_and_aux(name):
    jcfg, jm, jp, _, tm, tp = _models(name)
    batch = _batch(jcfg, 2, 13, 5)
    want, waux = jm.forward(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    got, gaux = tm.forward(tp, {k: _t(v) for k, v in batch.items()})
    assert got.shape == (2, 13 + (jcfg.stub_prefix_len
                                  if jcfg.family == "vlm" else 0),
                         jcfg.vocab_size)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(float(gaux), float(waux), **TOL)
    if jcfg.is_moe:
        assert float(gaux) > 0


# (arch, rows, seq): both at 2 x 12, and deepseek-moe-16b at train_4k's
# sequence, one row of 4096 tokens: one routing group (``n_groups(1)``)
# with ``capacity_for(cfg, 4096)`` slots an expert
TRAIN_GRAD_CASES = [pytest.param(n, 2, 12, id=n) for n in (
    "deepseek-moe-16b", "internvl2-76b")] + [
    pytest.param("deepseek-moe-16b", 1, 4096, id="deepseek-moe-16b-seq4096")]


@pytest.mark.parametrize("name,rows,seq", TRAIN_GRAD_CASES)
def test_train_loss_and_gradients_match_reference(name, rows, seq):
    """The train step's loss (cross-entropy plus ``aux_loss_weight`` times
    the aux) and every parameter's gradient against ``jax.grad`` of the
    reference's loss, remat on. At 4096 tokens the reference attends in
    its default 512-row query blocks, and each MoE layer's routing is
    watched: one group of the row's tokens with the capacity
    ``capacity_for`` gives."""
    jcfg, jm, jp, tcfg, tm, _ = _models(name)
    if seq > 512:
        jm = jbuild(jcfg)
    batch = _batch(jcfg, rows, seq, 7)
    labels = np.roll(batch["tokens"], -1, axis=1)
    labels[:, -1] = -1
    batch["labels"] = labels
    scfg = dict(aux_loss_weight=0.5)
    jloss = jstep.make_loss_fn(jm, jstep.StepConfig(**scfg))
    want, wg = jax.value_and_grad(jloss)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    _, tp = both_trees(tcfg, 2)
    for x in topt.tree_leaves(tp):
        x.requires_grad_()
    route, groups = tmoe.route, []

    def watch(xg, logits, cfg, capacity):
        groups.append((xg.shape[0], xg.shape[1], capacity))
        return route(xg, logits, cfg, capacity)

    with mock.patch.object(tmoe, "route", watch):
        loss = tstep.make_loss_fn(tm, tstep.StepConfig(**scfg))(
            tp, {k: _t(v) for k, v in batch.items()})
        loss.backward()
    if jcfg.is_moe:
        # each MoE layer routes in the forward and in its remat recompute
        tokens = seq * rows // tmoe.n_groups(rows)
        assert groups == [(tmoe.n_groups(rows), tokens,
                           tmoe.capacity_for(tcfg, tokens))] * (
            2 * (tcfg.num_layers - tcfg.first_k_dense))
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-4)
    jax.tree.map(lambda w, g: np.testing.assert_allclose(
        _np(g.grad), np.asarray(w), rtol=1e-4,
        atol=1e-4 * max(float(np.abs(w).max()), 1e-30)), wg, tp,
        is_leaf=lambda x: isinstance(x, torch.Tensor))
    if jcfg.is_moe:
        assert float(tp["layers"]["moe"]["router"].grad.abs().max()) > 0


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "internvl2-76b"])
@pytest.mark.parametrize("true_len,start_pos", [(None, None), (9, None),
                                                (5, 16)])
def test_prefill_matches(name, true_len, start_pos):
    jcfg, jm, jp, _, tm, tp = _models(name)
    rng = np.random.default_rng(6)
    jcache = jm.init_cache(1, 48, jnp.float32)
    tcache = tm.init_cache(1, 48, torch.float32, device="cpu")
    if start_pos is not None:
        shape = (jcfg.num_layers, 1, start_pos, jcfg.num_kv_heads,
                 jcfg.head_dim)
        prefix = rng.normal(size=shape).astype(np.float32)
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
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    for a, b in zip(gcache, wcache):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "internvl2-76b"])
def test_teacher_forced_decode_per_row_positions(name):
    """Batch 3: one routing group of 3 tokens with capacity 1, so the rows
    compete for experts and some are dropped."""
    jcfg, jm, jp, tcfg, tm, tp = _models(name)
    rng = np.random.default_rng(8)
    b, t = 3, 32
    shape = (jcfg.num_layers, b, t, jcfg.num_kv_heads, jcfg.head_dim)
    init = tuple(rng.normal(size=shape).astype(np.float32) for _ in range(2))
    jcache = tuple(map(jnp.asarray, init))
    tcache = tuple(map(_t, init))
    pos = np.array([5, 17, 0], np.int32)
    toks = rng.integers(0, 512, (4, b, 1)).astype(np.int32)
    if tcfg.is_moe:
        assert tmoe.capacity_for(tcfg, b) == 1
    for step in range(4):
        p = pos + step
        want, jcache = jm.decode_step(jp, jnp.asarray(toks[step]),
                                      jnp.asarray(p), jcache)
        got, tcache = tm.decode_step(tp, _t(toks[step]).long(), _t(p),
                                     tcache)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
    for a, b_ in zip(tcache, jcache):
        np.testing.assert_allclose(_np(a), _np(b_), **TOL)


@pytest.mark.parametrize("batch", [2, 3])
def test_paged_engine_matches_reference(batch):
    """Five requests, four sharing a 16-token prefix, deepseek-moe-16b on
    the paged pool: the port's engine against the reference's, tokens and
    stats equal. At batch 3 every decode step routes its 3 rows (free ones
    included) as one group with capacity 1."""
    _, jm, jp, _, tm, tp = _models("deepseek-moe-16b")
    rng = np.random.default_rng(9)
    shared = rng.integers(0, 512, 16).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, 512, 2 + 3 * i)
                               .astype(np.int32)]) for i in range(4)]
    prompts.append(rng.integers(0, 512, 11).astype(np.int32))
    jreqs = [JRequest(i, p.copy(), max_new_tokens=5)
             for i, p in enumerate(prompts)]
    treqs = [Request(i, p.copy(), max_new_tokens=5)
             for i, p in enumerate(prompts)]
    jdev = jhw.DeviceSpec(**dataclasses.asdict(H100_SXM))
    jstats = JEngine(jm, jp, batch_size=batch, max_seq=48,
                     dev=jdev).serve(jreqs)
    tstats = ContinuousEngine(tm, tp, batch_size=batch,
                              max_seq=48).serve(treqs)
    for key in ("completed", "tokens_decoded", "prefills",
                "prefill_tokens_computed", "decode_steps", "peak_active",
                "prefill_compiles", "decode_compiles", "kv_block_size",
                "adapter", "prefix_cache", "family"):
        assert tstats[key] == jstats[key], key
    assert tstats["decode_compiles"] == 1
    assert tstats["prefix_cache"]["hits"] > 0
    for a, b in zip(treqs, jreqs):
        assert a.finish_reason == b.finish_reason
        assert a.cached_prompt_tokens == b.cached_prompt_tokens
        assert a.output == b.output, f"req {a.req_id}"


# ---------------------------------------------------------------------------
# head padding


def test_head_padding_is_an_exact_no_op():
    """internvl2-76b smoke (8 q / 2 kv heads) padded for a model axis of 3:
    12 q heads, each kv group 4 real then 2 zeroed. The port's padded
    logits equal the reference's padded model's on the same weights, and
    the unpadded model's on the real heads' weights; the port's own init
    zeroes the pads where the reference's init does."""
    jcfg = jconfigs.get_smoke("internvl2-76b").replace(dtype="float32")
    tcfg = tconfigs.get_smoke("internvl2-76b").replace(dtype="float32")
    jpad, tpad = jcfg.adapt_for_mesh(3), tcfg.adapt_for_mesh(3)
    assert tpad.q_heads == jpad.q_heads == 12
    jm = jbuild(jpad, q_block=8)
    jp, tp = both_trees(tpad, 4)
    batch = _batch(jcfg, 2, 9, 11)
    want, _ = jm.forward(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    got, _ = tbuild(tpad).forward(tp, {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(_np(got), _np(want), **TOL)

    mask = head_mask(tpad)
    assert mask.tolist() == [True] * 4 + [False] * 2 + [True] * 4 + [False] * 2
    real = dict(tp, layers=dict(tp["layers"], attn=dict(
        tp["layers"]["attn"],
        wq=tp["layers"]["attn"]["wq"][:, :, mask],
        wo=tp["layers"]["attn"]["wo"][:, mask])))
    unpadded, _ = tbuild(tcfg).forward(real, {k: _t(v)
                                              for k, v in batch.items()})
    np.testing.assert_allclose(_np(unpadded), _np(got), **TOL)

    own = tbuild(tpad).init(torch.Generator().manual_seed(0), "cpu")
    ref_init, _ = jm.init(jax.random.key(4))
    for got in (own["layers"]["attn"], _bridge(ref_init)["layers"]["attn"]):
        assert float(got["wq"][:, :, ~mask].abs().max()) == 0
        assert float(got["wo"][:, ~mask].abs().max()) == 0
        assert float(got["wq"][:, :, mask].abs().max()) > 0
