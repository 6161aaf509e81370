"""The recurrent families in the port against the reference: xlstm-1.3b,
zamba2-1.2b and whisper-small on their smoke configs in f32, the same
weights on both sides: N(0, 1/fan_in) in the reference's tree from a numpy
seed (the reference's own init derives each child builder's key from
Python's string hash, which changes from process to process, and with it
every greedy choice).

- The blocks on identical inputs: ``_causal_conv`` (with and without a
  carried state), ``mlstm_chunkwise`` and ``mlstm_step`` (T steps equal to
  the chunkwise form over T), ``slstm_block`` (and its gradients),
  ``ssd_chunkwise`` and
  ``ssd_step``, ``mamba_block``; whisper's ``encode``, ``cross_attention``
  and ``build_cross_cache``.
- Each model's ``forward``, ``prefill`` in chunks at ``start_pos`` (1-token
  chunks included) and ``decode_step`` at per-row positions, with every
  state leaf.
- The whole train step: the loss and every gradient against
  ``jax.value_and_grad`` of the reference's loss, and three steps of
  ``make_train_step`` against the jitted reference step; the SSD's and
  mLSTM's gradients over a long chunk, where the reference's are NaN.
- ``pow2_chunks``; a chunked prefill equal to a whole one.
- The reference's ``tests/test_recurrent_serving.py`` properties inside the
  port: batched decode equal to one request at a time, slot reuse leaking
  no state, audio refusing a request without frames; the port's
  continuous engine against the reference's (tokens, signature counts,
  joules); every arch of the port serving through its engine and CLI, and
  the CLI's refusals.

Floats agree within 1e-4 of max|reference| (``_close``); integers and
tokens exactly. The model-level tests keep every state leaf in f32, the KV
caches too (``init_cache(dtype=float32)``): under the default bf16 KV a
last-bit difference of an f32 key rounds either way, and one bf16 ulp of a
key moves the logits by more than 1e-4. The engines keep the default bf16
KV on both sides and are held by their tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import hw as jhw
from repro.data import pipeline as jpipe
from repro.models import build_model as jbuild
from repro.models import mamba2 as jmamba
from repro.models import whisper as jwhisper
from repro.models import xlstm as jxlstm
from repro.parallel.sharding import Sharder
from repro.serve.engine import ContinuousEngine as JEngine
from repro.serve.queue import Request as JRequest
from repro.serve.step import pow2_chunks as jpow2_chunks
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch import configs as tconfigs
from repro_torch.core.hw import H100_SXM
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model as tbuild
from repro_torch.models import common as tc
from repro_torch.models import mamba2 as tmamba
from repro_torch.models import whisper as twhisper
from repro_torch.models import xlstm as txlstm
from repro_torch.models.registry import serving_caps
from repro_torch.serve.engine import ContinuousEngine, Request
from repro_torch.serve.step import pow2_chunks
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep
from torch_weights import both_trees

REL = 1e-4
ARCHES = ["xlstm-1.3b", "zamba2-1.2b", "whisper-small"]
SHAPES = {"xlstm-1.3b": txlstm.param_shapes,
          "zamba2-1.2b": tmamba.param_shapes,
          "whisper-small": twhisper.param_shapes}
SHD = Sharder(None)
MAX_SEQ = 32


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Smoke-size tensors gain nothing from intra-op threads, and the
    suite runs several test processes at once: one thread each (restored
    after the test)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


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


def _close_tree(tree, jtree, what=""):
    tl, jl = jax.tree.leaves(tree), jax.tree.leaves(jtree)
    assert len(tl) == len(jl), (what, len(tl), len(jl))
    for i, (a, b) in enumerate(zip(tl, jl)):
        _close(a, b, what=f"{what} leaf {i}")


def _randn(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


_MODELS = {}


def _models(name):
    """(jcfg, reference model, its params, tcfg, port model, its params),
    f32, made once per process."""
    if name not in _MODELS:
        jcfg = jconfigs.get_smoke(name).replace(dtype="float32")
        tcfg = tconfigs.get_smoke(name).replace(dtype="float32")
        jp, tp = both_trees(tcfg, 2)
        _MODELS[name] = (jcfg, jbuild(jcfg), jp, tcfg, tbuild(tcfg), tp)
    return _MODELS[name]


def _frames(cfg, rng, b=1):
    return _randn(rng, b, cfg.enc_seq, cfg.d_model)


# ---------------------------------------------------------------------------
# configs and parameter trees


@pytest.mark.parametrize("name", ARCHES)
def test_config_and_param_tree(name):
    """The configs equal the reference's, the port's ``param_shapes`` give
    the reference init's tree leaf for leaf, and the port's init makes
    it."""
    jcfg, jm, _, tcfg, tm, _ = _models(name)
    assert tconfigs.get(name) == tconfigs.base.ModelConfig(
        **dataclasses.asdict(jconfigs.get(name)))
    assert tcfg == tconfigs.base.ModelConfig(**dataclasses.asdict(jcfg))
    assert name in tconfigs.ARCH_NAMES
    jp, _ = jm.init(jax.random.key(2))
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    spec = SHAPES[name](tcfg)
    assert jshapes == jax.tree.map(lambda leaf: leaf[0], spec,
                                   is_leaf=lambda x: isinstance(x, tuple))
    tp = tm.init(torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.map(tuple, jax.tree.map(lambda t: t.shape, tp)) == \
        jshapes
    # ones where the reference inits ones (zamba2's d_skip), zeros for norms
    if name == "zamba2-1.2b":
        assert bool((tp["mamba"]["d_skip"] == 1).all())
    assert bool((tp["final_norm"] == 0).all())


def test_build_model_and_adapter_serve_every_family():
    """No family of the port raises 'not ported' any more."""
    for name in tconfigs.ARCH_NAMES:
        cfg = tconfigs.get_smoke(name)
        model = tbuild(cfg)
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        eng = ContinuousEngine(model, params, batch_size=2, max_seq=MAX_SEQ,
                               telemetry=False)
        assert eng.adapter.kind in ("paged-kv", "window-ring", "recurrent")
        assert (eng.adapter.kind == "recurrent") == (
            cfg.family in ("ssm", "hybrid", "audio"))


# ---------------------------------------------------------------------------
# blocks on identical inputs


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(with_state):
    rng = np.random.default_rng(0)
    x, w = _randn(rng, 2, 7, 12), _randn(rng, 4, 12)
    st = _randn(rng, 2, 3, 12) if with_state else None
    jo, jst = jxlstm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                  None if st is None else jnp.asarray(st))
    to, tst = txlstm._causal_conv(_t(x), _t(w),
                                  None if st is None else _t(st))
    _close(to, jo, what="out")
    _close(tst, jst, what="state")
    assert tst.dtype == torch.float32


def _mlstm_inputs(seed, b=2, t=16, nh=4, dh=8):
    rng = np.random.default_rng(seed)
    q, k, v = (_randn(rng, b, t, nh, dh) for _ in range(3))
    g = _randn(rng, b, t, 2 * nh, scale=3.0)
    logi = np.minimum(g[..., :nh], txlstm.I_CLAMP)
    logf = -np.logaddexp(0, -g[..., nh:])
    C, n = _randn(rng, b, nh, dh, dh), _randn(rng, b, nh, dh)
    return q, k, v, logi.astype(np.float32), logf.astype(np.float32), C, n


@pytest.mark.parametrize("chunk", [4, 16])
def test_mlstm_chunkwise_matches_reference_and_steps(chunk):
    q, k, v, logi, logf, C, n = _mlstm_inputs(1)
    jh, (jC, jn) = jxlstm.mlstm_chunkwise(
        *map(jnp.asarray, (q, k, v, logi, logf)),
        (jnp.asarray(C), jnp.asarray(n)), chunk=chunk)
    th, (tC, tn) = txlstm.mlstm_chunkwise(
        *map(_t, (q, k, v, logi, logf)), (_t(C), _t(n)), chunk=chunk)
    _close(th, jh, what="h")
    _close(tC, jC, what="C")
    _close(tn, jn, what="n")
    # T single steps (in place on the state) give the chunkwise form
    sC, sn = _t(C), _t(n)
    hs = []
    for i in range(q.shape[1]):
        sl = slice(i, i + 1)
        h, _ = txlstm.mlstm_step(*(_t(a[:, sl]) for a in (q, k, v, logi,
                                                           logf)),
                                 (sC, sn))
        hs.append(h)
    _close(torch.cat(hs, 1), jh, what="steps h")
    _close(sC, jC, what="steps C")
    _close(sn, jn, what="steps n")
    # one step against the reference's step
    jh1, (jC1, _) = jxlstm.mlstm_step(
        *(jnp.asarray(a[:, :1]) for a in (q, k, v, logi, logf)),
        (jnp.asarray(C), jnp.asarray(n)))
    tC1 = _t(C)
    th1, _ = txlstm.mlstm_step(*(_t(a[:, :1]) for a in (q, k, v, logi,
                                                         logf)),
                               (tC1, _t(n)))
    _close(th1, jh1, what="step h")
    _close(tC1, jC1, what="step C")


@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_block(with_state):
    jcfg, _, jp, tcfg, _, tp = _models("xlstm-1.3b")
    rng = np.random.default_rng(3)
    x = _randn(rng, 2, 9, jcfg.d_model)
    state = None
    if with_state:
        dh = jcfg.d_model // jcfg.num_heads
        state = [_randn(rng, 2, jcfg.num_heads, dh) for _ in range(4)]
        state[2] = state[2] * 0.1                       # m
    jx, jst = jxlstm.slstm_block(
        jnp.asarray(x), jp["slstm_0"], jcfg, SHD,
        None if state is None else tuple(map(jnp.asarray, state)))
    tst = None if state is None else tuple(map(_t, state))
    tx = txlstm.slstm_block(_t(x), tp["slstm_0"], tcfg, tst)
    _close(tx, jx, what="x")
    if with_state:
        for i, (a, b) in enumerate(zip(tst, jst)):
            _close(a, b, what=f"state {i}")


def test_slstm_block_gradients():
    """The sLSTM block under a gradient, its recurrent weights laid out
    once before the token loop: the gradients of ``sum(x_out * c)``
    with respect to x and every leaf of the block against
    ``jax.grad`` of the reference's block."""
    jcfg, _, jp, tcfg, _, tp = _models("xlstm-1.3b")
    rng = np.random.default_rng(6)
    x = _randn(rng, 2, 9, jcfg.d_model)
    c = _randn(rng, 2, 9, jcfg.d_model)

    def jloss(x, p):
        out, _ = jxlstm.slstm_block(x, p, jcfg, SHD, None)
        return (out * c).sum()

    jgx, jgp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jp["slstm_0"])
    leaves = tc.tree_map(lambda t: t.clone().requires_grad_(), tp["slstm_0"])
    tx = _t(x).requires_grad_()
    out = txlstm.slstm_block(tx, leaves, tcfg, None)
    flat = jax.tree.leaves(leaves)
    grads = torch.autograd.grad((out * _t(c)).sum(), [tx] + flat)
    _close(grads[0], jgx, what="d x")
    for i, (g, w) in enumerate(zip(grads[1:], jax.tree.leaves(jgp))):
        _close(g, w, what=f"d leaf {i}")


@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_block(with_state):
    jcfg, _, jp, tcfg, tm, tp = _models("xlstm-1.3b")
    rng = np.random.default_rng(4)
    x = _randn(rng, 2, 8, jcfg.d_model)
    jl = jax.tree.map(lambda a: a[0], jp["mlstm"])
    tl = tc.layer_of(tp["mlstm"], 0)
    if with_state:
        st = tc.tree_map(lambda c: c[0] + 0.1 * torch.randn(
            c[0].shape, generator=torch.Generator().manual_seed(5)),
                         tm.init_cache(2, MAX_SEQ, device="cpu")["mlstm"])
        # a private copy for the reference: on the CPU jnp.asarray of the
        # tensor's numpy view may alias it, and the port writes the state
        # in place while the reference's dispatch may still read it
        jst = tuple(jnp.asarray(np.array(s.numpy())) for s in st)
    else:
        st = jst = None
    jx, jnew = jxlstm.mlstm_block(jnp.asarray(x), jl, jcfg, SHD, jst,
                                  chunk=4)
    tx = txlstm.mlstm_block(_t(x), tl, tcfg, st, chunk=4)
    _close(tx, jx, what="x")
    if with_state:
        for i, (a, b) in enumerate(zip(st, jnew)):
            _close(a, b, what=f"state {i}")


@pytest.mark.parametrize("chunk", [4, 16])
def test_ssd_chunkwise_matches_reference_and_steps(chunk):
    rng = np.random.default_rng(6)
    b, t, h, p, n = 2, 16, 4, 8, 6
    x = _randn(rng, b, t, h, p)
    bm, cm = _randn(rng, b, t, n), _randn(rng, b, t, n)
    dt = np.logaddexp(0, _randn(rng, b, t, h)).astype(np.float32)
    a = -np.exp(_randn(rng, h, scale=0.5))
    S = _randn(rng, b, h, n, p)
    jy, jS = jmamba.ssd_chunkwise(*map(jnp.asarray, (x, bm, cm, dt, a, S)),
                                  chunk=chunk)
    ty, tS = tmamba.ssd_chunkwise(*map(_t, (x, bm, cm, dt, a, S)),
                                  chunk=chunk)
    _close(ty, jy, what="y")
    _close(tS, jS, what="S")
    sS = _t(S)
    ys = []
    for i in range(t):
        y, _ = tmamba.ssd_step(*(_t(v[:, i:i + 1]) for v in (x, bm, cm, dt)),
                               _t(a), sS)
        ys.append(y)
    _close(torch.cat(ys, 1), jy, what="steps y")
    _close(sS, jS, what="steps S")
    jy1, jS1 = jmamba.ssd_step(*(jnp.asarray(v[:, :1]) for v in
                                 (x, bm, cm, dt)), jnp.asarray(a),
                               jnp.asarray(S))
    tS1 = _t(S)
    ty1, _ = tmamba.ssd_step(*(_t(v[:, :1]) for v in (x, bm, cm, dt)),
                             _t(a), tS1)
    _close(ty1, jy1, what="step y")
    _close(tS1, jS1, what="step S")


def _long_chunk(kind, t):
    """(port function, reference function, inputs, states) of a chunkwise
    form over ``t`` tokens whose summed log decays pass ~88 within it."""
    if kind == "mlstm":
        q, k, v, logi, logf, C, n = _mlstm_inputs(3, b=1, t=t, nh=2, dh=4)
        return (txlstm.mlstm_chunkwise, jxlstm.mlstm_chunkwise,
                [q, k, v, logi, logf], [C, n])
    rng = np.random.default_rng(7)
    b, h, p, n = 1, 2, 4, 3
    x = _randn(rng, b, t, h, p)
    bm, cm = _randn(rng, b, t, n), _randn(rng, b, t, n)
    dt = np.logaddexp(0, _randn(rng, b, t, h)).astype(np.float32)
    a = -np.exp(_randn(rng, h, scale=0.5))
    return (tmamba.ssd_chunkwise, jmamba.ssd_chunkwise,
            [x, bm, cm, dt, a], [_randn(rng, b, h, n, p)])


@pytest.mark.parametrize("kind", ["mlstm", "ssd"])
def test_chunkwise_gradients_over_a_long_chunk(kind):
    """One 256-token chunk, over which the summed log decays pass ~88
    above the diagonal, and the same inputs in 16-token chunks (each of
    whose decays stays small, so the gradient runs through the state
    carried between chunks). The port's forward is the reference's at
    both, and its gradient with respect to every input, at both, is the
    reference's in 16-token chunks: the same function of the inputs. The
    reference exponentiates before it masks, so its own gradient over
    the long chunk is NaN: the one place the port departs from it."""
    t = 256
    fn, jfn, xs, states = _long_chunk(kind, t)
    rng = np.random.default_rng(8)
    jcall = [jnp.asarray(a) for a in xs]
    jst = tuple(map(jnp.asarray, states))

    def args():
        leaves = [_t(a).requires_grad_() for a in xs + states]
        return leaves, (*leaves[:len(xs)], tuple(leaves[len(xs):])
                        if kind == "mlstm" else leaves[-1])

    def jgrad(chunk, weights):
        def jloss(*flat):
            st_in = (tuple(flat[len(xs):]) if kind == "mlstm"
                     else flat[-1])
            yy, ss = jfn(*flat[:len(xs)], st_in, chunk=chunk)
            o = [yy] + (list(ss) if kind == "mlstm" else [ss])
            return sum((oo * jnp.asarray(_np(w))).sum()
                       for oo, w in zip(o, weights))
        return jax.grad(jloss, argnums=tuple(range(len(xs + states))))(
            *jcall, *jst)

    weights = None
    grads = {}
    for chunk in (t, 16):
        leaves, call = args()
        y, st = fn(*call, chunk=chunk)
        outs = [y] + (list(st) if kind == "mlstm" else [st])
        if weights is None:
            weights = [_t(_randn(rng, *o.shape)) for o in outs]
        sum(((o * w).sum() for o, w in zip(outs, weights))).backward()
        grads[chunk] = [x.grad for x in leaves]
        jy, _ = jfn(*jcall, jst if kind == "mlstm" else jst[0], chunk=chunk)
        _close(y, jy, what=f"y at chunk {chunk}")
    assert not all(np.isfinite(np.asarray(g)).all()
                   for g in jgrad(t, weights))
    want = jgrad(16, weights)
    for i, jg in enumerate(want):
        assert np.isfinite(np.asarray(jg)).all(), f"reference input {i}"
        for chunk in (t, 16):
            g = grads[chunk][i]
            assert bool(torch.isfinite(g).all()), f"input {i}, chunk {chunk}"
            _close(g, jg, what=f"gradient of input {i} at chunk {chunk}")


@pytest.mark.parametrize("t,with_state", [(8, False), (8, True), (1, True)])
def test_mamba_block(t, with_state):
    jcfg, _, jp, tcfg, tm, tp = _models("zamba2-1.2b")
    rng = np.random.default_rng(7)
    x = _randn(rng, 2, t, jcfg.d_model)
    jl = jax.tree.map(lambda a: a[0], jp["mamba"])
    tl = tc.layer_of(tp["mamba"], 0)
    if with_state:
        g = torch.Generator().manual_seed(8)
        st = tuple(0.1 * torch.randn(c[0].shape, generator=g) for c in
                   tm.init_cache(2, MAX_SEQ, device="cpu")["mamba"])
        # a private copy for the reference: on the CPU jnp.asarray of the
        # tensor's numpy view may alias it, and the port writes the state
        # in place while the reference's dispatch may still read it
        jst = tuple(jnp.asarray(np.array(s.numpy())) for s in st)
    else:
        st = jst = None
    jx, jnew = jmamba.mamba_block(jnp.asarray(x), jl, jcfg, SHD, jst,
                                  chunk=4)
    tx = tmamba.mamba_block(_t(x), tl, tcfg, st, chunk=4)
    _close(tx, jx, what="x")
    if with_state:
        for i, (a, b) in enumerate(zip(st, jnew)):
            _close(a, b, what=f"state {i}")


def test_whisper_encode_cross_attention_and_cross_cache():
    jcfg, jm, jp, tcfg, tm, tp = _models("whisper-small")
    rng = np.random.default_rng(9)
    fr = _frames(jcfg, rng, 2)
    jenc = jm.encode(jp, jnp.asarray(fr))
    tenc = tm.encode(tp, _t(fr))
    _close(tenc, jenc, what="encode")
    jxk, jxv = jm.build_cross_cache(jp, jenc)
    txk, txv = tm.build_cross_cache(tp, _t(np.asarray(jenc)))
    _close(txk, jxk, what="cross k")
    _close(txv, jxv, what="cross v")
    x = _randn(rng, 2, 5, jcfg.d_model)
    jl = jax.tree.map(lambda a: a[1], jp["decoder"]["cross_attn"])
    tl = tc.layer_of(tp["decoder"]["cross_attn"], 1)
    jo = jwhisper.cross_attention(jnp.asarray(x), jl, jxk[1], jxv[1], jcfg,
                                  SHD)
    to = twhisper.cross_attention(_t(x), tl, _t(np.asarray(jxk[1])),
                                  _t(np.asarray(jxv[1])), tcfg)
    _close(to, jo, what="cross attention")
    pos = np.array([[0, 3, 70], [5, 1, 2]])
    _close(twhisper.sinusoid(_t(pos), 64, torch.float32),
           jwhisper.sinusoid(jnp.asarray(pos), 64, jnp.float32),
           what="sinusoid")


# ---------------------------------------------------------------------------
# models: forward, chunked prefill, decode


def _batch(cfg, rng, b, s):
    batch = {"tokens": rng.integers(1, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.family == "audio":
        batch["frames"] = _frames(cfg, rng, b)
    return batch


@pytest.mark.parametrize("name", ARCHES)
def test_forward_matches_reference(name):
    jcfg, jm, jp, tcfg, tm, tp = _models(name)
    batch = _batch(jcfg, np.random.default_rng(10), 2, 12)
    jl, jaux = jm.forward(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, taux = tm.forward(tp, {k: _t(v) for k, v in batch.items()})
    _close(tl, jl, what="logits")
    assert taux == jaux == 0.0


def _train_batches(cfg, n, batch, seq):
    """``n`` of the reference pipeline's step-indexed batches (whisper's
    with frames): the same arrays feed both sides."""
    data = jpipe.SyntheticTokens(jpipe.DataConfig(
        seed=4, vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch),
        cfg)
    return [data.batch(i) for i in range(n)]


# (arch, rows, seq): every family at 2 x 24, and at train_4k's sequence
# one row of 4096 tokens of zamba2-1.2b (its SSD carries the state over 16
# chunks of 256) and whisper-small (its decoder past the released models'
# 448 positions)
TRAIN_GRAD_CASES = [pytest.param(n, 2, 24, id=n) for n in ARCHES] + [
    pytest.param(n, 1, 4096, id=f"{n}-seq4096")
    for n in ("zamba2-1.2b", "whisper-small")]


@pytest.mark.parametrize("name,rows,seq", TRAIN_GRAD_CASES)
def test_train_loss_and_gradients_match_reference(name, rows, seq):
    """The train step's loss and every parameter's gradient against
    ``jax.value_and_grad`` of the reference's loss, remat on (the mLSTM
    and Mamba2 layers and whisper's layers recomputed in the backward;
    xlstm's sLSTM token loop and zamba2's shared attention outside the
    checkpoint): every leaf within 1e-4 of the reference's gradient,
    relative and of its max|g|, and nonzero. Past one SSD chunk the
    reference runs its chunkwise form in 16-token chunks, the same
    function: over its default 256-token chunks its gradient is NaN
    (``test_chunkwise_gradients_over_a_long_chunk``); the port keeps its
    default chunks."""
    jcfg, jm, jp, tcfg, tm, _ = _models(name)
    if jcfg.family == "hybrid" and seq > tmamba.CHUNK:
        jm = jbuild(jcfg, chunk=16)
    (batch,) = _train_batches(jcfg, 1, rows, seq)
    jloss = jstep.make_loss_fn(jm, jstep.StepConfig())
    want, wg = jax.value_and_grad(jloss)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    _, tp = both_trees(tcfg, 2)                 # a copy this test may mark
    for x in topt.tree_leaves(tp):
        x.requires_grad_()
    loss = tstep.make_loss_fn(tm, tstep.StepConfig())(
        tp, {k: _t(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-4)
    jflat = jax.tree_util.tree_flatten_with_path(wg)[0]
    tflat = jax.tree.leaves(tp, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert len(jflat) == len(tflat)
    for (path, w), g in zip(jflat, tflat):
        what = jax.tree_util.keystr(path)
        w = np.asarray(w)
        np.testing.assert_allclose(
            _np(g.grad), w, rtol=1e-4,
            atol=1e-4 * max(float(np.abs(w).max()), 1e-30), err_msg=what)
        assert float(g.grad.abs().max()) > 0, f"{what}: zero gradient"


# the dense family's optimizer (``tests/test_torch_train.py``), and the
# same at lr 1e-4, where ``tests/test_torch_parallel.py`` holds these
# families' sharded trajectory
TRAIN_OPTS = [dict(lr=1e-3, warmup_steps=2, total_steps=10),
              dict(lr=1e-4, warmup_steps=2, total_steps=10)]


@pytest.mark.parametrize("opt", TRAIN_OPTS, ids=lambda o: f"lr{o['lr']:g}")
@pytest.mark.parametrize("name", ARCHES)
def test_train_step_matches_reference_over_three_steps(name, opt):
    """Three steps of ``make_train_step`` (2 microbatches, AdamW) against
    the jitted reference step on the same weights and batches: loss, grad
    norm and lr within 1e-4 relative at every step; every parameter
    within twice the summed learning rate, and at most 1e-4 of the
    elements more than 2e-5 apart."""
    jcfg, jm, jp, tcfg, tm, _ = _models(name)
    scfg = dict(num_microbatches=2)
    jfn = jax.jit(jstep.make_train_step(jm, jopt.OptConfig(**opt),
                                        jstep.StepConfig(**scfg)))
    jst = jstep.TrainState(jp, jopt.init_opt_state(jp))
    tfn = tstep.make_train_step(tm, topt.OptConfig(**opt),
                                tstep.StepConfig(**scfg))
    _, tp = both_trees(tcfg, 2)
    tst = tstep.TrainState(tp, topt.init_opt_state(tp))
    for i, batch in enumerate(_train_batches(jcfg, 3, 4, 16)):
        jst, jmet = jfn(jst, batch)
        tst, tmet = tfn(tst, {k: _t(x) for k, x in batch.items()})
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=1e-4, err_msg=f"step {i} {k}")
    lr_sum = sum(float(topt.lr_schedule(topt.OptConfig(**opt),
                                        torch.tensor(i))) for i in (1, 2, 3))
    diffs = np.concatenate([
        np.abs(_np(g) - np.asarray(w)).ravel() for w, g in zip(
            jax.tree.leaves(jst.params), jax.tree.leaves(
                tst.params, is_leaf=lambda x: isinstance(x, torch.Tensor)))])
    assert diffs.max() <= 2 * lr_sum, diffs.max()
    assert (diffs > 2e-5).mean() <= 1e-4, (diffs > 2e-5).sum()
    assert int(tst.opt.step) == 3


@pytest.mark.parametrize("name", ARCHES)
def test_chunked_prefill_and_decode_match_reference(name):
    """A batch of 2 prefilled in the chunks 8, 2, 1 (so a 1-token chunk
    takes the attention's single-query path at an integer position), then
    4 decode steps at per-row positions: logits and every state leaf
    against the reference's."""
    jcfg, jm, jp, tcfg, tm, tp = _models(name)
    rng = np.random.default_rng(11)
    batch = _batch(jcfg, rng, 2, 11)
    jst = jm.init_cache(2, MAX_SEQ, jnp.float32)
    tst = tm.init_cache(2, MAX_SEQ, torch.float32, device="cpu")
    off = 0
    for size in (8, 2, 1):
        jb = {"tokens": jnp.asarray(batch["tokens"][:, off:off + size])}
        tb = {"tokens": _t(batch["tokens"][:, off:off + size])}
        if off == 0 and "frames" in batch:
            jb["frames"] = jnp.asarray(batch["frames"])
            tb["frames"] = _t(batch["frames"])
        jlog, jst = jm.prefill(jp, jb, jst, start_pos=jnp.int32(off))
        tlog, tst = tm.prefill(tp, tb, tst, start_pos=off)
        _close(tlog, jlog, what=f"prefill logits at {off}")
        _close_tree(tst, jst, what=f"state after chunk at {off}")
        off += size
    pos = np.array([11, 11], np.int32)
    tok = rng.integers(1, jcfg.vocab_size, (2, 1)).astype(np.int32)
    for step in range(4):
        jlog, jst = jm.decode_step(jp, jnp.asarray(tok), jnp.asarray(pos),
                                   jst)
        tlog, tst = tm.decode_step(tp, _t(tok), _t(pos), tst)
        _close(tlog, jlog, what=f"decode logits step {step}")
        _close_tree(tst, jst, what=f"state after decode step {step}")
        tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
        assert (tok == torch.argmax(tlog, -1).numpy()).all()
        pos = pos + 1


def test_pow2_chunks():
    for n in list(range(1, 70)) + [255, 256, 300, 511]:
        assert pow2_chunks(n) == jpow2_chunks(n)
        assert sum(pow2_chunks(n)) == n
    with pytest.raises(ValueError):
        pow2_chunks(0)


@pytest.mark.parametrize("name", ARCHES)
def test_chunked_prefill_equals_whole(name):
    """The pow2 chunks of a 13-token prompt (8, 4, 1), state carried, give
    the whole prompt's last logits and state."""
    _, _, _, tcfg, tm, tp = _models(name)
    batch = _batch(tcfg, np.random.default_rng(12), 1, 13)
    whole = tm.init_cache(1, MAX_SEQ, torch.float32, device="cpu")
    tb = {k: _t(v) for k, v in batch.items()}
    wl, whole = tm.prefill(tp, tb, whole, start_pos=0)
    st = tm.init_cache(1, MAX_SEQ, torch.float32, device="cpu")
    off = 0
    for size in pow2_chunks(13):
        cb = {"tokens": tb["tokens"][:, off:off + size]}
        if off == 0 and "frames" in tb:
            cb["frames"] = tb["frames"]
        cl, st = tm.prefill(tp, cb, st, start_pos=off)
        off += size
    _close(cl, wl, what="last logits")
    _close_tree(st, whole, what="state")


# ---------------------------------------------------------------------------
# the reference's serving properties inside the port (numpy-seeded weights)


def _mk_reqs(cfg, plens, seed, max_new=5, cls=Request):
    """Requests whose content depends only on (seed, index)."""
    caps = serving_caps(cfg)
    reqs = []
    for i, plen in enumerate(plens):
        rng = np.random.default_rng(seed * 997 + i)
        kw = {}
        if caps.needs_frames:
            kw["frames"] = rng.standard_normal(
                (cfg.enc_seq, cfg.d_model)).astype(np.float32)
        reqs.append(cls(i, rng.integers(1, cfg.vocab_size, plen)
                        .astype(np.int32), max_new_tokens=max_new, **kw))
    return reqs


PLENS = (3, 7, 5, 1, 6, 2, 4)


@pytest.mark.parametrize("name", ARCHES)
def test_batched_decode_matches_sequential(name):
    """More requests than slots forces recycling; mixed lengths exercise
    every chunk path: batch 3 emits what one request at a time emits, and
    the signature counts stay bounded."""
    _, _, _, tcfg, tm, tp = _models(name)
    batched = _mk_reqs(tcfg, PLENS, 17)
    solo = _mk_reqs(tcfg, PLENS, 17)
    eb = ContinuousEngine(tm, tp, batch_size=3, max_seq=MAX_SEQ,
                          telemetry=False)
    eb.serve(batched)
    es = ContinuousEngine(tm, tp, batch_size=1, max_seq=MAX_SEQ,
                          telemetry=False)
    for r in solo:
        es.serve([r])
    for rb, rs in zip(batched, solo):
        assert len(rb.output) == 5
        assert rb.output == rs.output, (
            f"req {rb.req_id} (plen {len(rb.prompt)}) diverged: "
            f"batched={rb.output} sequential={rs.output}")
    if serving_caps(tcfg).needs_frames:
        bound = (len({pow2_chunks(p)[0] for p in PLENS})
                 + len({c for p in PLENS for c in pow2_chunks(p)[1:]}))
    else:
        bound = len({c for p in PLENS for c in pow2_chunks(p)})
    assert eb.trace_stats.compiles("decode") == 1
    assert eb.trace_stats.compiles("prefill") <= bound
    assert eb.trace_stats.compiles("state_scatter") == 1


@pytest.mark.parametrize("name", ARCHES)
def test_slot_reuse_does_not_leak_state(name):
    """A recycled slot behaves as if freshly allocated."""
    _, _, _, tcfg, tm, tp = _models(name)
    first = _mk_reqs(tcfg, (5,), seed=3)
    again = _mk_reqs(tcfg, (5,), seed=3)
    filler = _mk_reqs(tcfg, (4, 6, 2), seed=8)
    eng = ContinuousEngine(tm, tp, batch_size=1, max_seq=MAX_SEQ,
                           telemetry=False)
    eng.serve(first)
    eng.serve(filler)                  # occupy + recycle slot 0 three times
    eng.serve(again)
    assert first[0].output == again[0].output


def _dump(tree):
    """A copy of every leaf of a state tree of either package as f32
    numpy, in order."""
    return [x.detach().float().numpy().copy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32)
            for x in jax.tree.leaves(tree, is_leaf=lambda x: isinstance(
                x, torch.Tensor))]


@pytest.mark.parametrize("name", ARCHES)
def test_adapter_resets_rows_to_init_cache_as_the_reference(name):
    """The adapter keeps no fresh template: it fills its working tree and
    a freed row with each leaf's initial value. After the same traffic
    (batch 3, recycling) the port's state tree is the reference adapter's
    dump, and the rows freed after the last decode step are
    ``init_cache``'s exactly (xlstm's sLSTM stabiliser at -1e30); then two
    prefills into rows 0 and 1 of a fresh engine of each package and
    ``free_slot`` of row 1: row 1 is ``init_cache``'s again on both sides,
    rows 0 and 2 as they were, and the port's row 1 before it was freed
    is what its prompt alone gives (each prefill starts from the initial
    values, whatever the working tree held)."""
    jcfg, jm, jp, tcfg, tm, tp = _models(name)
    dev = jhw.DeviceSpec(**dataclasses.asdict(H100_SXM))
    jeng = JEngine(jm, jp, batch_size=3, max_seq=MAX_SEQ, dev=dev)
    eng = ContinuousEngine(tm, tp, batch_size=3, max_seq=MAX_SEQ,
                           telemetry=False)
    jeng.serve(_mk_reqs(jcfg, (5, 3, 6, 2, 7), 1, max_new=4, cls=JRequest))
    eng.serve(_mk_reqs(tcfg, (5, 3, 6, 2, 7), 1, max_new=4))
    init = _dump(tm.init_cache(3, MAX_SEQ, device="cpu"))
    got, want = _dump(eng.adapter.caches), _dump(jeng.adapter.caches)
    assert len(got) == len(want) == len(init)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, what=f"state leaf {i} after the serve")
    axes = jax.tree.leaves(eng.adapter._axes)
    # a row freed after the last decode step holds init_cache's values in
    # the reference's dump, and exactly those in the port's
    reset = [r for r in range(3) if all(
        np.array_equal(np.take(w, [r], ax), np.take(z, [r], ax))
        for w, z, ax in zip(want, init, axes))]
    assert reset
    for g, z, ax in zip(got, init, axes):
        np.testing.assert_array_equal(np.take(g, reset, ax),
                                      np.take(z, reset, ax))
    if name == "xlstm-1.3b":
        assert any((z == -1e30).all() and z.size for z in init)
    for fresh, cls in (
            (lambda: JEngine(jm, jp, batch_size=3, max_seq=MAX_SEQ,
                             dev=dev), JRequest),
            (lambda: ContinuousEngine(tm, tp, batch_size=3, max_seq=MAX_SEQ,
                                      telemetry=False), Request)):
        ad = fresh().adapter
        ad.ensure_ready()
        for slot, req in enumerate(_mk_reqs(tcfg, (6, 5), 9, cls=cls)):
            ad.prefill(slot, req)
        held = _dump(ad.caches)
        assert any(not np.array_equal(np.take(h, [1], ax),
                                      np.take(z, [1], ax))
                   for h, z, ax in zip(held, init, axes))
        ad.free_slot(1)
        for h, a, z, ax in zip(held, _dump(ad.caches), init, axes):
            np.testing.assert_array_equal(np.take(a, [1], ax),
                                          np.take(z, [1], ax))
            np.testing.assert_array_equal(np.take(a, [0, 2], ax),
                                          np.take(h, [0, 2], ax))
    # the working tree starts each prefill at init_cache's values: row 1
    # (prefilled after row 0) is what the same prompt alone gives
    alone = ContinuousEngine(tm, tp, batch_size=3, max_seq=MAX_SEQ,
                             telemetry=False).adapter
    alone.ensure_ready()
    alone.prefill(0, _mk_reqs(tcfg, (6, 5), 9)[1])
    for h, a, ax in zip(held, _dump(alone.caches), axes):
        np.testing.assert_array_equal(np.take(h, [1], ax),
                                      np.take(a, [0], ax))


@pytest.mark.parametrize("name", ARCHES)
def test_adapter_holds_the_rows_and_one_working_tree(name):
    """Counted on the meta device (the op counter's live bytes), the
    adapter allocates the batch's rows and one batch-1 tree at max_seq:
    what ``init_cache(3)`` and ``init_cache(1)`` allocate, nothing more
    (no template). The per-leaf fill values are Python numbers."""
    from repro_torch.launch.dryrun import _meta
    from repro_torch.models.registry import abstract_params
    from repro_torch.perf import op_cost
    from repro_torch.serve.state import make_adapter
    _, _, _, tcfg, tm, _ = _models(name)
    shapes, _ = abstract_params(tm)
    params = _meta(shapes, torch.float32)

    def live(fn):
        counter = op_cost.OpCounter(track_memory=True)
        with counter:
            out = fn()
        return out, counter.live_bytes

    def adapter():
        ad = make_adapter(tm, params, batch_size=3, max_seq=4096)
        ad.ensure_ready()
        return ad

    ad, held = live(adapter)
    _, rows = live(lambda: tm.init_cache(3, 4096, device="meta"))
    _, one = live(lambda: tm.init_cache(1, 4096, device="meta"))
    assert held == rows + one > 0
    assert all(isinstance(v, float) for v in jax.tree.leaves(ad._init))


def test_audio_requires_frames():
    _, _, _, tcfg, tm, tp = _models("whisper-small")
    eng = ContinuousEngine(tm, tp, batch_size=1, max_seq=MAX_SEQ,
                           telemetry=False)
    with pytest.raises(ValueError, match="frames"):
        eng.submit(Request(0, np.arange(1, 4, dtype=np.int32)))


@pytest.mark.parametrize("name", ARCHES)
def test_engine_matches_reference(name):
    """The port's continuous engine against the reference's on the same
    weights and requests (batch 3, recycling): tokens, finish reasons and
    signature counts equal; joules partitioned alike."""
    jcfg, jm, jp, tcfg, tm, tp = _models(name)
    jreqs = _mk_reqs(jcfg, (5, 3, 6, 2, 7), 1, max_new=4, cls=JRequest)
    treqs = _mk_reqs(tcfg, (5, 3, 6, 2, 7), 1, max_new=4)
    dev = jhw.DeviceSpec(**dataclasses.asdict(H100_SXM))
    jst = JEngine(jm, jp, batch_size=3, max_seq=MAX_SEQ, dev=dev).serve(jreqs)
    eng = ContinuousEngine(tm, tp, batch_size=3, max_seq=MAX_SEQ)
    tst = eng.serve(treqs)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert [r.finish_reason for r in treqs] == \
        [r.finish_reason for r in jreqs]
    for key in ("adapter", "family", "completed", "prefills",
                "decode_steps", "tokens_decoded", "slots_recycled",
                "prefill_compiles", "decode_compiles", "compiles"):
        assert tst[key] == jst[key], key
    # the power model sees the same state bytes (f32 recurrent leaves)
    assert eng.pm.cache_bytes == pytest.approx(
        float(sum(a.size * a.dtype.itemsize for a in jax.tree.leaves(
            jm.init_cache(3, MAX_SEQ)))))
    slot_tags = {eng.tel.slot_tag(i) for i in range(eng.batch_size)}
    slot_j = 0.0
    for blk in eng.tel.session.blocks():
        mask = np.zeros(blk.n, bool)
        for tag in slot_tags:
            mask |= blk.tag_mask(tag)
        slot_j += float((blk.watts * blk.dt)[mask].sum())
    assert all(r.energy_j > 0.0 for r in treqs)
    assert sum(r.energy_j for r in treqs) == pytest.approx(slot_j, abs=1e-6)


# ---------------------------------------------------------------------------
# the CLI


@pytest.mark.parametrize("name", ARCHES)
def test_cli_serves_on_the_host(name, capsys):
    stats = tserve.main(["--arch", name, "--smoke", "--device", "cpu",
                         "--requests", "3", "--batch", "2", "--prompt-len",
                         "6", "--max-new", "3", "--max-seq", "16"])
    assert stats["completed"] == 3 and stats["adapter"] == "recurrent"
    assert stats["decode_compiles"] == 1
    assert f"arch={name}-smoke" in capsys.readouterr().out


@pytest.mark.parametrize("flags,match", [
    (["--prefill-buckets", "8,16"], "--prefill-buckets"),
    (["--engine", "static"], "--engine static"),
    (["--kv-block-size", "8"], "--kv-block-size"),
    (["--prefix-cache", "on"], "--prefix-cache"),
])
def test_cli_refuses_what_a_recurrent_family_cannot_do(flags, match,
                                                       capsys):
    with pytest.raises(SystemExit):
        tserve.main(["--arch", "zamba2-1.2b", "--smoke", "--device", "cpu",
                     *flags])
    assert match in capsys.readouterr().err
