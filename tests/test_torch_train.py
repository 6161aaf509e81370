"""The port's training path against the reference: the optimizer, the
losses, the train step (microbatched, chunked, cast once) on granite-20b's
and gemma3-27b's smoke configs in f32 with bridged weights, the flash
kernel's autograd Function, the data pipeline, the loop and the launcher.

Inputs come from numpy seeds. Tolerances: the optimizer and the losses
1e-6 (f32 elementwise; the two frameworks round the same operations);
loss values and gradients of the model 1e-4 relative (matmuls summed in
another order); over 3 train steps, losses and grad norms 1e-4 relative,
and parameters: all but 1e-4 of the elements within 2e-5, and every one
within twice the summed learning rate. Each AdamW step moves an element by
about lr whatever its gradient's size (m/sqrt(v) ~ sign(g) early on), so an
element whose gradient is near zero on both sides may step the other way
when the two sides' f32 gradients differ in the last bits: 3 of 131,072
elements of a granite-20b smoke leaf did, by 1.05e-4.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jpipe
from repro.models import build_model as jbuild
from repro.models import common as jc
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_numpy
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.launch import train as ttrain
from repro_torch.models import build_model as tbuild
from repro_torch.models import common as tc
from repro_torch.obs import validate_chrome_trace
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep
from torch_weights import model_tree

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


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


def _rand_tree(rng, scale=1.0):
    return {"a": (rng.normal(size=(3, 5)) * scale).astype(np.float32),
            "b": {"c": (rng.normal(size=(7,)) * scale).astype(np.float32),
                  "d": (rng.normal(size=(2, 2, 3)) * scale).astype(
                      np.float32)}}


# ---------------------------------------------------------------------------
# optimizer


@pytest.mark.parametrize("step", [0, 1, 3, 50, 99, 100, 101, 5000, 9999,
                                  10000, 20000])
def test_lr_schedule_matches_reference(step):
    cfg = dict(lr=3e-4, warmup_steps=100, total_steps=10_000)
    want = jopt.lr_schedule(jopt.OptConfig(**cfg), jnp.int32(step))
    got = topt.lr_schedule(topt.OptConfig(**cfg),
                           torch.tensor(step, dtype=torch.int32))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=0)


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0], ids=["unclipped",
                                                          "clipped"])
def test_adamw_update_matches_reference(grad_scale):
    rng = np.random.default_rng(0)
    params = _rand_tree(rng)
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=5)
    jstate = jopt.init_opt_state(params)
    tparams = params_from_numpy(params, "cpu")
    tstate = topt.init_opt_state(tparams)
    jp = params
    for i in range(3):
        grads = _rand_tree(rng, grad_scale)
        jp, jstate, jm = jopt.adamw_update(jopt.OptConfig(**cfg), jp, grads,
                                           jstate)
        tparams, tstate, tm = topt.adamw_update(
            topt.OptConfig(**cfg), tparams, params_from_numpy(grads, "cpu"),
            tstate)
        if i == 0:
            assert (float(jm["grad_norm"]) > 1.0) == (grad_scale > 1)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
        for want, got in ((jp, tparams), (jstate.m, tstate.m),
                          (jstate.v, tstate.v)):
            jax.tree.map(lambda w, g: np.testing.assert_allclose(
                _np(g), np.asarray(w), rtol=1e-6, atol=1e-6), want,
                got, is_leaf=lambda x: isinstance(x, torch.Tensor))
        assert int(tstate.step) == int(jstate.step) == i + 1


# ---------------------------------------------------------------------------
# losses


def test_softmax_xent_value_and_grad_match_reference():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(2, 6, 40)).astype(np.float32) * 3
    labels = rng.integers(0, 40, (2, 6)).astype(np.int32)
    mask = (rng.random((2, 6)) > 0.3).astype(np.float32)
    for m in (None, mask):
        want, wg = jax.value_and_grad(
            lambda x: jc.softmax_xent(x, labels, m))(logits)
        x = _t(logits).requires_grad_()
        got = tc.softmax_xent(x, _t(labels),
                              None if m is None else _t(m))
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-6)
        np.testing.assert_allclose(_np(x.grad), np.asarray(wg), atol=1e-6)


@pytest.mark.parametrize("n_chunks", [1, 4, 16])
def test_chunked_softmax_xent_value_and_grad_match_reference(n_chunks):
    rng = np.random.default_rng(2)
    d, v = 24, 64
    h = rng.normal(size=(2, 5, d)).astype(np.float32)
    params = {"final_norm": rng.normal(size=(d,)).astype(np.float32) * 0.1,
              "unembed": rng.normal(size=(d, v)).astype(np.float32) * 0.3}
    labels = rng.integers(0, v, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.3).astype(np.float32)
    want, wg = jax.value_and_grad(lambda x: jc.chunked_softmax_xent(
        x, params, labels, mask, n_chunks))(h)
    x = _t(h).requires_grad_()
    got = tc.chunked_softmax_xent(x, params_from_numpy(params, "cpu"),
                                  _t(labels), _t(mask), n_chunks)
    got.backward()
    got = float(got.detach())
    np.testing.assert_allclose(got, float(want), rtol=1e-6)
    np.testing.assert_allclose(_np(x.grad), np.asarray(wg), atol=1e-6)
    # the same as the unchunked loss over the full logits
    full = jc.softmax_xent(jc.unembed(h, params, jstep_shd()), labels, mask)
    np.testing.assert_allclose(got, float(full), rtol=1e-5)


def jstep_shd():
    from repro.parallel.sharding import Sharder
    return Sharder(None)


def test_chunked_softmax_xent_refuses_a_ragged_vocab():
    h = torch.zeros(1, 2, 4)
    params = {"final_norm": torch.zeros(4), "unembed": torch.zeros(4, 10)}
    with pytest.raises(ValueError, match="multiple"):
        tc.chunked_softmax_xent(h, params, torch.zeros(1, 2, dtype=torch.long),
                                n_chunks=4)


# ---------------------------------------------------------------------------
# the flash kernel's autograd Function (the plain version on the host)

# (B, H, Hkv, S, T, D, causal, window, q_offset, block)
GRAD_CASES = [
    (1, 4, 4, 40, 40, 16, True, None, 0, 16),      # causal, MHA, 3 blocks
    (2, 8, 2, 33, 33, 16, True, None, 0, 8),       # GQA, ragged last block
    (1, 8, 1, 24, 24, 32, True, 7, 0, 8),          # window, MQA
    (1, 4, 2, 12, 40, 16, True, None, 28, 5),      # q_offset past a prefix
    (1, 4, 2, 12, 40, 16, True, 9, 20, 4),         # window + q_offset
    (1, 4, 4, 20, 30, 16, False, None, 0, 7),      # not causal
    (1, 4, 4, 6, 10, 16, True, None, 0, 512),      # one block
]


@pytest.mark.parametrize("case", GRAD_CASES, ids=str)
def test_flash_function_gradients_equal_the_plain_versions(case):
    b, h, hkv, s, t, d, causal, window, q_offset, block = case
    rng = np.random.default_rng(s + t)
    q, k, v = (_t(rng.normal(size=(b, n, m, d)).astype(np.float32))
               for n, m in ((h, s), (hkv, t), (hkv, t)))
    do = _t(rng.normal(size=(b, h, s, d)).astype(np.float32))
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ref.attention(*leaves, **mask).backward(do)
    want = [x.grad for x in leaves]
    got = ops.attention_grads(q, k, v, do, block=block, **mask)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    # the Function: the same forward as the plain version, the same grads
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = ops.flash_attention(*leaves, **mask)
    assert out.grad_fn is not None and "FlashAttention" in out.grad_fn.name()
    torch.testing.assert_close(out, ref.attention(q, k, v, **mask),
                               rtol=0, atol=0)
    out.backward(do)
    for x, w in zip(leaves, want):
        torch.testing.assert_close(x.grad, w, rtol=1e-5, atol=1e-6)


def test_flash_without_a_gradient_stays_off_the_function():
    q = torch.randn(1, 2, 4, 16, requires_grad=True)
    k = torch.randn(1, 2, 4, 16)
    with torch.no_grad():
        assert ops.flash_attention(q, k, k).grad_fn is None
    assert ops.flash_attention(q.detach(), k, k).grad_fn is None


# ---------------------------------------------------------------------------
# the model under a gradient, and the train step against the reference


@pytest.fixture(scope="module", params=["granite-20b", "gemma3-27b"])
def bridged(request):
    jcfg = jconfigs.get_smoke(request.param).replace(dtype="float32")
    tcfg = tconfigs.get_smoke(request.param).replace(dtype="float32")
    return jcfg, jbuild(jcfg, q_block=8), model_tree(tcfg, 0), tcfg


def test_forward_and_gradients_match_reference(bridged):
    """The training forward's logits and every parameter's gradient
    against ``repro.models.transformer.DecoderLM.forward`` under
    ``jax.grad``, with remat on and off (on the card the same gradients
    need the flash kernel's Function: ``tests/test_torch_cuda.py``)."""
    jcfg, jm, jp, tcfg = bridged
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 40))
    toks = toks.astype(np.int32)

    def jloss(p):
        logits, _ = jm.forward(p, {"tokens": toks})
        return jnp.sum(logits * jnp.cos(jnp.arange(logits.shape[-1])))

    want, wg = jax.jit(jax.value_and_grad(jloss))(jp)
    for remat in (True, False):
        tm = tbuild(tcfg, remat=remat)
        tp = params_from_numpy(jp, "cpu")
        for x in topt.tree_leaves(tp):
            x.requires_grad_()
        logits, aux = tm.forward(tp, {"tokens": _t(toks)})
        assert aux == 0.0
        loss = (logits * torch.cos(torch.arange(logits.shape[-1]).float())
                ).sum()
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(want),
                                   rtol=1e-4)
        jax.tree.map(lambda w, g: np.testing.assert_allclose(
            _np(g.grad), np.asarray(w), rtol=1e-4,
            atol=1e-4 * float(np.abs(w).max())), wg, tp,
            is_leaf=lambda x: isinstance(x, torch.Tensor))
        assert all(float(x.grad.abs().max()) > 0
                   for x in tp["layers"]["attn"].values())


# (num_microbatches, vocab_chunks, cast_params_once)
STEP_CASES = [(1, 1, False), (2, 1, False), (1, 4, False), (1, 1, True)]


@pytest.mark.parametrize("case", STEP_CASES,
                         ids=lambda c: f"micro{c[0]}-chunks{c[1]}"
                                       + ("-cast" if c[2] else ""))
def test_train_step_matches_reference_over_three_steps(bridged, case):
    jcfg, jm, jp, tcfg = bridged
    n_micro, chunks, cast = case
    scfg = dict(num_microbatches=n_micro, vocab_chunks=chunks,
                cast_params_once=cast)
    data = jpipe.SyntheticTokens(jpipe.DataConfig(
        seed=4, vocab_size=jcfg.vocab_size, seq_len=24, global_batch=4))
    jfn = jax.jit(jstep.make_train_step(jm, jopt.OptConfig(**OPT),
                                        jstep.StepConfig(**scfg)))
    jst = jstep.TrainState(jp, jopt.init_opt_state(jp))
    tfn = tstep.make_train_step(tbuild(tcfg), topt.OptConfig(**OPT),
                                tstep.StepConfig(**scfg))
    tp = params_from_numpy(jp, "cpu")
    tst = tstep.TrainState(tp, topt.init_opt_state(tp))
    for i in range(3):
        batch = data.batch(i)
        jst, jm_ = jfn(jst, batch)
        tst, tm_ = tfn(tst, {k: _t(x) for k, x in batch.items()})
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm_[k]), float(jm_[k]),
                                       rtol=1e-4, err_msg=f"step {i} {k}")
    lr_sum = sum(float(topt.lr_schedule(topt.OptConfig(**OPT),
                                        torch.tensor(i))) for i in (1, 2, 3))
    diffs = np.concatenate([
        np.abs(_np(g) - np.asarray(w)).ravel() for w, g in zip(
            jax.tree.leaves(jst.params), jax.tree.leaves(
                tst.params, is_leaf=lambda x: isinstance(x, torch.Tensor)))])
    assert diffs.max() <= 2 * lr_sum, diffs.max()
    assert (diffs > 2e-5).mean() <= 1e-4, (diffs > 2e-5).sum()
    assert int(tst.opt.step) == 3


def test_train_step_refuses_a_batch_that_does_not_split():
    cfg = tconfigs.get_smoke("granite-20b").replace(dtype="float32")
    model = tbuild(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu",
                        dtype=torch.float32)
    fn = tstep.make_grad_fn(model, tstep.StepConfig(num_microbatches=2))
    toks = torch.zeros(3, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="microbatches"):
        fn(params, {"tokens": toks, "labels": toks})


def test_init_makes_f32_master_parameters():
    cfg = tconfigs.get_smoke("granite-20b")          # bf16 compute
    model = tbuild(cfg)
    p32 = model.init(torch.Generator().manual_seed(0), "cpu",
                     dtype=torch.float32)
    p16 = model.init(torch.Generator().manual_seed(0), "cpu")
    assert {x.dtype for x in topt.tree_leaves(p32)} == {torch.float32}
    assert {x.dtype for x in topt.tree_leaves(p16)} == {torch.bfloat16}
    # a bf16 forward on f32 masters: gradients land on the f32 leaves
    grads = tstep.make_grad_fn(model, tstep.StepConfig())(
        p32, {k: _t(x) for k, x in tpipe.SyntheticTokens(tpipe.DataConfig(
            vocab_size=cfg.vocab_size, seq_len=16, global_batch=2)).batch(0)
              .items()})[1]
    for g in topt.tree_leaves(grads):
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
        assert float(g.abs().max()) > 0


# ---------------------------------------------------------------------------
# data pipeline


@pytest.mark.parametrize("arch", ["granite-20b", "gemma3-27b"])
def test_synthetic_tokens_equal_reference_bit_for_bit(arch):
    kw = dict(seed=5, vocab_size=1000, seq_len=37, global_batch=3, ngram=4)
    jd = jpipe.SyntheticTokens(jpipe.DataConfig(**kw),
                               jconfigs.get_smoke(arch))
    td = tpipe.SyntheticTokens(tpipe.DataConfig(**kw),
                               tconfigs.get_smoke(arch))
    for i in (0, 1, 17):
        jb, tb = jd.batch(i), td.batch(i)
        assert jb.keys() == tb.keys()
        for k in jb:
            assert jb[k].dtype == tb[k].dtype
            np.testing.assert_array_equal(jb[k], tb[k])
    shape = tconfigs.base.SHAPES["train_4k"]
    cell = tpipe.for_cell(tconfigs.get_smoke(arch), shape, seed=1)
    assert cell.cfg.seq_len == 4096 and cell.cfg.global_batch == 256


def test_prefetcher_order_restart_and_device():
    src = tpipe.SyntheticTokens(tpipe.DataConfig(vocab_size=50, seq_len=8,
                                                 global_batch=2))
    pf = tpipe.Prefetcher(src, start_step=0)
    try:
        got = [pf.next() for _ in range(4)]
    finally:
        pf.close()
    assert [i for i, _ in got] == [0, 1, 2, 3]
    np.testing.assert_array_equal(got[2][1]["tokens"],
                                  src.batch(2)["tokens"])
    pf = tpipe.Prefetcher(src, start_step=5, device="cpu")
    try:
        i, b = pf.next()
        j, _ = pf.next()
    finally:
        pf.close()
    assert (i, j) == (5, 6) and isinstance(b["tokens"], torch.Tensor)
    np.testing.assert_array_equal(b["tokens"].numpy(), src.batch(5)["tokens"])


# ---------------------------------------------------------------------------
# loop and launcher


def test_train_loop_checkpoint_restart(tmp_path):
    calls = {"steps": []}

    def fake_step(state, batch):
        s = state["n"] + 1
        calls["steps"].append(int(s))
        return {"n": s}, {"loss": torch.tensor(1.0) / s,
                          "grad_norm": torch.tensor(1.0)}

    data = tpipe.SyntheticTokens(tpipe.DataConfig(seed=0, vocab_size=16,
                                                  seq_len=4, global_batch=2))
    cfg = tloop.LoopConfig(total_steps=6, ckpt_every=2,
                           ckpt_dir=str(tmp_path))
    state = {"n": torch.tensor(0, dtype=torch.int32)}
    state, hist, summary = tloop.run(fake_step, state, data, cfg)
    assert int(state["n"]) == 6 and len(hist) == 6
    assert hist[-1]["loss"] == pytest.approx(1 / 6)
    # the per-tag joules partition the session's energy
    assert summary["energy_by_tag"].keys() == {"train_step"}
    assert abs(sum(summary["energy_by_tag"].values())
               - summary["energy_j"]) <= 1e-6
    # simulate crash + restart: resumes from step 6 checkpoint (no-op run)
    state2, hist2, _ = tloop.run(
        fake_step, {"n": torch.tensor(0, dtype=torch.int32)}, data, cfg)
    assert int(state2["n"]) == 6 and len(hist2) == 0
    # partial restart: delete newest, rerun -> resumes from 4
    import shutil
    shutil.rmtree(tmp_path / "step_00000006")
    state3, hist3, _ = tloop.run(
        fake_step, {"n": torch.tensor(0, dtype=torch.int32)}, data, cfg)
    assert len(hist3) == 2 and int(state3["n"]) == 6


def test_fetch_metrics_takes_one_stacked_copy():
    m = {"loss": torch.tensor(2.5), "grad_norm": torch.tensor(0.5,
                                                             dtype=torch.float64),
         "lr": np.float32(1e-3)}
    got = tloop.fetch_metrics(m)
    assert got == {"loss": 2.5, "grad_norm": 0.5,
                   "lr": pytest.approx(1e-3)}


def test_launch_train_on_the_host(tmp_path):
    trace = tmp_path / "t.json"
    log = tmp_path / "log.json"
    hist = ttrain.main(["--smoke", "--device", "cpu", "--steps", "4",
                        "--batch", "4", "--seq", "16", "--micro", "2",
                        "--trace-out", str(trace), "--log-json", str(log),
                        "--metrics-json", str(tmp_path / "m.json"),
                        "--ckpt-dir", str(tmp_path / "ck"),
                        "--ckpt-every", "2"])
    assert len(hist) == 4
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in hist)
    summary = json.loads(log.read_text())["summary"]
    assert summary["train_step_compiles"] == 1
    doc = json.loads(trace.read_text())
    validate_chrome_trace(doc)
    od = doc["otherData"]
    assert abs(od["attributed_j"] - od["energy_total_j"]) <= 1e-6
    metrics = json.loads((tmp_path / "m.json").read_text())
    assert "train_tokens" in json.dumps(metrics)
    assert (tmp_path / "ck" / "step_00000004" / "_COMMITTED").exists()


def test_launch_train_refuses_a_mesh(monkeypatch):
    """A mesh runs one rank a process under torchrun: outside it (no
    WORLD_SIZE) a mesh of 2 ranks is refused (``tests/test_torch_parallel.py``
    runs it under torchrun)."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        ttrain.main(["--smoke", "--device", "cpu", "--mesh-data", "2"])


def test_launch_train_without_device_raises_on_a_host_without_cuda(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--smoke", "--steps", "1"])
