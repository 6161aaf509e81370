"""The port's checkpoints: the reference's substrate tests
(``tests/test_substrate.py``: roundtrip, atomicity, async with prune,
newest wins) on the port, and the cross-read both ways: a reference
``TrainState`` saved by ``repro.checkpoint.ckpt.save`` restores in the port
and trains on to the reference's step-3 loss, and the port's checkpoint,
bf16 leaf included, restores in the reference bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import ckpt as jckpt
from repro.data import pipeline as jpipe
from repro.models import build_model as jbuild
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import ckpt
from repro_torch.models import build_model as tbuild
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep

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


def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b)


def test_ckpt_roundtrip(tmp_path):
    tree = _tree()
    ckpt.save(tree, tmp_path, step=3, extra={"note": "x"})
    restored, manifest = ckpt.restore(tree, tmp_path)
    assert manifest["step"] == 3 and manifest["extra"]["note"] == "x"
    topt.tree_map(_equal, tree, restored)
    assert manifest["leaves"]["b__c"] == {"shape": [4], "dtype": "bfloat16"}
    assert manifest["leaves"]["step"] == {"shape": [], "dtype": "int32"}


def test_ckpt_atomicity_partial_ignored(tmp_path):
    tree = _tree()
    ckpt.save(tree, tmp_path, step=1)
    # fake a crashed save: directory without _COMMITTED
    bad = tmp_path / "step_00000002"
    bad.mkdir()
    (bad / "manifest.json").write_text("{}")
    assert ckpt.valid_steps(tmp_path) == [1]
    ckpt.gc_partial(tmp_path)
    assert not bad.exists()
    restored, manifest = ckpt.restore(tree, tmp_path)
    assert manifest["step"] == 1


def test_ckpt_async_and_prune(tmp_path):
    saver = ckpt.AsyncSaver()
    tree = _tree()
    for s in (1, 2, 3, 4):
        saver.save(tree, tmp_path, s)
    saver.wait()
    ckpt.prune(tmp_path, keep=2)
    assert ckpt.valid_steps(tmp_path) == [3, 4]


def test_ckpt_async_save_is_a_copy_taken_at_the_call(tmp_path):
    tree = {"x": torch.zeros(1000)}
    saver = ckpt.AsyncSaver()
    saver.save(tree, tmp_path, 1)
    tree["x"].add_(1.0)                  # the train step updates in place
    saver.wait()
    restored, _ = ckpt.restore(tree, tmp_path)
    assert float(restored["x"].abs().max()) == 0.0


def test_ckpt_restore_picks_newest(tmp_path):
    tree = {"x": torch.zeros(2)}
    ckpt.save(tree, tmp_path, 1)
    ckpt.save({"x": torch.ones(2)}, tmp_path, 5)
    restored, m = ckpt.restore(tree, tmp_path)
    assert m["step"] == 5
    np.testing.assert_array_equal(restored["x"].numpy(), np.ones(2))


def test_ckpt_restore_without_a_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.restore(_tree(), tmp_path)


def test_ckpt_keys_are_the_references(tmp_path):
    params = {"layers": {"attn": {"wq": torch.zeros(2, 3)}},
              "embedding": torch.zeros(4, 2)}
    state = tstep.TrainState(params, topt.init_opt_state(params))
    keys = [k for k, _ in ckpt._flatten(state)]
    jparams = jax.tree.map(lambda t: jnp.zeros(t.shape), params)
    jstate = jstep.TrainState(jparams, jopt.init_opt_state(jparams))
    assert sorted(keys) == sorted(k for k, _ in jckpt._flatten(jstate))
    assert "opt__step" in keys and "params__layers__attn__wq" in keys


def _batches(vocab):
    data = jpipe.SyntheticTokens(jpipe.DataConfig(
        seed=4, vocab_size=vocab, seq_len=24, global_batch=4))
    return [data.batch(i) for i in range(3)]


def test_reference_checkpoint_restores_in_the_port_and_trains_on(tmp_path):
    arch = "granite-20b"
    jcfg = jconfigs.get_smoke(arch).replace(dtype="float32")
    tcfg = tconfigs.get_smoke(arch).replace(dtype="float32")
    jm = jbuild(jcfg, q_block=8)
    jp, _ = jm.init(jax.random.key(0))
    batches = _batches(jcfg.vocab_size)
    jfn = jax.jit(jstep.make_train_step(jm, jopt.OptConfig(**OPT),
                                        jstep.StepConfig()))
    jst = jstep.TrainState(jp, jopt.init_opt_state(jp))
    for b in batches[:2]:
        jst, _ = jfn(jst, b)
    jckpt.save(jst, tmp_path, 2)
    _, want = jfn(jst, batches[2])
    # the port restores into its own TrainState and takes step 3
    tm = tbuild(tcfg)
    like = tm.init(torch.Generator().manual_seed(9), "cpu",
                   dtype=torch.float32)
    state, manifest = ckpt.restore(
        tstep.TrainState(like, topt.init_opt_state(like)), tmp_path)
    assert manifest["step"] == 2 and int(state.opt.step) == 2
    tfn = tstep.make_train_step(tm, topt.OptConfig(**OPT), tstep.StepConfig())
    _, got = tfn(state, {k: torch.from_numpy(x) for k, x in
                         batches[2].items()})
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    params = {"w": torch.randn(3, 4, generator=torch.Generator()
                               .manual_seed(0)),
              "w16": torch.randn(5, generator=torch.Generator()
                                 .manual_seed(1)).to(torch.bfloat16)}
    state = tstep.TrainState(params, topt.init_opt_state(params))
    state.opt.m["w"].fill_(0.25)
    state = state._replace(opt=state.opt._replace(
        step=torch.tensor(11, dtype=torch.int32)))
    ckpt.save(state, tmp_path, 11)
    jlike = jstep.TrainState(
        {"w": jnp.zeros((3, 4)), "w16": jnp.zeros((5,), jnp.bfloat16)},
        jopt.init_opt_state({"w": jnp.zeros((3, 4)),
                             "w16": jnp.zeros((5,), jnp.bfloat16)}))
    restored, manifest = jckpt.restore(jlike, tmp_path)
    assert manifest["step"] == 11
    np.testing.assert_array_equal(np.asarray(restored.params["w"]),
                                  params["w"].numpy())
    assert str(np.asarray(restored.params["w16"]).dtype) == "bfloat16"
    np.testing.assert_array_equal(
        np.asarray(restored.params["w16"]).astype(np.float32),
        params["w16"].float().numpy())
    np.testing.assert_array_equal(np.asarray(restored.opt.m["w"]),
                                  np.full((3, 4), 0.25, np.float32))
    assert int(restored.opt.step) == 11
