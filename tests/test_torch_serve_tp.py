"""The sharded serve step (``serve.step.ShardedServeStep``) on gloo ranks
against the unsharded port and the reference, and the partial-softmax
combine it decodes with.

Each mesh, (data 1, model 4) and (data 2, model 2), is one spawn of four
ranks (``tests/torch_dist_worker.py`` task ``serve_tp``) that serves
every case under the reference dry-run's ``serve_rules`` for its batch.
Smoke configs in f32, weights from a numpy seed through the bridge, a
batch of 2 rows (max_seq 32), a prefill and 4 greedy decode steps at
per-row positions: row 0 decodes after its prompt, row 1 from position
5, inside the first sequence block, so that on model 4 the later ranks'
blocks hold no valid key for it. Cases:

- qwen3-32b: 2 KV heads, so the caches split over sequence on model 4
  and over KV heads on model 2;
- granite-20b (MQA: sequence on both meshes), and again with a tail
  prefill (``start_pos`` 10) over the sequence-split cache;
- gemma3-27b: window rings and global caches split over KV heads;
- deepseek-moe-16b: experts over ``model`` (its MoE groups follow the
  batch spec: one a batch shard, on both sides);
- internvl2-76b: the patch prefix (8 positions) before the prompt.

The recurrent families (``RECURRENT``, one spawn a mesh for the three)
split their compute over ``model`` as the reference's specs lay it out:

- xlstm-1.3b: 4 heads, so the mLSTM runs the rank's heads on both
  meshes; its sLSTM runs every head, its state gathered at use;
- zamba2-1.2b: the Mamba2 layers' 16 heads and the shared attention's 8
  split over ``model``, its caches over KV heads;
- whisper-small (synthetic frames): 8 heads split, the MLPs' width too;
- each again with 3 heads on both sides (a ``replace`` of the smoke
  config: the heads divide neither model 4 nor model 2, as whisper's 12
  and xlstm's 4 do not at model 16): the recurrences and the attention run
  every head on every rank, the KV caches split over sequence, and the
  rank's inner channels still split the products (zamba2 at d_model 96:
  its ``w_in``, 419 columns, stays whole while its conv, ``out_norm`` and
  ``w_out`` split).

A batch of one (long_500k's layout) splits zamba2's shared-attention
caches over ``("pod", "data")`` on a pod 2 x data 2 mesh
(``Sharder.kv_split`` over one group of four ranks).

Every call's whole-vocabulary logits (gathered over ``model``) agree with
the unsharded port on the same mesh shape within 1e-5 of max|logit|, and
with the reference's ``prefill``/``decode_step`` on the same weights at
the serve tests' tolerance (rtol and atol 1e-4); the greedy tokens are
equal on all three.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch.mesh import make_host_mesh as jmesh
from repro.models import build_model as jbuild
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_numpy
from repro_torch.launch.mesh import RankMesh, make_host_mesh
from repro_torch.models import build_model as tbuild
from repro_torch.models import common
from repro_torch.models import mamba2, transformer, whisper, xlstm
from repro_torch.parallel import comm
from repro_torch.perf import op_cost
from repro_torch.serve.step import ShardedServeStep, cell_rules
from torch_dist_worker import one_rank, spawn

TOL = dict(rtol=1e-4, atol=1e-4)
MAX_SEQ, PROMPT, STEPS, B = 32, 12, 4, 2
CASES = {"qwen3-32b": ("qwen3-32b", None), "granite-20b": ("granite-20b",
                                                           None),
         "granite-20b-tail": ("granite-20b", 10),
         "gemma3-27b": ("gemma3-27b", None),
         "deepseek-moe-16b": ("deepseek-moe-16b", None),
         "internvl2-76b": ("internvl2-76b", None)}
MESHES = {"model4": {"data": 1, "model": 4}, "data2-model2": {"data": 2,
                                                              "model": 2}}
# the recurrent families: (arch, smoke config fields replaced on both sides)
HEADS3 = dict(num_heads=3, num_kv_heads=3)
RECURRENT = {"xlstm-1.3b": ("xlstm-1.3b", {}),
             "zamba2-1.2b": ("zamba2-1.2b", {}),
             "whisper-small": ("whisper-small", {}),
             "xlstm-1.3b-h3": ("xlstm-1.3b", dict(HEADS3, d_model=96)),
             "zamba2-1.2b-h3": ("zamba2-1.2b", dict(HEADS3, d_model=96,
                                                    head_dim=64)),
             "whisper-small-h3": ("whisper-small", HEADS3)}
PARAM_SHAPES = {"dense": transformer.param_shapes,
                "moe": transformer.param_shapes,
                "vlm": transformer.param_shapes, "ssm": xlstm.param_shapes,
                "hybrid": mamba2.param_shapes, "audio": whisper.param_shapes}


def _weights(spec, rng):
    if isinstance(spec, dict):
        return {k: _weights(v, rng) for k, v in spec.items()}
    shape, fan_in = spec
    if fan_in is None:
        # the norm scales: small, not zero, so that they count
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)
    if fan_in == "ones":
        return np.ones(shape, np.float32)
    return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)


def _case(arch, tail, seed, replace=None, rows=B):
    replace = replace or {}
    cfg = tconfigs.get_smoke(arch).replace(dtype="float32", **replace)
    rng = np.random.default_rng(seed)
    w = _weights(PARAM_SHAPES[cfg.family](cfg), rng)
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (rows, PROMPT)).astype(np.int32)}
    prefix = 0
    if cfg.family == "vlm":
        prefix = cfg.stub_prefix_len
        batch["patch_embeddings"] = rng.standard_normal(
            (rows, prefix, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (rows, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    pos = np.array([prefix + PROMPT, 5][:rows], np.int64)
    return {"arch": arch, "cfg": replace, "np": w, "np_batch": batch,
            "params": params_from_numpy(w, "cpu"),
            "batch": {k: torch.from_numpy(v) for k, v in batch.items()},
            "pos": torch.from_numpy(pos), "max_seq": MAX_SEQ,
            "steps": STEPS, "tail": tail}


def _port(c, sizes):
    """The unsharded port on a model built on the mesh's shape (its MoE
    groups: one a batch shard)."""
    cfg = tconfigs.get_smoke(c["arch"]).replace(dtype="float32", **c["cfg"])
    model = tbuild(cfg, sizes)
    b = c["batch"]["tokens"].shape[0]
    caches = model.init_cache(b, MAX_SEQ, torch.float32, "cpu")
    batch = {k: v.clone() for k, v in c["batch"].items()}
    toks = batch["tokens"].long()
    logits = []
    with torch.no_grad():
        if c["tail"]:
            a = c["tail"]
            lg, caches = model.prefill(c["params"], {"tokens": toks[:, :a]},
                                       caches)
            logits.append(lg)
            lg, caches = model.prefill(c["params"], {"tokens": toks[:, a:]},
                                       caches, start_pos=a)
        else:
            lg, caches = model.prefill(c["params"], dict(batch, tokens=toks),
                                       caches)
        logits.append(lg)
        tok = lg.argmax(-1)
        tokens = [tok]
        for i in range(STEPS):
            lg, caches = model.decode_step(c["params"], tok, c["pos"] + i,
                                           caches)
            logits.append(lg)
            tok = lg.argmax(-1)
            tokens.append(tok)
    return logits, tokens


def _ref(c, sizes):
    """The reference's prefill and decode steps on the same weights; for
    deepseek-moe on one batch shard, on a one-device mesh (one MoE group,
    as the sharded side routes it)."""
    jcfg = jconfigs.get_smoke(c["arch"]).replace(dtype="float32",
                                                 **c["cfg"])
    mesh = jmesh() if jcfg.is_moe and sizes["data"] == 1 else None
    jm = jbuild(jcfg, mesh, q_block=8)
    jp = jax.tree.map(jnp.asarray, c["np"])
    cache = jm.init_cache(c["batch"]["tokens"].shape[0], MAX_SEQ,
                          jnp.float32)
    batch = {k: jnp.asarray(v) for k, v in c["np_batch"].items()}
    prefill, decode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    logits = []
    if c["tail"]:
        a = c["tail"]
        lg, cache = prefill(jp, {"tokens": batch["tokens"][:, :a]}, cache)
        logits.append(np.asarray(lg))
        lg, cache = prefill(jp, {"tokens": batch["tokens"][:, a:]}, cache,
                            start_pos=jnp.int32(a))
    else:
        lg, cache = prefill(jp, batch, cache)
    logits.append(np.asarray(lg))
    tok = jnp.argmax(lg, -1).astype(jnp.int32)
    tokens = [np.asarray(tok)]
    pos = jnp.asarray(c["pos"].numpy().astype(np.int32))
    for i in range(STEPS):
        lg, cache = decode(jp, tok, pos + i, cache)
        logits.append(np.asarray(lg))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
        tokens.append(np.asarray(tok))
    return logits, tokens


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_serve_matches_unsharded_port_and_reference(tmp_path, mesh):
    sizes = MESHES[mesh]
    cases = {name: _case(arch, tail, seed)
             for seed, (name, (arch, tail)) in enumerate(CASES.items())}
    # the layouts the cases exercise on this mesh
    split = {name: cell_rules(tconfigs.get_smoke(c["arch"]), B, sizes)
             .get("kv_seq") for name, c in cases.items()}
    assert split["granite-20b"] == "model"
    assert split["qwen3-32b"] == ("model" if sizes["model"] == 4 else None)
    assert split["gemma3-27b"] is None
    _serve_and_compare(tmp_path, sizes, cases, mesh)


def _serve_and_compare(tmp_path, sizes, cases, mesh):
    """Serve ``cases`` through the sharded step on one spawn of the mesh's
    ranks and hold every call against the unsharded port and the
    reference; returns the ranks' results."""
    paths = {}
    for name, c in cases.items():
        paths[name] = str(tmp_path / f"{name}.pt")
        torch.save({k: v for k, v in c.items()
                    if k not in ("np", "np_batch")}, paths[name])
    world = sizes.get("pod", 1) * sizes["data"] * sizes["model"]
    res = spawn("serve_tp", world, tmp_path, dict(sizes, cases=paths))
    for name, c in cases.items():
        want, want_tok = _port(c, sizes)
        ref, ref_tok = _ref(c, sizes)
        got = [torch.zeros_like(w) for w in want]
        got_tok = [torch.zeros_like(t) for t in want_tok]
        for rank in res:
            r = rank[name]
            for g, x in zip(got + got_tok, r["logits"] + r["tokens"]):
                g[r["rows"]] = x
        for i, (g, w, j) in enumerate(zip(got, want, ref)):
            scale = w.abs().max().item()
            np.testing.assert_allclose(
                g.numpy(), w.numpy(), rtol=0, atol=1e-5 * scale,
                err_msg=f"{name} on {mesh}: call {i} against the port")
            np.testing.assert_allclose(
                g.numpy(), j, **TOL,
                err_msg=f"{name} on {mesh}: call {i} against the reference")
        for i, (g, w, j) in enumerate(zip(got_tok, want_tok, ref_tok)):
            assert torch.equal(g, w), (name, mesh, i)
            assert np.array_equal(g.numpy(), j), (name, mesh, i)
    return res


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_recurrent_serve_matches_unsharded_port_and_reference(
        tmp_path, mesh):
    """The recurrent families (``RECURRENT``) through the sharded serve
    step, their compute split over ``model``: the whole-vocabulary logits
    against the unsharded port (1e-5 of max|logit|) and the reference
    (rtol and atol 1e-4), the greedy tokens equal on all three; and each
    rank's state blocks split as the ``cache_axes`` say."""
    sizes = MESHES[mesh]
    n = sizes["model"]
    cases = {name: _case(arch, None, 10 + seed, replace)
             for seed, (name, (arch, replace)) in enumerate(RECURRENT.items())}
    assert cell_rules(tconfigs.get_smoke("zamba2-1.2b"), B, sizes) == {}
    assert cell_rules(tconfigs.get_smoke("whisper-small").replace(**HEADS3),
                      B, sizes) == {"kv_seq": "model"}
    res = _serve_and_compare(tmp_path, sizes, cases, mesh)
    rows = B // sizes["data"]
    shapes = res[0]
    # xlstm smoke: C [L, B, NH, dh, dh] over its 4 heads, the conv state's
    # inner channels (256) and the sLSTM state's heads (which the
    # recurrence gathers)
    assert shapes["xlstm-1.3b"]["cache_shapes"][:3] == [
        (2, rows, 4 // n, 64, 64), (2, rows, 4 // n, 64),
        (2, rows, 3, 256 // n)]
    assert shapes["xlstm-1.3b"]["cache_shapes"][3] == (rows, 4 // n, 32)
    # zamba2 smoke: S over the 16 Mamba2 heads, the conv state over x|B|C
    # (288 channels, blocks that cross x/B/C), KV over the 8 KV heads
    assert shapes["zamba2-1.2b"]["cache_shapes"][:3] == [
        (4, rows, 16 // n, 16, 16), (4, rows, 3, 288 // n),
        (rows, MAX_SEQ, 8 // n, 16)]
    # 3 heads: the state whole over heads, the KV caches over sequence
    assert shapes["zamba2-1.2b-h3"]["cache_shapes"][:3] == [
        (4, rows, 3, 16, 64), (4, rows, 3, 224 // n),
        (rows, MAX_SEQ // n, 3, 64)]
    assert shapes["whisper-small-h3"]["cache_shapes"][0] == (
        2, rows, MAX_SEQ // n, 3, 16)


def test_batch_of_one_splits_the_cache_over_pod_and_data(tmp_path):
    """zamba2 smoke at a batch of one on pod 2 x data 2 (long_500k's
    layout, ``cell_rules``: ``kv_seq`` over ``("pod", "data")``): each
    rank holds 8 of the 32 positions of every shared-attention cache, the
    decode steps combine the four blocks' partial softmaxes over one group
    of the four ranks (``Sharder.kv_split`` on a DeviceMesh), and the
    logits and tokens agree with the unsharded port and the reference."""
    sizes = {"pod": 2, "data": 2, "model": 1}
    assert cell_rules(tconfigs.get_smoke("zamba2-1.2b"), 1, sizes) == {
        "batch": None, "kv_seq": ("pod", "data")}
    cases = {"zamba2-1.2b-b1": _case("zamba2-1.2b", None, 20, rows=1)}
    res = _serve_and_compare(tmp_path, sizes, cases, "pod2-data2")
    for rank in res:
        assert rank["zamba2-1.2b-b1"]["cache_shapes"][2] == (1, 8, 8, 16)


class _StackedRanks(comm.ShapeGroup):
    """``size`` ranks in one process: dim 0 of each tensor is the rank,
    and a sum or a max over the group is one over dim 0 that every rank
    receives."""

    def __init__(self, size):
        self.size, self.axes, self.crosses_pod = size, ("model",), False

    def all_reduce(self, t):
        return t.copy_(t.sum(0, keepdim=True).expand_as(t))

    def all_reduce_max(self, t):
        return t.copy_(t.amax(0, keepdim=True).expand_as(t))


def test_softmax_combine_of_16_blocks_equals_unsplit_attention():
    """16 blocks of 8 keys each: every block's ``partial_attention``
    joined by ``comm.softmax_combine`` equals ``attention_scores`` over
    all 128 keys (f32, within 1e-6 of max|o|). The mask leaves whole
    blocks without a valid key for some rows (a row's keys all in the
    first block, another's all in the last) and one row with no valid
    key at all (the unsplit softmax's mean of the values)."""
    n, t = 16, 128
    g = torch.Generator().manual_seed(3)
    q = torch.randn(3, 4, 8, 16, generator=g)
    k = torch.randn(3, t, 2, 16, generator=g)
    v = torch.randn(3, t, 2, 16, generator=g)
    kp = torch.arange(t)
    mask = torch.rand(3, 4, t, generator=g) < 0.5
    mask[0, 1] = kp < 5                       # the first block only
    mask[1, 2] = kp >= t - 3                  # the last block only
    mask[2, 3] = False                        # no valid key anywhere
    want = common.attention_scores(q, k, v, mask)
    blk = t // n
    parts = [common.partial_attention(q, k[:, r * blk:(r + 1) * blk],
                                      v[:, r * blk:(r + 1) * blk],
                                      mask[..., r * blk:(r + 1) * blk])
             for r in range(n)]
    m, l, o = (torch.stack(x) for x in zip(*parts))
    assert (m[1:, 0, 1] == common.NEG_INF).all()
    got = comm.softmax_combine(m, l, o, _StackedRanks(n))
    assert torch.isfinite(got).all()
    for r in range(n):
        np.testing.assert_allclose(got[r].numpy(), want.numpy(), rtol=0,
                                   atol=1e-6 * want.abs().max().item())
    # on a stand-in mesh the combine counts a max and one sum of l and o
    meta = [x[0].to("meta") for x in (m, l, o)]
    with op_cost.OpCounter() as counter:
        comm.softmax_combine(*meta, RankMesh({"model": n}).world)
    assert sorted(counter.collectives) == sorted([
        ("all-reduce", m[0].numel() * 4, n, False),
        ("all-reduce", o[0].numel() // 16 * 17 * 4, n, False)])


def test_sharded_serve_step_at_one_rank_is_the_model(tmp_path):
    """On a one-rank mesh every split is a no-op: the sharded prefill and
    decode equal the model's own bit for bit."""
    _one_rank_is_the_model(tmp_path, "granite-20b")


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "zamba2-1.2b",
                                  "whisper-small"])
def test_sharded_recurrent_serve_step_at_one_rank_is_the_model(tmp_path,
                                                               arch):
    """The recurrent families' sharded steps, their compute split over a
    ``model`` axis of one rank, equal the model's own bit for bit (as
    ``chip_smoke.py`` holds zamba2-1.2b's on one NCCL rank)."""
    _one_rank_is_the_model(tmp_path, arch)


def _one_rank_is_the_model(tmp_path, arch):
    c = _case(arch, None, 0)
    want, _ = _port(c, {"data": 1, "model": 1})
    with one_rank(tmp_path):
        mesh = make_host_mesh()
        cfg = tconfigs.get_smoke(arch).replace(dtype="float32")
        model = tbuild(cfg, mesh, shd_rules=cell_rules(cfg, B, mesh))
        step = ShardedServeStep(model, mesh, B, MAX_SEQ)
        params = step.layout(c["params"])
        caches = step.layout_cache(model.init_cache(B, MAX_SEQ,
                                                    torch.float32, "cpu"))
        batch = dict(c["batch"], tokens=c["batch"]["tokens"].long())
        with torch.no_grad():
            lg, caches = step.prefill(params, batch, caches)
            got = [lg]
            tok = lg.argmax(-1)
            for i in range(STEPS):
                lg, caches = step.decode(params, tok, c["pos"] + i, caches)
                got.append(lg)
                tok = lg.argmax(-1)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
