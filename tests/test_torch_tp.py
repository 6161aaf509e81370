"""The sharded train step's tensor parallelism and collectives on the host.

- A layer's tensor-parallel algebra: over a ``model`` axis of 4, each
  rank's forward of a transformer layer on its blocks (its query heads,
  the KV heads they read, its MLP columns and rows) with the sums over
  the ranks left out (``_Partial``); the partial outputs summed, as the
  all-reduce sums them, against the reference's layer (``_block``) on
  the same weights from a numpy seed, in f32 within 1e-5 of max|y|.
  Cases: granite's MQA (2 query heads a rank over the one KV head),
  qwen3's KV heads chosen from 2 whole ones, gemma3's window layer (KV
  heads split), and 12 query heads over 6 KV heads (3 a rank: one KV head
  a query head).
- The collectives of tensor parallelism that carry a gradient
  (``comm``: the all-gather along dim 1 and dim 0, whose backward is the
  reduce-scatter, and ``all_reduce_sum``, Megatron's ``f`` and ``g`` at
  once) on 2 and 4 gloo ranks: the output and the gradient of
  ``sum(out * cotangent)`` exactly (f64, sums of at most 4 terms) against
  numpy.
- The blocks: the sharded step on a data 2 x model 2 stand-in mesh
  (``RankMesh``, meta tensors) in each layout never makes a tensor of a
  whole stacked parameter leaf whose spec splits it, nor its gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jconfigs
from repro.models import build_model as jbuild
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_numpy
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import RankMesh
from repro_torch.models import abstract_params, common
from repro_torch.models import build_model as tbuild
from repro_torch.models.transformer import (_dense_layer_axes,
                                            _dense_layer_shapes)
from repro_torch.parallel.sharding import (NamedSharding, TensorParallel,
                                           tree_specs)
from repro_torch.train.optimizer import (OptConfig, abstract_opt_state,
                                         tree_map)
from repro_torch.train.step import ShardedTrainStep, StepConfig, TrainState
from torch_dist_worker import spawn

TP = 4


class _Partial(TensorParallel):
    """Rank ``rank`` of ``size`` with its sums over the ranks left out:
    each product returns the rank's partial output."""

    def sum(self, x):
        return x


def _numpy_weights(spec, rng):
    if isinstance(spec, dict):
        return {k: _numpy_weights(v, rng) for k, v in spec.items()}
    shape, fan_in = spec
    if fan_in is None:
        # the norm scales: small, not zero, so that they count
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)
    return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)


def tp_layer(cfg, p, x, positions, is_global, size):
    """The layer's output from ``size`` ranks' partial outputs, summed
    where the all-reduce sums them: the attention's, then the MLP's."""
    sizes = {"model": size}
    specs = tree_specs(sizes, _dense_layer_axes(cfg, ()), p)
    blocks = [tree_map(lambda t, s: NamedSharding(sizes, s).block(
        t, {"model": r}), p, specs) for r in range(size)]
    xn = common.rms_norm(x, p["norm1"])
    h = sum(common.attention(xn, b["attn"], cfg, positions=positions,
                             is_global=is_global,
                             tp=_Partial(None, size, r))[0]
            for r, b in enumerate(blocks))
    x = x + h
    xn = common.rms_norm(x, p["norm2"])
    return x + sum(common.mlp(xn, b["mlp"], _Partial(None, size, r),
                              cfg.d_ff) for r, b in enumerate(blocks))


@pytest.mark.parametrize("arch,over,is_global,kv", [
    ("granite-20b", {}, True, "slice"),
    ("qwen3-32b", {}, True, "slice"),
    ("gemma3-27b", {}, False, "split"),
    ("granite-20b", {"num_heads": 12, "num_kv_heads": 6}, True, "list")],
    ids=["granite-mqa", "qwen3-kv-choice", "gemma3-window", "kv-per-head"])
def test_tp_layer_partials_sum_to_the_reference_layer(arch, over, is_global,
                                                      kv):
    kw = dict(over, dtype="float32")
    jcfg = jconfigs.get_smoke(arch).replace(**kw)
    cfg = tconfigs.get_smoke(arch).replace(**kw)
    rng = np.random.default_rng(11)
    p = _numpy_weights(_dense_layer_shapes(cfg, (), cfg.d_ff), rng)
    s = 48                                  # past gemma3's 32-token window
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    h_local = cfg.q_heads // TP
    if kv == "split":
        assert cfg.num_kv_heads % TP == 0
    else:
        sel = common.rank_kv_heads(cfg, _Partial(None, TP, 1), h_local)
        assert isinstance(sel, list) is (kv == "list")
    got = tp_layer(cfg, params_from_numpy(p, "cpu"), torch.from_numpy(x),
                   torch.arange(s), is_global, TP)
    jm = jbuild(jcfg, q_block=8)
    want, _, _ = jm._block(jnp.asarray(x), jax.tree.map(jnp.asarray, p),
                           positions=jnp.arange(s), is_global=is_global)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_and_their_gradients_on_gloo_ranks(tmp_path, world):
    res = spawn("collectives", world, tmp_path, {"seed": 5})
    for r, rank in enumerate(res):
        for name, (x, c, y, g) in rank.items():
            x, c = x.numpy(), c.numpy()
            n = x.shape[0]
            if name == "all_gather":
                m = x.shape[2]
                want_y = np.concatenate(list(x), axis=1)
                want_g = c.sum(0)[:, r * m:(r + 1) * m]
            elif name == "all_gather_0":
                m = x.shape[1]
                want_y = np.concatenate(list(x), axis=0)
                want_g = c.sum(0)[r * m:(r + 1) * m]
            else:
                want_y, want_g = x.sum(0), c.sum(0)
            np.testing.assert_allclose(y.numpy(), want_y, rtol=1e-12,
                                       err_msg=f"{name} out, rank {r}")
            np.testing.assert_allclose(g.numpy(), want_g, rtol=1e-12,
                                       err_msg=f"{name} grad, rank {r}")


class _Shapes(TorchDispatchMode):
    """The shape of every tensor an op makes."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.seen.add(tuple(t.shape))
        return out


@pytest.mark.parametrize("arch,layout", [
    ("granite-20b", "2d"), ("deepseek-moe-16b", "2d"),
    ("granite-20b", "fsdp"), ("deepseek-moe-16b", "ep"),
    ("zamba2-1.2b", "2d"), ("xlstm-1.3b", "2d")])
def test_no_rank_holds_a_whole_stacked_leaf(arch, layout):
    sizes = {"data": 2, "model": 2}
    mesh = RankMesh(sizes)
    rules = dryrun.layout_rules(layout, sizes)
    cfg = tconfigs.get_smoke(arch).replace(dtype="float32")
    model = tbuild(cfg, mesh, shd_rules=rules,
                   **({"moe_impl": "shard_map"} if layout == "ep" else {}))
    step = ShardedTrainStep(model, OptConfig(), StepConfig(
        num_microbatches=2), mesh, rules)
    shapes, axes = abstract_params(model)
    params = tree_map(lambda s: torch.empty(s, device="meta"), shapes)
    state = step.layout(TrainState(params, abstract_opt_state(params)))
    tokens = torch.empty((8, 16), dtype=torch.int32, device="meta")
    whole = []

    def stacked(shape, ax, sh):
        if ax and ax[0] == "layers" and sh.shards > 1:
            whole.append(tuple(shape))
    tree_map(stacked, shapes, axes, step.shardings.params)
    assert whole
    with _Shapes() as seen:
        step(state, {"tokens": tokens, "labels": tokens})
    assert not set(whole) & seen.seen, set(whole) & seen.seen
