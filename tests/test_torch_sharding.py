"""The port's logical-axis sharding against the reference's: ``spec_for``
on many (axes, shape, rules, mesh shape) cases, ``param_specs`` and
``state_specs`` for every published config on both production mesh shapes,
``cache_specs`` with ``serve_rules`` for every shape cell, and the block
layout a spec gives a rank.

No device and no process group: a mesh here is its axis sizes (the
reference's ``spec_for`` reads only ``mesh.shape``), and the parameter and
cache trees are abstract on both sides (``abstract_params``;
``abstract_cache`` and ``init_cache(..., device="meta")``). Specs must be
equal, entry for entry.
"""
import itertools
import types

import jax
import pytest
import torch

from repro import configs as jconfigs
from repro.models import abstract_params as jabstract
from repro.models import build_model as jbuild
from repro.parallel import sharding as jshard
from repro.serve import step as jserve
from repro.train import step as jstep
from repro_torch import configs as tconfigs
from repro_torch.launch import mesh as tmesh
from repro_torch.models import abstract_params as tabstract
from repro_torch.models import build_model as tbuild
from repro_torch.parallel import sharding as tshard
from repro_torch.serve import step as tserve
from repro_torch.train import step as tstep

MESHES = {
    "single": {"data": 16, "model": 16},
    "multi": {"pod": 2, "data": 16, "model": 16},
    "host1": {"pod": 1, "data": 1, "model": 1},
    "host4": {"pod": 1, "data": 2, "model": 2},
    "pods": {"pod": 2, "data": 2, "model": 1},
    "data8": {"data": 8, "model": 1},
}

RULES = {
    "default": None,
    "serve_long": {"batch": None, "kv_seq": ("pod", "data")},
    "kv_seq_model": {"kv_seq": "model"},
    "zero3": {"embed": ("pod", "data", "model"), "vocab": None,
              "heads": None, "kv_heads": None, "mlp": None,
              "experts": None, "ssm_inner": None,
              "batch": ("pod", "data", "model")},
}

AXES = [
    ("vocab", "embed"), ("embed", "vocab"), ("norm",),
    ("layers", "embed", "heads", "head_dim"),
    ("layers", "embed", "kv_heads", "head_dim"),
    ("layers", "heads", "head_dim", "embed"),
    ("layers", "embed", "mlp"), ("layers", "mlp", "embed"),
    ("layers", "experts", "embed", "expert_mlp"),
    ("layers", "embed", "experts"), ("embed", "ssm_inner"),
    ("layers", "conv_width", "ssm_inner"), (None, "heads", None, None),
    ("batch",), ("batch", None), ("batch", "seq", "act_embed"),
    ("layers", "batch", "kv_seq", "act_kv_heads", None),
    ("batch", "kv_seq", "act_kv_heads", None),
    ("embed", "embed"), ("heads", "kv_heads"), (None, None), (),
    ("unknown_axis", "embed"),
]
SIZES = [1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 100, 128, 256, 512]


def _ref_mesh(sizes):
    return types.SimpleNamespace(shape=dict(sizes))


def _shapes(axes):
    """A few shapes for ``axes``: every dim from SIZES in turn, and None."""
    yield None
    for i, size in enumerate(SIZES):
        yield tuple(SIZES[(i + 3 * j) % len(SIZES)] for j in range(len(axes)))


@pytest.mark.parametrize("mesh,rules", list(itertools.product(MESHES, RULES)))
def test_spec_for_matches_reference(mesh, rules):
    sizes, r = MESHES[mesh], RULES[rules]
    n = 0
    for axes in AXES:
        for shape in _shapes(axes):
            want = jshard.spec_for(_ref_mesh(sizes), axes, shape, r)
            for m in (sizes, tmesh.AbstractMesh(tuple(sizes),
                                                tuple(sizes.values()))):
                got = tshard.spec_for(m, axes, shape, r)
                assert isinstance(got, tshard.PartitionSpec)
                assert tuple(got) == tuple(want), (axes, shape, got, want)
            n += 1
    assert n == sum(1 + len(SIZES) for _ in AXES)


def _flat(tree, prefix=""):
    """(path, spec as a tuple) of a spec tree of either package."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}/")
    elif hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from _flat(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tuple(tree)


def _production(kind):
    return tmesh.make_production_mesh(multi_pod=kind == "multi")


@pytest.mark.parametrize("kind", ["single", "multi"])
@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_param_and_state_specs_match_reference(arch, kind):
    """Each published config, adapted to the model axis as the dry-run
    adapts it, on the production mesh shapes: every parameter leaf's spec,
    and the state's (``m`` and ``v`` follow their parameter)."""
    mesh = _production(kind)
    jcfg = jconfigs.get(arch).adapt_for_mesh(mesh.shape["model"])
    tcfg = tconfigs.get(arch).adapt_for_mesh(mesh.shape["model"])
    jsds, jaxes = jabstract(jbuild(jcfg))
    tshapes, taxes = tabstract(tbuild(tcfg))
    assert jax.tree.map(lambda x: tuple(x.shape), jsds) == tshapes
    rm = _ref_mesh(mesh.shape)
    want = dict(_flat(jstep.param_specs(rm, jsds, jaxes)))
    got = dict(_flat(tstep.param_specs(mesh, tshapes, taxes)))
    assert got == want
    want = dict(_flat(jstep.state_specs(rm, jsds, jaxes)))
    got = dict(_flat(tstep.state_specs(mesh, tshapes, taxes)))
    assert got == want and any(v for v in got.values())


@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_cache_specs_match_reference_for_every_shape_cell(arch):
    """``serve_rules`` and ``cache_specs`` for every shape cell (batch and
    max_seq as the dry-run gives them) on both production meshes."""
    for kind, (name, shape) in itertools.product(
            ["single", "multi"], jconfigs.SHAPES.items()):
        mesh = _production(kind)
        jcfg = jconfigs.get(arch).adapt_for_mesh(mesh.shape["model"])
        tcfg = tconfigs.get(arch).adapt_for_mesh(mesh.shape["model"])
        tshape = tconfigs.base.SHAPES[name]
        assert tserve.serve_rules(tshape) == jserve.serve_rules(shape)
        rules = tserve.serve_rules(tshape)
        max_seq = shape.seq_len + (jcfg.stub_prefix_len
                                   if jcfg.family == "vlm" else 0)
        jm, tm = jbuild(jcfg), tbuild(tcfg)
        jsds = jserve.abstract_cache(jm, shape.global_batch, max_seq)
        tsds = tm.init_cache(shape.global_batch, max_seq, device="meta")
        want = dict(_flat(jserve.cache_specs(_ref_mesh(mesh.shape), jm,
                                             jsds, rules)))
        got = dict(_flat(tserve.cache_specs(mesh, tm, tsds, rules)))
        assert got == want, (kind, name)


def test_token_batch_specs_shard_the_batch_dim():
    mesh = _production("multi")
    sds = {"tokens": torch.empty((256, 4096), device="meta"),
           "frames": torch.empty((256, 1500, 768), device="meta")}
    got = tstep.batch_specs(mesh, sds)
    want = jstep.batch_specs(_ref_mesh(mesh.shape), {
        k: jax.ShapeDtypeStruct(tuple(v.shape), "float32")
        for k, v in sds.items()})
    assert {k: tuple(v) for k, v in got.items()} == {
        k: tuple(v) for k, v in want.items()}
    assert tuple(got["tokens"]) == (("pod", "data"),)


def test_production_meshes_are_abstract():
    single, multi = _production("single"), _production("multi")
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.size == 512


def test_tree_specs_walks_dicts_and_tuples():
    axes = {"a": (("layers", "batch", "kv_seq", "act_kv_heads", None),) * 2,
            "b": ("vocab", "embed")}
    shapes = {"a": ((4, 8, 64, 16, 128),) * 2, "b": (1000, 64)}
    got = tshard.tree_specs({"data": 4, "model": 4}, axes, shapes)
    want = jshard.tree_specs(_ref_mesh({"data": 4, "model": 4}), axes,
                             shapes)
    assert dict(_flat(got)) == dict(_flat(want))
    assert isinstance(got["a"], tuple) and len(got["a"]) == 2
    # without shapes nothing is dropped for divisibility
    assert tuple(tshard.tree_specs({"data": 4}, axes)["b"]) == (None,
                                                                "data")


SPLIT_CASES = [
    # spec, mesh sizes, full shape
    ((("pod", "data"), None), {"pod": 2, "data": 2, "model": 2}, (8, 3)),
    ((None, "model"), {"pod": 1, "data": 2, "model": 2}, (3, 8)),
    (("data", "model"), {"pod": 1, "data": 2, "model": 4}, (4, 8)),
    ((), {"pod": 2, "data": 1, "model": 2}, (5,)),
    ((("pod", "data", "model"),), {"pod": 2, "data": 2, "model": 2}, (16,)),
]


@pytest.mark.parametrize("spec,sizes,shape", SPLIT_CASES)
def test_named_sharding_blocks_tile_the_tensor(spec, sizes, shape):
    """Every mesh coordinate's block, split major to minor as JAX splits
    it; the distinct blocks tile the full tensor once, each held by
    ``replicas`` coordinates; the DTensor placements name the same split."""
    from torch.distributed.tensor import Replicate, Shard
    sh = tshard.NamedSharding(sizes, tshard.P(*spec))
    t = torch.arange(int(torch.tensor(shape).prod())).reshape(shape)
    seen = {}
    for coords in itertools.product(*(range(n) for n in sizes.values())):
        c = dict(zip(sizes, coords))
        blk = sh.block(t, c)
        assert sh.full_shape(blk.shape) == tuple(shape)
        seen.setdefault(tuple(blk.reshape(-1).tolist()), []).append(c)
        # the block at (pod, data) sits at index pod * |data| + data
        for i, e in enumerate(spec):
            idx = 0
            for a in tshard.spec_axes(e):
                idx = idx * sizes[a] + c[a]
            n = shape[i] // blk.shape[i]
            assert blk.reshape(-1)[0] in t.narrow(i, idx * (shape[i] // n),
                                                  shape[i] // n)
    assert len(seen) == sh.shards
    assert all(len(v) == sh.replicas for v in seen.values())
    assert sorted(x for k in seen for x in k) == t.reshape(-1).tolist()
    placements = sh.placements()
    for name, p in zip(sizes, placements):
        dims = [i for i, e in enumerate(spec) if name in tshard.spec_axes(e)]
        assert p == (Shard(dims[0]) if dims else Replicate())


def test_placements_refuse_an_order_dtensor_cannot_split():
    sh = tshard.NamedSharding({"pod": 2, "data": 2}, tshard.P(("data",
                                                               "pod")))
    with pytest.raises(ValueError, match="mesh's order"):
        sh.placements()


def test_sharder_is_the_identity_and_reads_the_batch_split():
    shd = tshard.Sharder(tmesh.AbstractMesh(("pod", "data", "model"),
                                            (2, 2, 2)))
    x = torch.ones(3)
    assert shd(x, "batch") is x and not shd.local
    assert shd.batch_axes(8) == ("pod", "data")
    assert shd.batch_axes(2) == ("pod",)            # data dropped: 2 % 4
    assert shd.batch_axes(3) == ()
    assert tuple(shd.spec(("embed", "heads"), (8, 8))) == ("data", "model")
    assert tshard.Sharder().batch_axes(8) == ()


def test_gather_over_some_axes_keeps_the_others():
    """On a pod 2 x data 2 x model 3 stand-in mesh: a dim split over
    ("pod", "data") gathers its minor axis alone (one all-gather over
    data's 2 ranks) and keeps the major one; gathering the major axis
    while keeping the minor one is refused (the blocks would not be
    contiguous)."""
    from repro_torch.perf import op_cost
    mesh = tmesh.RankMesh({"pod": 2, "data": 2, "model": 3})
    sh = tshard.NamedSharding(mesh, tshard.P(("pod", "data"), "model"))
    block = torch.empty(3, 4, device="meta")
    with op_cost.OpCounter() as counter:
        assert sh.gather(block, {"data"}).shape == (6, 4)
        assert sh.gather(block, {"data", "pod", "model"}).shape == (12, 12)
    # data (twice: both calls), then pod (crossing the pods), then model
    assert dict(counter.collectives) == {
        ("all-gather", 6 * 4 * 4, 2, False): 2.0,
        ("all-gather", 12 * 4 * 4, 2, True): 1.0,
        ("all-gather", 12 * 12 * 4, 3, False): 1.0}
    with pytest.raises(ValueError, match="keeps a minor axis"):
        sh.gather(block, {"pod"})


def test_sharder_uses_a_layers_blocks_and_splits_over_model():
    """Within ``rank_blocks`` a layer's leaves are gathered over every
    split axis but ``model`` on a tensor-parallel axis (the router whole);
    ``tp`` names the model ranks only where they do not split the batch;
    outside it, and at one rank, nothing changes."""
    mesh = tmesh.RankMesh({"data": 2, "model": 2})
    shd = tshard.Sharder(mesh, tp_axes=("heads", "mlp"),
                         tp_replicated=("router",))
    axes = {"wq": ("layers", "embed", "heads", "head_dim"),
            "router": ("layers", "embed", "experts")}
    shapes = {"wq": (3, 8, 4, 2), "router": (3, 8, 4)}
    specs = tshard.tree_specs(mesh, axes, shapes)
    blocks = {"wq": torch.empty(4, 2, 2, device="meta"),
              "router": torch.empty(4, 2, device="meta")}
    assert shd.use(blocks, "layers", stacked=True) is blocks
    assert shd.tp is None
    with shd.rank_blocks({"layers": specs}, {"layers": axes}):
        used = shd.use(blocks, "layers", stacked=True)
        assert used["wq"].shape == (8, 2, 2)         # model kept on heads
        assert used["router"].shape == (8, 4)        # gathered whole
        with shd.rank_batch(("data",)):
            tp = shd.tp
            assert (tp.size, tp.rank, tp.group.size) == (2, 0, 2)
            assert tp.group.axes == ("model",)
        with shd.rank_batch(("data", "model")):
            assert shd.tp is None
    one = tshard.Sharder(tmesh.RankMesh({"data": 1, "model": 1}),
                         tp_axes=("heads",))
    with one.rank_blocks({"layers": specs}, {"layers": axes}):
        assert one.tp is None
        wq = torch.empty(8, 4, 2)
        assert one.use({"wq": wq}, "layers", stacked=True)["wq"] is wq


def test_sharder_kv_split_names_the_ranks_of_a_cache_sequence():
    """Within ``rank_blocks`` a cache leaf's ``kv_seq`` entry names the
    ranks that split its sequence (major to minor over several axes,
    size-1 axes dropped); None outside it and where the sequence is
    whole."""
    mesh = tmesh.RankMesh({"pod": 2, "data": 4, "model": 1})
    shd = tshard.Sharder(mesh)
    long = tshard.P("layers", None, ("pod", "data", "model"), None)
    assert shd.kv_split(long) is None
    with shd.rank_blocks({}, {}):
        split = shd.kv_split(long)
        assert (split.size, split.rank) == (8, 0)
        assert split.group.axes == ("pod", "data")
        assert shd.kv_split(tshard.P(None, "data", None, "model")) is None
        assert shd.kv_split(tshard.P()) is None
