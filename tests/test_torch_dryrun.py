"""The port's dry-run against the reference's compiled cells, its per-rank
bytes against the blocks a 2-rank gloo run cuts, and the depth cuts
PERF.md §4 made by hand, sized on the meta device.

Reference side: a granite-20b smoke cell at 2 layers in f32, compiled on
one CPU device (``jax.jit(...).lower(...).compile()``, as the reference's
dry-run does on its mesh): a train step (batch 8 x 32 in 2 microbatches)
and a prefill (batch 2 x 64, bf16 weights and caches). Port side: the
same cell through ``launch.dryrun.build_cell`` on a one-device mesh,
counted on the meta device.

- argument bytes: equal to ``memory_analysis().argument_size_in_bytes``
  exactly (the same leaves in the same dtypes);
- FLOPs against ``repro.perf.hlo_cost.analyze_text``: within 1 % on the
  prefill cell (the same dots: projections, attention over the cache,
  the MLP and the last token's logits), within 5 % on the train cell,
  whose one named difference is the flash backward's recompute: the
  reference differentiates XLA's attention, which keeps its softmax for
  the backward; the port's kernel keeps none, so ``attention_grads``
  recomputes QKᵀ and PV (``4·B·H·S·T·D`` a layer a microbatch) before
  the 8·B·H·S·T·D of the backward proper. The test counts that term and
  holds the rest equal to 1e-6;
- per device: the same train cell lowered under ``state_specs`` on a data
  2 x model 2 mesh of host devices (a subprocess with
  ``--xla_force_host_platform_device_count=4``: the reference's own tests
  cannot set it in-process), its per-device FLOPs against one rank's count
  on a data 2 x model 2 ``RankMesh``: within 5 %. Named differences: the
  flash backward's recompute (the rank's heads and rows), and the KV
  projections of MQA's one KV head, which every ``model`` rank computes
  for its query heads (XLA partitions part of that work): the rest of the
  port's count exceeds the reference's by less than that term.

The serve cells run the sharded serve step (``ShardedServeStep``):
granite-20b's prefill_32k and decode_32k fit a rank of the single mesh
with peaks in a stated band, and their per-rank FLOPs are 1/16 of the
same cell computed replicated over ``model`` (a data 16 x model 1 mesh:
the rank's rows with every head), to within the MQA key and value
projections and the lookups every rank repeats. A block cut from a
tensor owns exactly its bytes (a leading-dim slice was a view of the
whole storage), so zamba2-1.2b's decode_32k peaks within a few GB of its
argument bytes. deepseek-moe-16b's train_4k cell in the ``2d`` layout
computes only the rank's experts.
"""
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import ShapeConfig as JShape
from repro.models import abstract_params as jabstract
from repro.models import build_model as jbuild
from repro.models import token_batch_specs as jbatch
from repro.perf import hlo_cost
from repro.serve.step import abstract_cache as jcache
from repro.train import optimizer as jopt
from repro.train.step import StepConfig as JStepConfig
from repro.train.step import TrainState as JTrainState
from repro.train.step import make_train_step as jmake_step
from repro_torch import configs as tconfigs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import RankMesh, make_production_mesh
from repro_torch.models import abstract_params, build_model
from repro_torch.parallel import comm
from repro_torch.parallel.sharding import NamedSharding, P
from repro_torch.perf import op_cost, step_analysis
from repro_torch.train.optimizer import abstract_opt_state, tree_map
from repro_torch.train.step import TrainState, param_specs, state_specs
from torch_dist_worker import spawn

ONE = {"data": 1, "model": 1}
TRAIN = ShapeConfig("train_smoke", "train", 32, 8)
PREFILL = ShapeConfig("prefill_smoke", "prefill", 64, 2)
N_MICRO = 2


def _cfgs():
    kw = dict(num_layers=2, dtype="float32")
    return (jconfigs.get_smoke("granite-20b").replace(**kw),
            tconfigs.get_smoke("granite-20b").replace(**kw))


@pytest.fixture(scope="module")
def ref_cells():
    """(train, prefill) reference executables of the smoke cells."""
    jcfg, _ = _cfgs()
    model = jbuild(jcfg)
    params, _ = jabstract(model)
    state = JTrainState(params, jopt.abstract_opt_state(params))
    batch = jbatch(jcfg, JShape(TRAIN.name, "train", TRAIN.seq_len,
                                TRAIN.global_batch))
    step = jmake_step(model, jopt.OptConfig(),
                      JStepConfig(num_microbatches=N_MICRO))
    train = jax.jit(step, donate_argnums=(0,)).lower(state, batch).compile()

    scfg = jcfg.replace(param_dtype="bfloat16")
    smodel = jbuild(scfg)
    sparams, _ = jabstract(smodel)
    cache = jcache(smodel, PREFILL.global_batch, PREFILL.seq_len)
    sbatch = jbatch(scfg, JShape(PREFILL.name, "prefill", PREFILL.seq_len,
                                 PREFILL.global_batch))
    prefill = jax.jit(lambda p, b, c: smodel.prefill(p, b, c),
                      donate_argnums=(2,)).lower(sparams, sbatch,
                                                 cache).compile()
    return train, prefill


def _port_cell(shape):
    _, tcfg = _cfgs()
    variant = {"n_micro": N_MICRO} if shape.kind == "train" else None
    fn, args, cfg, _, info = dryrun.build_cell("granite-20b", shape, ONE,
                                               variant, tcfg)
    return fn, args, cfg, info


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_argument_bytes_equal_the_reference_executable(ref_cells, kind):
    compiled = ref_cells[0 if kind == "train" else 1]
    _, _, _, info = _port_cell(TRAIN if kind == "train" else PREFILL)
    assert info["argument_bytes"] == \
        compiled.memory_analysis().argument_size_in_bytes


def test_prefill_flops_within_1pct_of_hlo_cost(ref_cells):
    fn, args, _, _ = _port_cell(PREFILL)
    port = dryrun.count_cell(fn, args).flops
    ref = hlo_cost.analyze_text(ref_cells[1].as_text())["flops"]
    assert abs(port - ref) <= 0.01 * ref, (port, ref)


def test_train_flops_within_5pct_of_hlo_cost(ref_cells):
    fn, args, cfg, _ = _port_cell(TRAIN)
    port = dryrun.count_cell(fn, args).flops
    ref = hlo_cost.analyze_text(ref_cells[0].as_text())["flops"]
    assert abs(port - ref) <= 0.05 * ref, (port, ref)
    # the named difference: the flash backward's recompute of QKᵀ and PV
    b = TRAIN.global_batch // N_MICRO
    s = TRAIN.seq_len
    recompute = (cfg.num_layers * N_MICRO
                 * 4 * b * cfg.q_heads * s * s * cfg.head_dim)
    assert port - recompute == pytest.approx(ref, rel=1e-6)


_REF_PER_DEVICE = """
import json
import jax
from repro import configs
from repro.configs import base
from repro.launch import dryrun
from repro.launch.mesh import make_host_mesh
from repro.perf import hlo_cost
smoke = configs.get_smoke
configs.get = lambda name: smoke(name).replace(num_layers=2,
                                               dtype="float32")
dryrun.SHAPES["train_smoke"] = base.ShapeConfig("train_smoke", "train",
                                                {seq}, {batch})
fn, args, _, _, _ = dryrun.build_cell(
    "granite-20b", "train_smoke", make_host_mesh(data=2, model=2),
    {{"n_micro": {micro}}})
text = fn.lower(*args).compile().as_text()
print(json.dumps([jax.device_count(), hlo_cost.analyze_text(text)["flops"]]))
"""


def test_train_flops_per_device_within_5pct_of_hlo_cost():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(pathlib.Path(__file__).parents[1] / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _REF_PER_DEVICE.format(
            seq=TRAIN.seq_len, batch=TRAIN.global_batch, micro=N_MICRO)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    devices, ref = json.loads(proc.stdout.strip().splitlines()[-1])
    assert devices == 4
    _, tcfg = _cfgs()
    sizes = {"data": 2, "model": 2}
    fn, args, cfg, _, _ = dryrun.build_cell("granite-20b", TRAIN, sizes,
                                            {"n_micro": N_MICRO}, tcfg)
    port = dryrun.count_cell(fn, args).flops
    assert abs(port - ref) <= 0.05 * ref, (port, ref)
    # the rank's rows of a microbatch and its query heads
    b = TRAIN.global_batch // N_MICRO // sizes["data"]
    s, h = TRAIN.seq_len, cfg.q_heads // sizes["model"]
    recompute = cfg.num_layers * N_MICRO * 4 * b * h * s * s * cfg.head_dim
    # k and v of the rank's rows on each model rank: forward, recompute
    # and the backward's two products, less the rank's 1 / model share
    kv = (cfg.num_layers * N_MICRO * 4 * 2 * 2 * b * s * cfg.d_model
          * cfg.num_kv_heads * cfg.head_dim) * (1 - 1 / sizes["model"])
    assert 0 <= port - recompute - ref <= kv, (port - recompute - ref, kv)


def test_rank_bytes_from_specs_equal_the_blocks_layout_cuts(tmp_path):
    """Two gloo ranks (data 2) lay the smoke state out with
    ``ShardedTrainStep.layout``; the bytes of each rank's blocks equal
    ``step_analysis.rank_bytes`` from the specs, with no process group."""
    res = spawn("train", 2, tmp_path, {
        "arch": "granite-20b", "data": 2, "steps": 0, "micro": 1,
        "seed": 0, "batch": [4, 16], "opt": {}})
    cfg = tconfigs.get_smoke("granite-20b").replace(dtype="float32")
    sizes = {"pod": 1, "data": 2, "model": 1}
    shapes, axes = abstract_params(build_model(cfg))
    full = tree_map(lambda s: torch.empty(s, device="meta"), shapes)
    want = step_analysis.rank_bytes(sizes, param_specs(sizes, shapes, axes),
                                    full)
    full_bytes = sum(t.numel() * 4 for t in _leaves(full))
    assert want < full_bytes
    for rank in res:
        got = sum(t.numel() * t.element_size() for t in _leaves(
            rank["blocks"]))
        assert got == want
    # m and v follow their parameter: the state is three such trees and
    # the step counter
    state = TrainState(full, abstract_opt_state(full))
    assert step_analysis.rank_bytes(
        sizes, state_specs(sizes, shapes, axes), state) == 3 * want + 4


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


# the depth cuts of PERF.md §4, at the card phases' shapes: the train
# phase (batch 8 x 512, 2 microbatches), the VLM phase's forward (256
# patches + 256 tokens), the serve phase (batch 4, 512 positions), and the
# serve_long phase's decode step (batch 4 over 32768 positions) and a
# one-row 32768-token prefill
TRAIN_PHASE = ShapeConfig("train_phase", "train", 512, 8)
VLM_PHASE = ShapeConfig("vlm_phase", "prefill", 256, 1)
SERVE_PHASE = ShapeConfig("serve_phase", "prefill", 512, 4)
LONG_PHASE = ShapeConfig("long_phase", "decode", 32768, 4)
LONG_PREFILL = ShapeConfig("long_prefill", "prefill", 32768, 1)
# train_4k's sequence on the card: its 256 rows cut to 2, in 2 microbatches
TRAIN_4K_CARD = ShapeConfig("train_4k_card", "train", 4096, 2)

_COUNTS = {}


def _count(arch, layers, shape):
    """The dry-run's record of one step of ``arch`` cut to ``layers`` (None:
    whole) at ``shape`` on one device (a train cell in 2 microbatches),
    counted once a process."""
    key = (arch, layers, shape.name)
    if key not in _COUNTS:
        cfg = tconfigs.get(arch)
        if layers is not None:
            cfg = cfg.replace(num_layers=layers)
        variant = {"n_micro": 2} if shape.kind == "train" else None
        _COUNTS[key] = dryrun.analyze_cell(arch, shape, ONE, variant, cfg)[0]
    return _COUNTS[key]


@pytest.mark.parametrize("arch,layers,shape,fits", [
    ("granite-20b", None, TRAIN_PHASE, False),
    ("granite-20b", 4, TRAIN_PHASE, True),
    ("internvl2-76b", None, VLM_PHASE, False),
    ("internvl2-76b", 32, VLM_PHASE, True),
    ("deepseek-moe-16b", None, SERVE_PHASE, True),
    # whole, the dense phase's serve (65.5 and 66.7 GB of bf16 weights)
    ("qwen3-32b", None, SERVE_PHASE, True),
    ("deepseek-coder-33b", None, SERVE_PHASE, True),
    ("granite-20b", None, LONG_PHASE, True),
    ("gemma3-27b", None, LONG_PHASE, True),
    ("zamba2-1.2b", None, LONG_PHASE, True),
    # a row of 32768 positions: 74.1 GB of weights and cache before the
    # prefill's activations
    ("qwen3-32b", None, LONG_PREFILL, False),
    # the train_4k runs, at the train phase's depth cuts
    ("granite-20b", 4, TRAIN_4K_CARD, True),
    ("zamba2-1.2b", None, TRAIN_4K_CARD, True),
    ("whisper-small", None, TRAIN_4K_CARD, True),
    ("deepseek-moe-16b", 4, TRAIN_4K_CARD, True),
])
def test_the_depth_cuts_of_perf_md(arch, layers, shape, fits):
    rec = _count(arch, layers, shape)
    assert rec["fits"] is fits
    n = rec["n_params"]
    args = rec["analysis"]["memory"]["argument_bytes"]
    if shape.kind == "train":
        # f32 parameters, m and v, then full f32 gradients on top
        assert args >= 12 * n and rec["analysis"]["peak_bytes"] >= 16 * n
    else:
        assert args >= 2 * n
    assert np.isfinite(rec["roofline"]["compute_s"])


@pytest.mark.parametrize("arch,layers", [
    ("granite-20b", 4), ("zamba2-1.2b", None), ("whisper-small", None),
    ("deepseek-moe-16b", 4)])
def test_a_train_4k_card_count_holds_the_state_and_a_row_of_logits(
        arch, layers):
    """The rule behind a train run's count, not its bytes: the arguments
    hold each parameter's f32 master, m and v (12 bytes); the peak holds
    those, a full f32 gradient (16 bytes a parameter in all) and, beside
    them, one microbatch row's f32 logits over the vocabulary."""
    rec = _count(arch, layers, TRAIN_4K_CARD)
    n = rec["n_params"]
    cfg = tconfigs.get(arch)
    logits = TRAIN_4K_CARD.seq_len * cfg.vocab_size * 4
    assert rec["n_micro"] == 2
    assert rec["analysis"]["memory"]["argument_bytes"] >= 12 * n
    assert rec["analysis"]["peak_bytes"] >= 16 * n + logits


# the stand-in mesh: a rank's collectives without a process group

def test_vocab_chunks_on_a_tensor_parallel_rank():
    """qwen3-32b's train_4k cell with ``vocab_chunks=16`` on the single
    production mesh (data 16 x model 16), cut to one layer: its vocabulary
    (151936) is a multiple of 16 chunks, but a rank's block (9496) is not,
    so the rank cuts its block into 16 chunks of 593 or 594 columns. The
    chunked loss costs the plain one's FLOPs plus one recompute of the
    rank's logits (each chunk's, in the backward): the chunks cover the
    block's columns once."""
    cfg = tconfigs.get("qwen3-32b").replace(num_layers=1)
    mesh = make_production_mesh()
    (_, plain), (chunked, counter) = (
        dryrun.analyze_cell("qwen3-32b", "train_4k", mesh, v, cfg)
        for v in (None, {"vocab_chunks": 16}))
    assert chunked["fits"]
    shape = tconfigs.SHAPES["train_4k"]
    tokens = shape.global_batch * shape.seq_len // mesh.shape["data"]
    v_rank = cfg.vocab_size // mesh.shape["model"]
    assert v_rank % 16
    assert counter.flops - plain.flops == 2 * tokens * cfg.d_model * v_rank


@pytest.mark.parametrize("variant,all_to_all", [
    ({"layout": "ep"}, True), ({"layout": "fsdp"}, False),
    ({"moe_shard_map": 1}, True), (None, False)])
def test_layout_variants_run_on_a_stand_in_mesh(variant, all_to_all):
    """A smoke MoE train cell (2 layers, batch 8 x 32) on a data 2 x model
    2 stand-in mesh runs under each layout: expert parallelism's
    all-to-alls and its aux loss's mean over the world go to stand-ins."""
    cfg = tconfigs.get_smoke("deepseek-moe-16b").replace(num_layers=2)
    rec, counter = dryrun.analyze_cell("deepseek-moe-16b", TRAIN,
                                       {"data": 2, "model": 2}, variant, cfg)
    ops = {op for op, _, _, _ in counter.collectives}
    assert ("all-to-all" in ops) is all_to_all
    assert {"all-gather", "all-reduce"} <= ops
    assert counter.flops > 0 and rec["peak_gb"] > 0


def test_stand_in_collectives_take_meta_tensors_above_one_rank():
    """Above one rank a stand-in moves no data, so real tensors raise; at
    one rank each collective is the identity, as the real one is."""
    x = torch.arange(12.0).reshape(4, 3)
    group = RankMesh({"data": 2, "model": 1}).world
    fns = (comm.all_reduce, comm.all_gather, comm.all_to_all,
           comm.all_reduce_mean, comm.all_reduce_max, comm.all_reduce_sum)
    for fn in fns:
        with pytest.raises(RuntimeError, match="meta tensors only"):
            fn(x.clone(), group)
        assert fn(x.to("meta"), group).device.type == "meta"
    one = RankMesh(ONE).world
    for fn in fns:
        assert torch.equal(fn(x.clone(), one), x)
    # an all-gather's backward is the stand-in's reduce-scatter
    xm = x.to("meta").requires_grad_()
    (g,) = torch.autograd.grad(comm.all_gather(xm, group).sum(), [xm])
    assert g.shape == x.shape and g.device.type == "meta"
    xo = x.clone().requires_grad_()
    (g,) = torch.autograd.grad((comm.all_gather(xo, one) * x).sum(), [xo])
    assert torch.equal(g, x)


SIZES = {"pod": 2, "data": 2, "model": 3}


@pytest.mark.parametrize("spec", [
    P("data"), P(None, "model"), P("model", "data"),
    P(("pod", "data"), None), P(("data", "pod"), "model"),
    P(None, ("pod", "data", "model"))])
def test_gather_puts_the_blocks_back_in_rank_order(spec, monkeypatch):
    """``NamedSharding.gather`` assembles the all-gather's blocks (rank
    order: row-major over the mesh's coordinates) into the full tensor;
    ranks that hold the same block are read once."""
    mesh = RankMesh(SIZES)
    sh = NamedSharding(mesh, spec)
    full = torch.arange(12 * 12, dtype=torch.float32).reshape(12, 12)
    blocks = [sh.block(full, dict(zip(SIZES, c)))
              for c in np.ndindex(*SIZES.values())]
    monkeypatch.setattr(comm, "all_gather",
                        lambda x, group: torch.cat(blocks))
    assert torch.equal(sh.gather(blocks[0]), full)


def test_ring_bytes_of_each_collective():
    """A rank's link bytes for a result of 1200 bytes over 4 ranks: 3/4 of
    it for an all-gather or an all-to-all, twice that for an all-reduce,
    and 3/4 of the input (4 results) for a reduce-scatter."""
    assert op_cost.ring_bytes("all-gather", 1200, 4) == 900
    assert op_cost.ring_bytes("all-to-all", 1200, 4) == 900
    assert op_cost.ring_bytes("all-reduce", 1200, 4) == 1800
    assert op_cost.ring_bytes("reduce-scatter", 1200, 4) == 3600
    assert op_cost.ring_bytes("reduce-scatter", 1200, 1) == 0


def test_stand_in_gather_reports_one_all_gather():
    """On meta a gather over a 2 x 2 x 3 stand-in mesh gives the full
    shape and reports one all-gather of every rank's block."""
    sh = NamedSharding(RankMesh(SIZES), P("model", "data"))
    block = torch.empty(4, 6, device="meta")
    with op_cost.OpCounter() as counter:
        assert sh.gather(block).shape == (12, 12)
    assert dict(counter.collectives) == {
        ("all-gather", 12 * 4 * 6 * 4, 12, True): 1.0}


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("spec", [P("data"), P(None, "data"),
                                  P("data", "model")],
                         ids=["dim0", "dim1", "both"])
def test_a_block_owns_exactly_its_bytes(device, spec):
    """A [128, 64, 32] f32 tensor on a data 16 x model 4 mesh, split on
    dim 0, dim 1 or both: the block holds the spec's slice and its
    storage is its own bytes (a dim-0 slice is contiguous, but as a view
    its storage was the whole tensor's 1,048,576 bytes)."""
    sizes = {"data": 16, "model": 4}
    t = torch.arange(128 * 64 * 32, dtype=torch.float32).reshape(128, 64, 32)
    sh = NamedSharding(sizes, spec)
    coords = {"data": 3, "model": 1}
    blk = sh.block(t.to(device), coords)
    assert blk.untyped_storage().nbytes() == blk.nbytes
    assert blk.nbytes < t.nbytes
    if device == "cpu":
        assert torch.equal(blk, t[sh.block_slices(t.shape, coords)])


def test_zamba2_decode_peaks_near_its_argument_bytes():
    """zamba2-1.2b decode_32k on the single mesh: its 12 shared-attention
    KV leaves are split on dim 0 (the batch) and over their KV heads, and
    each rank's block no longer keeps the whole leaf's storage: the peak
    lies within 3 GB of the argument bytes (209.6 GB against 13.17 GB when
    it did)."""
    rec, _ = dryrun.analyze_cell("zamba2-1.2b", "decode_32k",
                                 make_production_mesh())
    args = rec["analysis"]["memory"]["argument_bytes"]
    assert 0 <= rec["analysis"]["peak_bytes"] - args <= 3e9, (
        rec["analysis"]["peak_bytes"], args)


# granite-20b's serve cells on the single mesh: the peak band (decimal GB)
# around the host count (decode 0.755, prefill 9.285)
SERVE_BANDS = {"decode_32k": (0.5, 1.5), "prefill_32k": (7.5, 11.0)}


@pytest.mark.parametrize("shape", list(SERVE_BANDS))
def test_granite_serve_cells_fit_and_split_their_compute(shape):
    """granite-20b's serve cell on the single mesh fits a rank with its
    peak in the band, and its rank's FLOPs are 1/16 of the same cell
    computed replicated over ``model`` (data 16 x model 1: the rank's
    rows, every head), up to 5 % more: the MQA key and value projections,
    which every rank computes whole, and the norms and lookups."""
    rec, counter = dryrun.analyze_cell("granite-20b", shape,
                                       make_production_mesh())
    lo, hi = SERVE_BANDS[shape]
    assert rec["fits"] and lo <= rec["peak_gb"] <= hi, rec["peak_gb"]
    _, whole = dryrun.analyze_cell("granite-20b", shape,
                                   {"data": 16, "model": 1})
    assert 1 / 16 <= counter.flops / whole.flops <= 1.05 / 16, (
        counter.flops / whole.flops)


@pytest.mark.parametrize("shape", ["decode_32k", "prefill_32k"])
def test_zamba2_serve_cells_split_their_compute(shape):
    """zamba2-1.2b's serve cell on the single mesh: its rank's FLOPs are
    1/16 of the same cell computed replicated over ``model`` (data 16 x
    model 1), up to 1 % more: the chunks' C B^T products of the Mamba2
    layers, which every rank computes whole (1.0038 x 1/16 at prefill on
    the host, exactly 1/16 at decode); and its peak falls below 5 GB
    (14.43 and 11.20 GB when its compute ran replicated)."""
    rec, counter = dryrun.analyze_cell("zamba2-1.2b", shape,
                                       make_production_mesh())
    assert rec["fits"] and rec["peak_gb"] < 5.0, rec["peak_gb"]
    _, whole = dryrun.analyze_cell("zamba2-1.2b", shape,
                                   {"data": 16, "model": 1})
    assert 1 / 16 <= counter.flops / whole.flops <= 1.01 / 16, (
        counter.flops / whole.flops)


def test_zamba2_long_500k_splits_its_caches_over_pod_and_data():
    """zamba2-1.2b long_500k (a batch of one): the shared-attention caches
    split over sequence on ``("pod", "data")`` and over KV heads on
    ``model``, so the rank's peak falls from 26.12 GB (every cache whole)
    to below 2 GB on both meshes."""
    for multi in (False, True):
        rec, _ = dryrun.analyze_cell("zamba2-1.2b", "long_500k",
                                     make_production_mesh(multi_pod=multi))
        assert rec["fits"] and rec["peak_gb"] < 2.0, (multi, rec["peak_gb"])


def test_moe_2d_train_cell_computes_the_ranks_experts():
    """deepseek-moe-16b train_4k in the ``2d`` layout on the single mesh:
    each rank computes its 4 of 64 experts (``experts`` over ``model``),
    so ``useful`` rises from the 0.072 of every expert computed on every
    rank to above 0.5 (0.632 on the host)."""
    rec, _ = dryrun.analyze_cell("deepseek-moe-16b", "train_4k",
                                 make_production_mesh())
    assert rec["fits"] and rec["roofline"]["useful_ratio"] > 0.5, rec[
        "roofline"]["useful_ratio"]

