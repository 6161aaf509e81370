"""The port's roofline formulas, op counter and flash custom op.

- ``count_params``, ``active_params`` and ``model_flops`` equal the
  reference's exactly on all ten full configs and their shape cells (the
  reference's ``abstract_params`` against the port's shape tree);
- the flash kernel's custom op on the host: its output equals the plain
  version's bitwise, its counted FLOPs are ``4·B·H·S·T·D`` (as
  ``FlopCounterMode`` counts them too) and its bytes q, k, v and o; on the
  meta device it gives the output's shape and launches nothing;
- trip scaling: the scaled count equals the unscaled one exactly (FLOPs,
  bytes and, for the microbatches, the peak) on a microbatched train step
  and on an xlstm smoke prefill with sLSTM layers; under a gradient the
  scaled FLOPs equal the unscaled ones exactly;
- the perf driver's variants and the roofline report on a written record.
"""
import json

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as jconfigs
from repro.configs.base import SHAPES as JSHAPES
from repro.models import abstract_params as jabstract
from repro.models import build_model as jbuild
from repro.perf import roofline as jroof
from repro_torch import configs as tconfigs
from repro_torch.benchmarks import bench_roofline
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.launch import dryrun, perf
from repro_torch.models import abstract_params, build_model
from repro_torch.perf import op_cost, roofline

ONE = {"data": 1, "model": 1}


@pytest.mark.parametrize("arch", tconfigs.ARCH_NAMES)
def test_param_counts_and_model_flops_equal_the_reference(arch):
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    jparams, _ = jabstract(jbuild(jcfg))
    tshapes, _ = abstract_params(build_model(tcfg))
    n = roofline.count_params(tshapes)
    assert n == jroof.count_params(jparams)
    na = roofline.active_params(tcfg, n)
    assert na == jroof.active_params(jcfg, n)
    assert tconfigs.shape_cells(arch) == jconfigs.shape_cells(arch)
    for shape in tconfigs.shape_cells(arch):
        assert roofline.model_flops(tcfg, SHAPES[shape], na) == \
            jroof.model_flops(jcfg, JSHAPES[shape], na)
    assert list(tconfigs.all_cells()) == list(jconfigs.all_cells())


def _qkv(hkv, s=16, t=24, dtype=torch.float32):
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(2, 4, s, 32)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(2, hkv, t, 32)).astype(
        np.float32)) for _ in range(2))
    return q.to(dtype), k.to(dtype), v.to(dtype)


@pytest.mark.parametrize("causal,window,hkv,off", [
    (True, None, 4, 8), (True, 5, 4, 8), (True, None, 2, 8),
    (True, 3, 1, 0), (False, None, 1, 0)])
def test_flash_op_counts_and_matches_the_plain_version(causal, window, hkv,
                                                       off):
    q, k, v = _qkv(hkv)
    kw = dict(causal=causal, window=window, q_offset=off)
    with op_cost.OpCounter() as c:
        o = ops.flash_attention(q, k, v, **kw)
    assert torch.equal(o, ref.attention(q, k, v, **kw))
    want = 4 * 2 * 4 * 16 * 24 * 32
    assert c.flops == want
    assert c.bytes == sum(x.numel() * 4 for x in (q, k, v, o))
    assert c.by_op[("flash_fwd", 1.0)] == [want, c.bytes, 1]
    with FlopCounterMode(display=False) as fc:
        ops.flash_attention(q, k, v, **kw)
    assert fc.get_total_flops() == want


def test_flash_op_on_meta_gives_the_shape_and_launches_nothing():
    q, k, v = (x.to("meta") for x in _qkv(2, dtype=torch.bfloat16))
    before = (ops.launches, dict(ops.route_launches), ops.window_launches)
    with op_cost.OpCounter() as c:
        o = ops.flash_attention(q, k, v, window=4)
    assert o.shape == q.shape and o.dtype == q.dtype
    assert o.device.type == "meta"
    assert (ops.launches, ops.route_launches, ops.window_launches) == before
    assert c.flops == 4 * 2 * 4 * 16 * 24 * 32


def _unscaled(fn, args):
    """``dryrun.count_cell`` with every trip of every loop run."""
    counter = op_cost.OpCounter(scale_loops=False, track_memory=True)
    with counter:
        counter.track(args)
        fn(*args)
    return counter


def _train_cell(n_micro):
    cfg = tconfigs.get_smoke("granite-20b").replace(num_layers=2,
                                                   dtype="float32")
    fn, args, _, _, _ = dryrun.build_cell(
        "granite-20b", ShapeConfig("t", "train", 32, 8), ONE,
        {"n_micro": n_micro}, cfg)
    return fn, args


@pytest.mark.parametrize("n_micro", [2, 4, 8])
def test_scaled_microbatches_count_exactly(n_micro):
    """``trips`` runs microbatches 0 and 1 and counts 1 as the other
    ``n - 1``: FLOPs, bytes and the peak equal the unscaled run's."""
    fn, args = _train_cell(n_micro)
    plain = _unscaled(fn, args)
    scaled = dryrun.count_cell(fn, args)
    assert scaled.flops == plain.flops
    assert scaled.bytes == plain.bytes
    assert scaled.peak_bytes == plain.peak_bytes
    assert dict(scaled.collectives) == dict(plain.collectives)
    assert sum(n for (_, m), (_, _, n) in scaled.by_op.items() if m > 1) \
        or n_micro <= 2


def test_scaled_slstm_prefill_counts_exactly():
    """An xlstm smoke prefill (2 sLSTM layers over 64 tokens, mLSTM chunks
    of 16): ``scan`` runs trip 0 of each loop; FLOPs and bytes equal the
    unscaled run's exactly, the peak to within one trip's temporaries."""
    cfg = tconfigs.get_smoke("xlstm-1.3b")
    assert len(build_model(cfg).slstm_idx) == 2
    fn, args, _, _, _ = dryrun.build_cell(
        "xlstm-1.3b", ShapeConfig("p", "prefill", 64, 2), ONE, cfg=cfg)
    plain = _unscaled(fn, args)
    scaled = dryrun.count_cell(fn, args)
    assert scaled.flops == plain.flops
    assert scaled.bytes == plain.bytes
    assert sum(n for (_, m), (_, _, n) in scaled.by_op.items()) < \
        sum(n for (_, m), (_, _, n) in plain.by_op.items()) / 4
    assert abs(scaled.peak_bytes - plain.peak_bytes) <= 0.02 * \
        plain.peak_bytes


def test_scaled_slstm_train_counts_flops_exactly():
    """Under a gradient the sLSTM's trip 0 runs in ``core.loops._Trip``: its
    forward and backward count ``n`` times, so the FLOPs are exact."""
    cfg = tconfigs.get_smoke("xlstm-1.3b").replace(dtype="float32")
    fn, args, _, _, _ = dryrun.build_cell(
        "xlstm-1.3b", ShapeConfig("t", "train", 32, 4), ONE,
        {"n_micro": 1}, cfg)
    plain = _unscaled(fn, args)
    scaled = dryrun.count_cell(fn, args)
    assert scaled.flops == plain.flops


def test_parse_variant_and_the_refused_variants():
    assert perf.parse_variant("") == {}
    assert perf.parse_variant("layout=fsdp,n_micro=4,cast_once=1,"
                              "vocab_chunks=8,moe_shard_map=true") == {
        "layout": "fsdp", "n_micro": 4, "cast_once": True,
        "vocab_chunks": 8, "moe_shard_map": True}
    for knob in ("barrier=1", "carry_barrier=1", "scores_bf16=1"):
        with pytest.raises(ValueError, match="XLA"):
            perf.parse_variant(knob)
    with pytest.raises(ValueError, match="unknown"):
        perf.parse_variant("q_block=256")
    with pytest.raises(ValueError, match="XLA"):
        dryrun.build_cell("granite-20b", "train_4k", ONE, {"barrier": True})


def test_bench_roofline_reads_a_written_record(tmp_path, capsys):
    rl = {"compute_s": 0.5, "memory_s": 2.0, "collective_s": 0.25,
          "dominant": "memory", "useful_ratio": 0.5}
    (tmp_path / "single").mkdir()
    (tmp_path / "single" / "granite-20b__train_4k.json").write_text(
        json.dumps({"arch": "granite-20b", "shape": "train_4k",
                    "n_chips": 256, "roofline": rl,
                    "hbm_per_device_gb": 12.5, "fits": True}))
    (tmp_path / "single" / "broken.json").write_text(json.dumps(
        {"arch": "x", "shape": "train_4k", "error": "E"}))
    rows = bench_roofline.run(json_path=str(tmp_path / "rows.json"),
                              results=tmp_path).rows
    assert list(rows) == ["roofline/single/granite-20b/train_4k"]
    row = rows["roofline/single/granite-20b/train_4k"]
    assert row["us_per_call"] == pytest.approx(2.0e6)
    assert "dom=memory;roofline_frac=0.250" in row["derived"]
    assert "fits=True" in row["derived"]
    assert json.loads((tmp_path / "rows.json").read_text()) == rows
    assert "roofline/single/granite-20b/train_4k" in capsys.readouterr().out
