"""The port's parallel layer against the reference and against itself on
one process: meshes, expert parallelism, the sharded train step, the
trainer under torchrun, and the GPU-pod hardware entries.

Multi-rank cases run as spawned ``gloo`` processes
(``tests/torch_dist_worker.py``: a ``file://`` store under ``tmp_path``,
one torch thread a rank, a 120 s limit); this process computes the other
side. Everything is f32. Tolerances:

- expert parallelism at one rank against the reference's ``shard_map``
  path: y, aux and the gradients within 1e-5 of the largest magnitude
  (the same routing; the products in another layout);
- expert parallelism on 4 ranks (data 2 x model 2, capacity factor 8 so
  that no token drops on either side) against the port's grouped path on
  the same mesh shape: y within 1e-5, gradients within 1e-4 of max;
- the sharded train step on 4 ranks against the one-process step on the
  same mesh shape (its MoE groups follow the same batch spec): loss and
  grad norm within 1e-5 relative, each step's gathered gradients within
  1e-5 of the largest |gradient| (the sums run in another order) against
  the one-process trajectory's and against the one-process gradients at
  the rank's parameters before the step (xlstm and zamba2, whose
  recurrences amplify AdamW's lr-sized differences, hold the trajectory
  in their lr 1e-4 cases only), the gathered parameters within
  1e-5 of the largest |parameter| where no product is split over
  ``model``, each rank's blocks exactly the spec's slices of them;
- the sharded step at one rank against the reference's jitted step with
  ``shardings(mesh, state_specs(...))`` on ``make_host_mesh()``: the rule
  of ``tests/test_torch_train.py`` (losses and grad norms 1e-4 relative;
  parameters all but 1e-4 of the elements within 2e-5, every one within
  twice the summed learning rate).
"""
import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import configs as jconfigs
from repro.launch.mesh import make_host_mesh as jmesh
from repro.models import build_model as jbuild
from repro.models import moe as jmoe
from repro.parallel.sharding import Sharder as JSharder
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_numpy
from repro_torch.cluster import topology
from repro_torch.core import hw
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as ttrain
from repro_torch.models import abstract_params
from repro_torch.models import build_model as tbuild
from repro_torch.models import moe as tmoe
from repro_torch.parallel.sharding import NamedSharding, Sharder
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep
from torch_dist_worker import SRC, one_rank, spawn
from torch_weights import model_tree, numpy_tree

OPT = dict(lr=1e-2)
# the 4-rank mesh's shape, for the one-process side
HOST4 = tmesh.AbstractMesh(("pod", "data", "model"), (1, 2, 2))


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().float().numpy()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


# ---------------------------------------------------------------------------
# meshes


def test_make_host_mesh_needs_a_process_group_of_its_size(tmp_path):
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        tmesh.make_host_mesh()
    with one_rank(tmp_path):
        mesh = tmesh.make_host_mesh()
        assert mesh.mesh_dim_names == ("pod", "data", "model")
        assert tuple(mesh.shape) == (1, 1, 1)
        assert mesh.device_type == "cpu"
        with pytest.raises(ValueError, match="has 1"):
            tmesh.make_host_mesh(data=2)
        assert Sharder(mesh).local
        assert Sharder(mesh).batch_axes(5) == ("pod", "data")


# ---------------------------------------------------------------------------
# expert parallelism


def _moe_setup(capacity_factor=None):
    jcfg = jconfigs.get_smoke("deepseek-moe-16b").replace(dtype="float32")
    tcfg = tconfigs.get_smoke("deepseek-moe-16b").replace(dtype="float32")
    if capacity_factor is not None:
        jcfg = jcfg.replace(capacity_factor=capacity_factor)
        tcfg = tcfg.replace(capacity_factor=capacity_factor)
    p = numpy_tree(tmoe.moe_param_shapes(tcfg, 1), 0, unstack=True)
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(4, 16, jcfg.d_model)) * 0.3).astype(np.float32)
    r = rng.normal(size=x.shape).astype(np.float32)
    return jcfg, tcfg, p, x, r


GRAD_LEAVES = ("router", "w_gate", "w_up", "w_down")


@pytest.mark.parametrize("capacity_factor", [None, 8.0],
                         ids=["published", "no-drops"])
def test_expert_parallel_at_one_rank_matches_reference(tmp_path,
                                                       capacity_factor):
    """``moe_apply_shard_map`` on a one-rank mesh against the reference's
    ``moe_apply(..., impl="shard_map")`` on ``make_host_mesh()``: y, aux and
    the gradients of ``sum(y * r) + aux`` (with the published capacity
    factor the one group drops tokens, alike on both sides)."""
    jcfg, tcfg, p, x, r = _moe_setup(capacity_factor)
    mesh = jmesh()
    shd = JSharder(mesh)

    def jloss(params):
        y, aux = jmoe.moe_apply(x, params, jcfg, shd, impl="shard_map")
        return (y * r).sum() + aux, (y, aux)

    (_, (jy, jaux)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jax.numpy.asarray, p))
    with one_rank(tmp_path):
        tp = params_from_numpy(p, "cpu")
        leaves = [tp[k].requires_grad_() for k in GRAD_LEAVES]
        y, aux = tmoe.moe_apply(torch.from_numpy(x), tp, tcfg,
                                Sharder(tmesh.make_host_mesh()),
                                impl="shard_map")
        grads = torch.autograd.grad((y * torch.from_numpy(r)).sum() + aux,
                                    leaves)
    scale = float(np.abs(np.asarray(jy)).max())
    np.testing.assert_allclose(_np(y), np.asarray(jy), rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-5)
    for k, g in zip(GRAD_LEAVES, grads):
        w = np.asarray(jg[k])
        np.testing.assert_allclose(_np(g), w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=k)


def test_expert_parallel_on_four_ranks_matches_grouped_path(tmp_path):
    """data 2 x model 2: each rank routes its quarter of the tokens, the
    buffers cross the model pairs by all-to-all, and the gradients come
    back through both all-to-alls and the all-gather; against the port's
    grouped path on the same mesh shape in one process."""
    _, tcfg, p, x, r = _moe_setup(8.0)
    tp = params_from_numpy(p, "cpu")
    torch.save(tp, tmp_path / "params.pt")
    torch.save((torch.from_numpy(x), torch.from_numpy(r)),
               tmp_path / "inputs.pt")
    res = spawn("moe_ep", 4, tmp_path, {
        "data": 2, "model": 2, "capacity_factor": 8.0,
        "params": str(tmp_path / "params.pt"),
        "inputs": str(tmp_path / "inputs.pt")})
    leaves = [tp[k].requires_grad_() for k in GRAD_LEAVES]
    shd = Sharder(HOST4)
    y, _ = tmoe.moe_apply(torch.from_numpy(x), tp, tcfg, shd)
    grads = torch.autograd.grad((y * torch.from_numpy(r)).sum(), leaves)
    scale = float(y.detach().abs().max())
    for rank in res:
        d = rank["coords"]["data"]
        np.testing.assert_allclose(_np(rank["y"]), _np(y[2 * d:2 * d + 2]),
                                   rtol=0, atol=1e-5 * scale)
        assert np.isfinite(float(rank["aux"]))
        for k, g in zip(GRAD_LEAVES, grads):
            np.testing.assert_allclose(
                _np(rank["grads"][k]), _np(g), rtol=0,
                atol=1e-4 * float(g.abs().max()), err_msg=k)
    # each model rank ran two of the four experts: the gradients of all
    # four are there only because the ranks' partial ones were summed
    assert all(float(g.abs().amax(dim=(1, 2)).min()) > 0
               for g in grads[1:])


# ---------------------------------------------------------------------------
# the sharded train step


def _batch(cfg, shape, seed=0):
    """Tokens and labels from a numpy seed (whisper's frames after them,
    as ``torch_dist_worker.train`` draws them)."""
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape).astype(
        np.int32))
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (shape[0], cfg.enc_seq, cfg.d_model)).astype(np.float32))
    return batch


def _four_rank_case(arch, layout, lr=OPT["lr"]):
    name = f"{arch}-{layout}" + ("" if lr == OPT["lr"] else f"-lr{lr:g}")
    return pytest.param(arch, layout, lr, id=name)


@pytest.mark.parametrize("arch,layout,lr", [
    _four_rank_case("granite-20b", "2d"), _four_rank_case("qwen3-32b", "2d"),
    _four_rank_case("gemma3-27b", "2d"),
    _four_rank_case("deepseek-moe-16b", "2d"),
    _four_rank_case("zamba2-1.2b", "2d"),
    _four_rank_case("granite-20b", "fsdp"),
    _four_rank_case("deepseek-moe-16b", "ep"),
    _four_rank_case("xlstm-1.3b", "2d"),
    _four_rank_case("whisper-small", "2d"),
    _four_rank_case("zamba2-1.2b", "2d", 1e-4),
    _four_rank_case("xlstm-1.3b", "2d", 1e-4)])
def test_sharded_step_on_four_ranks_matches_one_process(tmp_path, arch,
                                                        layout, lr):
    """data 2 x model 2, batch 8 x 16 from numpy seed 0 in 2 microbatches,
    2 steps (the reference's ``tests/test_distributed.py`` set), in the
    ``2d`` layout (tensor parallelism over ``model``: MQA granite and
    qwen3's KV heads, gemma3's window layers, the MoE model's attention
    and shared experts; zamba2's Mamba2 heads and inner channels, its
    shared attention and MLP; xlstm's mLSTM heads, row-parallel
    projections and sLSTM FFN; whisper's heads and MLPs, with frames) and
    in ``fsdp`` and ``ep`` (``model`` splits the batch)."""
    opt_args = dict(OPT, lr=lr)
    args = {"arch": arch, "data": 2, "model": 2, "steps": 2, "micro": 2,
            "seed": 0, "batch": [8, 16], "opt": opt_args, "layout": layout}
    res = spawn("train", 4, tmp_path, args)
    cfg = tconfigs.get_smoke(arch).replace(dtype="float32")
    amesh = HOST4
    rules = dryrun.layout_rules(layout, amesh.shape)
    model = tbuild(cfg, amesh, shd_rules=rules,
                   **({"moe_impl": "shard_map"} if layout == "ep" else {}))
    params = model.init(torch.Generator().manual_seed(0), "cpu",
                        dtype=torch.float32)
    state = tstep.TrainState(params, topt.init_opt_state(params))
    grad_fn = tstep.make_grad_fn(model, tstep.StepConfig(num_microbatches=2))
    batch = _batch(cfg, (8, 16))
    init = topt.tree_map(torch.Tensor.clone, state.params)
    want, want_grads = [], []
    for _ in range(2):
        loss, g = grad_fn(state.params, batch)
        want_grads.append(topt.tree_map(torch.Tensor.clone, g))
        params, opt, m = topt.adamw_update(topt.OptConfig(**opt_args),
                                           state.params, g, state.opt)
        state = tstep.TrainState(params, opt)
        want.append((float(loss), float(m["grad_norm"])))
    pmax = max(float(p.abs().max()) for p in topt.tree_leaves(state.params))
    specs = dict(_leaves(tstep.state_specs(
        amesh, *abstract_params(model), rules).params))
    # with a product split over model its partial sums round otherwise
    # than the one-process product, and AdamW's first steps turn rounding
    # in a near-zero gradient element (|g| ~ eps) into lr-sized
    # differences. So each step's update is held on its own as well: the
    # one-process AdamW applied to the rank's gathered parameters before
    # the step and its gathered gradients (the moments carried) against
    # the rank's gathered parameters after it, within 1e-5 of the step's
    # largest change plus 2 f32 ulps of the parameter (a sum of squares
    # in another order may move the clip's scale by one ulp). It holds
    # the clip's norm and each leaf's replica count in the block-aware
    # update. Each step's gradients are held twice, within 1e-5 of
    # max|g|: against the one-process trajectory's gradients, and against
    # the one-process gradients at the rank's gathered parameters before
    # the step (at step 0 the same initial parameters). Where xlstm's or
    # zamba2's products are split over model, the trajectories part by
    # those lr-sized differences and the recurrences amplify them: at the
    # test's lr 1e-2, step 1 reads 1.0e-5 of max|g| on zamba2 and 4.3e-5
    # on xlstm against the trajectory, 3.4e-6 and 3.0e-6 at lr 1e-4. So
    # those two hold the trajectory's gradients in their lr 1e-4 cases,
    # and the rank's own parameters' in every case.
    split = layout == "2d" and bool(model.shd.tp_axes)
    recurrent = cfg.family in ("ssm", "hybrid")
    checks = [want_grads] if not split or not recurrent \
        or lr < OPT["lr"] else []
    checks.append([want_grads[0]] + [
        grad_fn(topt.tree_map(torch.Tensor.clone, before), batch)[1]
        for before in res[0]["fulls"][:-1]])
    n_split = 0
    for rank in res:
        got = list(zip(rank["loss"], rank["grad_norm"]))
        np.testing.assert_allclose(got, want, rtol=1e-5)
        for a, b in zip(rank["fulls"], res[0]["fulls"]):
            assert all(torch.equal(x, y) for x, y in zip(
                topt.tree_leaves(a), topt.tree_leaves(b)))
        for held in checks:
            for got_g, want_g in zip(rank["grads"], held):
                gmax = max(float(g.abs().max())
                           for g in topt.tree_leaves(want_g))
                got_g = dict(_leaves(got_g))
                for name, w in _leaves(want_g):
                    np.testing.assert_allclose(
                        _np(got_g[name]), _np(w), rtol=0, atol=1e-5 * gmax,
                        err_msg=name)
        before, opt = init, topt.init_opt_state(init)
        for i, (g, after) in enumerate(zip(rank["grads"], rank["fulls"])):
            p, opt, m = topt.adamw_update(
                topt.OptConfig(**opt_args),
                topt.tree_map(torch.Tensor.clone, before),
                topt.tree_map(torch.Tensor.clone, g), opt)
            assert float(m["grad_norm"]) == pytest.approx(
                rank["grad_norm"][i], rel=1e-5)
            b = {k: _np(v).astype(np.float64) for k, v in _leaves(before)}
            want_d = {k: _np(v) - b[k] for k, v in _leaves(p)}
            dmax = max(float(np.abs(d).max()) for d in want_d.values())
            for name, a in _leaves(after):
                err = np.abs(_np(a) - b[name] - want_d[name])
                tol = 1e-5 * dmax + 2 * np.spacing(
                    np.abs(b[name]).astype(np.float32))
                assert (err <= tol).all(), (
                    f"step {i} update {name}: {float((err - tol).max())} "
                    "over")
            before = after
        full = dict(_leaves(rank["fulls"][-1]))
        if not split:
            for name, w in _leaves(state.params):
                np.testing.assert_allclose(_np(full[name]), _np(w), rtol=0,
                                           atol=1e-5 * pmax, err_msg=name)
        for name, blk in _leaves(rank["blocks"]):
            sh = NamedSharding(amesh, specs[name])
            assert torch.equal(blk, sh.block(full[name], rank["coords"]))
            n_split += blk.numel() < full[name].numel()
    assert n_split > 0           # FSDP's layout: the ranks hold blocks


def test_sharded_step_at_one_rank_matches_reference(tmp_path):
    """deepseek-moe smoke in f32 on a one-device mesh: the reference routes
    in ONE group there (its batch spec), not in ``gcd(B, 32)``; the port's
    step on ``make_host_mesh()`` must do the same."""
    jcfg = jconfigs.get_smoke("deepseek-moe-16b").replace(dtype="float32")
    tcfg = tconfigs.get_smoke("deepseek-moe-16b").replace(dtype="float32")
    p = model_tree(tcfg, 1)
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    mesh = jmesh()
    jm = jbuild(jcfg, mesh, q_block=8)
    _, axes = jm.init(None)
    jp = jax.tree.map(jax.numpy.asarray, p)
    jst = jstep.TrainState(jp, jopt.init_opt_state(jp))
    ssh = jstep.shardings(mesh, jstep.state_specs(mesh, jp, axes))
    jfn = jax.jit(jstep.make_train_step(jm, jopt.OptConfig(**opt),
                                        jstep.StepConfig(num_microbatches=2)),
                  in_shardings=(ssh, None))
    batches = [_batch(tcfg, (4, 16), seed=i) for i in range(3)]
    with one_rank(tmp_path):
        tmesh_ = tmesh.make_host_mesh()
        tm = tbuild(tcfg, tmesh_)
        tfn = tstep.ShardedTrainStep(tm, topt.OptConfig(**opt),
                                     tstep.StepConfig(num_microbatches=2),
                                     tmesh_)
        tp = params_from_numpy(p, "cpu")
        tst = tfn.layout(tstep.TrainState(tp, topt.init_opt_state(tp)))
        for i, b in enumerate(batches):
            jst, jmet = jfn(jst, {k: v.numpy() for k, v in b.items()})
            tst, tmet = tfn(tst, b)
            for k in ("loss", "grad_norm", "lr"):
                np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                           rtol=1e-4, err_msg=f"{i} {k}")
    lr_sum = sum(float(topt.lr_schedule(topt.OptConfig(**opt),
                                        torch.tensor(i))) for i in (1, 2, 3))
    diffs = np.concatenate([
        np.abs(_np(g) - np.asarray(w)).ravel() for w, g in zip(
            jax.tree.leaves(jst.params), jax.tree.leaves(
                tst.params, is_leaf=lambda x: isinstance(x, torch.Tensor)))])
    assert diffs.max() <= 2 * lr_sum, diffs.max()
    assert (diffs > 2e-5).mean() <= 1e-4, (diffs > 2e-5).sum()
    # the one-device step without a mesh (gcd(B, 32) groups) drops other
    # tokens, so it is not the function the mesh step computes
    plain = tstep.make_train_step(tbuild(tcfg), topt.OptConfig(**opt),
                                  tstep.StepConfig(num_microbatches=2))
    tp = params_from_numpy(p, "cpu")
    _, m0 = plain(tstep.TrainState(tp, topt.init_opt_state(tp)), batches[0])
    assert float(m0["loss"]) != pytest.approx(
        float(jfn(jstep.TrainState(jp, jopt.init_opt_state(jp)),
                  {k: v.numpy() for k, v in batches[0].items()})[1]["loss"]),
        rel=1e-4)


def test_rank_share_weights_the_valid_tokens(tmp_path):
    """With a label mask the global loss is the mean over the global valid
    tokens: at one rank the share is 1 and the loss is the mean itself."""
    with one_rank(tmp_path):
        share = tstep.RankShare()
        xent = torch.tensor(2.5)
        mask = torch.tensor([[1.0, 0.0, 1.0]])
        assert float(share.rank_loss(xent, mask, torch.tensor(0.5))) == 3.0
        assert float(share.rank_loss(xent, torch.zeros(1, 3), 0.0)) == 0.0


# ---------------------------------------------------------------------------
# the trainer under torchrun


def _torchrun(tmp_path, n, extra):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={n}", "-m", "repro_torch.launch.train",
           "--smoke", "--device", "cpu", "--batch", "4", "--seq", "32",
           "--micro", "2", "--steps", "3"] + extra
    proc = subprocess.run(cmd, env=env, cwd=tmp_path, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def test_trainer_under_torchrun_matches_one_process_and_resumes(tmp_path):
    ckpt = tmp_path / "ckpt"
    out = _torchrun(tmp_path, 2, ["--mesh-data", "2", "--ckpt-dir",
                                  str(ckpt), "--ckpt-every", "1",
                                  "--log-json", str(tmp_path / "a.json")])
    assert out.count("final loss") == 1          # rank 0 prints
    run = json.loads((tmp_path / "a.json").read_text())
    one = ttrain.main(["--smoke", "--device", "cpu", "--batch", "4",
                       "--seq", "32", "--micro", "2", "--steps", "3"])
    # the smoke config computes in bf16, where a rank's one-row microbatch
    # rounds its products otherwise than the one process's two rows
    # (3e-5 of the first step's grad norm, 2.5e-4 of the second loss)
    np.testing.assert_allclose([r["loss"] for r in run["history"]],
                               [r["loss"] for r in one], rtol=1e-3)
    assert run["history"][0]["loss"] == pytest.approx(one[0]["loss"],
                                                      rel=1e-6)
    # J/token counts the global batch's tokens on every rank's loop
    assert run["summary"]["tokens"] == 3 * 4 * 32
    # the checkpoint holds full leaves; resuming from step 2 gives step 3
    # again, bit for bit
    final = {p.name: p.read_bytes() for p in (ckpt / "step_00000003")
             .glob("*.bin")}
    shutil.rmtree(ckpt / "step_00000003")
    _torchrun(tmp_path, 2, ["--mesh-data", "2", "--ckpt-dir", str(ckpt),
                            "--log-json", str(tmp_path / "b.json")])
    resumed = json.loads((tmp_path / "b.json").read_text())["history"]
    assert [r["step"] for r in resumed] == [3]
    assert resumed[0]["loss"] == run["history"][2]["loss"]
    again = {p.name: p.read_bytes() for p in (ckpt / "step_00000003")
             .glob("*.bin")}
    assert again == final and len(final) > 10
    manifest = json.loads((ckpt / "step_00000003" / "manifest.json")
                          .read_text())
    emb = manifest["leaves"]["params__embedding"]["shape"]
    assert emb == [tconfigs.get_smoke("granite-20b").vocab_size,
                   tconfigs.get_smoke("granite-20b").d_model]


# ---------------------------------------------------------------------------
# the GPU pod: hardware entries and topology


def test_gpu_pod_partition_and_topology():
    part = hw.gpu_pod_partition()
    assert part.n_nodes == 32 and len(part.node.devices) == 8
    assert all(d is hw.H100_SXM for d in part.node.devices)
    assert part.node.tdp_w == 10_200.0 and part.node.net_gbps == 3200.0
    assert hw.H100_NVLINK_BW == 900e9 and hw.H100_NET_BW == 50e9
    # one GPU's network share is its port: 400 Gb/s = 50 GB/s
    assert part.node.net_gbps / 8 / 8 * 1e9 == hw.H100_NET_BW
    topo = topology.gpu_topology(n_pods=2)
    assert len(topo.nodes) == 64 and set(topo.partitions) == {"pod0",
                                                              "pod1"}
    assert topology.validate_addressing(topo)
    assert topology.validate_addressing(topology.dalek_topology())
    pod0 = topo.partition_nodes("pod0")
    assert topo.bisection_gbps(pod0) == 32 * 3200.0
