"""One rank of a multi-process test of the port's parallel layer, and the
parent's helpers to start them.

    python tests/torch_dist_worker.py TASK RANK WORLD STORE OUT ARGS_JSON

Joins a ``gloo`` process group of WORLD ranks on the ``file://`` STORE,
runs TASK with the JSON arguments and writes what the parent compares to
OUT/RANK.pt. Module-level imports are torch, numpy and the standard
library only: a rank never imports JAX (the parent computes the reference
side).
"""
import contextlib
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

HERE = pathlib.Path(__file__).resolve().parent
SRC = HERE.parent / "src"
TIMEOUT_S = 120


def spawn(task, world, tmp_path, args, timeout=TIMEOUT_S):
    """Run TASK on WORLD ranks, one process each, and return each rank's
    result. A rank that fails, or a group that outlives ``timeout`` (a
    deadlock), fails the caller with the ranks' output; every process is
    gone when this returns."""
    out = pathlib.Path(tmp_path) / f"{task}-{world}"
    out.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "torch_dist_worker.py"), task, str(r),
         str(world), str(out / "store"), str(out), json.dumps(args)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        logs = [p.communicate(timeout=max(deadline - time.monotonic(), 1))[0]
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, f"ranks {bad} failed:\n" + "\n".join(
        logs[r][-3000:] for r in bad)
    return [torch.load(out / f"{r}.pt") for r in range(world)]


@contextlib.contextmanager
def one_rank(tmp_path, backend="gloo"):
    """A one-rank process group in this process (``file://`` store in
    ``tmp_path``), torn down on exit."""
    import torch.distributed as dist
    dist.init_process_group(backend, init_method=f"file://{tmp_path}/store1",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh(args):
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh(data=args.get("data", 1),
                          model=args.get("model", 1),
                          pod=args.get("pod", 1))


def train(args):
    """``args["steps"]`` sharded train steps from the seeded state on a
    global batch from a numpy seed, in ``args["layout"]`` (``2d`` by
    default; ``fsdp``, ``ep``: ``launch.dryrun.layout_rules``); the
    losses, grad norms, each step's gathered gradients and gathered
    parameters after it, and the rank's blocks."""
    from repro_torch import configs
    from repro_torch.launch.dryrun import layout_rules
    from repro_torch.models import build_model
    from repro_torch.parallel.sharding import mesh_shape
    from repro_torch.train.optimizer import (OptConfig, init_opt_state,
                                             tree_map)
    from repro_torch.train.step import (ShardedTrainStep, StepConfig,
                                        TrainState)
    mesh = _mesh(args)
    layout = args.get("layout", "2d")
    rules = layout_rules(layout, mesh_shape(mesh))
    cfg = configs.get_smoke(args["arch"]).replace(dtype="float32")
    kw = {"moe_impl": "shard_map"} if layout == "ep" else {}
    model = build_model(cfg, mesh, shd_rules=rules, **kw)
    params = model.init(torch.Generator().manual_seed(0), "cpu",
                        dtype=torch.float32)
    state = TrainState(params, init_opt_state(params))
    step = ShardedTrainStep(model, OptConfig(**args["opt"]),
                            StepConfig(num_microbatches=args["micro"]),
                            mesh, rules)
    state = step.layout(state)
    rng = np.random.default_rng(args["seed"])
    tokens = rng.integers(0, cfg.vocab_size, tuple(args["batch"]))
    batch = {"tokens": torch.from_numpy(tokens.astype(np.int32))}
    batch["labels"] = torch.roll(batch["tokens"], -1, dims=1)
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (args["batch"][0], cfg.enc_seq, cfg.d_model)).astype(np.float32))
    losses, norms, grads, fulls = [], [], [], []
    lay = step.shardings.params
    for _ in range(args["steps"]):
        loss, g = step.grads(state, batch)
        grads.append(tree_map(lambda b, sh: sh.gather(b).clone(), g, lay))
        state, metrics = step.apply(state, loss, g)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        fulls.append(tree_map(torch.Tensor.clone, step.gather(state).params))
    return {"loss": losses, "grad_norm": norms, "grads": grads,
            "fulls": fulls, "blocks": state.params,
            "coords": lay["final_norm"].coords()}


def moe_ep(args):
    """Expert parallelism on the mesh: the rank's rows of a global x
    through ``moe_apply_shard_map``; y, aux and the summed gradients of a
    loss whose ranks' parts add up to ``sum(y * r)``."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.models import moe
    from repro_torch.parallel.sharding import NamedSharding, Sharder
    mesh = _mesh(args)
    cfg = configs.get_smoke("deepseek-moe-16b").replace(
        capacity_factor=args["capacity_factor"], dtype="float32")
    p = torch.load(args["params"])
    x_full, r_full = torch.load(args["inputs"])
    shd = Sharder(mesh)
    rows = NamedSharding(mesh, shd.spec(("batch",), (x_full.shape[0],)))
    x, r = rows.block(x_full), rows.block(r_full)
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()
              if k != "shared"}
    with shd.rank_batch(shd.batch_axes(x_full.shape[0])):
        y, aux = moe.moe_apply(x, dict(p, **leaves), cfg, shd,
                               impl="shard_map")
    loss = (y * r).sum() / rows.replicas
    grads = torch.autograd.grad(loss, list(leaves.values()))
    for g in grads:
        dist.all_reduce(g)
    return {"y": y.detach(), "aux": aux.detach(), "coords": rows.coords(),
            "grads": dict(zip(leaves, grads))}


def collectives(args):
    """Each collective that carries a gradient, over the world group, on
    the rank's slice of inputs from a numpy seed: its output and the
    gradient of ``sum(out * cotangent)`` (the rank's cotangent slice;
    an all-gather's is its reduce-scatter, along dim 1 and dim 0)."""
    from repro_torch.parallel import comm
    import torch.distributed as dist
    rank, n = dist.get_rank(), dist.get_world_size()
    rng = np.random.default_rng(args["seed"])
    shapes = {"all_gather": ((3, 2), (3, 2 * n)),
              "all_gather_0": ((2, 3), (2 * n, 3)),
              "all_reduce_sum": ((2, 3), (2, 3))}
    ops = {"all_gather": lambda x: comm.all_gather(x, None, dim=1),
           "all_gather_0": lambda x: comm.all_gather(x, None, dim=0),
           "all_reduce_sum": comm.all_reduce_sum}
    out = {}
    for name, (xs, ys) in shapes.items():
        x_all = torch.from_numpy(rng.normal(size=(n,) + xs))
        c_all = torch.from_numpy(rng.normal(size=(n,) + ys))
        x = x_all[rank].clone().requires_grad_()
        y = ops[name](x)
        (g,) = torch.autograd.grad((y * c_all[rank]).sum(), [x])
        out[name] = (x_all, c_all, y.detach(), g)
    return out


def serve_tp(args):
    """The sharded serve step (``serve.step.ShardedServeStep``, the
    reference dry-run's ``serve_rules`` for the case's batch on the mesh)
    for each case file of ``args["cases"]``: a prefill of the global
    batch (with ``tail``, of its first ``tail`` tokens and then of the
    rest at ``start_pos``), then ``steps`` greedy decode steps at the
    per-row positions ``pos`` + i (a case's ``cfg``: fields of the smoke
    config replaced). Returns per case the rank's rows, the
    whole-vocabulary logits of those rows from each call, the greedy
    tokens and the shapes of the rank's cache blocks."""
    from repro_torch import configs
    from repro_torch.models import build_model
    from repro_torch.serve.step import ShardedServeStep, cell_rules
    mesh = _mesh(args)
    out = {}
    for name, path in args["cases"].items():
        c = torch.load(path)
        cfg = configs.get_smoke(c["arch"]).replace(dtype="float32",
                                                   **c.get("cfg", {}))
        b = c["batch"]["tokens"].shape[0]
        model = build_model(cfg, mesh, shd_rules=cell_rules(cfg, b, mesh))
        step = ShardedServeStep(model, mesh, b, c["max_seq"])
        params = step.layout(c["params"])
        caches = step.layout_cache(model.init_cache(
            b, c["max_seq"], torch.float32, "cpu"))
        batch = {k: step.rows(v) for k, v in c["batch"].items()}
        logits = []
        with torch.no_grad():
            if c.get("tail"):
                a = c["tail"]
                lg, caches = step.prefill(
                    params, {"tokens": batch["tokens"][:, :a]}, caches)
                logits.append(step.whole_logits(lg))
                lg, caches = step.prefill(
                    params, {"tokens": batch["tokens"][:, a:]}, caches,
                    start_pos=a)
            else:
                lg, caches = step.prefill(params, batch, caches)
            logits.append(step.whole_logits(lg))
            tok = logits[-1].argmax(-1)
            tokens = [tok]
            pos = step.rows(c["pos"])
            for i in range(c["steps"]):
                lg, caches = step.decode(params, tok, pos + i, caches)
                logits.append(step.whole_logits(lg))
                tok = logits[-1].argmax(-1)
                tokens.append(tok)
        out[name] = {"rows": step.rows(torch.arange(b)), "logits": logits,
                     "tokens": tokens, "cache_shapes": [
                         tuple(t.shape) for t in _tensors(caches)]}
    return out


def _tensors(tree):
    """The tensors of a dict/tuple tree, in order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    return [tree]


def compress(args):
    """``compressed_psum_pod`` and two steps of ``compress_grads_over_pod``
    (error feedback carried) on the rank's gradients from a numpy seed."""
    from repro_torch.parallel import compress as tcomp
    mesh = _mesh(args)
    rng = np.random.default_rng(args["seed"] + 100 * mesh.get_rank())
    flat = torch.from_numpy(rng.normal(size=args["n"]).astype(np.float32))
    out = {"flat": flat, "psum": tcomp.compressed_psum_pod(
        flat, mesh.get_group("pod"))}
    err = None
    for i in range(2):
        grads = {"b": torch.from_numpy(rng.normal(size=(3, 100)).astype(
            np.float32)), "a": torch.from_numpy(rng.normal(
                size=(7, 61)).astype(np.float32))}
        red, err = tcomp.compress_grads_over_pod(grads, mesh, err)
        out[f"grads{i}"], out[f"red{i}"], out[f"err{i}"] = grads, red, err
    return out


def main(argv):
    task, rank, world, store, out, args = argv
    torch.set_num_threads(1)
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=int(rank), world_size=int(world))
    try:
        result = {"train": train, "moe_ep": moe_ep, "compress": compress,
                  "collectives": collectives,
                  "serve_tp": serve_tp}[task](json.loads(args))
        torch.save(result, pathlib.Path(out) / f"{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
