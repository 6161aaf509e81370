"""End-to-end training driver for the PyTorch port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-20b \
        --smoke --steps 100 --batch 8 --seq 256 [--device cpu]

--smoke uses the reduced same-family config (CPU-runnable). Runs on the
CUDA card unless ``--device cpu`` asks for the host. ``--mesh-data`` and
``--mesh-model`` above 1 shard the train state over a ("pod", "data",
"model") mesh of one rank per process, launched by torchrun:

    python -m torch.distributed.run --standalone --nproc_per_node 2 \
        -m repro_torch.launch.train --smoke --device cpu --mesh-data 2

(gloo on the host, NCCL on the cards, one card a rank). Every rank builds
the same seeded state and keeps its blocks (``ShardedTrainStep``); rank 0
prints, writes the logs and the checkpoints (full leaves), and J/token
counts the global batch's tokens. Integrates checkpointing (atomic,
resumable), ``repro_torch.telemetry`` energy monitoring (J/token, per-tag
attribution), and the energy-aware loop.
"""
from __future__ import annotations

import argparse
import json
import os

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.core.device import resolve_device
from repro_torch.core.tracing import TraceStats, counting_call
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model
from repro_torch.obs import MetricsRegistry, Tracer, write_chrome_trace
from repro_torch.train import loop as loop_mod
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.step import (ShardedTrainStep, StepConfig,
                                    TrainState, make_train_step)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-20b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device: the CUDA card by default; 'cpu' "
                         "runs on the host")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--power-cap-w", type=float, default=None)
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--log-json", default=None)
    ap.add_argument("--trace-out", default=None,
                    help="write a Perfetto/chrome-trace timeline JSON of "
                         "the run (train_step/checkpoint spans with "
                         "per-span attributed joules)")
    ap.add_argument("--metrics-json", default=None,
                    help="write the metrics-registry snapshot "
                         "(deterministic JSON)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    n_ranks = args.mesh_data * args.mesh_model
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if n_ranks != world:
        raise ValueError(f"mesh data {args.mesh_data} x model "
                         f"{args.mesh_model} needs {n_ranks} ranks; "
                         f"WORLD_SIZE is {world} (launch with torchrun "
                         f"--nproc_per_node {n_ranks})")
    mesh = None
    if n_ranks > 1:
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
        mesh = make_host_mesh(data=args.mesh_data, model=args.mesh_model)
    rank0 = mesh is None or dist.get_rank() == 0

    model = build_model(cfg, mesh)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    # f32 master parameters (the reference's param_dtype); the layers
    # compute in cfg.dtype
    params = model.init(gen, device, dtype=torch.float32)
    state = TrainState(params, init_opt_state(params))

    opt_cfg = OptConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                        total_steps=args.steps)
    step_cfg = StepConfig(num_microbatches=args.micro)
    layout = None
    if mesh is not None:
        layout = ShardedTrainStep(model, opt_cfg, step_cfg, mesh)
        state = layout.layout(state)
        step_fn = layout
    else:
        step_fn = make_train_step(model, opt_cfg, step_cfg)
    # counting_call: one "compile" per new abstract signature, where the
    # reference's counting_jit traces — a fixed-shape run counts one
    trace_stats = TraceStats()
    train_step = counting_call(step_fn, "train_step", trace_stats)

    data = SyntheticTokens(
        DataConfig(seed=0, vocab_size=cfg.vocab_size, seq_len=args.seq,
                   global_batch=args.batch), cfg)
    loop_cfg = loop_mod.LoopConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir, power_cap_w=args.power_cap_w,
        n_chips=n_ranks)

    def on_step(rec):
        if rank0 and (rec["step"] % 10 == 0 or rec["step"] == 1):
            print(f"step {rec['step']:5d} loss {rec['loss']:.4f} "
                  f"gnorm {rec['grad_norm']:.3f} {rec['wall_s']*1e3:.0f}ms "
                  f"E={rec['energy_j']:.1f}J")

    tracer = Tracer() if args.trace_out else None
    registry = MetricsRegistry()
    state, history, summary = loop_mod.run(
        train_step, state, data, loop_cfg, device=device, on_step=on_step,
        tracer=tracer, metrics_registry=registry, layout=layout)
    session = summary.pop("session", None)   # live object, not JSON
    summary["train_step_compiles"] = trace_stats.compiles("train_step")
    if mesh is not None:
        dist.destroy_process_group()
    if not rank0:
        return history
    print(f"final loss {history[-1]['loss']:.4f}  "
          f"J/token {summary['j_per_token']:.4f}  "
          f"avg {summary['avg_power_w']:.1f} W  "
          f"tags {list(summary['energy_by_tag'])}  "
          f"train_step_compiles {summary['train_step_compiles']}")
    if args.trace_out and tracer is not None:
        write_chrome_trace(args.trace_out, tracer, session=session,
                           meta={"process": "dalek-train",
                                 "arch": cfg.name, "steps": args.steps})
        print(f"timeline -> {args.trace_out}")
    if args.metrics_json:
        registry.write_json(args.metrics_json)
        print(f"metrics -> {args.metrics_json}")
    if args.log_json:
        with open(args.log_json, "w") as f:
            json.dump({"history": history, "summary": summary}, f, default=float)
    return history


if __name__ == "__main__":
    main()
