"""Serving driver for the PyTorch port.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-27b \
        --smoke --requests 6 --max-new 16 --engine continuous --power-cap 150

Serves synthetic prompts through either engine — ``static`` (padded batch,
lock-step decode) or ``continuous`` (request queue, slot recycling, paged
KV with radix prefix sharing or window rings, energy-aware admission) —
with per-request energy attribution from the ``repro_torch.telemetry`` tag
bus and a typed ``EnergyReport`` summary. Runs on the CUDA card unless
``--device cpu`` asks for the host.

The engines serve on one device, as the reference's do. ``--mesh-data``
and ``--mesh-model`` above 1 run the prompts instead as one batch through
the sharded serve step (``serve.step.ShardedServeStep``, the reference
dry-run's layout of a serve cell) on a mesh of one rank a process,
launched by torchrun: a prefill, then ``--max-new`` - 1 greedy decode
steps; rank 0 prints its rows' tokens:

    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc_per_node 4 -m repro_torch.launch.serve --arch granite-20b \
        --smoke --device cpu --mesh-model 4 --requests 2
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.device import resolve_device
from repro_torch.models import build_model
from repro_torch.models.registry import serving_caps
from repro_torch.obs import write_chrome_trace
from repro_torch.serve.engine import ContinuousEngine, Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-27b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device: the CUDA card by default; 'cpu' "
                         "runs on the host")
    ap.add_argument("--engine", choices=["static", "continuous"],
                    default="continuous")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--power-cap", type=float, default=None,
                    help="node power cap in W (continuous engine only)")
    ap.add_argument("--prefill-buckets", default="auto",
                    help="prompt-length bucketing: 'auto' (power-of-two "
                         "edges, bounded prefill signatures), 'off' (exact "
                         "lengths), or explicit comma-separated edges like "
                         "'8,16,32'")
    ap.add_argument("--kv-block-size", default="auto",
                    help="paged KV cache block size (continuous engine): "
                         "'auto' (largest power-of-two <= 32 dividing "
                         "max-seq; contiguous for model families that "
                         "cannot page), 'off' (contiguous per-slot cache), "
                         "or an explicit size dividing max-seq")
    ap.add_argument("--prefix-cache", default="auto",
                    choices=["auto", "on", "off"],
                    help="radix prefix cache over prompt blocks (requires "
                         "paged KV): shared prompt prefixes prefill once; "
                         "'auto' enables it exactly when the model family "
                         "supports paged KV")
    ap.add_argument("--trace-out", default=None,
                    help="write a Perfetto/chrome-trace timeline JSON: "
                         "request-lifecycle + engine-step spans with "
                         "per-span attributed joules")
    ap.add_argument("--metrics-json", default=None,
                    help="write the engine metrics-registry snapshot "
                         "(deterministic JSON)")
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    args = ap.parse_args(argv)
    buckets = (args.prefill_buckets
               if args.prefill_buckets in ("auto", "off")
               else [int(b) for b in args.prefill_buckets.split(",")])
    kv_block = (args.kv_block_size if args.kv_block_size in ("auto", "off")
                else int(args.kv_block_size))

    device = resolve_device(args.device)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    caps = serving_caps(cfg)
    # Fail fast on flag/family combinations the engine would reject later,
    # with the flag value that fixes them.
    if args.prefix_cache == "on" and not caps.prefix_cache:
        ap.error(f"--prefix-cache on: the {cfg.family!r} family serves "
                 f"through the {caps.kind!r} adapter, which has no paged KV "
                 f"to share prefixes in (use --prefix-cache auto)")
    if isinstance(kv_block, int) and not caps.paged_kv:
        ap.error(f"--kv-block-size {kv_block}: the {cfg.family!r} family "
                 f"cannot page its cache (use --kv-block-size auto)")
    if isinstance(buckets, list) and not caps.bucketed_prefill:
        ap.error(f"--prefill-buckets {args.prefill_buckets}: the "
                 f"{cfg.family!r} family prefills chunked left-to-right, "
                 f"not right-padded to buckets (use --prefill-buckets auto)")
    if args.engine == "static" and caps.kind == "recurrent":
        ap.error(f"--engine static: the {cfg.family!r} family carries "
                 f"recurrent state, which right-padded batch prefill would "
                 f"corrupt (use --engine continuous)")
    use_prefix = (caps.prefix_cache if args.prefix_cache == "auto"
                  else args.prefix_cache == "on")
    if args.mesh_data * args.mesh_model > 1:
        if caps.needs_frames:
            ap.error(f"--mesh-model/--mesh-data: the {cfg.family!r} family "
                     "needs encoder frames, which the sharded step is not "
                     "given")
        return serve_sharded(args, cfg, device)

    model = build_model(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = model.init(gen, device)
    rng = np.random.default_rng(0)
    frames = None
    if caps.needs_frames:
        # synthetic encoder frames stand in for a log-mel front-end
        frames = [rng.standard_normal((cfg.enc_seq, cfg.d_model))
                  .astype(np.float32) for _ in range(args.requests)]
    reqs = [Request(i, rng.integers(0, cfg.vocab_size,
                                    args.prompt_len).astype(np.int32),
                    max_new_tokens=args.max_new,
                    frames=frames[i] if frames is not None else None)
            for i in range(args.requests)]

    if args.engine == "static":
        engine = ServeEngine(model, params, batch_size=args.batch,
                             max_seq=args.max_seq, prefill_buckets=buckets)
        stats = {}
        for i in range(0, len(reqs), args.batch):
            group = engine.serve(reqs[i:i + args.batch])
            for k, v in group.items():
                # compile counts are engine-lifetime cumulative, not per-call
                if isinstance(v, (int, float)) and not k.endswith("_compiles"):
                    stats[k] = stats.get(k, 0.0) + v
        stats["decode_tok_per_s"] = (stats["tokens_decoded"] /
                                     stats["decode_s"] if stats.get("decode_s")
                                     else 0.0)
        stats["energy_by_tag"] = dict(engine.tel.session.report().by_tag)
        stats["prefill_compiles"] = engine.trace_stats.compiles("prefill")
        stats["decode_compiles"] = engine.trace_stats.compiles("decode")
    else:
        engine = ContinuousEngine(model, params, batch_size=args.batch,
                                  max_seq=args.max_seq,
                                  power_cap_w=args.power_cap,
                                  prefill_buckets=buckets,
                                  kv_block_size=kv_block,
                                  prefix_cache=use_prefix)
        stats = engine.serve(reqs)

    print(f"arch={cfg.name} engine={args.engine} device={device} "
          f"adapter={stats.get('adapter', 'static')} family={cfg.family} "
          f"reqs={args.requests} "
          f"prefill={stats['prefill_s']*1e3:.0f}ms "
          f"decode={stats['decode_s']*1e3:.0f}ms "
          f"({stats['decode_tok_per_s']:.1f} tok/s)")
    print(f"compiles: prefill={stats['prefill_compiles']} "
          f"decode={stats['decode_compiles']} "
          f"buckets={list(engine.buckets) if engine.buckets else 'off'}")
    if stats.get("kv_block_size"):
        pc = stats.get("prefix_cache")
        pc_str = (f" prefix-cache hit-rate={pc['hit_rate']:.0%} "
                  f"cached-tokens={pc['cached_tokens']}" if pc else "")
        print(f"paged-kv: block={stats['kv_block_size']} "
              f"peak-blocks={stats['kv_pages']['peak_used']}/"
              f"{stats['kv_pages']['total_blocks']}{pc_str}")
    if engine.tel is not None:
        # full-session telemetry report from the unified API
        rep = engine.tel.session.report(tokens=stats.get("tokens_decoded"))
        print(f"energy: {rep}")
    if args.trace_out and engine.tracer is not None:
        write_chrome_trace(
            args.trace_out, engine.tracer,
            session=engine.tel.session if engine.tel is not None else None,
            meta={"process": "dalek-serve", "arch": cfg.name,
                  "engine": args.engine})
        print(f"timeline -> {args.trace_out}")
    if args.metrics_json:
        engine.metrics.write_json(args.metrics_json)
        print(f"metrics -> {args.metrics_json}")
    for r in reqs:
        j_tok = r.energy_j / max(len(r.output), 1)
        print(f"  req {r.req_id}: {len(r.output)} tokens "
              f"[{r.finish_reason or 'ok'}] {r.energy_j:.2f} J "
              f"({j_tok:.3f} J/token)")
    return stats


def serve_sharded(args, cfg, device):
    """``--requests`` prompts from numpy seed 0 as one batch through the
    sharded serve step on a (data, model) mesh of WORLD_SIZE ranks: a
    prefill and ``--max-new`` - 1 greedy decode steps. Returns rank 0's
    rows' tokens (None on the other ranks)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve.step import ShardedServeStep, cell_rules
    n = args.mesh_data * args.mesh_model
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if n != world:
        raise ValueError(f"mesh data {args.mesh_data} x model "
                         f"{args.mesh_model} needs {n} ranks; WORLD_SIZE is "
                         f"{world} (launch with torchrun --nproc_per_node "
                         f"{n})")
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    try:
        mesh = make_host_mesh(data=args.mesh_data, model=args.mesh_model)
        b = args.requests
        model = build_model(cfg, mesh, shd_rules=cell_rules(cfg, b, mesh))
        step = ShardedServeStep(model, mesh, b, args.max_seq)
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        params = step.layout(model.init(gen, device))
        caches = step.layout_cache(model.init_cache(b, args.max_seq,
                                                    device=device))
        rng = np.random.default_rng(0)
        prompts = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (b, args.prompt_len)).astype(np.int64))
        t0 = time.perf_counter()
        with torch.no_grad():
            lg, caches = step.prefill(
                params, {"tokens": step.rows(prompts).to(device)}, caches)
            out = [step.whole_logits(lg).argmax(-1)]
            for i in range(args.max_new - 1):
                lg, caches = step.decode(params, out[-1],
                                         args.prompt_len + i, caches)
                out.append(step.whole_logits(lg).argmax(-1))
        tokens = torch.cat(out, dim=1).cpu()
        wall = time.perf_counter() - t0
        rows = step.rows(torch.arange(b)).tolist()
        rank0 = dist.get_rank() == 0
    finally:
        dist.destroy_process_group()
    if not rank0:
        return None
    print(f"arch={cfg.name} sharded serve step on mesh data "
          f"{args.mesh_data} x model {args.mesh_model} device={device} "
          f"reqs={b} rules={cell_rules(cfg, b, mesh)} {wall * 1e3:.0f}ms")
    for r, t in zip(rows, tokens.tolist()):
        print(f"  req {r}: {t}")
    return tokens


if __name__ == "__main__":
    main()
