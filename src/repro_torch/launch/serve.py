"""Serving driver for the PyTorch port.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-20b \
        --smoke --requests 6 --max-new 16 --power-cap 150

Serves synthetic prompts through the continuous engine (request queue, slot
recycling, paged KV with radix prefix sharing, energy-aware admission) with
per-request energy attribution from the ``repro_torch.telemetry`` tag bus
and a typed ``EnergyReport`` summary. Runs on the CUDA card unless
``--device cpu`` asks for the host.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.device import resolve_device
from repro_torch.models import build_model
from repro_torch.models.registry import serving_caps
from repro_torch.serve.engine import ContinuousEngine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-20b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device: the CUDA card by default; 'cpu' "
                         "runs on the host")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--power-cap", type=float, default=None,
                    help="node power cap in W")
    ap.add_argument("--prefill-buckets", default="auto",
                    help="prompt-length bucketing: 'auto' (power-of-two "
                         "edges, bounded prefill signatures), 'off' (exact "
                         "lengths), or explicit comma-separated edges like "
                         "'8,16,32'")
    ap.add_argument("--kv-block-size", default="auto",
                    help="paged KV cache block size: 'auto' (largest "
                         "power-of-two <= 32 dividing max-seq) or an "
                         "explicit size dividing max-seq")
    ap.add_argument("--prefix-cache", default="auto",
                    choices=["auto", "on", "off"],
                    help="radix prefix cache over prompt blocks: shared "
                         "prompt prefixes prefill once")
    ap.add_argument("--metrics-json", default=None,
                    help="write the engine metrics-registry snapshot "
                         "(deterministic JSON)")
    args = ap.parse_args(argv)
    buckets = (args.prefill_buckets
               if args.prefill_buckets in ("auto", "off")
               else [int(b) for b in args.prefill_buckets.split(",")])
    kv_block = (args.kv_block_size if args.kv_block_size == "auto"
                else int(args.kv_block_size))

    device = resolve_device(args.device)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    use_prefix = (serving_caps(cfg).prefix_cache
                  if args.prefix_cache == "auto"
                  else args.prefix_cache == "on")

    model = build_model(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = model.init(gen, device)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size,
                                    args.prompt_len).astype(np.int32),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]

    engine = ContinuousEngine(model, params, batch_size=args.batch,
                              max_seq=args.max_seq,
                              power_cap_w=args.power_cap,
                              prefill_buckets=buckets,
                              kv_block_size=kv_block,
                              prefix_cache=use_prefix)
    stats = engine.serve(reqs)

    print(f"arch={cfg.name} engine=continuous device={device} "
          f"adapter={stats['adapter']} family={cfg.family} "
          f"reqs={args.requests} "
          f"prefill={stats['prefill_s']*1e3:.0f}ms "
          f"decode={stats['decode_s']*1e3:.0f}ms "
          f"({stats['decode_tok_per_s']:.1f} tok/s)")
    print(f"compiles: prefill={stats['prefill_compiles']} "
          f"decode={stats['decode_compiles']} "
          f"buckets={list(engine.buckets) if engine.buckets else 'off'}")
    pc = stats.get("prefix_cache")
    pc_str = (f" prefix-cache hit-rate={pc['hit_rate']:.0%} "
              f"cached-tokens={pc['cached_tokens']}" if pc else "")
    print(f"paged-kv: block={stats['kv_block_size']} "
          f"peak-blocks={stats['kv_pages']['peak_used']}/"
          f"{stats['kv_pages']['total_blocks']}{pc_str}")
    if engine.tel is not None:
        rep = engine.tel.session.report(tokens=stats.get("tokens_decoded"))
        print(f"energy: {rep}")
    if args.metrics_json:
        engine.metrics.write_json(args.metrics_json)
        print(f"metrics -> {args.metrics_json}")
    for r in reqs:
        j_tok = r.energy_j / max(len(r.output), 1)
        print(f"  req {r.req_id}: {len(r.output)} tokens "
              f"[{r.finish_reason or 'ok'}] {r.energy_j:.2f} J "
              f"({j_tok:.3f} J/token)")
    return stats


if __name__ == "__main__":
    main()
