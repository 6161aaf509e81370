"""Quickstart: build an assigned architecture (reduced config), train a few
steps on synthetic data, and serve a batch of requests with the trained
weights.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Runs on the CUDA card unless ``--device cpu`` asks for the host.
"""
import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.device import resolve_device
from repro_torch.core.tracing import counting_call
from repro_torch.data.pipeline import (DataConfig, SyntheticTokens,
                                       batch_to_device)
from repro_torch.models import build_model
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train.optimizer import (OptConfig, init_opt_state,
                                         tree_leaves, tree_map)
from repro_torch.train.step import StepConfig, TrainState, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="the CUDA card by default; 'cpu' runs on the host")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = configs.get_smoke("granite-20b")
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = model.init(gen, dev, dtype=torch.float32)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"model: {cfg.name}  params={n_params/1e6:.1f}M")

    # --- train a few steps ---
    state = TrainState(params, init_opt_state(params))
    step = counting_call(
        make_train_step(model, OptConfig(lr=3e-3, warmup_steps=5),
                        StepConfig()), "quickstart_train_step")
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                      global_batch=4))
    losses = []
    for i in range(10):
        state, metrics = step(state, batch_to_device(data.batch(i), dev))
        if i % 3 == 0:
            # dalek: allow[host-sync] demo prints the loss every 3rd step
            losses.append(float(metrics["loss"]))
            print(f"  step {i}: loss={losses[-1]:.4f}")

    # --- serve with the trained weights: detached (serving takes no
    # gradient, so each flash call goes straight to the kernel), and f32
    # (the layers cast each weight to the compute dtype where they use it)
    serve_params = tree_map(torch.Tensor.detach, state.params)
    engine = ServeEngine(model, serve_params, batch_size=4, max_seq=96)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, 8).astype(np.int32),
                    max_new_tokens=8) for i in range(3)]
    stats = engine.serve(reqs)
    print(f"served 3 requests: {stats['tokens_decoded']} tokens, "
          f"{stats['decode_tok_per_s']:.1f} tok/s, "
          f"energy_by_tag={ {k: round(v,2) for k,v in stats['energy_by_tag'].items()} }")
    for r in reqs:
        print(f"  req {r.req_id}: {r.output}")
    return losses, reqs


if __name__ == "__main__":
    main()
