"""The paged steps' two layouts of the pool, timed side by side (card only).

"whole": the step gathers every layer's view of the rows it serves
before the model runs and scatters them back after it (``paged_gather``,
``paged_scatter_block`` / ``paged_scatter_slot``), a copy of the batch's
whole cache beside the pool. "layers": the serve's step
(``serve.step.make_paged_decode_step`` / ``make_paged_slot_prefill``),
which gathers and scatters one layer at a time (``common.PagedLayers``),
one layer's views beside the pool. Each model at its published width and
depth, bf16 weights from ``--seed``, the 512-position serve's shapes: a
decode step of 4 rows at position 200 and a cold 256-token prefill into
one row, blocks of 32. The two layouts' logits and pools must be equal;
each is timed in the order whole, layers, layers, whole: the wall of one
synchronised call (median of ``--iters``), and the kernels of one call
and their summed device time (``torch.profiler`` over 3 calls).

Run: ``PYTHONPATH=src python -m repro_torch.benchmarks.paged_steps``
(~2 min with the defaults).
"""
from __future__ import annotations

import argparse
import statistics
import time

import torch

from repro_torch.benchmarks.common import kernel_events

BATCH, MAX_SEQ, BLOCK, POS, PROMPT = 4, 512, 32, 200, 256


def whole_decode(model):
    """The decode step gathering every layer's views at once."""
    from repro_torch.models.common import paged_gather, paged_scatter_block

    def step(params, tokens, pos, tables, pool):
        view = paged_gather(pool, tables)
        logits, view = model.decode_step(params, tokens, pos, view)
        paged_scatter_block(pool, view, tables, pos)
        return logits
    return step


def whole_prefill(model):
    """The bucketed slot prefill gathering every layer's view at once."""
    from repro_torch.models.common import (mask_cache_tail, paged_gather,
                                           paged_scatter_slot)

    def step(params, tokens, true_len, start_pos, table_row, pool):
        sub = paged_gather(pool, table_row[None, :])
        logits, sub = model.prefill(params, {"tokens": tokens}, sub,
                                    true_len=true_len, start_pos=start_pos)
        mask_cache_tail(sub, start_pos + true_len)
        paged_scatter_slot(pool, sub, table_row)
        return logits
    return step


def layers_decode(model):
    from repro_torch.serve.step import make_paged_decode_step
    step = make_paged_decode_step(model)
    return lambda *a: step(*a)[1]


def layers_prefill(model):
    from repro_torch.serve.step import make_paged_slot_prefill
    step = make_paged_slot_prefill(model, bucketed=True)
    return lambda *a: step(*a)[1]


def measure(fn, iters):
    """(median wall ms of a synchronised call, device-busy ms a call,
    kernels a call); the last two None where the profiler lost records."""
    walls = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    events, ok = kernel_events(fn, 3)
    if not ok:
        return statistics.median(walls), None, None
    return (statistics.median(walls), sum(us for _, us in events) / 3e3,
            len(events) / 3)


def run_model(arch, seed, iters):
    from repro_torch import configs
    from repro_torch.models import build_model
    cfg = configs.get(arch)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = model.init(gen, "cuda")
    nb = MAX_SEQ // BLOCK
    pool = model.init_cache(BATCH * nb + 1, BLOCK, device="cuda")
    for c in pool:
        c.normal_(generator=gen)
    tables = torch.arange(1, BATCH * nb + 1, dtype=torch.int32,
                          device="cuda").reshape(BATCH, nb)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, 1), generator=gen,
                           device="cuda", dtype=torch.int32)
    pos = torch.full((BATCH,), POS, dtype=torch.int32, device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (1, PROMPT), generator=gen,
                           device="cuda", dtype=torch.int32)
    steps = {
        "decode": ((whole_decode(model), layers_decode(model)),
                   (tokens, pos, tables)),
        "prefill": ((whole_prefill(model), layers_prefill(model)),
                    (prompt, PROMPT, 0, tables[1])),
    }
    with torch.no_grad():
        for kind, ((whole, layers), args) in steps.items():
            outs = []
            for fn in (whole, layers):
                p = tuple(c.clone() for c in pool)
                outs.append((fn(params, *args, p), p))
            (lw, pw), (ll, pl) = outs
            equal = torch.equal(lw, ll) and all(
                torch.equal(a, b) for a, b in zip(pw, pl))
            del outs, pw, pl
            print(f"{arch} {kind}: logits and pool equal {equal}",
                  flush=True)
            if not equal:
                raise AssertionError(f"{arch} {kind}: the layouts differ")
            for name, fn in (("whole", whole), ("layers", layers),
                             ("layers", layers), ("whole", whole)):
                wall, dev, kernels = measure(
                    lambda: fn(params, *args, pool), iters)
                print(f"{arch} {kind} {name}: wall {wall:.3f} ms, device "
                      f"busy {dev} ms, kernels {kernels}", flush=True)
    del params, pool
    torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-20b,deepseek-moe-16b")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("paged_steps: no CUDA device")
    print(f"{torch.cuda.get_device_name(0)}; batch {BATCH} x {MAX_SEQ}, "
          f"block {BLOCK}: decode at position {POS}, a cold {PROMPT}-token "
          f"prefill", flush=True)
    for arch in args.arch.split(","):
        run_model(arch, args.seed, args.iters)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
