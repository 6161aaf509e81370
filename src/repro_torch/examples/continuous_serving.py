"""Continuous-batching serving with per-request energy attribution.

Submits a burst of mixed-length requests to the ContinuousEngine under a
node power cap and prints the per-request J/token report — the paper's
GPIO-tagged energy attribution (Sec. 4.1) driving an energy-aware serving
decision (DVFS capping + admission control, Sec. 3.6/6.1).

    PYTHONPATH=src python -m repro_torch.examples.continuous_serving \
        [--device cpu]

Runs on the CUDA card unless ``--device cpu`` asks for the host. The power
model is ``H100_SXM``'s, whose one-slot power (292.8 W) is above the
reference's 150 W cap (its TPU v5e model's is not: at 150 W every request
here would be shed), so the cap here is 300 W, which admits all four
slots at the top clock.
"""
import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serve.engine import ContinuousEngine, Request

POWER_CAP_W = 300.0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="the CUDA card by default; 'cpu' runs on the host")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = configs.get_smoke("granite-20b")
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = model.init(gen, dev)

    engine = ContinuousEngine(model, params, batch_size=4, max_seq=64,
                              power_cap_w=POWER_CAP_W)
    if engine.dvfs is not None:
        print(f"power cap {POWER_CAP_W:.0f} W -> DVFS "
              f"{engine.dvfs.f_ghz:.2f} GHz, max "
              f"{engine.admission.max_slots(4)} concurrent slots")

    rng = np.random.default_rng(0)
    for i in range(10):
        engine.submit(Request(
            i, rng.integers(0, cfg.vocab_size, 8).astype(np.int32),
            max_new_tokens=int(rng.integers(2, 20))))

    stats = engine.run()
    print(f"\n{stats['completed']} completed, {stats['shed']} shed, "
          f"{stats['slots_recycled']} slot recycles, "
          f"peak {stats['peak_active']} active")
    print(f"decode: {stats['tokens_decoded']} tokens at "
          f"{stats['decode_tok_per_s']:.1f} tok/s")
    # the unified telemetry API: one typed report for the whole session
    report = engine.tel.session.report(tokens=stats["tokens_decoded"])
    print(f"board energy: {report}")
    print("\nper-request attribution (tag-bus bitmask shares):")
    for r in engine.finished:
        print(f"  req {r.req_id}: {len(r.output):2d} tokens "
              f"[{r.finish_reason}] {r.energy_j:6.2f} J "
              f"({r.energy_j / max(len(r.output), 1):.3f} J/token)")
    return stats, engine


if __name__ == "__main__":
    main()
