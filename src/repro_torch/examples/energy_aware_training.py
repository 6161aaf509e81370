"""Energy-aware training (the paper's core theme): the power-cap sweep of
the DVFS model (the time/energy Pareto the DALEK platform was built to
measure, Sec. 3.6, 4, 6.1), then a short training run with the 1000 SPS
telemetry and per-tag attribution.

    PYTHONPATH=src python -m repro_torch.examples.energy_aware_training \
        [--device cpu]

It trains zamba2-1.2b's smoke config (the Mamba2 hybrid), as the
reference does. Runs on the CUDA card unless ``--device cpu`` asks for the
host.
"""
import argparse

import torch

from repro_torch import configs
from repro_torch.core import energy
from repro_torch.core.device import resolve_device
from repro_torch.core.hw import H100_SXM
from repro_torch.core.tracing import counting_call
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.models import build_model
from repro_torch.train import loop as loop_mod
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.step import StepConfig, TrainState, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="the CUDA card by default; 'cpu' runs on the host")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = configs.get_smoke("zamba2-1.2b")
    model = build_model(cfg)
    # roofline terms for the smoke model on one H100 (the energy model's
    # input; assumed values, as the reference assumes its own)
    terms = {"compute": 0.004, "memory": 0.003, "collective": 0.0}

    print("power-cap sweep (DVFS cubic model, paper Sec. 3.6):")
    print("cap_W  f_GHz  step_s  step_J  J_vs_uncapped")
    e0 = energy.step_energy_j(terms)
    for cap in (None, 500.0, 350.0, 200.0):
        st = energy.cap_frequency(cap, terms) if cap else None
        t = energy.step_time_s(terms, st)
        e = energy.step_energy_j(terms, st)
        f = st.f_ghz if st else H100_SXM.f_max_ghz
        print(f"{cap or 'none':>5}  {f:.2f}  {t*1e3:6.2f}ms  {e:6.2f}J  "
              f"{e/e0:5.2f}x")

    # short real run with telemetry + tags
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = model.init(gen, dev, dtype=torch.float32)
    state = TrainState(params, init_opt_state(params))
    step = counting_call(make_train_step(model, OptConfig(lr=1e-3),
                                         StepConfig()),
                         "energy_example_train_step")
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                      global_batch=2), cfg)
    state, hist, summary = loop_mod.run(
        step, state, data, loop_mod.LoopConfig(total_steps=8), device=dev,
        roofline_terms=terms)
    print(f"\n8 telemetered steps: {summary['tokens']} tokens, "
          f"{summary['energy_j']:.1f} J total at "
          f"{summary['avg_power_w']:.1f} W avg, "
          f"J/token={summary['j_per_token']:.4f}")
    print(f"per-tag attribution: "
          f"{ {k: round(v,1) for k,v in summary['energy_by_tag'].items()} }")
    return summary


if __name__ == "__main__":
    main()
