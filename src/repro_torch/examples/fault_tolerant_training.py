"""Fault-tolerant elastic training: inject node failures mid-run; the
orchestrator shrinks the worker set, restores the last committed checkpoint,
and finishes. Demonstrates the checkpoint-restart path a large deployment
depends on (on one device the "mesh" a rebuild makes is the model alone).

    PYTHONPATH=src python -m repro_torch.examples.fault_tolerant_training \
        [--device cpu]

Runs on the CUDA card unless ``--device cpu`` asks for the host.
"""
import argparse
import shutil
import tempfile

import torch

from repro_torch import configs
from repro_torch.checkpoint import ckpt
from repro_torch.cluster.fault import ElasticTrainOrchestrator, FailureInjector
from repro_torch.core.device import resolve_device
from repro_torch.core.tracing import counting_call
from repro_torch.data.pipeline import (DataConfig, SyntheticTokens,
                                       batch_to_device)
from repro_torch.models import build_model
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.step import StepConfig, TrainState, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="the CUDA card by default; 'cpu' runs on the host")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = configs.get_smoke("qwen3-32b")
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                      global_batch=4))
    ckpt_dir = tempfile.mkdtemp()
    sessions = {}

    def build(n_workers):
        model = build_model(cfg)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = model.init(gen, dev, dtype=torch.float32)
        state = TrainState(params, init_opt_state(params))
        step = counting_call(make_train_step(model, OptConfig(lr=1e-3),
                                             StepConfig()),
                             "fault_example_train_step")
        sessions["cur"] = {"state": state, "step_fn": step,
                           "workers": n_workers}
        print(f"  [build] mesh rebuilt for {n_workers} workers")
        return sessions["cur"]

    def restore(sess, step):
        steps = ckpt.valid_steps(ckpt_dir)
        if not steps:
            return 0
        sess["state"], manifest = ckpt.restore(sess["state"], ckpt_dir)
        print(f"  [restore] resumed from step {manifest['step']}")
        return manifest["step"]

    def train_chunk(sess, start, n):
        st = sess["state"]
        for i in range(start, start + n):
            st, _ = sess["step_fn"](st, batch_to_device(data.batch(i), dev))
        sess["state"] = st
        return start + n

    def save(sess, step):
        ckpt.save(sess["state"], ckpt_dir, step)

    try:
        failures = FailureInjector(mtbf_s=40.0, seed=3).schedule(["w1"],
                                                                 100.0)
        print(f"injected failures at t={[round(t, 1) for t, _ in failures]}")
        orch = ElasticTrainOrchestrator(build=build, restore=restore,
                                        train_chunk=train_chunk, save=save,
                                        ckpt_every=10, min_workers=1)
        st = orch.run(total_steps=40, initial_workers=4,
                      failure_events=failures, step_time_s=1.0)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(f"finished: step={st.step}, restarts={st.restarts}, "
          f"lost+redone steps={st.lost_steps}, final workers={st.n_workers}")
    return st


if __name__ == "__main__":
    main()
