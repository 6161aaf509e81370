"""The port's training examples, its copy of ``cluster/fault.py`` (the
reference's fault tests on the port), its checkpoint I/O bench and the
elastic cluster example (the reference example's output, line for line), on
the host."""
import importlib.util
import pathlib

import pytest
import torch

from repro_torch.benchmarks import bench_checkpoint_io
from repro_torch.benchmarks import run as bench_run
from repro_torch.cluster.fault import (ElasticTrainOrchestrator,
                                       FailureInjector, HeartbeatMonitor)
from repro_torch.examples import (continuous_serving, elastic_cluster,
                                  energy_aware_training,
                                  fault_tolerant_training, quickstart)

REF_EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Smoke-size tensors gain nothing from intra-op threads, and the
    suite runs several test processes at once: one thread each (restored
    after the test)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quickstart_trains_and_serves_on_the_host():
    losses, reqs = quickstart.main(["--device", "cpu"])
    assert len(losses) == 4 and all(l == l for l in losses)
    assert [len(r.output) for r in reqs] == [8, 8, 8]


def test_energy_aware_training_partitions_its_joules(monkeypatch):
    # it trains zamba2-1.2b's smoke model, as the reference's example does
    built = []
    build = energy_aware_training.build_model
    monkeypatch.setattr(energy_aware_training, "build_model",
                        lambda cfg: built.append(cfg.name) or build(cfg))
    summary = energy_aware_training.main(["--device", "cpu"])
    assert built == ["zamba2-1.2b-smoke"]
    assert summary["tokens"] == 8 * 2 * 64
    assert abs(sum(summary["energy_by_tag"].values())
               - summary["energy_j"]) <= 1e-6


def test_continuous_serving_attributes_every_request():
    stats, engine = continuous_serving.main(["--device", "cpu"])
    assert stats["completed"] == 10 and stats["shed"] == 0
    assert engine.admission.max_slots(4) == 4
    assert all(r.energy_j > 0 for r in engine.finished)


def test_fault_tolerant_training_restarts_and_finishes():
    st = fault_tolerant_training.main(["--device", "cpu"])
    assert st.step == 40 and st.restarts >= 1 and st.lost_steps > 0


def test_heartbeat_detection():
    hb = HeartbeatMonitor(interval_s=1.0, miss_limit=3)
    hb.beat("n0", 0.0)
    hb.beat("n1", 0.0)
    hb.beat("n0", 5.0)
    assert hb.dead(6.0) == ["n1"]


def test_failure_injection_deterministic():
    fi = FailureInjector(mtbf_s=1000.0, seed=7)
    e1 = fi.schedule(["a", "b"], 5000.0)
    e2 = FailureInjector(mtbf_s=1000.0, seed=7).schedule(["a", "b"], 5000.0)
    assert e1 == e2 and len(e1) > 0


def test_elastic_orchestrator_survives_failures():
    calls = {"build": 0, "saves": []}

    def build(n):
        calls["build"] += 1
        return {"workers": n}

    def restore(sess, step):
        return step or 0

    def train_chunk(sess, start, n):
        return start + n

    def save(sess, step):
        calls["saves"].append(step)

    orch = ElasticTrainOrchestrator(
        build=build, restore=restore, train_chunk=train_chunk, save=save,
        ckpt_every=10, min_workers=2)
    st = orch.run(total_steps=100, initial_workers=4,
                  failure_events=[(15.0, 1), (47.0, 2)], step_time_s=1.0)
    assert st.step == 100
    assert st.restarts == 2
    assert st.n_workers == 2
    assert calls["build"] == 3               # initial + 2 shrinks
    assert st.lost_steps > 0                 # work was lost and redone
    assert calls["saves"][-1] == 100


def test_checkpoint_io_bench_on_the_host(capsys):
    rows = bench_checkpoint_io.run(device="cpu").rows
    assert set(rows) == {f"ckpt/{n}/{op}" for n in ("seq", "small_leaves")
                         for op in ("write", "read")}
    assert all(r["derived"].endswith("MB/s;cpu") for r in rows.values())
    bench_run.main(["--only", "checkpoint", "--device", "cpu"])
    assert "ckpt/seq/read" in capsys.readouterr().out


def test_examples_without_device_raise_on_a_host_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for ex in (quickstart, energy_aware_training, fault_tolerant_training,
               continuous_serving):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ex.main([])


def test_elastic_cluster_prints_the_reference_example(capsys):
    cm = elastic_cluster.main([])
    out = capsys.readouterr().out
    spec = importlib.util.spec_from_file_location(
        "ref_elastic_cluster", REF_EXAMPLES / "elastic_cluster.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    ref.main()
    assert out == capsys.readouterr().out
    assert "saved" in out and cm.jobs[1].state == "DONE"
    assert set(cm.elastic.states()[n] for n in cm.jobs[1].nodes) == {"off"}
