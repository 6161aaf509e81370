"""Configurations, traffic mixes and metrics are found by file name: a new
cell is new files and new entries, and no edit."""
import json
import shutil

from portbench import spec


def test_every_entry_of_the_benchmark_resolves():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        spec.config(bench, w["config"])
        assert spec.traffic(w["traffic"])["kind"]
        assert spec.cell_metrics(bench, w["name"], False)
        assert spec.cell_metrics(bench, w["name"], True)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))


def test_a_new_config_mix_and_metric_are_found_by_name(tmp_path):
    here = tmp_path / "portbench"
    shutil.copytree(spec.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.load_benchmark()
    (here / "configs" / "tiny.json").write_text(json.dumps(
        {"name": "tiny", "model": {"vocab_size": 10}}))
    (here / "traffic" / "burst.json").write_text(json.dumps(
        {"kind": "serve", "clients": 3}))
    (here / "metrics" / "queue_ms.py").write_text(
        "def read(record):\n    return record['queue_ms']\n")
    bench["configs"].append({"name": "tiny", "source": "x",
                             "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "tiny.burst", "config": "tiny",
                               "traffic": "burst", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "queue_ms", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "engine", "moves": "ttft_p95_ms",
                               "workloads": ["tiny.burst"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    b = spec.load_benchmark(tmp_path)
    w = spec.workload(b, "tiny.burst")
    assert spec.config(b, w["config"], tmp_path)["model"]["vocab_size"] == 10
    assert spec.traffic(w["traffic"], here)["clients"] == 3
    names = [m["name"] for m in spec.cell_metrics(b, "tiny.burst", True)]
    assert names == ["queue_ms"]
    got = spec.read_metrics(spec.cell_metrics(b, "tiny.burst", True),
                            {"queue_ms": 4.5}, here)
    assert got == {"queue_ms": {"value": 4.5, "unit": "ms"}}
    e2e = [m["name"] for m in spec.cell_metrics(b, "tiny.burst", False)]
    assert "setup_s" in e2e and "tok_s" in e2e
