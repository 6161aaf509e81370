"""The harness loads neither JAX nor the JAX package, and the reference
loads nothing of the program. Each check of what loads runs in a fresh
interpreter, so that what other tests imported does not count; a run that
finds JAX loaded prints no result."""
import json
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]


def _loaded(code: str):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True,
        env={"PYTHONPATH": f"{ROOT}:{ROOT / 'src'}", "PATH": "/usr/bin:/bin"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax_nor_the_jax_package():
    top = _loaded(
        "import sys; sys.argv = ['x']\n"
        "sys.path.insert(0, 'portbench')\n"
        "import run, control\n"
        "from portbench import spec, generator, nvml, trace, roofline, "
        "weights\n"
        "from portbench.kinds import serve\n"
        "from portbench.reference import decoder, judge\n"
        "serve.model_config(spec.config(spec.load_benchmark(), "
        "'granite-20b'))\n"
        "import repro_torch.serve.engine\n"
        "for m in spec.load_benchmark()['end_to_end'] + "
        "spec.load_benchmark()['per_layer']:\n"
        "    spec.metric_reader(m['name'])\n")
    assert "repro_torch" in top          # the program did load
    assert not top & {"jax", "jaxlib", "flax", "repro"}


def test_reference_loads_nothing_of_the_program():
    top = _loaded("from portbench.reference import decoder, judge\n"
                  "import portbench.weights, portbench.generator\n")
    assert not top & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


#: what a serve run hands back, as far as the result line reads it
RECORD = {"correct": True, "attempted": 3, "failed": 0, "tokens": 30,
          "window_s": 1.5, "setup_s": 2.0, "energy_j": None,
          "requests": [{"ttft_s": 0.1, "prompt": 8, "cached": 0}] * 3,
          "reference_s": 0.5, "setup_parts": {}, "compare": {},
          "phases": {}, "memory_peak_bytes": 1,
          "checks": {"max_logit_gap": {"value": 0.0, "limit": 0.25}}}


@pytest.mark.parametrize("loads", ["nothing", "jax"])
def test_a_metric_that_loads_jax_stops_the_result(tmp_path, monkeypatch,
                                                  capsys, loads):
    """The look at ``sys.modules`` comes after every metric is read: a
    metric file that imports a module named ``jax`` leaves no result."""
    import torch
    from portbench import spec
    from portbench.kinds import serve
    monkeypatch.syspath_prepend(str(spec.HERE))
    import run
    here = tmp_path / "portbench"
    shutil.copytree(spec.HERE / "metrics", here / "metrics",
                    ignore=shutil.ignore_patterns("__pycache__"))
    if loads == "jax":
        (tmp_path / "stub").mkdir()
        (tmp_path / "stub" / "jax.py").write_text("")
        monkeypatch.syspath_prepend(str(tmp_path / "stub"))
        (here / "metrics" / "tok_s.py").write_text(
            "import jax\n\n\ndef read(record):\n"
            "    return record['tokens'] / record['window_s']\n")
    reader = spec.metric_reader
    monkeypatch.setattr(spec, "metric_reader",
                        lambda name, _=None: reader(name, here))
    for var in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR",
                "TORCHINDUCTOR_CACHE_DIR", "CUDA_CACHE_PATH"):
        monkeypatch.setenv(var, "")          # run.prepare() sets them
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "card")
    monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
    monkeypatch.setattr(run, "energy_meter", lambda torch: None)
    monkeypatch.setattr(serve, "run", lambda *a, **k: RECORD)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    try:
        rc = run.main(["--workload", "deepseek-moe-16b.uniq", "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    finally:
        sys.modules.pop("jax", None)
    out = capsys.readouterr().out
    if loads == "jax":
        assert rc != 0 and out == ""
    else:
        assert rc == 0
        assert json.loads(out.splitlines()[-1])["metrics"]["tok_s"][
            "value"] == 20.0
