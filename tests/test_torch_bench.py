"""The port's measurement path (bandwidth, peak, launch latency) on the
host: each bench runs at the reference bench's own constants and emits the
reference's row names; on the host the rows read the plain versions and
name the host, never the card. No CPU time here is a device reading."""
import ast
import pathlib

import pytest
import torch

from repro_torch.benchmarks import bench_bandwidth, bench_launch_latency
from repro_torch.benchmarks import bench_peak, run as bench_run
from repro_torch.kernels.dpa_matmul import dpa_matmul as dk
from repro_torch.kernels.stream import stream as sk

REF_BENCH = pathlib.Path(__file__).resolve().parents[1] / "benchmarks"


def _ref_constant(module, name):
    """The value of ``name`` assigned at the top of a reference bench
    (read from its source: the reference benches import jax's side)."""
    tree = ast.parse((REF_BENCH / f"{module}.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign):
            targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
            if name in targets:
                return eval(compile(ast.Expression(node.value), module,
                                    "eval"))
    raise KeyError(name)


def test_constants_are_the_reference_benches():
    assert bench_bandwidth.SIZES_KB == _ref_constant("bench_bandwidth",
                                                     "SIZES_KB")
    assert bench_bandwidth.COLS == _ref_constant("bench_bandwidth", "COLS")
    assert bench_peak.M == bench_peak.K == bench_peak.N \
        == _ref_constant("bench_peak", "M")


def test_bandwidth_bench_emits_the_reference_rows_on_the_host(capsys):
    rows = bench_bandwidth.run(device="cpu").rows
    want = [f"bandwidth/{op}/{kb}KB" for kb in bench_bandwidth.SIZES_KB
            for op in ("copy", "scale", "add", "triad")]
    assert list(rows) == want
    printed = [line.split(",")[0]
               for line in capsys.readouterr().out.splitlines()]
    assert printed == want
    for name, row in rows.items():
        assert row["us_per_call"] > 0 and row["compiles"] >= 1, name
        assert row["derived"].endswith("GB/s;host_cpu"), name


def test_peak_bench_emits_the_reference_rows_on_the_host():
    rows = bench_peak.run(device="cpu").rows
    assert list(rows) == [f"peak/{v}/512x512x512"
                          for v in ("fma_f32", "dpa2", "dpa4")]
    assert "H100_datasheet_peak=1979Top/s" in rows["peak/dpa4/512x512x512"][
        "derived"]


def test_launch_latency_bench_on_the_host_runs_no_kernel():
    before = (dict(sk.launches), dict(dk.launches))
    rows = bench_launch_latency.run(device="cpu").rows
    assert list(rows) == ["launch/eager_dispatch", "launch/kernel_dispatch",
                          "launch/first_launch"]
    assert all(r["us_per_call"] > 0 for r in rows.values())
    assert rows["launch/kernel_dispatch"]["derived"] == "plain-version;cpu"
    assert (dict(sk.launches), dict(dk.launches)) == before


@pytest.mark.parametrize("bench", [bench_bandwidth, bench_peak,
                                   bench_launch_latency])
def test_bench_without_device_raises_on_a_host_without_cuda(bench,
                                                            monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_run.main(["--only", "peak"])
