"""The port's ``bench_serving`` (the reference's ``benchmarks/
bench_serving.py``) on the host at its smoke sizes: every scenario runs
through the port's engines, the engines' token assertions hold, and the
rows carry what the reference's rows carry — the signature counts of the
retrace scenario (one a distinct length unbucketed, one a bucket
bucketed, the reference's ``prefill_buckets``), the prefix cache's hits,
both families' adapters in the mixed-family scenario, and the span
overhead's budget row. Speedup gates print PASS or FAIL (readings, never
errors); ``main`` returns the continuous-vs-static speedup."""
import json

import pytest
import torch

from repro.serve.step import prefill_buckets as jprefill_buckets
from repro_torch.benchmarks import bench_serving, run as bench_run

SMALL = ["--device", "cpu", "--requests", "8", "--mixed-lengths", "6",
         "--prefix-requests", "6", "--prefix-len", "40",
         "--prefix-max-seq", "64", "--family-requests", "4",
         "--overhead-repeats", "1"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    # one thread for the bench, and the worker's count back after it: a
    # module fixture outlives the tests of its file
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        path = tmp_path_factory.mktemp("bench") / "rows.json"
        trace = path.with_name("trace.json")
        speedup = bench_serving.main(SMALL + ["--json", str(path),
                                              "--trace-out", str(trace)])
    finally:
        torch.set_num_threads(n)
    return speedup, json.loads(path.read_text()), trace


def test_every_scenario_writes_its_rows(bench):
    speedup, rows, trace = bench
    assert speedup > 0
    for name in ("static_decode", "continuous_decode", "continuous_energy",
                 "mixed_unbucketed", "mixed_bucketed", "prefill_compiles",
                 "prefix_cold", "prefix_cached", "aux_compiles",
                 "mixed_family_transformer", "mixed_family_ssm",
                 "mixed_family", "span_overhead"):
        assert f"serve/{name}" in rows, name
    assert json.loads(trace.read_text())["traceEvents"]


def test_retrace_counts_follow_the_reference_rule(bench):
    _, rows, _ = bench
    # lengths 4..9 at max_seq 64: one signature a length unbucketed, one a
    # bucket edge they reach bucketed
    assert rows["serve/mixed_unbucketed"]["compiles"] == 6
    edges = jprefill_buckets(64)
    reached = {next(e for e in edges if n <= e) for n in range(4, 10)}
    assert rows["serve/mixed_bucketed"]["compiles"] == len(reached)
    assert rows["serve/prefill_compiles"]["compiles"] == len(reached)


def test_prefix_and_mixed_family_rows(bench):
    _, rows, _ = bench
    assert rows["serve/prefix_cached"]["hit_rate"] > 0.5
    assert "adapter=recurrent" in rows["serve/mixed_family_ssm"]["derived"]
    assert "adapter=paged-kv" in \
        rows["serve/mixed_family_transformer"]["derived"]
    span = rows["serve/span_overhead"]
    assert span["budget"] == 0.05 and span["value"] >= 0.0


def test_gates_print_pass_or_fail(capsys):
    bench_serving.main(SMALL + ["--family-arch", "zamba2-1.2b"])
    out = capsys.readouterr().out
    for gate in (">= 1.5x gate", ">= 2x gate", "budget"):
        assert any(gate in line and ("PASS" in line or "FAIL" in line)
                   for line in out.splitlines()), gate
    assert "transformer/zamba2-1.2b" in out


def test_runner_registers_serving():
    assert ("repro_torch.benchmarks.bench_serving"
            in [m for _, m in bench_run.MODULES])
