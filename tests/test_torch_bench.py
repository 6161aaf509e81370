"""The port's measurement path (bandwidth, peak, launch latency) on the
host: each bench runs at the reference bench's own constants and emits the
reference's row names; on the host the rows read the plain versions and
name the host, never the card. No CPU time here is a device reading.

The host benches (energy platform, elastic power, scheduling) run on the
host wherever they are called: they emit the reference's row names, at its
constants, with the reference's derived numbers where those are not
timings, and each row names the host CPU."""
import ast
import importlib
import pathlib

import pytest
import torch

from repro_torch.benchmarks import bench_bandwidth, bench_elastic
from repro_torch.benchmarks import bench_energy_platform, bench_launch_latency
from repro_torch.benchmarks import bench_peak, bench_scheduler
from repro_torch.benchmarks import run as bench_run
from repro_torch.benchmarks.common import host_cpu
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


def _ref_rows(module):
    """The row names a reference bench records (string first arguments of
    its ``record``/``rows.record``/``emit`` calls, read from its source)."""
    tree = ast.parse((REF_BENCH / f"{module}.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and node.args
                and isinstance(node.args[0], (ast.Constant, ast.JoinedStr))
                and getattr(node.func, "attr", getattr(node.func, "id", ""))
                in ("record", "emit")):
            arg = node.args[0]
            names.add(arg.value if isinstance(arg, ast.Constant)
                      else "".join(v.value if isinstance(v, ast.Constant)
                                   else "{}" for v in arg.values))
    return names


def test_host_bench_constants_are_the_reference_benches():
    for name in ("READ_S", "TAG_S"):
        assert getattr(bench_energy_platform, name) \
            == _ref_constant("bench_energy_platform", name), name


@pytest.mark.parametrize("bench,module,want", [
    (bench_energy_platform, "bench_energy_platform", None),
    (bench_elastic, "bench_elastic", ["elastic/day_sim"]),
    (bench_scheduler, "bench_scheduler",
     [f"sched/{o}" for o in ("time", "energy", "edp")]),
], ids=["energy", "elastic", "scheduler"])
def test_host_bench_emits_the_reference_rows_naming_the_host(
        bench, module, want, capsys):
    rows = bench.run(device="cpu").rows
    ref = _ref_rows(module)
    if want is None:
        assert set(rows) == ref and len(rows) == 8
    else:
        assert list(rows) == want
        assert set(ref) == ({"elastic/day_sim"} if module == "bench_elastic"
                            else {"sched/{}"})
    printed = [line.split(",")[0]
               for line in capsys.readouterr().out.splitlines()]
    assert printed == list(rows)
    for name, row in rows.items():
        assert row["us_per_call"] > 0, name
        assert row["derived"].endswith(f";host={host_cpu()}"), name


def test_energy_bench_rows_hold_the_paper_rates():
    rows = bench_energy_platform.run(device="cpu").rows
    assert "hw_rate=1000SPS" in rows["energy/mainboard_read_legacy"][
        "derived"]
    assert "res=1mW" in rows["energy/probe_vectorized_10s"]["derived"]
    assert "_vs_legacy" in rows["energy/mainboard_read_columnar"]["derived"]
    assert "roundtrip=bit_exact" in rows["energy/trace_reload"]["derived"]


@pytest.mark.parametrize("module,bench", [
    ("bench_elastic", bench_elastic), ("bench_scheduler", bench_scheduler)])
def test_host_bench_derives_the_reference_numbers(module, bench, capsys,
                                                  monkeypatch):
    """Everything but the timing column equals the reference bench's run
    (the reference benches import jax's side, so they are loaded from the
    repository root)."""
    monkeypatch.syspath_prepend(str(REF_BENCH.parent))
    importlib.import_module(f"benchmarks.{module}").run()
    ref = {line.split(",")[0]: line.split(",", 2)[2]
           for line in capsys.readouterr().out.splitlines()}
    rows = bench.run(device="cpu").rows
    assert {k: v["derived"].rsplit(";host=", 1)[0]
            for k, v in rows.items()} == ref


def test_runner_runs_the_host_benches_with_the_others(capsys):
    for only in ("energy", "elastic", "scheduler"):
        bench_run.main(["--only", only, "--device", "cpu"])
    out = capsys.readouterr().out
    for name in ("energy/session_sample", "elastic/day_sim", "sched/edp"):
        assert name in out
    assert [m for _, m in bench_run.MODULES][-3:] == [
        "repro_torch.benchmarks.bench_energy_platform",
        "repro_torch.benchmarks.bench_elastic",
        "repro_torch.benchmarks.bench_scheduler"]


def test_host_cpu_names_a_masked_processor_by_family_and_model(tmp_path):
    """A host may hide the model name; the row still names the
    processor, and never with a comma (the CSV's separator)."""
    info = tmp_path / "cpuinfo"
    block = ("processor\t: {i}\nvendor_id\t: GenuineIntel\ncpu family\t: 6"
             "\nmodel\t\t: 207\nmodel name\t: {name}\ncpu MHz\t\t: "
             "2692.292\n\n")
    info.write_text(block.format(i=0, name="unknown")
                    + block.format(i=1, name="unknown"))
    assert host_cpu(str(info)).startswith(
        "GenuineIntel family 6 model 207 @ 2692 MHz (")
    info.write_text(block.format(i=0, name="Xeon, Platinum 8480+"))
    assert host_cpu(str(info)).startswith("Xeon Platinum 8480+ (")
    assert "," not in host_cpu()


@pytest.mark.parametrize("drop, whole", [(0, True), (1000, True),
                                         (1024, False), (1031, False)])
def test_kernel_events_whole_session(monkeypatch, drop, whole):
    """``kernel_events`` on sessions whose first ``drop`` records kineto
    dropped (a stand-in session: ``LEAD`` leading markers, 3 calls of 2
    kernels, ``TAIL`` trailing markers): whole, with every kernel of the
    calls, while a leading marker is left; past that not ok, and run
    again up to ``tries`` sessions, whatever is left (7 trailing markers
    alone are not a whole session)."""
    from repro_torch.benchmarks import common
    names = ([common.MARKER] * common.LEAD + ["a", "b"] * 3
             + [common.MARKER] * common.TAIL)
    runs = []

    def session(fn, n):
        runs.append(n)
        return [(i, name, 1.0) for i, name in enumerate(names)][drop:]

    monkeypatch.setattr(common, "profiler_session", session)
    sessions = []
    kept, ok = common.kernel_events(lambda: None, 3, tries=3,
                                    sessions=sessions)
    assert ok is whole
    if whole:
        assert kept == [("a", 1.0), ("b", 1.0)] * 3 and runs == [3]
        assert sessions == [(len(names) - drop, common.LEAD - drop,
                             common.TAIL)]
    else:
        assert runs == [3, 3, 3]
