"""The port's timeline export (``repro_torch.obs.export``): the same Chrome
trace documents as the reference's on the same spans, the exact joule
partition on a live engine run, and the serving CLI's ``--trace-out`` and
``--engine static`` on the host."""
import json

import numpy as np
import pytest
import torch

from repro.obs import chrome_trace as jchrome_trace
from repro.obs.spans import SpanRecord as JSpanRecord
from repro_torch import configs
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model
from repro_torch.obs import (SpanRecord, chrome_trace, parse_chrome_trace,
                             validate_chrome_trace, write_chrome_trace)
from repro_torch.serve.engine import ContinuousEngine, Request, ServeEngine


def _spans(cls=SpanRecord):
    return [
        cls(0, None, "prefill", "req0", 0.0, 0.2, {"window": 0, "bucket": 16}),
        cls(1, None, "decode_step", "engine", 0.2, 0.3, {"window": 1}),
        cls(2, 1, "sample", "engine", 0.25, 0.28, {}),
        cls(3, None, "finish", "req0", 0.3, 0.3, {"reason": "eos"}),
    ]


def test_chrome_trace_is_the_references_document():
    energies, walls = [2.5, 1.5], [0.2, 0.1]
    got = chrome_trace(_spans(), energies, walls, meta={"process": "t"})
    want = jchrome_trace(_spans(JSpanRecord), energies, walls,
                         meta={"process": "t"})
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)


def test_chrome_trace_energy_partition_and_round_trip(tmp_path):
    energies, walls = [2.5, 1.5], [0.2, 0.1]
    doc = chrome_trace(_spans(), energies, walls, meta={"process": "t"})
    validate_chrome_trace(doc)
    od = doc["otherData"]
    assert od["energy_total_j"] == pytest.approx(4.0)
    assert od["attributed_j"] == pytest.approx(4.0)      # exact partition
    assert od["n_spans"] == 4 and od["n_windows"] == 2
    names = {ev["args"]["name"]: ev["tid"] for ev in doc["traceEvents"]
             if ev["ph"] == "M" and ev["name"] == "thread_name"}
    assert names["engine"] == 0

    path = tmp_path / "t.json"
    write_chrome_trace(path, _spans(), window_energies=energies,
                       window_walls=walls, meta={"process": "t"})
    recs, summary = parse_chrome_trace(path)
    assert summary["parsed_attributed_j"] == pytest.approx(
        summary["attributed_j"])
    by_id = {r.span_id: r for r in recs}
    assert by_id[0].attrs["energy_j"] == pytest.approx(2.5)
    assert by_id[1].attrs["energy_j"] == pytest.approx(1.5)
    assert by_id[2].parent_id == 1 and by_id[2].name == "sample"
    assert by_id[3].t1 == by_id[3].t0
    assert by_id[0].track == "req0" and by_id[0].attrs["bucket"] == 16
    for r, p in zip(sorted(recs, key=lambda r: r.span_id), _spans()):
        assert r.t0 == pytest.approx(p.t0, abs=1e-6)
        assert r.t1 == pytest.approx(p.t1, abs=1e-6)


def test_chrome_trace_rejects_double_claimed_window():
    spans = [SpanRecord(0, None, "a", "engine", 0.0, 0.1, {"window": 0}),
             SpanRecord(1, None, "b", "engine", 0.1, 0.2, {"window": 0})]
    with pytest.raises(ValueError, match="attributed twice"):
        chrome_trace(spans, [1.0], [0.1])


def test_validate_chrome_trace_rejects_malformed():
    with pytest.raises(ValueError):
        validate_chrome_trace({"no": "traceEvents"})
    with pytest.raises(ValueError):
        validate_chrome_trace({"traceEvents": [{"name": "x", "ph": "X",
                                               "pid": 1, "tid": 0}]})
    with pytest.raises(ValueError):
        validate_chrome_trace({"traceEvents": [
            {"name": "x", "ph": "?", "pid": 1, "tid": 0, "ts": 0}]})


@pytest.fixture(scope="module")
def smoke_model():
    cfg = configs.get_smoke("gemma3-27b")
    model = build_model(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(0), "cpu")


@pytest.mark.parametrize("engine", ["continuous", "static"])
def test_engine_trace_export_sums_to_report(smoke_model, engine, tmp_path):
    """Per-span joules partition the session total, on the window-ring
    continuous engine and on the static engine."""
    cfg, model, params = smoke_model
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, 8).astype(np.int32),
                    max_new_tokens=4) for i in range(2)]
    if engine == "continuous":
        eng = ContinuousEngine(model, params, batch_size=2, max_seq=32)
        eng.serve(reqs + [Request(2, rng.integers(0, cfg.vocab_size, 8)
                                  .astype(np.int32), max_new_tokens=4)])
    else:
        eng = ServeEngine(model, params, batch_size=2, max_seq=32)
        eng.serve(reqs)
    path = tmp_path / "serve.json"
    write_chrome_trace(path, eng.tracer, session=eng.tel.session,
                       meta={"process": "test"})
    recs, summary = parse_chrome_trace(path)
    report = eng.tel.session.report()
    assert summary["attributed_j"] == pytest.approx(report.energy_j,
                                                    abs=1e-6)
    span_sum = sum(r.attrs.get("energy_j", 0.0) for r in recs
                   if "window" in r.attrs or "windows" in r.attrs)
    assert span_sum == pytest.approx(report.energy_j, abs=1e-6)
    names = {r.name for r in recs}
    assert {"prefill", "decode_step", "finish"} <= names
    if engine == "continuous":
        assert {"queued", "decode"} <= names


@pytest.mark.parametrize("engine", ["continuous", "static"])
def test_cli_engines_and_trace_out(engine, tmp_path, capsys):
    """The CLI's default arch (gemma3-27b) at smoke size on the host,
    through either engine, writes a trace ``validate_chrome_trace``
    accepts."""
    path = tmp_path / "trace.json"
    stats = tserve.main(["--smoke", "--device", "cpu", "--engine", engine,
                         "--requests", "3", "--batch", "2", "--prompt-len",
                         "40", "--max-new", "6", "--max-seq", "64",
                         "--trace-out", str(path)])
    out = capsys.readouterr().out
    assert "arch=gemma3-27b-smoke" in out and f"engine={engine}" in out
    assert stats["decode_compiles"] == 1 and "J/token" in out
    if engine == "continuous":
        assert stats["adapter"] == "window-ring" and stats["completed"] == 3
    else:
        assert stats["tokens_decoded"] == 18
    doc = json.loads(path.read_text())
    validate_chrome_trace(doc)
    assert doc["otherData"]["arch"] == "gemma3-27b-smoke"
    assert doc["otherData"]["attributed_j"] == pytest.approx(
        doc["otherData"]["energy_total_j"], abs=1e-6)


def test_cli_refuses_paging_a_window_ring_family():
    with pytest.raises(SystemExit):
        tserve.main(["--smoke", "--device", "cpu", "--kv-block-size", "8"])
    with pytest.raises(SystemExit):
        tserve.main(["--smoke", "--device", "cpu", "--prefix-cache", "on"])
