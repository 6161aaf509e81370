"""Find a cell's configuration, traffic mix and per-layer metrics by the
names ``BENCHMARK.json`` gives them.

A configuration is the JSON file its entry names; a traffic mix is
``traffic/<mix>.json``; a per-layer metric is ``metrics/<name>.py``, a
module with ``read(record)``. A later cell adds files and entries, and
edits none of these."""
from __future__ import annotations

import importlib.util
import json
import pathlib
from typing import Dict, List, Optional

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: pathlib.Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json (have: "
                   f"{[w['name'] for w in bench['workloads']]})")


def config(bench: Dict, name: str, root: pathlib.Path = ROOT) -> Dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, here: pathlib.Path = HERE) -> Dict:
    return json.loads((here / "traffic" / f"{name}.json").read_text())


def metric_reader(name: str, here: pathlib.Path = HERE):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics with
    ``trace`` off, its per-layer metrics with it on. A metric with a
    ``workloads`` list belongs to those cells; one without it, to every
    cell (a per-layer one: every cell that reports the metric it moves)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names
                             else [])]


def read_metrics(metrics: List[Dict], record: Dict,
                 here: pathlib.Path = HERE) -> Dict[str, Dict]:
    """{name: {"value", "unit"}} of each metric whose reader found
    something to read."""
    out: Dict[str, Dict] = {}
    for m in metrics:
        value: Optional[float] = metric_reader(m["name"], here)(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
