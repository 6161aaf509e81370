"""The port's cross-run bench gate against the reference's: every case of
``tests/test_regression_gate.py``, and one of each rule the gate has, run
through both gates on the same files must give the same return code and
print the same lines (the failure strings included). On a replay report
as ``launch.replay --json`` writes it (``per_request_j`` a list of
(req_id, J) pairs) the reference's gate raises TypeError; the port's holds
each request's joules to 1e-6 J."""
import importlib.util
import json
from pathlib import Path

import pytest

from repro_torch.benchmarks import regression_gate as port_gate

REPO = Path(__file__).resolve().parent.parent

_spec = importlib.util.spec_from_file_location(
    "reference_regression_gate", REPO / "benchmarks" / "regression_gate.py")
ref_gate = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref_gate)

ROW = {"us_per_call": 100.0, "derived": ""}

# (previous rows, current rows, want rc): the reference test file's three
# cases first, then one case per rule of the gate
CASES = {
    "new_analysis_rows_are_ungated": (
        {"analysis/DLK001": {"findings": 0}},
        {"analysis/DLK001": {"findings": 0},
         "analysis/DLK009": {"findings": 3},
         "analysis/DLK010": {"findings": 1},
         "analysis/DLK011": {"findings": 2},
         "analysis/DLK012": {"findings": 5}}, 0),
    "findings_increase_on_pinned_row_fails": (
        {"analysis/DLK009": {"findings": 0}},
        {"analysis/DLK009": {"findings": 2}}, 1),
    "findings_decrease_or_equal_passes": (
        {"analysis/DLK009": {"findings": 2},
         "analysis/DLK012": {"findings": 4}},
        {"analysis/DLK009": {"findings": 0},
         "analysis/DLK012": {"findings": 4}}, 0),
    "same_rows": ({"a": ROW, "b": dict(ROW, compiles=3)},
                  {"a": ROW, "b": dict(ROW, compiles=3)}, 0),
    "slowdown_above_threshold": ({"a": ROW},
                                 {"a": dict(ROW, us_per_call=120.0)}, 1),
    "slowdown_below_the_gated_floor": (
        {"a": dict(ROW, us_per_call=10.0)},
        {"a": dict(ROW, us_per_call=30.0)}, 0),
    "compiles_increase": ({"b": dict(ROW, compiles=3)},
                          {"b": dict(ROW, compiles=4)}, 1),
    "compile_row_time_not_gated": (
        {"b": dict(ROW, compiles=3)},
        {"b": dict(ROW, compiles=3, us_per_call=900.0)}, 0),
    "hit_rate_drop": ({"c": dict(ROW, hit_rate=0.5)},
                      {"c": dict(ROW, hit_rate=0.25)}, 1),
    "replay_drift": (
        {"r": {"attributed_j": 1.5, "completed": 3}},
        {"r": {"attributed_j": 1.6, "completed": 3}}, 1),
    "budget_exceeded": ({"s": {"value": 1.0, "budget": 2.0}},
                        {"s": {"value": 3.0, "budget": 2.0}}, 1),
    "row_only_in_one_file": ({"a": ROW}, {"z": ROW}, 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_gate_equals_reference_gate(case, tmp_path, capsys):
    prev_rows, cur_rows, want = CASES[case]
    prev, cur = tmp_path / "prev.json", tmp_path / "cur.json"
    prev.write_text(json.dumps(prev_rows))
    cur.write_text(json.dumps(cur_rows))
    outs = []
    for gate in (ref_gate, port_gate):
        rc = gate.main([str(prev), str(cur)])
        outs.append((rc, capsys.readouterr().out))
    assert outs[0][0] == want
    assert outs[1] == outs[0]


REPLAY = {"replay/baseline": {
    "attributed_j": 74.386446, "energy_j": 74.386446, "completed": 8,
    "shed": 0, "tokens": 96, "per_request_j": [[0, 9.0832905],
                                              [1, 7.978574]]}}


def test_reference_gate_cannot_read_a_replay_report(tmp_path):
    """The fault is real: ``launch.replay --json`` writes
    ``per_request_j`` as (req_id, J) pairs, and the reference's drift
    check subtracts them as numbers."""
    path = tmp_path / "replay.json"
    path.write_text(json.dumps(REPLAY))
    with pytest.raises(TypeError):
        ref_gate.main([str(path), str(path)])


@pytest.mark.parametrize("change,want", [
    (None, 0), ((1, 1e-7), 0), ((1, 2e-6), 1), ("ids", 1)])
def test_port_gate_holds_each_request_of_a_replay_report(tmp_path, capsys,
                                                         change, want):
    cur = json.loads(json.dumps(REPLAY))
    per = cur["replay/baseline"]["per_request_j"]
    if change == "ids":
        per[1][0] = 2
    elif change is not None:
        per[change[0]][1] += change[1]
    prev_path, cur_path = tmp_path / "prev.json", tmp_path / "cur.json"
    prev_path.write_text(json.dumps(REPLAY))
    cur_path.write_text(json.dumps(cur))
    assert port_gate.main([str(prev_path), str(cur_path)]) == want
    out = capsys.readouterr().out
    assert ("replay per_request_j drifted" in out) == bool(want)


def test_port_gate_directory_mode_and_history(tmp_path, capsys):
    """Directory mode pairs files by basename and ``--history`` appends
    one record an artifact, in both gates alike."""
    for side, rows in (("prev", {"a": ROW}),
                       ("cur", {"a": dict(ROW, us_per_call=130.0)})):
        (tmp_path / side).mkdir()
        (tmp_path / side / "BENCH_x.json").write_text(json.dumps(rows))
    outs = []
    hist = tmp_path / "history.json"
    for gate in (ref_gate, port_gate):
        rc = gate.main(["--prev-dir", str(tmp_path / "prev"), "--cur-dir",
                        str(tmp_path / "cur"), "--history", str(hist)])
        outs.append((rc, capsys.readouterr().out,
                     json.loads(hist.read_text())))
        hist.unlink()
    assert outs[0][0] == 1
    assert outs[1] == outs[0]
