"""On the card: each cell's correctness limits lie between the program's
readings and the fp8 control's: the run's verdict reads the program
correct and, by the same verdict in the program's place, the control not,
on one fresh seed at the cell's own size and a short window of its own
traffic (about three minutes a cell).

    python -m pytest -m cuda portbench/tests/test_portbench_control_cuda.py
"""
import sys

import pytest

from portbench import spec

sys.path.insert(0, str(spec.HERE))

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's "
                    "size on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_limit_lies_between_the_program_and_the_fp8_control(card, cell):
    import control
    (r,) = control.readings(cell, [987654321], 10.0)
    assert r["correct"] is True, r
    assert r["control_correct"] is False, r
