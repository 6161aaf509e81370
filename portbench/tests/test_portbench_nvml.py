"""The NVML energy reader's arithmetic, against a stand-in library."""
import ctypes

import pytest

from portbench import nvml


class Stub:
    """Two devices; the counter of each steps by ``step`` mJ a read."""

    def __init__(self, uuids, start=1_000_000, step=2500):
        self.uuids, self.mj, self.step = uuids, start, step

    def nvmlInit_v2(self):
        return 0

    def nvmlDeviceGetCount_v2(self, count):
        count._obj.value = len(self.uuids)
        return 0

    def nvmlDeviceGetHandleByIndex_v2(self, i, handle):
        handle._obj.value = i.value + 1
        return 0

    def nvmlDeviceGetUUID(self, handle, buf, n):
        buf.value = self.uuids[handle.value - 1].encode()
        return 0

    def nvmlDeviceGetTotalEnergyConsumption(self, handle, v):
        self.mj += self.step * handle.value
        v._obj.value = self.mj
        return 0

    def nvmlDeviceGetEnforcedPowerLimit(self, handle, v):
        v._obj.value = 700000
        return 0


def test_reads_the_matched_device_and_converts_millijoules():
    lib = Stub(["GPU-aaaa", "GPU-1234-abcd"])
    m = nvml.Nvml("1234-ABCD", lib=lib)
    assert m.handle.value == 2
    a, b = m.energy_mj(), m.energy_mj()
    assert b - a == 5000
    assert nvml.joules(a, b) == 5.0
    assert m.power_limit_w() == 700.0


def test_no_matching_device_and_a_backward_counter_raise():
    with pytest.raises(RuntimeError):
        nvml.Nvml("ffff", lib=Stub(["GPU-aaaa"]))
    with pytest.raises(ValueError):
        nvml.joules(10, 9)


def test_a_failing_call_raises():
    lib = Stub(["GPU-aaaa"])
    lib.nvmlInit_v2 = lambda: 9
    with pytest.raises(RuntimeError):
        nvml.Nvml("aaaa", lib=lib)
