"""The card's own energy counter, read through NVML.

``nvmlDeviceGetTotalEnergyConsumption`` gives the millijoules the card
has used since its kernel module loaded; the energy of a window is the
difference of two readings. The library is ``libnvidia-ml.so.1`` (the one
``nvidia-smi`` uses), loaded with ``ctypes``; the NVML device is the one
whose UUID is CUDA device 0's."""
from __future__ import annotations

import ctypes
from typing import Optional

LIBRARY = "libnvidia-ml.so.1"


def _norm_uuid(u: str) -> str:
    u = u.strip().lower()
    return u[4:] if u.startswith("gpu-") else u


class Nvml:
    """One NVML device, matched by UUID. ``lib``: a loaded library (a
    stub in tests)."""

    def __init__(self, uuid: str, lib=None):
        self.lib = lib if lib is not None else self._load()
        self._check(self.lib.nvmlInit_v2(), "nvmlInit_v2")
        count = ctypes.c_uint(0)
        self._check(self.lib.nvmlDeviceGetCount_v2(ctypes.byref(count)),
                    "nvmlDeviceGetCount_v2")
        want = _norm_uuid(uuid)
        self.handle = None
        for i in range(count.value):
            h = ctypes.c_void_p()
            self._check(self.lib.nvmlDeviceGetHandleByIndex_v2(
                ctypes.c_uint(i), ctypes.byref(h)), "GetHandleByIndex")
            buf = ctypes.create_string_buffer(96)
            self._check(self.lib.nvmlDeviceGetUUID(h, buf, ctypes.c_uint(96)),
                        "nvmlDeviceGetUUID")
            if _norm_uuid(buf.value.decode()) == want:
                self.handle = h
                break
        if self.handle is None:
            raise RuntimeError(f"no NVML device has the UUID {uuid}")

    @staticmethod
    def _load():
        lib = ctypes.CDLL(LIBRARY)
        p, u = ctypes.POINTER, ctypes.c_uint
        for name, args in (
                ("nvmlInit_v2", []),
                ("nvmlDeviceGetCount_v2", [p(u)]),
                ("nvmlDeviceGetHandleByIndex_v2", [u, p(ctypes.c_void_p)]),
                ("nvmlDeviceGetUUID", [ctypes.c_void_p, ctypes.c_char_p, u]),
                ("nvmlDeviceGetTotalEnergyConsumption",
                 [ctypes.c_void_p, p(ctypes.c_ulonglong)]),
                ("nvmlDeviceGetEnforcedPowerLimit", [ctypes.c_void_p, p(u)])):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
        return lib

    @staticmethod
    def _check(rc, what):
        if rc != 0:
            raise RuntimeError(f"NVML {what} returned {rc}")

    def energy_mj(self) -> int:
        """The card's energy counter, in millijoules."""
        v = ctypes.c_ulonglong(0)
        self._check(self.lib.nvmlDeviceGetTotalEnergyConsumption(
            self.handle, ctypes.byref(v)), "GetTotalEnergyConsumption")
        return int(v.value)

    def power_limit_w(self) -> Optional[float]:
        v = ctypes.c_uint(0)
        if self.lib.nvmlDeviceGetEnforcedPowerLimit(self.handle,
                                                    ctypes.byref(v)) != 0:
            return None
        return v.value / 1000.0


def joules(mj_start: int, mj_end: int) -> float:
    """The energy between two counter readings, in joules."""
    if mj_end < mj_start:
        raise ValueError(f"the energy counter ran backwards: {mj_start} "
                         f"then {mj_end} mJ")
    return (mj_end - mj_start) / 1000.0
