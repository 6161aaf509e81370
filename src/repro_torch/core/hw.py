"""Hardware registry: the device the port serves on.

The paper's core idea — *manage heterogeneous compute with first-class energy
accounting* — needs a device model: peak compute, memory bandwidth, TDP,
idle power and the DVFS envelope. The port runs on one NVIDIA H100 SXM.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """One compute device (CPU, GPU, or TPU chip)."""

    name: str
    vendor: str
    kind: str                  # cpu | gpu | tpu | npu
    peak_flops: float          # FLOP/s at the headline dtype
    peak_dtype: str
    mem_bw: float              # B/s
    mem_gb: float
    tdp_w: float
    idle_w: float = 0.0
    # DVFS envelope
    f_max_ghz: float = 1.0
    f_min_ghz: float = 0.5


# NVIDIA H100 SXM5. Peak rate, bandwidth, memory, TDP and f_max are the data
# sheet's (bf16 dense tensor-core rate). idle_w (the average of 119 power
# samples over 2.35 s) and f_min_ghz (the idle SM clock) were read with
# `nvidia-smi -q -d POWER,CLOCK` on an idle "NVIDIA H100 80GB HBM3" whose
# power limit read 700.00 W (driver 580.159.03).
H100_SXM = DeviceSpec("H100 SXM", "nvidia", "gpu", 989e12, "bf16",
                      3.35e12, 80, 700, 73.64, 1.98, 0.345)
