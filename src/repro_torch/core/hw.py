"""Hardware registry: DALEK's partitions (paper Tab. 1/2) and the device
the port serves on.

The paper's core idea — *manage heterogeneous compute with first-class energy
accounting* — needs a device model: peak compute, memory bandwidth, link
bandwidth, TDP, idle and suspend power. The registry carries the paper's four
consumer-grade partitions verbatim (used by the fidelity tests that reproduce
Tab. 2 totals), the NVIDIA H100 SXM the port runs on, and a deployment
of hosts of eight of them (``gpu_pod_partition``: NVLink inside a host,
the network across hosts).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


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


@dataclasses.dataclass(frozen=True)
class NodeSpec:
    name: str
    devices: Tuple[DeviceSpec, ...]
    ram_gb: float
    idle_w: float
    suspend_w: float
    tdp_w: float
    boot_s: float = 120.0      # paper: up to 2 min between alloc and job start
    net_gbps: float = 2.5      # paper: 2.5 GbE


@dataclasses.dataclass(frozen=True)
class PartitionSpec_:
    """A homogeneous group of nodes (paper: four nodes per partition)."""

    name: str
    node: NodeSpec
    n_nodes: int

    @property
    def idle_w(self):
        return self.node.idle_w * self.n_nodes

    @property
    def suspend_w(self):
        return self.node.suspend_w * self.n_nodes

    @property
    def tdp_w(self):
        return self.node.tdp_w * self.n_nodes


# --------------------------------------------------------------------------
# DALEK's devices (paper Tab. 1/2)

RYZEN_7945HX = DeviceSpec("Ryzen 9 7945HX", "amd", "cpu", 1.6e12, "f32",
                          83e9, 96, 75, 15, 5.4, 3.0)
CORE_ULTRA_185H = DeviceSpec("Core Ultra 9 185H", "intel", "cpu", 0.9e12, "f32",
                             90e9, 32, 115, 12, 5.1, 0.7)
RYZEN_AI_HX370 = DeviceSpec("Ryzen AI 9 HX 370", "amd", "cpu", 0.8e12, "f32",
                            120e9, 32, 54, 8, 5.1, 1.0)
CORE_I9_13900H = DeviceSpec("Core i9-13900H", "intel", "cpu", 0.7e12, "f32",
                            80e9, 96, 115, 10, 5.4, 0.8)
RTX_4090 = DeviceSpec("GeForce RTX 4090", "nvidia", "gpu", 82.6e12, "f32",
                      1008e9, 24, 450, 20, 2.52, 0.21)
RX_7900XTX = DeviceSpec("Radeon RX 7900 XTX", "amd", "gpu", 61.4e12, "f32",
                        960e9, 24, 300, 15, 2.5, 0.5)
ARC_A770 = DeviceSpec("Arc A770", "intel", "gpu", 39.3e12, "f32",
                      560e9, 16, 225, 35, 2.4, 0.3)
RADEON_890M = DeviceSpec("Radeon 890M", "amd", "gpu", 12.0e12, "f16",
                         96e9, 0, 30, 3, 2.9, 0.4)

# NVIDIA H100 SXM5. Peak rate, bandwidth, memory, TDP and f_max are the data
# sheet's (bf16 dense tensor-core rate). idle_w (the average of 119 power
# samples over 2.35 s) and f_min_ghz (the idle SM clock) were read with
# `nvidia-smi -q -d POWER,CLOCK` on an idle "NVIDIA H100 80GB HBM3" whose
# power limit read 700.00 W (driver 580.159.03).
H100_SXM = DeviceSpec("H100 SXM", "nvidia", "gpu", 989e12, "bf16",
                      3.35e12, 80, 700, 73.64, 1.98, 0.345)


# A host of eight H100 SXMs: the counterpart of the reference's TPU v5e pod
# (TPU_V5E, TPU_V5E_ICI_BW, TPU_V5E_DCN_BW). The GPUs of a host talk over
# NVLink, hosts over the network, whose per-GPU share is what the ``pod``
# axis's reduction crosses. Data-sheet values, none measured: NVLink 4 per
# GPU (NVIDIA H100 data sheet), and across hosts one 400 Gb/s ConnectX-7
# port a GPU (NVIDIA DGX H100 data sheet).
H100_NVLINK_BW = 900e9     # B/s per GPU
H100_NET_BW = 50e9         # B/s per GPU across hosts


def _dalek_node(name, cpu, gpu, ram, idle, susp, tdp, net=2.5):
    devs = (cpu,) + ((gpu,) if gpu else ())
    return NodeSpec(name, devs, ram, idle, susp, tdp, net_gbps=net)


# paper Tab. 2 rows (per-node power derived from 4-node partition totals)
DALEK_PARTITIONS: Dict[str, PartitionSpec_] = {
    "az4-n4090": PartitionSpec_(
        "az4-n4090", _dalek_node("az4-n4090", RYZEN_7945HX, RTX_4090,
                                 96, 53.0, 1.5, 525.0), 4),
    "az4-a7900": PartitionSpec_(
        "az4-a7900", _dalek_node("az4-a7900", RYZEN_7945HX, RX_7900XTX,
                                 96, 48.0, 1.5, 375.0), 4),
    "iml-ia770": PartitionSpec_(
        "iml-ia770", _dalek_node("iml-ia770", CORE_ULTRA_185H, ARC_A770,
                                 32, 65.0, 23.0, 340.0, net=5.0), 4),
    "az5-a890m": PartitionSpec_(
        "az5-a890m", _dalek_node("az5-a890m", RYZEN_AI_HX370, RADEON_890M,
                                 32, 4.0, 2.0, 54.0), 4),
}

FRONTEND = NodeSpec("front", (CORE_I9_13900H,), 96, 15.0, 15.0, 115.0,
                    net_gbps=20.0)
SWITCH_IDLE_W, SWITCH_TDP_W = 20.0, 100.0
RPI_IDLE_W, RPI_TDP_W, N_RPI = 3.0, 9.0, 4

# paper Tab. 2 "Total" row for fidelity checks
PAPER_TOTALS = {"idle_w": 727.0, "suspend_w": 112.0, "tdp_w": 5427.0}


def gpu_pod_partition(name="h100-pod", n_gpus=256, gpus_per_node=8):
    """Hosts of ``gpus_per_node`` H100 SXMs (the reference's
    ``tpu_pod_partition``). From the NVIDIA DGX H100 data sheet: 2 TB of
    host memory, 10.2 kW maximum, eight 400 Gb/s network ports. Not on a
    data sheet, so allowances: idle is the GPUs' idle power (H100_SXM)
    plus 150 W for the host (the reference's allowance for its TPU host),
    suspend 0 W (a powered-off host), boot 300 s."""
    node = NodeSpec(
        f"{name}-host", (H100_SXM,) * gpus_per_node, ram_gb=2048,
        idle_w=gpus_per_node * H100_SXM.idle_w + 150, suspend_w=0.0,
        tdp_w=10_200.0, boot_s=300.0, net_gbps=gpus_per_node * 400.0)
    return PartitionSpec_(name, node, n_gpus // gpus_per_node)


def cluster_idle_w(mode: str = "off") -> float:
    """Cluster power with all compute nodes in a given state.

    mode="off": paper Sec. 3.4 — nodes powered down after 10 min idle, only
    frontend + switch + RPis draw power (~50 W).
    mode="suspend": S3 (paper Tab. 2 suspend column).
    mode="idle": all nodes booted but idle (Tab. 2 idle column).
    """
    base = FRONTEND.idle_w + SWITCH_IDLE_W + N_RPI * RPI_IDLE_W
    if mode == "off":
        return base
    if mode == "suspend":
        return base + sum(p.suspend_w for p in DALEK_PARTITIONS.values())
    return base + sum(p.idle_w for p in DALEK_PARTITIONS.values())
