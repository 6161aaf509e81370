"""Cluster topology (paper Sec. 2): partitions, nodes, network.

DALEK: four partitions x four nodes on a 2.5 GbE switch (one 5 GbE
partition), frontend with 2x10 Gbps aggregated uplinks, per-partition /27
subnets inside 192.168.1.0/24.
"""
from __future__ import annotations

import dataclasses
import ipaddress
from typing import Dict, List, Optional, Tuple

from repro_torch.core import hw


@dataclasses.dataclass(frozen=True)
class Link:
    a: str
    b: str
    gbps: float


@dataclasses.dataclass
class Node:
    name: str
    partition: str
    spec: hw.NodeSpec
    ip: str
    switch_port: int


class Topology:
    def __init__(self):
        self.nodes: Dict[str, Node] = {}
        self.links: List[Link] = []
        self.partitions: Dict[str, List[str]] = {}

    def add_node(self, node: Node, link_gbps: float):
        self.nodes[node.name] = node
        self.partitions.setdefault(node.partition, []).append(node.name)
        self.links.append(Link(node.name, "switch", link_gbps))

    def partition_nodes(self, partition: str) -> List[str]:
        return list(self.partitions.get(partition, []))

    def bisection_gbps(self, names: List[str]) -> float:
        """Min aggregate bandwidth in/out of a node set (star topology:
        bottleneck is the sum of member uplinks vs the rest)."""
        inside = sum(l.gbps for l in self.links if l.a in names)
        outside = sum(l.gbps for l in self.links if l.a not in names
                      and l.a != "switch")
        return min(inside, outside)


def dalek_topology() -> Topology:
    """The paper's exact cluster (Tab. 3 addressing)."""
    topo = Topology()
    base = ipaddress.ip_address("192.168.1.0")
    subnet_starts = {"az4-n4090": 1, "az4-a7900": 33,
                     "iml-ia770": 65, "az5-a890m": 97}
    ports = {"az4-n4090": 33, "az4-a7900": 37, "iml-ia770": 41,
             "az5-a890m": 45}
    for pname, part in hw.DALEK_PARTITIONS.items():
        for i in range(part.n_nodes):
            ip = str(base + subnet_starts[pname] + i)
            node = Node(f"{pname}-{i}", pname, part.node, ip,
                        ports[pname] + i)
            topo.add_node(node, part.node.net_gbps)
    return topo


def gpu_topology(n_pods: int = 2, gpus_per_pod: int = 256,
                 gpus_per_node: int = 8) -> Topology:
    """A deployment of H100 hosts (the reference's ``tpu_topology``):
    ``gpus_per_node`` GPUs a host on NVLink, the hosts of a pod on the
    network, each host's uplink its GPUs' ports."""
    topo = Topology()
    part = hw.gpu_pod_partition(n_gpus=gpus_per_pod,
                                gpus_per_node=gpus_per_node)
    for p in range(n_pods):
        pname = f"pod{p}"
        for h in range(part.n_nodes):
            node = Node(f"{pname}-host{h}", pname, part.node,
                        f"10.{p}.{h // 256}.{h % 256}", h)
            topo.add_node(node, part.node.net_gbps)
    return topo


def validate_addressing(topo: Topology) -> bool:
    """Paper List. 1: /27 blocks per partition inside one /24 (pods of a
    GPU deployment have their own /16 and are not checked)."""
    for pname, names in topo.partitions.items():
        ips = sorted(int(ipaddress.ip_address(topo.nodes[n].ip))
                     for n in names)
        if "pod" in pname:
            continue
        block = ips[0] >> 5
        if any((ip >> 5) != block for ip in ips):
            return False
    return True
