"""Elastic node power management (paper Sec. 3.4).

SLURM hooks on DALEK: noderesume sends a Wake-on-LAN magic packet, a
dedicated ``powerstate`` user shuts nodes down via passwordless sudo over
SSH. Policy: power off after 10 minutes idle; up to 2 minutes boot delay
between reservation and job start; idle cluster draws ~50 W.

This module is the framework's elasticity engine: the same state machine
drives the simulated DALEK partitions and, on a real deployment, the power
states of the GPU nodes the port serves and trains on. Training integrates
via the cluster manager: jobs trigger resume, idle timers trigger suspend,
and energy accounting integrates power over state dwell times.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional

from repro_torch.core.hw import NodeSpec

IDLE_OFF_S = 600.0        # paper: 10 minutes
DEFAULT_BOOT_S = 120.0    # paper: up to 2 minutes


class PowerState(enum.Enum):
    OFF = "off"
    BOOTING = "booting"
    IDLE = "idle"
    BUSY = "busy"
    SUSPENDED = "suspended"


@dataclasses.dataclass
class NodePower:
    spec: NodeSpec
    state: PowerState = PowerState.OFF
    since: float = 0.0               # state entry time
    boot_done: float = 0.0
    energy_j: float = 0.0
    transitions: int = 0

    def watts(self) -> float:
        if self.state == PowerState.OFF:
            return 0.0
        if self.state == PowerState.SUSPENDED:
            return self.spec.suspend_w
        if self.state == PowerState.BOOTING:
            return self.spec.idle_w          # boot draws ~idle
        if self.state == PowerState.IDLE:
            return self.spec.idle_w
        return self.spec.tdp_w


class ElasticController:
    """Event-driven power state machine over a set of nodes."""

    def __init__(self, nodes: Dict[str, NodeSpec],
                 idle_off_s: float = IDLE_OFF_S):
        self.nodes: Dict[str, NodePower] = {
            name: NodePower(spec) for name, spec in nodes.items()}
        self.idle_off_s = idle_off_s
        self.t = 0.0
        self.log: List[tuple] = []

    def _set(self, name: str, state: PowerState):
        np_ = self.nodes[name]
        if np_.state != state:
            np_.transitions += 1
            self.log.append((self.t, name, np_.state.value, state.value))
        np_.state = state
        np_.since = self.t

    def advance(self, dt: float):
        """Integrate energy, apply idle-timeout power-off, finish boots."""
        end = self.t + dt
        for name, np_ in self.nodes.items():
            t = self.t
            # boot completion inside the window
            if np_.state == PowerState.BOOTING and np_.boot_done <= end:
                np_.energy_j += np_.watts() * (np_.boot_done - t)
                t_save, self.t = self.t, np_.boot_done
                self._set(name, PowerState.IDLE)
                self.t = t_save
                t = np_.boot_done
            # idle timeout inside the window
            if np_.state == PowerState.IDLE:
                off_at = np_.since + self.idle_off_s
                if off_at <= end:
                    np_.energy_j += np_.watts() * max(off_at - t, 0.0)
                    t_save, self.t = self.t, off_at
                    self._set(name, PowerState.OFF)
                    self.t = t_save
                    t = off_at
            np_.energy_j += np_.watts() * max(end - t, 0.0)
        self.t = end

    # -- SLURM hook analogues -------------------------------------------------

    def resume(self, names: List[str]) -> float:
        """noderesume (WoL): returns the time when all nodes are up."""
        ready = self.t
        for n in names:
            np_ = self.nodes[n]
            if np_.state in (PowerState.OFF, PowerState.SUSPENDED):
                self._set(n, PowerState.BOOTING)
                np_.boot_done = self.t + np_.spec.boot_s
                ready = max(ready, np_.boot_done)
            elif np_.state == PowerState.BOOTING:
                ready = max(ready, np_.boot_done)
        return ready

    def mark_busy(self, names: List[str]):
        for n in names:
            if self.nodes[n].state != PowerState.BUSY:
                self._set(n, PowerState.BUSY)

    def release(self, names: List[str]):
        """nodesuspend path: back to IDLE; idle timer starts now."""
        for n in names:
            self._set(n, PowerState.IDLE)

    # -- accounting -----------------------------------------------------------

    def total_power_w(self) -> float:
        return sum(n.watts() for n in self.nodes.values())

    def total_energy_j(self) -> float:
        return sum(n.energy_j for n in self.nodes.values())

    def states(self) -> Dict[str, str]:
        return {n: p.state.value for n, p in self.nodes.items()}
