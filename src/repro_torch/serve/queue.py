"""Request queue + energy-aware admission control for the serving engine.

Requests enter a FIFO queue; the admission controller decides, per engine
iteration, how many may occupy decode slots. Under a node power cap it
consults the DVFS model (``core.energy.cap_frequency``) for the highest
sustainable frequency and limits concurrency so the modeled average power
stays under the cap; requests whose predicted queue wait (from measured
throughput, ``core.scheduler.ThroughputStats``) exceeds their TTL are shed.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Deque, List, Optional

import numpy as np

from repro_torch.core.energy import DvfsState, ServePowerModel, cap_frequency
from repro_torch.core.hw import DeviceSpec
from repro_torch.core.scheduler import ThroughputStats


@dataclasses.dataclass
class Request:
    """One generation request. ``output`` accumulates sampled token ids;
    ``energy_j`` accumulates this request's share of board energy from the
    tag-bus attribution (paper Sec. 4.1)."""

    req_id: int
    prompt: np.ndarray              # [S] int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    frames: Optional[np.ndarray] = None  # audio: [enc_seq, D] encoder frames
    ttl_s: Optional[float] = None   # shed if predicted wait exceeds this
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    finish_reason: str = ""   # "length" | "eos" | "shed" | "capacity" | "pages"
    energy_j: float = 0.0
    prefill_s: float = 0.0
    decode_steps: int = 0
    cached_prompt_tokens: int = 0   # prompt span served from the prefix cache

    @property
    def n_generated(self) -> int:
        return len(self.output)


class RequestQueue:
    """FIFO admission queue with shed support."""

    def __init__(self):
        self._q: Deque[Request] = collections.deque()
        self.n_shed = 0

    def push(self, req: Request):
        self._q.append(req)

    def pop(self) -> Request:
        return self._q.popleft()

    def peek(self) -> Request:
        return self._q[0]

    def shed(self, req: Request, reason: str = "shed"):
        """Mark ``req`` shed AND drop it from the queue: a shed request must
        never be ``pop()``-ed into a slot (callers used to need a separate
        ``remove()``; forgetting it re-admitted dead requests)."""
        req.done = True
        req.finish_reason = reason
        self.n_shed += 1
        try:
            self._q.remove(req)
        except ValueError:
            pass    # already popped (e.g. shed straight from a pop())

    def queued_tokens(self, cached_tokens_fn=None) -> int:
        """Token budget waiting in the queue (admission wait estimate):
        prompt tokens still to prefill plus the generation budget — counting
        only ``max_new_tokens`` undercounts the wait and sheds too late.

        ``cached_tokens_fn(req)`` (optional) returns the prompt span the
        prefix cache is expected to serve without compute; pricing queued
        prompts gross of cache hits over-sheds warm-prefix traffic, so the
        engine passes its prefix-cache probe here."""
        if cached_tokens_fn is None:
            return sum(len(r.prompt) + r.max_new_tokens for r in self._q)
        return sum(
            max(0, len(r.prompt) - cached_tokens_fn(r)) + r.max_new_tokens
            for r in self._q)

    def snapshot(self) -> List[Request]:
        """Queue contents in FIFO order (for shed walks)."""
        return list(self._q)

    def remove(self, req: Request):
        self._q.remove(req)

    def __len__(self):
        return len(self._q)

    def __bool__(self):
        return bool(self._q)


class AdmissionController:
    """Energy-aware admission: concurrency under a power cap + TTL shedding.

    With no cap every free slot is filled (work-conserving). With a cap:

    1. ``cap_frequency`` picks the highest DVFS state whose modeled step
       power at full batch fits the cap (frequency is set per-node, not
       per-slot).
    2. At that frequency, concurrency is limited to the largest ``n`` whose
       duty-cycle-average power (``ServePowerModel.avg_power_w``) fits the
       cap — admitting more requests raises utilization and therefore power.
    3. Requests whose predicted wait (queued tokens / measured decode rate)
       exceeds their TTL are shed instead of queued indefinitely.
    4. ``max_slots_fn`` / ``should_shed_fn`` override steps 2 and 3 wholesale
       — the injection point a trace-replay harness
       uses to regression-test policy variants against recorded power
       without subclassing the controller.
    """

    def __init__(self, power_model: Optional[ServePowerModel] = None,
                 power_cap_w: Optional[float] = None,
                 stats: Optional[ThroughputStats] = None,
                 max_slots_fn: Optional[Callable[[int], int]] = None,
                 should_shed_fn: Optional[Callable[["Request", int],
                                                   bool]] = None):
        self.pm = power_model
        self.cap_w = power_cap_w
        self.stats = stats or ThroughputStats()
        self.max_slots_fn = max_slots_fn
        self.should_shed_fn = should_shed_fn

    def dvfs(self, batch_size: int) -> Optional[DvfsState]:
        """DVFS state sustaining the cap at full concurrency (None = f_max)."""
        if self.cap_w is None or self.pm is None:
            return None
        return cap_frequency(self.cap_w, self.pm.terms(batch_size),
                             self.pm.dev)

    def apply_dvfs(self, batch_size: int) -> Optional[DvfsState]:
        """Resolve and install the capped DVFS state on the power model."""
        st = self.dvfs(batch_size)
        if self.pm is not None:
            self.pm.dvfs = st
        return st

    def max_slots(self, batch_size: int) -> int:
        """Largest concurrency whose modeled average power fits the cap."""
        if self.max_slots_fn is not None:
            return self.max_slots_fn(batch_size)
        if self.cap_w is None or self.pm is None:
            return batch_size
        n = 0
        for i in range(1, batch_size + 1):
            if self.pm.avg_power_w(i) <= self.cap_w:
                n = i
        return n

    def admit(self, n_active: int, batch_size: int) -> bool:
        return n_active < min(batch_size, self.max_slots(batch_size))

    def should_shed(self, req: Request, tokens_ahead: int,
                    prefill_tokens_ahead: int = 0) -> bool:
        """Shed when the predicted wait for the work in front of this
        request exceeds its TTL. The two phases are priced separately:
        ``tokens_ahead`` (decode budgets) at the measured decode rate and
        ``prefill_tokens_ahead`` (prompt tokens still to prefill) at the
        measured prefill rate — prefill moves a whole prompt per call, so
        pricing prompts at the ~orders-slower decode rate would predict
        waits that never happen and shed requests that would meet their
        TTL. Unmeasured prefill contributes nothing (optimistic, like the
        unmeasured-decode case). A request with nothing ahead of it is
        never shed — it would start immediately. Injected ``should_shed_fn``
        policies receive the decode-budget count only, unchanged from
        before prompt accounting existed."""
        if self.should_shed_fn is not None:
            return self.should_shed_fn(req, tokens_ahead)
        if req.ttl_s is None or tokens_ahead + prefill_tokens_ahead <= 0:
            return False
        if self.stats.rate("decode") <= 0:
            return False       # nothing measured yet: admit optimistically
        wait = self.stats.predicted_wait_s(tokens_ahead)
        prefill_rate = self.stats.rate("prefill")
        if prefill_tokens_ahead > 0 and prefill_rate > 0:
            wait += prefill_tokens_ahead / prefill_rate
        return wait > req.ttl_s
