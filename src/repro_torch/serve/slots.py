"""Per-slot KV-cache bookkeeping for continuous batching.

Each batch row of the shared KV cache is a *slot*. A slot is bound to one
request from prefill until EOS/length, then recycled for the next queued
request while the other slots keep decoding — the cache itself never
reshapes, only the slot's position/ownership state changes.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.serve.queue import Request


@dataclasses.dataclass
class Slot:
    index: int
    req: Optional[Request] = None
    pos: int = 0            # cache position the *next* token writes to
    last_token: int = 0     # token fed to the next decode step

    @property
    def free(self) -> bool:
        return self.req is None


class SlotManager:
    """Slot lifecycle: assign at prefill, advance per decode, release+recycle."""

    def __init__(self, batch_size: int, max_seq: int):
        self.batch_size = batch_size
        self.max_seq = max_seq
        self.slots: List[Slot] = [Slot(i) for i in range(batch_size)]
        self.n_assigned = 0
        self.n_released = 0
        self.n_prefill_tokens = 0   # true prompt tokens (bucket pad excluded)
        self.peak_active = 0

    def free_slots(self) -> List[Slot]:
        return [s for s in self.slots if s.free]

    def active_slots(self) -> List[Slot]:
        return [s for s in self.slots if not s.free]

    @property
    def n_active(self) -> int:
        return sum(1 for s in self.slots if not s.free)

    def assign(self, slot: Slot, req: Request, first_token: int):
        """Bind ``req`` after its prefill wrote cache [0, len(prompt)).

        ``slot.pos`` is always the TRUE prompt length: a bucketed prefill
        right-pads to its bucket edge but scatters only the real prefix, so
        decode resumes at the true position, not the padded one. The prompt
        must leave at least one decode position; a generation budget beyond
        capacity is fine — the engine finishes the request at capacity
        (``at_capacity``) instead of truncating the budget up front."""
        assert slot.free, f"slot {slot.index} busy"
        assert len(req.prompt) < self.max_seq, (
            f"request {req.req_id}: prompt of {len(req.prompt)} leaves no "
            f"decode position in a {self.max_seq}-position cache")
        slot.req = req
        slot.pos = len(req.prompt)
        slot.last_token = first_token
        self.n_assigned += 1
        self.n_prefill_tokens += len(req.prompt)
        self.peak_active = max(self.peak_active, self.n_active)

    def advance(self, slot: Slot, token: int):
        """Record one decoded token: the fed token landed at ``pos``.

        ``pos`` is NOT clamped at ``max_seq - 1``: clamping silently
        overwrote the last KV position every subsequent step (stale
        attention, corrupted cache). The engine checks ``at_capacity`` after
        each advance and finishes the request (finish_reason "capacity")
        instead of letting it wrap."""
        slot.pos += 1
        slot.last_token = token

    def at_capacity(self, slot: Slot) -> bool:
        """True when the next decode would write past the cache: the
        request must finish now (finish_reason "capacity")."""
        return slot.pos > self.max_seq - 1

    def release(self, slot: Slot):
        slot.req = None
        slot.pos = 0
        slot.last_token = 0
        self.n_released += 1

    def batch_tokens(self) -> np.ndarray:
        """[B, 1] int32 next-token inputs (free slots feed token 0)."""
        return np.array([[s.last_token] for s in self.slots], np.int32)

    def batch_positions(self) -> np.ndarray:
        """[B] int32 per-slot cache positions (free slots pinned at 0;
        their writes land in recycled rows that the next prefill
        overwrites)."""
        return np.array([min(s.pos, self.max_seq - 1) for s in self.slots],
                        np.int32)
