"""Profiler sessions inside the measured window, and their reduction to
device time, idle time and kernel time by name.

The traced run profiles short sessions spread over the window. Kineto can
drop a session's first records, so each session is bracketed by ``LEAD``
spin kernels before and ``TAIL`` after (the method of
``repro_torch.benchmarks.common.kernel_events``, copied): a session counts
only if it kept at least one leading marker and every trailing one. It
can also lose records in between (seen on the card in sessions of a few
seconds of eager decode steps), so a session counts only if its kernels
span at least ``COVER`` of the host time it ran. Markers are left out of
every number.

The host clock and the trace's clock are tied by the trailing markers: the
harness notes the host time right before it launches them on an idle
device (each engine call ends at a host sync), and the first of them
starts on the device a launch later.
"""
from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional, Sequence, Tuple

MARKER, MARKER_CYCLES, LEAD, TAIL = "spin_kernel", 1000, 1024, 8
#: the least share of a session's host time its kept kernels must span
COVER = 0.9


class Session:
    """One profiler session: ``start()`` between engine calls, ``stop()``
    between engine calls later; ``events`` after ``stop``."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.torch = torch
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.host_start_ns = self.host_tail_ns = None

    def start(self):
        self.prof.__enter__()
        self.host_start_ns = time.perf_counter_ns()
        for _ in range(LEAD):
            self.torch.cuda._sleep(MARKER_CYCLES)

    def stop(self):
        self.torch.cuda.synchronize()
        self.host_tail_ns = time.perf_counter_ns()
        for _ in range(TAIL):
            self.torch.cuda._sleep(MARKER_CYCLES)
        self.torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)

    def events(self) -> List[Tuple[int, int, str]]:
        """(start ns, end ns, name) of every CUDA kernel kept, in time
        order."""
        from torch.autograd import DeviceType
        evs = self.prof.profiler.kineto_results.events()
        return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                      for e in evs if e.device_type() == DeviceType.CUDA)


def reduce_session(events: Sequence[Tuple[int, int, str]],
                   host_tail_ns: Optional[int] = None,
                   host_start_ns: Optional[int] = None) -> Optional[Dict]:
    """A whole session's kernels without the markers: {"kernels": [(start,
    end, name)], "span_s", "busy_s", "gaps": [(start, end)],
    "offset_ns"}; None for a session that lost records (a leading or
    trailing marker, or, given its host start and tail times, kernels
    spanning less than ``COVER`` of them). ``span_s`` runs from the first
    kept kernel's start to the last one's end; ``busy_s`` is the union of
    kernel intervals in it; ``offset_ns`` maps host time to trace time
    (trace = host + offset)."""
    marks = [MARKER in name for _, _, name in events]
    head = next((i for i, m in enumerate(marks) if not m), len(marks))
    tail = next((i for i, m in enumerate(marks[::-1]) if not m), len(marks))
    kernels = [e for e, m in zip(events, marks) if not m]
    if not kernels or head < 1 or tail != TAIL:
        return None
    busy, gaps = 0, []
    cur_s, cur_e = kernels[0][0], kernels[0][1]
    for s, e, _ in kernels[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = kernels[-1][1] - kernels[0][0]
    if host_start_ns is not None and host_tail_ns is not None and \
            span < COVER * (host_tail_ns - host_start_ns):
        return None
    offset = None
    if host_tail_ns is not None:
        first_tail = events[len(events) - TAIL][0]
        offset = first_tail - host_tail_ns
    return {"kernels": kernels, "span_s": span / 1e9, "busy_s": busy / 1e9,
            "gaps": gaps, "offset_ns": offset}


def short_name(name: str) -> str:
    """A kernel's name without its argument list: ``void
    at::native::vectorized_gather_kernel<16, long>(char*, ...)`` reads
    ``at::native::vectorized_gather_kernel<16, long>``."""
    n = name.replace("(anonymous namespace)::", "")
    n = n[5:] if n.startswith("void ") else n
    cut = n.find("(")
    return (n[:cut] if cut > 0 else n)[:160]


def kernel_seconds(sessions: Sequence[Dict]) -> Dict[str, float]:
    """Device seconds by kernel (``short_name``) over the sessions."""
    by: Dict[str, float] = {}
    for s in sessions:
        for a, b, name in s["kernels"]:
            k = short_name(name)
            by[k] = by.get(k, 0.0) + (b - a) / 1e9
    return by


def idle_by_span(sessions: Sequence[Dict],
                 spans: Sequence[Tuple[str, int, int]]) -> Dict[str, float]:
    """Idle device seconds by what the host was doing: each gap is given
    to the host span (name, start ns, end ns; host clock) that holds its
    middle, or to "harness" between spans."""
    out: Dict[str, float] = {}
    spans = sorted(spans, key=lambda s: s[1])
    starts = [s[1] for s in spans]
    for sess in sessions:
        off = sess["offset_ns"]
        for a, b in sess["gaps"]:
            name = "unaligned"
            if off is not None:
                mid = (a + b) // 2 - off
                i = bisect.bisect_right(starts, mid) - 1
                name = (spans[i][0] if i >= 0 and spans[i][2] >= mid
                        else "harness")
            out[name] = out.get(name, 0.0) + (b - a) / 1e9
    return out


def top(by: Dict[str, float], n: int = 10) -> List[List]:
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
