"""Benchmark utilities: timing + CSV emission (``name,us_per_call,derived``)
and the collected rows, as in the reference's ``benchmarks/common.py``.

``time_fn`` takes the median wall time of a call that ends at
``torch.cuda.synchronize()`` when its output lies on the card, where the
reference blocks on its JAX arrays. ``device_ms`` reads one call's
device time under ``torch.profiler`` (``chip_smoke.py`` and the design
yardsticks time with it). ``host_cpu`` names the processor a host bench
ran on.
"""
import json
import os
import platform
import statistics
import time

import torch


def _block(out):
    """Wait for the device work behind ``out``, as ``block_until_ready``
    does for a JAX array (host benches return no tensor: nothing to wait
    for)."""
    if isinstance(out, torch.Tensor) and out.device.type == "cuda":
        torch.cuda.synchronize(out.device)


def host_cpu(cpuinfo: str = "/proc/cpuinfo") -> str:
    """The host processor as ``cpuinfo`` gives it: its model name,
    or where the host hides that (``unknown``) its vendor, family, model
    and clock; then the count of CPUs. Commas are dropped so that it fits
    a CSV column."""
    info = {}
    try:
        with open(cpuinfo) as f:
            for line in f:
                if not line.strip():
                    break                   # the first processor's block
                key, _, value = line.partition(":")
                info[key.strip()] = value.strip()
    except OSError:
        pass
    name = info.get("model name", "")
    if name in ("", "unknown") and "cpu family" in info:
        name = (f"{info.get('vendor_id', '')} family {info['cpu family']} "
                f"model {info.get('model', '?')} @ "
                f"{float(info.get('cpu MHz', 0)):.0f} MHz")
    name = name or platform.processor() or "unknown CPU"
    name = f"{name} ({os.cpu_count()} CPUs)"
    return " ".join(name.replace(",", " ").split())


def time_fn(fn, *args, warmup=2, iters=5, **kw):
    """Median wall time per call in seconds (each call waits for the card)."""
    for _ in range(warmup):
        _block(fn(*args, **kw))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _block(fn(*args, **kw))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def emit(name, seconds, derived=""):
    print(f"{name},{seconds * 1e6:.1f},{derived}")


class BenchRows:
    """Collects emitted rows so a bench can return them; extra keyword
    fields ride along in each row."""

    def __init__(self):
        self.rows = {}

    def record(self, name, seconds, derived="", **extra):
        emit(name, seconds, derived)
        self.rows[name] = {"us_per_call": seconds * 1e6, "derived": derived,
                           **extra}

    def dump(self, json_path):
        """Write the rows as JSON to ``json_path`` (nothing when None)."""
        if json_path:
            with open(json_path, "w") as f:
                json.dump(self.rows, f, indent=2, sort_keys=True)


#: the marker kernel ``kernel_events`` brackets a session with
#: (``torch.cuda._sleep``'s kernel), its length in clock cycles, and how
#: many markers lead and end a session. On an H100 (NVIDIA H100 80GB
#: HBM3, 700 W) kineto drops a session's first records as out of its
#: window, more of them the older the process, whatever the session waits
#: first (``benchmarks.profiler_probe``, PERF.md §7): the leading markers
#: are what it drops
MARKER, MARKER_CYCLES, LEAD, TAIL = "spin_kernel", 1000, 1024, 8


def profiler_session(fn, n, settle=0.0):
    """(start ns, name, us) of every CUDA kernel kineto kept of one
    ``torch.profiler`` session: a ``settle`` s wait on the host, ``LEAD``
    markers, ``n`` calls of ``fn``, ``TAIL`` markers, in time order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if settle:
            time.sleep(settle)
        for _ in range(LEAD):
            torch.cuda._sleep(MARKER_CYCLES)
        for _ in range(n):
            fn()
        for _ in range(TAIL):
            torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()
    # the raw kineto events, not the FunctionEvents the profiler builds
    # from them, a Python object each (xlstm-1.3b's train step has 560,000
    # kernels)
    return sorted((e.start_ns(), e.name(), e.duration_ns() / 1e3)
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA)


def kernel_events(fn, n, tries=8, accept=None, sessions=None):
    """(events, ok): (name, us) of every CUDA kernel of ``n`` calls of
    ``fn`` under ``torch.profiler`` (``profiler_session``). A session is
    whole when it kept a leading marker, the calls' kernels and every
    trailing marker (every marker where the calls launch none). ``ok``:
    the session is whole, or its last kernel is a marker and ``accept`` (a
    test of its kept kernels) holds; it is run again, up to ``tries``
    sessions, until ``ok``. Not ok: the last session's kernels.
    ``sessions``: a list that gets (kernels, leading markers kept,
    trailing markers kept) of every session run."""
    for _ in range(tries):
        events = profiler_session(fn, n)
        marks = [MARKER in name for _, name, _ in events]
        kept = [(name, us) for (_, name, us), m in zip(events, marks)
                if not m]
        head = next((i for i, m in enumerate(marks) if not m), len(marks))
        tail = next((i for i, m in enumerate(marks[::-1]) if not m),
                    len(marks))
        if sessions is not None:
            sessions.append((len(events), head, tail))
        whole = (head >= 1 and tail == TAIL if kept
                 else len(marks) == LEAD + TAIL)
        ok = whole or (bool(events) and marks[-1] and accept is not None
                       and accept(kept))
        if ok:
            break
    return kept, ok


def device_ms(fn, n=30, by_kernel=False):
    """Device time of one call of ``fn`` under ``torch.profiler``: over
    one profiled run of ``n`` calls (``kernel_events``), the median
    duration of each CUDA kernel it launches, summed over its kernels. A
    run whose first records the profiler dropped counts where its last
    kernel is the trailing marker and each kernel it kept ran in at least
    half the calls (so no kernel of a call is missing, and each median is
    over n/2 calls or more). A run of no kernel, or no such run in 8,
    fails. ``by_kernel``: also {kernel name: its median}."""
    fn()
    torch.cuda.synchronize()

    def counts(events):
        by = {}
        for name, us in events:
            by.setdefault(name, []).append(us / 1e3)
        return by

    sessions = []
    events, ok = kernel_events(fn, n, accept=lambda ev: bool(ev) and all(
        len(v) >= n / 2 for v in counts(ev).values()), sessions=sessions)
    if not (ok and events):
        raise AssertionError(
            f"the profiler recorded no kernel of the calls, or lost the "
            f"first or last kernels of 8 sessions (kernels, markers kept "
            f"of {LEAD} leading and {TAIL} trailing: {sessions})")
    kernels = {k: statistics.median(v) for k, v in counts(events).items()}
    total = sum(kernels.values())
    return (total, kernels) if by_kernel else total
