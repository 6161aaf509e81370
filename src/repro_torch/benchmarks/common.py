"""Benchmark utilities: timing + CSV emission (``name,us_per_call,derived``)
and the collected rows, as in the reference's ``benchmarks/common.py``.

``time_fn`` takes the median wall time of a call that ends at
``torch.cuda.synchronize()`` when its output lies on the card, where the
reference blocks on its JAX arrays. ``device_ms`` reads one call's
device time under ``torch.profiler`` (``chip_smoke.py`` and the design
yardsticks time with it).
"""
import statistics
import time

import torch


def _block(out):
    """Wait for the device work behind ``out``, as ``block_until_ready``
    does for a JAX array."""
    if out.device.type == "cuda":
        torch.cuda.synchronize(out.device)


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


def device_ms(fn, n=10, sessions=3, by_kernel=False):
    """Device time of one call of ``fn`` under ``torch.profiler``: in each
    of ``sessions`` profiled runs of ``n`` calls, the median duration of
    each CUDA kernel it launches, summed over its kernels; then the median
    over the sessions that recorded any kernel. (The profiler has been seen
    to drop one call's events, once a whole session's, and once to read a
    session wrong: so no total over the calls is divided by their count,
    and no single session is trusted.) ``by_kernel``: also {kernel name:
    its median over the sessions}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    readings, kernels = [], {}
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name.setdefault(e.name, []).append(
                    e.time_range.elapsed_us())
        if by_name:
            readings.append(sum(statistics.median(v)
                                for v in by_name.values()) / 1e3)
            for name, v in by_name.items():
                kernels.setdefault(name, []).append(
                    statistics.median(v) / 1e3)
    if not readings:
        raise AssertionError("the profiler recorded no kernel in "
                             f"{sessions} sessions")
    total = statistics.median(readings)
    if not by_kernel:
        return total
    return total, {k: statistics.median(v) for k, v in kernels.items()}
