"""Benchmark utilities: timing + CSV emission (``name,us_per_call,derived``)
and the collected rows, as in the reference's ``benchmarks/common.py``.

``time_fn`` takes the median wall time of a call that ends at
``torch.cuda.synchronize()`` when its output lies on the card, where the
reference blocks on its JAX arrays.
"""
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
