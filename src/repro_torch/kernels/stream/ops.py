"""Counted entry points for the STREAM kernels, with bytes-moved accounting
(the bandwidth bench derives GB/s exactly like the paper's ``bandwidth``
tool).

Each entry point goes through :func:`repro_torch.core.tracing.counting_call`
and counts one compile per new abstract signature, where the reference's
``counting_jit`` traces a new executable.
"""
from repro_torch.core.tracing import TraceStats, counting_call
from repro_torch.kernels.stream import stream as k

#: module-level compile accounting — bench_bandwidth reports these counts
stats = TraceStats()


def _copy(a):
    return k.stream_copy(a)


def _scale(a, x):
    return k.stream_scale(a, x)


def _add(a, b):
    return k.stream_add(a, b)


def _triad(a, b, x):
    return k.stream_triad(a, b, x)


copy = counting_call(_copy, "stream/copy", stats)
scale = counting_call(_scale, "stream/scale", stats)
add = counting_call(_add, "stream/add", stats)
triad = counting_call(_triad, "stream/triad", stats)


def bytes_moved(op: str, a) -> int:
    n = a.numel() * a.element_size()
    return {"read": n, "write": n, "copy": 2 * n, "scale": 2 * n,
            "add": 3 * n, "triad": 3 * n}[op]
