"""Paper Fig. 4 / Fig. 6 (Sec. 5.1/5.3): STREAM-style memory bandwidth.

Sweeps f32 buffers of 64 KB, 1 MB, 16 MB and 128 MB (1024 columns) through
copy, scale, add and triad on the hand-written STREAM kernels
(``csrc/stream.cu``, through ``kernels/stream/ops``), as the reference
bench sweeps the same sizes and ops. Each row is the median wall time of
one call that ends at ``torch.cuda.synchronize()``, so at the small sizes
it is mostly launch and synchronisation latency (Fig. 8's subject), not
bandwidth. GB/s counts the bytes of ``bytes_moved`` (each input read once,
the output written once).

On the card the derived column adds the share of the H100 SXM data sheet's
HBM rate (3.35 TB/s, ``core.hw.H100_SXM.mem_bw``). The H100 has a 50 MB L2,
so the 64 KB-16 MB buffers stay in it between calls: a share above 1 there
is L2 bandwidth, not a fault. Only the 128 MB buffers stream from HBM.
With ``device="cpu"`` the same path runs the plain versions on the host
and the column names the host instead; that is no device reading.
"""
import numpy as np
import torch

from repro_torch.benchmarks.common import BenchRows, time_fn
from repro_torch.core.device import resolve_device
from repro_torch.core.hw import H100_SXM
from repro_torch.kernels.stream import ops as stream_ops
from repro_torch.kernels.stream import stream as sk

SIZES_KB = [64, 1024, 16 * 1024, 128 * 1024]   # L1/L2/L3/RAM-ish
COLS = 1024
X = 1.7
OPS = ("copy", "scale", "add", "triad")        # the reference bench's rows


def _input(seed, rows, dev):
    return torch.as_tensor(np.random.default_rng(seed).normal(
        size=(rows, COLS)), dtype=torch.float32).to(dev)


def _derived(gbs, dev) -> str:
    if dev.type == "cuda":
        return (f"{gbs:.2f}GB/s;share_of_H100_datasheet_HBM="
                f"{gbs * 1e9 / H100_SXM.mem_bw:.3f}")
    return f"{gbs:.2f}GB/s;host_cpu"


def run(device=None, ops=OPS):
    """One row per op in ``ops`` and size; ``read`` and ``write``, which
    the reference bench names but does not emit, run on the kernels'
    wrappers directly (its ops module counts no compile for them)."""
    dev = resolve_device(device)
    out = BenchRows()
    for kb in SIZES_KB:
        rows = max(kb * 1024 // (COLS * 4), 1)
        a = _input(0, rows, dev)
        b = _input(1, rows, dev) if {"add", "triad"} & set(ops) else None
        calls = {
            "copy": (stream_ops.copy, (a,)),
            "scale": (stream_ops.scale, (a, X)),
            "add": (stream_ops.add, (a, b)),
            "triad": (stream_ops.triad, (a, b, X)),
            "read": (sk.stream_read, (a,)),
            "write": (lambda: sk.stream_write((rows, COLS), X, device=dev),
                      ()),
        }
        for name in ops:
            fn, args = calls[name]
            t = time_fn(fn, *args)
            gbs = stream_ops.bytes_moved(name, a) / t / 1e9
            out.record(f"bandwidth/{name}/{kb}KB", t, _derived(gbs, dev),
                       compiles=stream_ops.stats.compiles(f"stream/{name}"))
    return out

if __name__ == "__main__":
    run()
