"""The STREAM elementwise kernel of ``csrc/stream.cu`` beside the designs
that were tried and not kept (``stream_designs.cu``: 1, 2 or 4 16-byte
accesses a thread and input, with and without the evict-first hints) and
the PyTorch call that computes the same function (``clone``, ``mul``,
``add``, ``add`` with alpha, ``full``), on one card.

Per (op, size, design): the device time of one call
(``common.device_ms``: the median kernel duration over 30 calls in one
``torch.profiler`` session), f32 at 16 MiB (in the 50 MB L2) and
128 MiB (past it). Every design's output is held equal to the plain
version first. Prints the card's name and power limit, one line per
reading, and a JSON line.

    PYTHONPATH=src python -m repro_torch.benchmarks.stream_designs
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess

import torch

from repro_torch.benchmarks.common import device_ms
from repro_torch.kernels import build
from repro_torch.kernels.stream import ref, stream as sk

HERE = pathlib.Path(__file__).resolve().parent
SIZES_MIB = (16, 128)
X = 1.7
OPS = ("stream_copy", "stream_scale", "stream_add", "stream_triad",
       "stream_write")
DESIGNS = [(u, cs) for u in (1, 2, 4) for cs in (False, True)]


def _designs():
    """(op, unroll, cs, a, b) -> a new output from ``stream_designs.cu``."""
    fn = ctypes.CDLL(str(build.build("stream_designs", HERE))).stream_design
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3 + [
        ctypes.c_float, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(op, unroll, cs, a, b):
        out = torch.empty_like(a)
        rc = fn(OPS.index(op), unroll, int(cs), a.data_ptr(), b.data_ptr(),
                out.data_ptr(), X, a.numel(),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"stream_design launch failed: cudaError {rc}")
        return out
    return run


def _kernel(op, a, b):
    return {"stream_copy": lambda: sk.stream_copy(a),
            "stream_scale": lambda: sk.stream_scale(a, X),
            "stream_add": lambda: sk.stream_add(a, b),
            "stream_triad": lambda: sk.stream_triad(a, b, X),
            "stream_write": lambda: sk.stream_write(tuple(a.shape), X)}[op]


def _plain(op, a, b):
    return {"stream_copy": lambda: ref.copy(a),
            "stream_scale": lambda: ref.scale(a, X),
            "stream_add": lambda: ref.add(a, b),
            "stream_triad": lambda: ref.triad(a, b, X),
            "stream_write": lambda: ref.write(tuple(a.shape), X, a.dtype,
                                              "cuda")}[op]()


def _library(op, a, b):
    xr = ref.scalar(X, a.dtype).item()
    return {"stream_copy": lambda: a.clone(),
            "stream_scale": lambda: torch.mul(a, xr),
            "stream_add": lambda: torch.add(a, b),
            "stream_triad": lambda: torch.add(b, a, alpha=xr),
            "stream_write": lambda: torch.full(tuple(a.shape), xr,
                                               device="cuda")}[op]


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("stream_designs needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    design = _designs()
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    rows = []
    for mib in SIZES_MIB:
        shape = ((mib << 20) // 4096, 1024)
        a = torch.randn(shape, device="cuda", generator=g)
        b = torch.randn(shape, device="cuda", generator=g)
        for op in OPS:
            want = _plain(op, a, b)
            calls = {"kernel": _kernel(op, a, b)}
            for u, cs in DESIGNS:
                calls[f"u{u}_{'cs' if cs else 'default'}"] = (
                    lambda u=u, cs=cs: design(op, u, cs, a, b))
            times = {}
            for name, call in calls.items():
                if not torch.equal(call(), want):
                    raise AssertionError(f"{op} {mib} MiB: {name} disagrees "
                                         f"with its plain version")
                times[name] = device_ms(call)
            times["library"] = device_ms(_library(op, a, b))
            rows.append(dict(op=op, mib=mib, device_ms=times))
            print(f"{op} f32 {mib} MiB, device ms a call: " + ", ".join(
                f"{k} {v:.4f}" for k, v in times.items()), flush=True)
    print(json.dumps({"card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
